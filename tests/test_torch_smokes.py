"""The port's CI smokes (``horovod_tpu_torch/tools/*_smoke.py``) and gate
(``horovod_tpu_torch/tools/ci_checks.sh``) against the reference's
(``tools/``):

- each smoke's seeded plan, worker constants and scenario are the
  reference's (``tests/test_chaos.py``'s ``chaos_plan``, ``guard_plan`` and
  ``driver_kill_plan``, ``tests/test_selfdrive.py``'s scenario, the
  constants of the reference smokes themselves);
- ``topo_smoke``'s dumps are byte-identical to the JAX ``tools/topo_plan.py``'s
  for the same arguments;
- every smoke's gate functions pass one good input and fail one bad input,
  so that no gate is vacuous;
- the cheap smokes (``quant``, ``zero``, ``guard``, and ``topo`` as the gate
  script's one stage) run whole on gloo ranks, started together; the heavy
  ones run whole only in ``ci_checks.sh``;
- ``ci_checks.sh`` with every stage skipped but ``topo`` exits 0, and a
  failing stage makes it exit nonzero;
- C9: a step's first call charges the collectives it issues call by call to
  ``hvd_axis_wire_bytes_total`` once (the composed step's model-axis psums,
  ZeRO-1's parameter all-gather), as the JAX package charges them at trace
  time; C10: ``make_train_step`` over a ``DistributedOptimizer`` on a
  subgroup averages the loss over that subgroup, not over every rank.
"""

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_ALL = ("LINT", "CHAOS", "METRICS", "OVERLAP", "GUARD", "DRIVER", "TOPO", "QUANT", "TRACE",
            "TUNE", "ZERO", "SIM", "SELFDRIVE", "LLM", "RESHARD", "SERVE", "TPFUSE", "TESTS")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_", "TORCHELASTIC_", "HVD_CI_SKIP_"))}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the scenarios are the reference's ------------------------------------------


def test_chaos_guard_and_driver_plans_are_the_reference_plans():
    import test_chaos as ref

    from horovod_tpu_torch.tools import chaos_smoke, driver_smoke, guard_smoke

    assert chaos_smoke.chaos_plan() == ref.chaos_plan()
    assert chaos_smoke.CHAOS_SEED == ref.CHAOS_SEED
    assert guard_smoke.guard_plan() == ref.guard_plan()
    assert guard_smoke.GUARD_SEED == ref.GUARD_SEED
    assert driver_smoke.driver_kill_plan() == ref.driver_kill_plan()
    assert driver_smoke.DRIVER_STEPS == ref.DRIVER_STEPS
    assert driver_smoke.DRIVER_FINAL_HEX == ref.DRIVER_FINAL_HEX
    # The port's schedules resolve to the reference's bytes.
    from horovod_tpu.fault.plan import FaultPlan as JaxPlan
    from horovod_tpu_torch.fault.plan import FaultPlan

    for plan in (ref.chaos_plan(), ref.guard_plan(), ref.driver_kill_plan()):
        text = json.dumps(plan)
        assert FaultPlan.from_json(text).canonical_schedule() == \
            JaxPlan.from_json(text).canonical_schedule()


def test_selfdrive_scenario_is_the_reference_scenario(tmp_path):
    import test_selfdrive as ref

    from horovod_tpu_torch.tools import selfdrive_smoke as sd

    assert sd.selfdrive_fault_plan() == ref.selfdrive_fault_plan()
    assert (sd.SELFDRIVE_SEED, sd.SELFDRIVE_STEPS, sd.SELFDRIVE_DELAY_S) == \
        (ref.SELFDRIVE_SEED, ref.SELFDRIVE_STEPS, ref.SELFDRIVE_DELAY_S)
    assert sd.DECISION_ACTIONS == ref.DECISION_ACTIONS
    port = json.loads(open(sd.write_drifted_calibration(str(tmp_path / "p.json"))).read())
    jax = json.loads(open(ref.write_drifted_calibration(str(tmp_path / "j.json"))).read())
    assert port == jax


REF_CONSTANTS = {
    "trace_smoke": ("FAULT_PLAN", "STEPS", "DELAY_S", "THRESHOLD_S"),
    "sim_smoke": ("STEPS",),
    "quant_smoke": ("D", "STEPS"),
    "zero_smoke": ("D", "STEPS"),
    "reshard_smoke": ("D", "N_FULL", "N_SHRUNK", "STEPS_PRE", "STEPS_SHRUNK", "STEPS_POST"),
    "llm_smoke": ("VOCAB", "D", "HEADS", "LAYERS", "T", "STEPS"),
    "tpfuse_smoke": ("VOCAB", "D", "HEADS", "LAYERS", "T", "STEPS", "TOL"),
    "topo_smoke": ("TOPOLOGIES",),
}


@pytest.mark.parametrize("name", sorted(REF_CONSTANTS))
def test_smoke_constants_are_the_reference_smokes(name):
    ref = _ref_tool(name)
    port = importlib.import_module(f"horovod_tpu_torch.tools.{name}")
    for key in REF_CONSTANTS[name]:
        assert getattr(port, key) == getattr(ref, key), (name, key)


@pytest.mark.parametrize("topo", ["1-slice", "2-slice", "4-slice", "2-pod"])
def test_topo_smoke_dumps_equal_the_jax_topo_plan(topo):
    from horovod_tpu.common.types import ReduceOp
    from horovod_tpu.topo import synthetic_model

    from horovod_tpu_torch.tools import topo_smoke

    ref = _ref_tool("topo_plan")
    sizes = dict(topo_smoke.TOPOLOGIES)[topo]
    want = json.dumps(ref.build_dump(synthetic_model(generation="v5e", **sizes),
                                     topo_smoke.COLLECTIVES, list(ref.DEFAULT_BYTES),
                                     ReduceOp.SUM), sort_keys=True, indent=1)
    assert topo_smoke.dump_text("v5e", sizes) == want


# --- every gate passes a good input and fails a bad one -------------------------


def _proc(rc=0, stderr=""):
    return SimpleNamespace(returncode=rc, stderr=stderr)


def _fails(fn, *args):
    with pytest.raises(AssertionError):
        fn(*args)


def _chaos_case():
    from horovod_tpu_torch.tools import chaos_smoke as c

    outs = {f"localhost:{r}": f"FINAL {r} 3 8 8.0\n" for r in range(3)}
    outs["fault_schedule.json"] = c.canonical_schedule(c.chaos_plan())
    outs["fault_events.jsonl"] = "\n".join(json.dumps({"action": a})
                                           for a in ("kill", "delay", "drop"))
    err = "localhost:2 failed with exit code 43\ngeneration 2: size 3"
    return c.assert_chaos_recovery, (_proc(0, err), outs), \
        (_proc(0, err.replace("generation 2", "generation 1")), outs)


def _guard_case():
    from horovod_tpu_torch.tools import guard_smoke as g

    a = 1.5
    w = [a * 6] * 8
    w[0] = a * 5 + (a - 0.5)
    outs = ["FINAL 0 6 " + " ".join(f"{v:.4f}" for v in w), "FINAL 1 6 "
            + " ".join(f"{v:.4f}" for v in w)]
    events = [(0, 1, "payload", 2, "nan", ""), (0, 2, "payload", 2, "nonfinite-zero", ""),
              (1, 1, "output", 3, "corrupt", ""), (0, 3, "guard", 1, "digest-heal",
                                                   "outliers=[1]")]
    bad = events[:3] + [(0, 3, "guard", 1, "digest-heal", "outliers=[0]")]
    return g.assert_guard_recovery, (outs, events), (outs, bad)


def _driver_case():
    from horovod_tpu_torch.fault.plan import DRIVER_KILL_EXIT_CODE
    from horovod_tpu_torch.tools import driver_smoke as d

    outs = {f"worker.localhost:{r}.out": f"START {r} {100 + r}\nFINAL {r} 2 8 "
            f"{d.DRIVER_FINAL_HEX}\n" for r in range(2)}
    err = ("resumed at generation 1 (epoch 2)\nlocalhost:0 reattached (pid 100, epoch 2)\n"
           "localhost:1 reattached (pid 101, epoch 2)")
    events = [(-1, 1, "driver", 1, a, "") for a in ("kill_driver", "resume")] + \
        [(r, 1, "driver", 1, a, "") for r in (0, 1) for a in ("park", "reattach")]
    good = (_proc(DRIVER_KILL_EXIT_CODE), _proc(0, err), outs, events)
    return d.assert_driver_kill_recovery, good, good[:3] + (events[:-1],)


METRICS_PAGE = """# TYPE hvd_op_execute_seconds histogram
hvd_op_execute_seconds_bucket{op="ALLREDUCE",rank="0",le="+Inf"} 3
hvd_op_execute_seconds_count{op="ALLREDUCE",rank="0"} 3
hvd_op_execute_seconds_sum{op="ALLREDUCE",rank="0"} 0.1
hvd_op_execute_seconds_bucket{op="ALLREDUCE",rank="1",le="+Inf"} 2
hvd_op_execute_seconds_count{op="ALLREDUCE",rank="1"} 2
hvd_op_execute_seconds_sum{op="ALLREDUCE",rank="1"} 0.1
# TYPE hvd_op_negotiate_seconds histogram
hvd_op_negotiate_seconds_bucket{op="ALLREDUCE",rank="0",le="+Inf"} 3
hvd_op_negotiate_seconds_count{op="ALLREDUCE",rank="0"} 3
hvd_op_negotiate_seconds_sum{op="ALLREDUCE",rank="0"} 0.1
# TYPE hvd_rpc_retries_total counter
hvd_rpc_retries_total 0
# TYPE hvd_kv_server_requests_total counter
hvd_kv_server_requests_total{role="driver"} 5
# TYPE hvd_elastic_world_size gauge
hvd_elastic_world_size{role="driver"} 2
# TYPE hvd_elastic_generations_total counter
hvd_elastic_generations_total{role="driver"} 1
"""


def _metrics_case():
    from horovod_tpu_torch.tools import metrics_smoke as m

    return m.validate_exposition, (METRICS_PAGE,), \
        (METRICS_PAGE.replace('world_size{role="driver"} 2', 'world_size{role="driver"} 1'),)


def _trace_case():
    from horovod_tpu_torch.tools import trace_smoke as t

    text = "TRACE_WORKER_DONE 0\nTRACE_WORKER_DONE 1"
    return t.check_attribution, (text, 0, True, {"1": 6.0}), (text, 0, True,
                                                              {"0": 1.0, "1": 6.0})


def _quant_case():
    from horovod_tpu_torch.tools import quant_smoke as q

    good = {"collective_permutes": 12, "permute_dtypes": ["int8"],
            "float_gradient_allreduces": 0}
    return q.check_wire, (good,), (dict(good, permute_dtypes=["float32", "int8"]),)


def _zero_case():
    from horovod_tpu_torch.ops.fusion import zero1_shard_len
    from horovod_tpu_torch.tools import zero_smoke as z

    sizes = [256, 16, 256, 16, 256, 16]
    shards = {f"g{i}": {"b0": torch.zeros(zero1_shard_len(k, 2, True))}
              for i, k in enumerate(sizes)}
    state = SimpleNamespace(shards=shards)
    whole = SimpleNamespace(shards={f"g{i}": {"b0": torch.zeros(k)}
                                    for i, k in enumerate(sizes)})
    return z.check_sharded, (state, 2, sizes), (whole, 2, [k * 4 for k in sizes])


def _tune_case():
    from horovod_tpu_torch.tools import tune_smoke as t

    base = {"exposed_us": 10.0, "n_groups": 1, "cost_us": 5.0, "wire_bytes": 100}
    good = ({"objectives": dict(base, exposed_us=9.0), "baseline": base},
            {"objectives": dict(base, n_groups=3), "baseline": base})
    return t.check_modeled_win, good, (good[0], {"objectives": base, "baseline": base})


def _sim_case():
    from horovod_tpu_torch.tools import sim_smoke as s

    stats = {"world_size": 2, "ranks": {"0": {"step_count": 8, "collectives": [1, 2]},
                                        "1": {"step_count": 8, "collectives": [1]}}}
    return s.check_stats, (stats,), (dict(stats, world_size=1),)


def _replay_case():
    from horovod_tpu_torch.tools import sim_smoke as s

    good = {"divergence": {"per_hop": {"ici": {"ratio": 2.5}}, "step": {"ratio": 1.3}}}
    bad = {"divergence": {"per_hop": {"ici": {"ratio": None}}, "step": {"ratio": 1.3}}}
    return s.check_replay_bounded, (good,), (bad,)


def _selfdrive_case():
    from horovod_tpu_torch.tools import selfdrive_smoke as sd

    hexw = np.full(4, float(sd.SELFDRIVE_STEPS), np.float32).tobytes().hex()
    decisions = sorted(
        [(-1, "driver", 1, "quarantine", "host=localhost reason=slow"),
         (-1, "driver", 1, "replan", ""), (-1, "driver", 3, "promote", "worker=127.0.0.1:1"),
         (-1, "driver", 2, "replan-restamp", ""), (-1, "driver", 3, "replan-restamp", ""),
         (1, "driver", 3, "spare-adopt", "")]
        + [(r, "driver", g, "replan-adopt", "") for r in (0, 1) for g in (1, 3)])
    outs = {"worker.a.out": "START 0 1\nSTART 1 2\n",
            "worker.b.out": "START 0 3\nSTART 1 4\n"
            + "".join(f"FINAL {r} 2 {sd.SELFDRIVE_STEPS} {hexw} quantized=1\n" for r in (0, 1)),
            "_journal": {"slow_strikes": {"localhost": 1},
                         "blacklist_reasons": {"localhost": "slow"},
                         "replan": {"config": {"wire_dtype": "int8"},
                                    "modeled": {"replanned_exposed_us": 1.0,
                                                "current_exposed_us": 2.0}}}}
    bad = {**outs, "worker.b.out": outs["worker.b.out"].replace("quantized=1", "quantized=0")}
    return sd.assert_selfdrive_recovery, (_proc(), outs, decisions), (_proc(), bad, decisions)


def _llm_case():
    from horovod_tpu_torch.tools import llm_smoke as llm

    k = 'hvd_axis_wire_bytes_total{{axis="{}",collective="{}"}}'
    good = {k.format("data", "reduce_scatter"): 10.0, k.format("model", "psum"): 32.0}
    return llm.check_axis_bytes, (good,), ({**good, k.format("model", "all_gather"): 4.0},)


def _reshard_case():
    from horovod_tpu_torch.tools import reshard_smoke as rs

    flat = {'hvd_reshard_total{trigger="quarantine"}': 2.0,
            'hvd_reshard_total{trigger="spare-promotion"}': 2.0,
            'hvd_reshard_bytes_total{axis="data"}': 30.0}
    reports = [{"moved_bytes": 10}, {"moved_bytes": 20}]
    return rs.check_metered, (flat, reports, 2), (flat, reports[:1], 2)


def _parity_case():
    from horovod_tpu_torch.tools import reshard_smoke as rs

    before = [torch.arange(4.0), torch.tensor([3.0])]
    rep = {"ef_dropped_elements": 0}
    return rs.check_parity, (before, [t.clone() for t in before], rep, "edge"), \
        (before, [before[0] + 1, before[1]], rep, "edge")


def _tpfuse_case():
    from horovod_tpu_torch.tools import tpfuse_smoke as tf

    good = {"fused_fwd_model_axis_allreduces": 0, "classic_fwd_model_axis_allreduces": 4,
            "fused_fwd_collective_permutes": 8}
    return tf.check_forward, (good,), (dict(good, fused_fwd_model_axis_allreduces=2),)


def _tpfuse_params_case():
    """Gate 1 on the parameters, on the card: a gap that AdamW makes of
    rounding-close gradients passes (an eps-scale gradient, 1e-9 against
    3e-9); a parameter moved off AdamW's replay fails."""
    from horovod_tpu_torch.tools import tpfuse_smoke as tf

    rng = np.random.RandomState(0)
    gc = rng.randn(3, 20000) * 1e-2
    gc[:, 0] = 1e-9
    gf = gc.copy()
    gf[:, 0] = 3e-9
    pc, pf = -tf._adamw_path(gc), -tf._adamw_path(gf)
    good = tf.c2_readings(pc, pf, gc, gf, [5000, 15000])
    assert good["past_tol"] == 1 and good["param_gap_max"] > 1e-5
    moved = pf.copy()
    moved[3] += 1e-5
    return tf.check_params, (good, True), \
        (tf.c2_readings(pc, moved, gc, gf, [5000, 15000]), True)


def _tpfuse_cpu_params_case():
    """On the CPU the reference's 5e-7 holds element for element: the same
    AdamW-made gap fails there."""
    from horovod_tpu_torch.tools import tpfuse_smoke as tf

    gc = np.full((3, 2), 1e-2)
    gf = gc.copy()
    gf[:, 0] += 1e-9
    good = tf.c2_readings(-tf._adamw_path(gc), -tf._adamw_path(gf), gc, gf, [2])
    gc[:, 0], gf[:, 0] = 1e-9, 3e-9
    bad = tf.c2_readings(-tf._adamw_path(gc), -tf._adamw_path(gf), gc, gf, [2])
    return tf.check_params, (good, False), (bad, False)


def _tuner_case():
    from horovod_tpu_torch.tools import tpfuse_smoke as tf

    return tf.check_tuner, (2, 30.0, 100.0, 4), (0, 30.0, 100.0, 4)


GATES = {"chaos": _chaos_case, "guard": _guard_case, "driver": _driver_case,
         "metrics": _metrics_case, "trace": _trace_case, "quant": _quant_case,
         "zero": _zero_case, "tune": _tune_case, "sim_stats": _sim_case,
         "sim_replay": _replay_case, "selfdrive": _selfdrive_case, "llm": _llm_case,
         "reshard_metered": _reshard_case, "reshard_parity": _parity_case,
         "tpfuse_forward": _tpfuse_case, "tpfuse_params": _tpfuse_params_case,
         "tpfuse_params_cpu": _tpfuse_cpu_params_case,
         "tpfuse_tuner": _tuner_case}


@pytest.mark.parametrize("name", sorted(GATES))
def test_smoke_gate_passes_good_and_fails_bad(name):
    gate, good, bad = GATES[name]()
    gate(*good)
    _fails(gate, *bad)


# --- the cheap smokes whole, and the gate script ---------------------------------


WHOLE = ("quant", "zero", "guard")     # topo runs whole as the gate script's stage


@pytest.fixture(scope="module")
def whole_runs():
    """The cheap smokes whole on gloo ranks, and ``ci_checks.sh`` with only
    its ``topo`` stage, started together (each is its own job of processes;
    none gates on time), each test reading its own."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"horovod_tpu_torch.tools.{name}_smoke", "--device", "cpu"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in WHOLE}
    procs["ci"] = _ci_popen(**{k: True for k in SKIP_ALL if k != "TOPO"})
    done = {}

    def result(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=240)
            done[name] = SimpleNamespace(returncode=procs[name].returncode, stdout=out,
                                         stderr=err)
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("name", WHOLE)
def test_cheap_smoke_runs_whole_on_the_cpu(whole_runs, name):
    proc = whole_runs(name)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "OK" in proc.stdout or "PASS" in proc.stdout or "recovered" in proc.stdout


def test_smoke_needs_its_cards_and_names_the_count():
    from horovod_tpu_torch.tools.smoke_common import need_ranks

    assert need_ranks(4, "cpu", "x") is None
    if not torch.cuda.is_available():
        assert need_ranks(2, None, "x") == 2


def _ci_popen(*args, **skips):
    env = _env(**{f"HVD_CI_SKIP_{k}": "1" for k in skips})
    return subprocess.Popen(["bash", os.path.join(REPO, "horovod_tpu_torch", "tools",
                                                  "ci_checks.sh"), *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _ci(*args, **skips):
    proc = _ci_popen(*args, **skips)
    out, err = proc.communicate(timeout=240)
    return SimpleNamespace(returncode=proc.returncode, stdout=out, stderr=err)


def test_ci_checks_runs_one_stage_alone(whole_runs):
    """Only the ``topo`` stage: ``topo_smoke`` runs whole (its PASS line)
    and the gate exits 0."""
    proc = whole_runs("ci")
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "ci_checks: topo smoke plans stable" in proc.stdout
    assert "[topo-smoke] PASS" in proc.stdout + proc.stderr
    assert "ci_checks: chaos_smoke skipped" in proc.stdout


def test_ci_checks_fails_with_its_stage():
    proc = _ci("--no-such-flag", **{k: True for k in SKIP_ALL if k != "LINT"})
    assert proc.returncode == 2, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "ci_checks: topo" not in proc.stdout


# --- C9 and C10 ----------------------------------------------------------------

ZERO1_WIDTHS = (16, 15)

C9_WORKER = r'''
import json, os
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics
from horovod_tpu_torch.analysis.graph_lint import record
from horovod_tpu_torch.models.transformer import TransformerLM, make_gpt_loss_fn
from horovod_tpu_torch.ops.fusion import tree_leaves
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.train import DistributedOptimizer, make_train_step
from horovod_tpu_torch.utils.convert import local_params_from_flax, params_to_numpy

out_dir = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{out_dir}/store")
r, n = hvd.rank(), hvd.size()
res = {}
K = 'hvd_axis_wire_bytes_total{{axis="{}",collective="{}"}}'

# C9, the composed step at data 1 x model 2: its model-axis psums.
mesh = build_mesh({"data": 1, "model": 2})
model = TransformerLM(vocab_size=64, d_model=32, n_heads=2, n_layers=2, max_len=8,
                      dtype=torch.float32, device="cpu", seed=0)
params = local_params_from_flax(params_to_numpy(model), "gpt", mesh, device="cpu")
rng = np.random.RandomState(0)
batch = tuple(torch.from_numpy(rng.randint(0, 64, (2, 8))) for _ in range(2))
metrics.install(True)
step = make_train_step(make_gpt_loss_fn(2, model_axis="model", dtype=torch.float32),
                       torch.optim.SGD(tree_leaves(params), lr=0.1), mesh=mesh, rules="gpt")
with record(mesh) as rec:
    step(params, batch)
first = metrics.flat().get(K.format("model", "psum"))
step(params, batch)
psums = [s.nbytes for s in rec.sites
         if s.axes == ("model",) and s.primitive == "psum" and s.nbytes > 4]
res["tp"] = {"first": first, "second": metrics.flat().get(K.format("model", "psum")),
             "want": float(sum(2 * (n - 1) * b // n for b in psums)), "psums": len(psums),
             "model_keys": sorted(k for k in metrics.flat() if 'axis="model"' in k)}
step.close()

# C9, the DP ZeRO-1 step: its parameter all-gather and gradient
# reduce-scatter, charged once a tap, at two widths (272 elements split even,
# 255 padded to 256).
res["zero1"] = {}
for width in ZERO1_WIDTHS:
    metrics.install(True)
    lin = torch.nn.Linear(16, width)
    opt = DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                               named_parameters=lin.named_parameters(), zero1=True, tuned=False)
    z = make_train_step(lambda m, b: m(b).square().mean(), opt)
    xb = torch.ones(2, 16)
    calls = []
    for tap in (True, False, True):     # a call, a second, one under a tap installed anew
        if tap:
            metrics.install(True)
        z(lin, xb)
        calls.append({c: metrics.flat().get(K.format("data", c))
                      for c in ("all_gather", "reduce_scatter")})
    res["zero1"][str(width)] = calls
    z.close()
metrics.install(False)

# C10: a DistributedOptimizer over a group of rank 0 alone; rank 1 never steps.
sub = dist.new_group([0])
if r == 0:
    lin2 = torch.nn.Linear(4, 4)
    opt2 = DistributedOptimizer(torch.optim.SGD(lin2.parameters(), lr=0.1),
                                named_parameters=lin2.named_parameters(), group=sub, tuned=False)
    s2 = make_train_step(lambda m, b: m(b).square().mean(), opt2)
    res["sub_loss"] = float(s2(lin2, torch.ones(3, 4)))
    s2.close()
dist.barrier()
if r == 0:
    with open(os.path.join(out_dir, "c9.json"), "w") as f:
        json.dump(res, f)
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def c9_run(tmp_path_factory):
    from torch_port_harness import run_ranks

    d = tmp_path_factory.mktemp("c9")
    run_ranks(f"ZERO1_WIDTHS = {ZERO1_WIDTHS!r}\n" + C9_WORKER, 2, d, timeout=120)
    with open(d / "c9.json") as f:
        return json.load(f)


def test_c9_composed_step_charges_its_model_axis_psums_once(c9_run):
    """Held to the port's own psum sites, not to the JAX package: the JAX
    composed step fails under JAX 0.9's ``check_vma`` (ROADMAP "Red tests").
    The figure is the ring factor over the payloads the recorder saw."""
    tp = c9_run["tp"]
    assert tp["psums"] == 8 and tp["first"] == tp["want"] > 0
    assert tp["second"] == tp["first"]
    assert tp["model_keys"] == ['hvd_axis_wire_bytes_total{axis="model",collective="psum"}']


def _jax_zero1_wire_bytes(width):
    """The JAX package's DP ZeRO-1 step on the same Linear(16, width) at 2
    CPU devices: what its metrics tap charges in the step's one trace."""
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu.jax as hvdj
    import horovod_tpu.metrics as jmetrics
    from horovod_tpu.parallel.mesh import build_mesh as jax_build_mesh

    mesh = jax_build_mesh({"data": 2}, devices=jax.devices()[:2])
    params = {"kernel": jnp.zeros((16, width)), "bias": jnp.zeros((width,))}
    tx = optax.sgd(0.1)
    jmetrics.install(True)
    try:
        step = hvdj.make_train_step(
            lambda p, b: jnp.mean(jnp.square(b @ p["kernel"] + p["bias"])), tx, mesh,
            donate=False, zero1=True)
        step(params, hvdj.init_zero1_stream_state(tx, params, 2), jnp.ones((4, 16)))
        flat = jmetrics.flat()
        return {c: flat.get(f'hvd_axis_wire_bytes_total{{axis="data",collective="{c}"}}')
                for c in ("all_gather", "reduce_scatter")}
    finally:
        jmetrics.install(False)


@pytest.mark.parametrize("width", ZERO1_WIDTHS)
def test_c9_zero1_step_charges_its_parameter_all_gather_once(c9_run, width):
    first, second, late = c9_run["zero1"][str(width)]
    want = _jax_zero1_wire_bytes(width)
    assert want["all_gather"] > 0 and want["reduce_scatter"] > 0
    assert first == want
    assert second == first      # once per step, as once per compile
    assert late == first        # a tap installed anew is charged anew


def test_c10_loss_averages_over_the_optimizers_group(c9_run):
    assert np.isfinite(c9_run["sub_loss"])
