"""The port's fault plans (horovod_tpu_torch/fault) against the JAX package's
(horovod_tpu/fault):

- tests/test_chaos.py's unit cases of plans, injector, backoff, decision
  streams, preemption and payload faults, run against the port's modules;
  its KV and RPC cases with the JAX module names mapped to the port's
  modules for the call;
- a table of plans (every kind, ``frac``, ``every``/``until``, ``tensor``
  patterns, selectors): the same ``canonical_schedule()`` bytes;
- one fixed eager op sequence at size 1 under one plan, through the JAX
  eager runtime and the port's (the native core and the Python runtime),
  with the guard at ``zero``: the same event lines and, bitwise, the same
  mutated outputs;
- ``payload_fault`` on torch CPU tensors in f32, f16 and bf16 against the
  JAX package's on the same bytes: the same element, bit and bytes, the
  input untouched;
- the port's own: ``install_plan`` after import arms every site and
  ``reset()`` disarms them; the guard's events after an injected nan
  (eager and DP step); the trace pusher's event-log tail; the profiler
  hook;
- end to end: ``tools/chaos_parity.py --smoke`` (``python -m
  horovod_tpu_torch.run -np 2`` of the small GPT binding step under the
  seeded plan, twice, the kill on rank 1).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import guard as jguard
from horovod_tpu.fault import injector as jinjector
from horovod_tpu.fault.plan import FaultPlan as JFaultPlan

import horovod_tpu_torch as hvd
from horovod_tpu_torch import fault as port_fault
from horovod_tpu_torch import guard as port_guard
from horovod_tpu_torch.fault import backoff as port_backoff
from horovod_tpu_torch.fault import injector as port_injector
from horovod_tpu_torch.fault import preemption as port_preemption
from horovod_tpu_torch.fault.plan import FaultPlan

from horovod_tpu_torch.tools import chaos_parity

import test_chaos as ref_tests
from torch_port_harness import run_reference_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """Every test starts and ends with no plan, no notice and no guard."""
    for mod in (port_injector, jinjector):
        mod.reset()
    port_preemption.clear()
    yield
    for mod in (port_injector, jinjector):
        mod.reset()
    port_preemption.clear()
    port_guard.reset()
    jguard.reset()


SWAPS = {"fault": port_fault, "_injector": port_injector, "_preemption": port_preemption,
         "Backoff": port_backoff.Backoff, "retry_call": port_backoff.retry_call,
         "FaultPlan": FaultPlan}
PORTABLE = [
    "test_plan_parse_defaults_and_errors", "test_plan_window_semantics", "test_plan_selectors",
    "test_schedule_bytes_deterministic", "test_fault_point_inactive_is_noop",
    "test_injector_delay_and_events", "test_injector_drop_raises_connectionerror",
    "test_injector_duplicate_directive", "test_injector_kill_calls_exit",
    "test_injector_rank_selector", "test_event_log_file_lines_are_deterministic",
    "test_backoff_jitter_bounds", "test_backoff_seed_from_env_controls_jitter_stream",
    "test_fault_stream_contract_per_seed_action_rank", "test_backoff_progression_and_determinism",
    "test_retry_call_recovers_then_gives_up", "test_retry_call_does_not_retry_unretryable",
    "test_preemption_flag_roundtrip", "test_sigterm_handler_sets_flag_and_chains",
    "test_preempt_fault_action_sets_notice", "test_payload_plan_parse_defaults",
    "test_payload_fault_nan_poisons_float_only",
    "test_payload_fault_corrupt_flips_exactly_one_bit",
    "test_payload_fault_stream_choice_is_deterministic",
    "test_payload_fault_tensor_pattern_has_own_window",
]


@pytest.mark.parametrize("name", PORTABLE)
def test_reference_chaos_test_holds_for_the_port(name, request):
    run_reference_test(ref_tests, name, SWAPS, request)


CONTROL_PLANE = [
    "test_kv_client_survives_injected_drop_burst", "test_kv_client_gives_up_after_budget",
    "test_basic_client_send_retries_dropped_rpc", "test_basic_client_duplicate_delivery",
    "test_driver_service_wait_timeout_names_phase",
]


@pytest.mark.parametrize("name", CONTROL_PLANE)
def test_reference_control_plane_chaos_test_holds_for_the_port(name, request, monkeypatch):
    """The cases that import ``horovod_tpu.run.http_server`` and
    ``horovod_tpu.run.network`` inside the test: those names resolve to the
    port's modules for the call."""
    import horovod_tpu.run as jrun

    from horovod_tpu_torch.run import http_server, network

    for name_, mod in (("http_server", http_server), ("network", network)):
        monkeypatch.setitem(sys.modules, f"horovod_tpu.run.{name_}", mod)
        monkeypatch.setattr(jrun, name_, mod, raising=False)
    run_reference_test(ref_tests, name, SWAPS, request)


# --- the same plan text, the same schedule bytes --------------------------------

PLANS = [
    {"seed": 1234, "faults": [{"kind": "drop", "site": "kv", "frac": 0.4, "count": 9},
                              {"kind": "kill", "rank": 0, "at_step": 3}]},
    {"seed": 7, "faults": [{"kind": k} for k in ("kill", "delay", "drop", "duplicate",
                                                 "preempt", "corrupt", "nan",
                                                 "kill_replica")]},
    {"seed": 99, "faults": [{"kind": "kill_driver", "after_s": 2.5},
                            {"kind": "restart_driver", "after_s": 1.0, "epoch": 2},
                            {"kind": "preempt", "worker": "localhost:1", "after_s": 2.0}]},
    {"seed": 5, "faults": [{"kind": "delay", "rank": 1, "seconds": 0.05, "every": 3,
                            "after": 2, "until": 40, "frac": 0.25},
                           {"kind": "delay", "site": "response", "every": 1, "count": 5}]},
    {"seed": 3, "faults": [{"kind": "nan", "tensor": "grad.*", "at_step": 2, "frac": 0.7},
                           {"kind": "corrupt", "rank": 2, "tensor": "grad", "element": 9,
                            "bit": 30, "gen": 1, "worker": "h:0"}]},
    {"seed": 11, "faults": [{"kind": "drop", "site": "request", "frac": 0.5, "after": 1},
                            {"kind": "delay", "site": "request", "seconds": 0.2},
                            {"kind": "duplicate", "site": "rpc", "frac": 0.1, "count": 4},
                            {"kind": "drop", "site": "spawn", "rank": 3, "frac": 0.9}]},
]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"seed{p['seed']}")
def test_canonical_schedule_bytes_match_jax(plan):
    text = json.dumps(plan)
    got = FaultPlan.from_json(text).canonical_schedule()
    assert got.encode() == JFaultPlan.from_json(text).canonical_schedule().encode()
    p, j = FaultPlan.from_json(text), JFaultPlan.from_json(text)
    for a, b in zip(p.actions, j.actions):
        for rank in (None, 0, 3):
            assert p.decision_trace(a, rank, 32) == j.decision_trace(b, rank, 32)
    for bad in ('{"faults": [{"kind": "delay", "every": 0}]}',
                '{"faults": [{"kind": "kill", "site": "driver"}]}',
                '{"faults": [{"kind": "nan", "site": "request"}]}'):
        with pytest.raises(ValueError):
            FaultPlan.from_json(bad)
        with pytest.raises(ValueError):
            JFaultPlan.from_json(bad)


# --- one eager sequence under one plan through both runtimes --------------------

EAGER_PLAN = json.dumps({"seed": 41, "faults": [
    {"kind": "delay", "site": "enqueue", "seconds": 0.0, "after": 1, "count": 2},
    {"kind": "nan", "site": "payload", "tensor": "c.ar1"},
    {"kind": "nan", "site": "payload", "frac": 0.5, "count": 6},
    {"kind": "corrupt", "site": "output", "count": 3},
    {"kind": "corrupt", "site": "output", "tensor": "c.bc", "element": 1, "bit": 3},
    {"kind": "delay", "site": "response", "seconds": 0.0, "count": 2},
]})


def _eager_sequence(h):
    """The fixed op sequence, each op synchronous: one plan each."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    return [h.allreduce(x, name="c.ar0"),
            h.allreduce(x * 2, name="c.ar1", op=h.Sum),
            h.allgather(rng.randn(4, 3).astype(np.float32), name="c.ag"),
            h.broadcast(rng.randn(5).astype(np.float32), 0, name="c.bc"),
            h.reducescatter(rng.randn(8, 2).astype(np.float32), name="c.rs"),
            h.allreduce(np.arange(6, dtype=np.int32), name="c.ar2", op=h.Sum)]


def _lines(events):
    return [{k: e[k] for k in ("seq", "site", "hit", "action", "detail", "rank")}
            for e in events]


@pytest.mark.parametrize("core", ["native", "python"])
def test_eager_event_lines_and_outputs_match_jax(core, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_CORE", core)
    monkeypatch.delenv("HOROVOD_RANK", raising=False)
    monkeypatch.setattr(jguard, "_guard_event_hits", 0)
    monkeypatch.setattr(port_guard, "_guard_event_hits", 0)
    jhvd.shutdown()
    hvd.shutdown()
    got = {}
    for key, h, inj, grd, init in (
            ("jax", jhvd, jinjector, jguard, lambda: jhvd.init()),
            ("port", hvd, port_injector, port_guard, lambda: hvd.init(device="cpu"))):
        init()
        grd.install("zero")
        inj.install_plan(inj.FaultPlan.from_json(EAGER_PLAN))
        try:
            outs = [np.asarray(o) for o in _eager_sequence(h)]
        finally:
            h.shutdown()
        got[key] = (outs, _lines(inj.events()))
        inj.reset()
        grd.reset()
    (jouts, jev), (pouts, pev) = got["jax"], got["port"]
    assert pev == jev
    actions = [e["action"] for e in pev]
    assert "nan" in actions and "corrupt" in actions and "nonfinite-zero" in actions
    assert ("delay" in actions) and (core == "python") == any(e["site"] == "response"
                                                              for e in pev)
    for p, j in zip(pouts, jouts):
        assert p.dtype == j.dtype and p.shape == j.shape
        assert p.tobytes() == j.tobytes()


# --- payload faults on torch tensors against numpy's ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("kind,pin", [("corrupt", False), ("corrupt", True), ("nan", False),
                                      ("nan", True)])
def test_payload_fault_on_torch_tensors_matches_jax(dtype, kind, pin):
    rng = np.random.RandomState(3)
    x32 = rng.randn(7, 5).astype(np.float32)
    t = torch.from_numpy(x32).to(getattr(torch, dtype))
    before = t.clone()
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().copy()
    # JAX's numpy path takes f32/f16 as they are and bf16 by its uint16 bits
    # (numpy counts ml_dtypes' bfloat16 as no float, so a nan there goes
    # through the f32 values, for the element it draws).
    if dtype == "bfloat16":
        ref_in = bits.view(np.uint16) if kind == "corrupt" else x32
    else:
        ref_in = t.numpy().copy()
    fault = {"kind": kind, "site": "payload", "count": 3}
    if pin:
        fault.update(element=13, bit=9)
    plan = json.dumps({"seed": 17, "faults": [fault]})
    port_injector.install_plan(FaultPlan.from_json(plan))
    jinjector.install_plan(JFaultPlan.from_json(plan))
    for _ in range(3):
        out = port_injector.payload_fault("payload", "grad", t)
        ref = jinjector.payload_fault("payload", "grad", ref_in)
        assert torch.is_tensor(out) and out.dtype == t.dtype and out is not t
        assert torch.equal(t.view(torch.uint8), before.view(torch.uint8))  # untouched
        if kind == "corrupt":
            assert out.view(torch.uint8).numpy().tobytes() == np.asarray(ref).tobytes()
        else:
            idx = int(np.flatnonzero(np.isnan(ref))[0])
            expect = before.clone()
            expect.view(-1)[idx] = float("nan")
            assert out.view(torch.uint8).numpy().tobytes() == \
                expect.view(torch.uint8).numpy().tobytes()
    assert _lines(port_injector.events()) == _lines(jinjector.events())
    assert len(port_injector.events()) == 3


def test_payload_fault_keeps_integers_and_numpy():
    port_injector.install_plan(FaultPlan.from_json(
        '{"faults": [{"kind": "nan", "site": "payload"}]}'))
    ints = torch.arange(6)
    assert port_injector.payload_fault("payload", "sizes", ints) is ints
    arr = np.ones(3, np.float32)
    out = port_injector.payload_fault("payload", "g", arr)
    assert isinstance(out, np.ndarray) and np.isnan(out).sum() == 1 and np.isfinite(arr).all()
    assert port_injector.payload_fault("payload", "g", None) is None


# --- the port's own --------------------------------------------------------------

def test_install_plan_arms_every_site_and_reset_disarms():
    """The call sites read the injector's live flag (no copy taken at
    import): a plan installed after import arms them, reset disarms."""
    from horovod_tpu_torch.core import native_runtime, runtime
    from horovod_tpu_torch.run import http_server, network
    from horovod_tpu_torch.serve import engine

    sites = (runtime, native_runtime, engine, http_server, network)
    assert all(m._fault is port_injector for m in sites)
    assert not any(m._fault.ACTIVE for m in sites)
    port_injector.install_plan(FaultPlan.from_json('{"faults": [{"kind": "delay"}]}'))
    assert all(m._fault.ACTIVE for m in sites)
    assert port_fault.injector.ACTIVE and port_fault.active_plan() is not None
    port_injector.reset()
    assert not any(m._fault.ACTIVE for m in sites)


def test_guard_event_follows_an_injected_nan_eager(monkeypatch):
    monkeypatch.delenv("HOROVOD_RANK", raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        port_guard.install("zero")
        port_injector.install_plan(FaultPlan.from_json(
            '{"faults": [{"kind": "nan", "tensor": "g", "element": 2}]}'))
        out = hvd.allreduce(np.ones(4, np.float32), name="g")
    finally:
        hvd.shutdown()
    assert out.tolist() == [1.0, 1.0, 0.0, 1.0]
    assert [(e["site"], e["action"], e["detail"]) for e in port_injector.events()] == [
        ("payload", "nan", "g[2]"), ("guard", "nonfinite-zero", "g n=1")]


def test_guard_event_follows_an_injected_nan_dp_step(tmp_path, monkeypatch):
    """The DP step's skip agreement writes its guard line; with no plan
    but an event-log file the line goes to the file."""
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("HOROVOD_FAULT_EVENT_LOG", str(log))
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                       named_parameters=model.named_parameters(),
                                       nonfinite="skip")
        step = hvd.make_train_step(lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), opt)
        x, y = torch.ones(3, 4), torch.zeros(3, 2)
        port_injector.install_plan(FaultPlan.from_json(
            '{"faults": [{"kind": "nan", "tensor": "batch", "at_step": 2, "element": 0}]}'))
        before = [p.detach().clone() for p in model.parameters()]
        step(model, (port_injector.payload_fault("payload", "batch", x), y))
        moved = [p.detach().clone() for p in model.parameters()]
        step(model, (port_injector.payload_fault("payload", "batch", x), y))
        after = [p.detach().clone() for p in model.parameters()]
    finally:
        hvd.shutdown()
    assert any(not torch.equal(a, b) for a, b in zip(before, moved))
    assert all(torch.equal(a, b) for a, b in zip(moved, after))      # skipped
    lines = [(e["site"], e["action"], e["detail"]) for e in port_injector.events()]
    assert lines == [("payload", "nan", "batch[0]"), ("guard", "nonfinite-skip", "reduce")]
    assert [json.loads(l)["action"] for l in log.read_text().splitlines()] == \
        ["nan", "nonfinite-skip"]


def test_trace_pusher_ships_the_event_log_tail():
    from horovod_tpu_torch import trace as port_trace
    from horovod_tpu_torch.run.http_server import KVStoreServer
    from horovod_tpu_torch.trace import pusher

    port_injector.install_plan(FaultPlan.from_json(
        '{"faults": [{"kind": "delay", "site": "enqueue"}]}'))
    for i in range(pusher.EVENT_LOG_TAIL + 5):
        port_injector.fault_point("enqueue", f"t{i}")
    srv = KVStoreServer(port=0)
    srv.start()
    port_trace.install(True)
    port_trace.TAP.event("shipped", cat="op")
    try:
        p = pusher.TracePusher("127.0.0.1", srv.port, rank=0, interval=60)
        p.push_once()
        doc = pusher.decode_window(srv.snapshot(port_trace.KV_SCOPE)["rank.0"])
        p.stop()
    finally:
        srv.stop()
        port_trace.reset()
    tail = port_injector.events()[-pusher.EVENT_LOG_TAIL:]
    assert doc["event_log"] == tail and len(tail) == pusher.EVENT_LOG_TAIL
    assert doc["event_log"][-1]["detail"] == f"t{pusher.EVENT_LOG_TAIL + 4}"


def test_profiler_hook_writes_a_trace_with_plan_ranges(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_PROFILER_DIR", str(tmp_path / "prof"))
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        for i in range(6):
            hvd.allreduce(np.ones(4, np.float32), name=f"p{i}")
    finally:
        hvd.shutdown()
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == "rank.0.pt.trace.json"
    names = {e.get("name", "") for e in json.loads((tmp_path / "prof" / trace).read_text())
             ["traceEvents"]}
    # Every plan's range, though the plans run on the executor's thread.
    assert len([n for n in names if n.startswith("hvd_plan_")]) == 6


def test_profiler_hook_start_failure_is_a_warning(tmp_path, monkeypatch, caplog):
    import torch.profiler

    def refuse(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setenv("HOROVOD_PROFILER_DIR", str(tmp_path / "prof"))
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    hvd.shutdown()
    with caplog.at_level("WARNING", logger="horovod_tpu_torch"):
        hvd.init(device="cpu")
    try:
        assert hvd.allreduce(np.ones(2, np.float32), op=hvd.Sum).tolist() == [1.0, 1.0]
    finally:
        hvd.shutdown()
    assert "could not start the torch.profiler session" in caplog.text


# --- end to end --------------------------------------------------------------------

def test_chaos_parity_smoke_two_runs_one_log(tmp_path):
    """``python -m horovod_tpu_torch.run -np 2`` of the small GPT binding
    step under the seeded plan, twice: rc 43, rank 0 terminated, every
    fault in the log, equal logs per rank, the NIC probe over 2 tasks."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.tools.chaos_parity",
                           "--smoke", "--no-profile", "--out", str(tmp_path)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["probe"]["interfaces"]
    lines = out["event_lines_by_rank"]
    assert [e["action"] for e in lines["1"]] == ["nan", "nonfinite-zero", "kill"]
    assert [e["action"] for e in lines["0"]] == ["delay"] * chaos_parity.DELAY_HITS + ["corrupt"]
    for run in out["chaos_runs"]:
        assert run["corrupt_param_diff"] == {"tensors": ["block_1.ln_2.bias"], "elements": [5]}
        assert run["delay_growth_ms"] > 0.5 * run["delay_sum_ms"]
    assert out["canonical_schedule"] == JFaultPlan.from_json(
        json.dumps(out["plan"])).canonical_schedule()
