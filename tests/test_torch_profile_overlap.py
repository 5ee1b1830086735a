"""The port's measuring tools against the reference's (``tools/``):

- ``horovod_tpu_torch/tools/profile_overlap.py --structural``: the
  def-use figures of the reference's two programs (the three-layer MLP and
  the small transformer) in its four modes equal the live JAX tool's
  (``tools/tpu_profile_overlap.py``'s ``_structural_stats`` over
  ``_structural_mlp`` / ``_structural_transformer``, loaded by ``importlib``;
  ``structural_mode`` is never called, it writes into the repo root):
  the all-reduce, reduce-scatter and collective counts and their
  independent groups, ``bytes_on_wire`` by dtype and by op, ``wire_model``,
  and ``topo_plans``' bucket count and bytes a hop (and ZeRO-1's plans).
  ``pairs_with_overlap`` is left out: the JAX tool reads it from the CPU
  compiler's schedule, which JAX 0.9 no longer interleaves (0 there), and
  the port counts its own from the order the step runs in;
- the port's ``--assert-overlap`` gates pass on its builds, and each gate
  fails on an input that breaks it (no gate is vacuous);
- the ``--ranks`` reading of a profile (``overlap_pairs``) on a made-up one,
  and the card's structural reading (``backward_overlap``): a streamed
  build passes, a posthoc one, whose groups all follow the backward,
  reads 0 although the optimizer's launches follow every group;
  the ring projection's formula;
- phase A at smoke size on the CPU and the ``--ranks 2`` gloo rehearsal, each
  its JSON line;
- ``eager_latency_breakdown`` on 2 gloo ranks under the port's launcher:
  six finite, positive medians;
- every new tool imports with ``jax``, ``flax`` and ``optax`` (and the JAX
  package) left out of ``sys.modules``.
"""

import copy
import importlib.util
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = (("default", False, False, False), ("overlap", True, False, False),
         ("quantized", True, True, False), ("zero1", True, False, True))
PROGRAMS = ("mlp3", "transformer")
DEF_USE_KEYS = ("all_reduce_count", "scalar_all_reduce_count", "independent_all_reduce_groups",
                "reduce_scatter_count", "independent_reduce_scatter_groups", "collective_count",
                "independent_collective_groups", "bytes_on_wire", "wire_model")
TOOLS = ("eager_latency_breakdown", "profile_overlap", "smoke_common", "chaos_smoke",
         "metrics_smoke", "guard_smoke", "driver_smoke", "topo_smoke", "quant_smoke",
         "trace_smoke", "tune_smoke", "zero_smoke", "sim_smoke", "selfdrive_smoke", "llm_smoke",
         "reshard_smoke", "tpfuse_smoke")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_", "TORCHELASTIC_"))}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _import_check():
    return ("import sys\n"
            + "".join(f"import horovod_tpu_torch.tools.{t}\n" for t in TOOLS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'flax', 'optax', 'horovod_tpu'))\n"
              "assert not bad, bad\n")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The tools' CPU runs, each a process (or a launcher's job) of its own,
    started together with the structural fixture's; each test reads its
    own. None gates on time."""
    trace_dir = tmp_path_factory.mktemp("phase_a")
    cmds = {
        "phase_a": ["-m", "horovod_tpu_torch.tools.profile_overlap", "--model", "transformer",
                    "--smoke", "--batch-size", "2", "--reps", "2", "--scan", "--device", "cpu",
                    "--trace-dir", str(trace_dir)],
        "ranks": ["-m", "horovod_tpu_torch.tools.profile_overlap", "--ranks", "2", "--model",
                  "transformer", "--smoke", "--batch-size", "1", "--reps", "1",
                  "--device", "cpu"],
        "breakdown": ["-m", "horovod_tpu_torch.run", "-np", "2", sys.executable, "-m",
                      "horovod_tpu_torch.tools.eager_latency_breakdown", "--device", "cpu",
                      "--reps", "20"],
        "imports": ["-c", _import_check()],
    }
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=REPO, env=_env(),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
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


def _tool(jobs, name):
    proc = jobs(name)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "tpu_profile_overlap_ref", os.path.join(REPO, "tools", "tpu_profile_overlap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def structural(tmp_path_factory, jobs):
    """(the port's --structural --assert-overlap JSON, the JAX tool's
    figures): the port runs in a process of its own while the JAX tool's
    eight builds run here."""
    out = tmp_path_factory.mktemp("structural") / "port.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.tools.profile_overlap", "--structural",
         "--assert-overlap", "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = _jax_tool()
        jax_figs = {}
        for mode, overlap, quantized, zero1 in MODES:
            jax_figs[mode] = {
                "mlp3": ref._structural_stats(ref._structural_mlp(overlap, quantized, zero1),
                                              zero1=zero1),
                "transformer": ref._structural_stats(
                    ref._structural_transformer(overlap, quantized, zero1), zero1=zero1)}
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, (stdout[-2000:], stderr[-3000:])
    with open(out) as f:
        return json.load(f), jax_figs


@pytest.mark.parametrize("mode", [m[0] for m in MODES])
@pytest.mark.parametrize("prog", PROGRAMS)
def test_structural_def_use_figures_equal_the_jax_tool(structural, mode, prog):
    port, jax_figs = structural
    got, want = port["results"][mode][prog], jax_figs[mode][prog]
    for key in DEF_USE_KEYS:
        assert got[key] == want[key], (mode, prog, key)
    for key in ("bucket_count", "bytes_per_hop_total", "flat_dcn_bytes_total", "per_bucket",
                "model"):
        assert got["topo_plans"][key] == want["topo_plans"][key], (mode, prog, key)
    if mode == "zero1":
        for key in ("bucket_count", "bucket_bytes", "plans_verified", "findings"):
            assert got["zero1_plans"][key] == want["zero1_plans"][key], (prog, key)


def test_structural_assert_overlap_passes_and_counts_interleaving(structural):
    port, _ = structural
    assert port["ok"] is True and port["world"] == 8
    from horovod_tpu_torch.tools.profile_overlap import structural_gates

    assert structural_gates(port["results"]) == []
    for prog in PROGRAMS:
        ov = port["results"]["overlap"][prog]
        assert ov["pairs_with_overlap"] == ov["gradient_groups"] - 1 >= 2
        assert port["results"]["default"][prog]["pairs_with_overlap"] == 0


def _break(results, path, value):
    out = copy.deepcopy(results)
    node = out
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return out


BREAKS = {
    "groups": (("overlap", "mlp3", "independent_all_reduce_groups"), 1),
    "pairs": (("overlap", "transformer", "pairs_with_overlap"), 0),
    "quantized_groups": (("quantized", "mlp3", "independent_collective_groups"), 2),
    "quantized_f32": (("quantized", "mlp3", "bytes_on_wire", "by_dtype"), {"s8": 1, "f32": 4}),
    "quantized_no_s8": (("quantized", "transformer", "bytes_on_wire", "by_dtype"), {}),
    "zero1_rs": (("zero1", "mlp3", "independent_reduce_scatter_groups"), 2),
    "zero1_wire": (("zero1", "mlp3", "wire_model", "grad_reduction_bytes"), 10 ** 12),
    "zero1_findings": (("zero1", "transformer", "zero1_plans", "findings"), ["x"]),
    "zero1_plans": (("zero1", "transformer", "zero1_plans", "plans_verified"), 4),
}


@pytest.mark.parametrize("name", sorted(BREAKS))
def test_each_structural_gate_fails_on_its_break(structural, name):
    from horovod_tpu_torch.tools.profile_overlap import structural_gates

    port, _ = structural
    path, value = BREAKS[name]
    assert structural_gates(_break(port["results"], path, value))


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, cuda=True):
        import torch

        self.name, self.time_range = name, _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = False


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_overlap_pairs_reads_nccl_kernels_against_compute():
    from horovod_tpu_torch.tools.profile_overlap import overlap_pairs

    prof = _Prof([_Event("gemm", 0, 10), _Event("ncclDevKernel_AllReduce", 5, 20),
                  _Event("elementwise", 12, 14), _Event("ncclDevKernel_AllReduce", 30, 40),
                  _Event("adam", 41, 50), _Event("cpu op", 0, 100, cuda=False)])
    out = overlap_pairs(prof, on_card=True)
    assert out["collective_intervals_us"] == [[5, 20], [30, 40]]
    assert out["compute_ops_overlapped_per_pair"] == [2, 0]
    assert out["pairs_with_overlap"] == 1


BWD = "autograd::engine::evaluate_function: AddmmBackward0"


def _one_rank(streamed: bool):
    """A made-up one-rank trace: backward ranges over [0, 50], three
    gradient groups' ``nccl:all_reduce`` host ranges (inside the backward
    when streamed, after it when posthoc), kernel launches through both, then
    the optimizer's launches after every group."""
    ev = [(False, BWD, 0, 20), (False, BWD, 20, 50)]
    ev += [(False, "cudaLaunchKernel", t, t + 1) for t in range(2, 50, 4)]
    groups = (10, 30, 49) if streamed else (55, 56, 57)
    ev += [(False, "nccl:all_reduce", t, t + 1) for t in groups]
    ev += [(False, "Optimizer.step#SGD.step", 60, 80)]
    ev += [(False, "cudaLaunchKernel", t, t + 1) for t in range(61, 80, 2)]
    return ev


@pytest.mark.parametrize("streamed,want", [(True, 2), (False, 0)])
def test_backward_overlap_counts_only_the_backwards_launches(streamed, want):
    """The card's structural trace reading: the optimizer's launches after
    every group do not count, so a posthoc build reads 0 and fails the gate
    while a streamed one passes (the last group, issued after the backward's
    last launch, is not overlapped)."""
    from horovod_tpu_torch.tools.profile_overlap import backward_overlap

    out = backward_overlap(_one_rank(streamed))
    assert out["trace_groups"] == 3 and out["trace_groups_overlapped"] == want


def test_backward_overlap_across_cards_and_without_a_backward():
    from horovod_tpu_torch.tools.profile_overlap import backward_overlap

    ev = [(False, BWD, 0, 40), (True, "gemm", 0, 10), (True, "ncclDevKernel_AllReduce", 5, 20),
          (True, "ncclDevKernel_AllReduce", 45, 60), (True, "adam", 50, 55)]
    out = backward_overlap(ev)
    assert (out["trace_groups"], out["trace_groups_overlapped"]) == (2, 1)
    none = backward_overlap([e for e in ev if e[1] != BWD])
    assert none["trace_groups_overlapped"] == 0 and "no autograd" in none["trace_source"]


def test_ring_projection_is_the_reference_formula_over_nvlink():
    from horovod_tpu_torch.tools.profile_overlap import ring_projection

    out = ring_projection(1000, 4, bwd_s=1e-9, step_s=1.0)
    bw = out["nvlink_bytes_per_s_cited"]
    assert bw == 386.7e9 and "topo/model.py" in out["nvlink_source"]
    t16 = 2 * 15 / 16 * 4000 / bw
    assert out["ring_allreduce_s_at_16_chips"]["fp32"] == pytest.approx(t16)
    assert out["ring_allreduce_s_at_16_chips"]["int8"] == pytest.approx(t16 / 4)
    assert out["exposed_comm_fraction_if_overlapped"]["fp32"] == pytest.approx(t16 - 1e-9)


def test_phase_a_on_the_cpu(jobs):
    line = _tool(jobs, "phase_a").strip().splitlines()[-1]
    out = json.loads(line)["phase_a"]
    rows = out["timings"]
    for prog in ("fwd", "grad", "step", "step_graph"):
        assert rows[prog]["median_s"] > 0 and rows[prog]["mean_s"] > 0
    assert rows["backward_window_s"] == rows["grad"]["median_s"] - rows["fwd"]["median_s"]
    assert rows["step"]["nccl_ms"] == 0 and rows["step_graph"]["form"].startswith("eager loop")
    assert os.path.exists(out["trace"])
    assert set(out["exposed_comm_fraction_if_overlapped"]) == {"fp32", "bf16", "int8"}


def test_ranks_rehearsal_on_two_gloo_ranks(jobs):
    line = _tool(jobs, "ranks").strip().splitlines()[-1]
    out = json.loads(line)
    assert out["mode"] == "ranks" and out["ranks"] == 2
    for variant in ("posthoc", "overlap"):
        row = out[variant]
        assert len(row["step_ms"]) == 2 and all(ms > 0 for ms in row["step_ms"])
        assert all(len(i) >= 2 for i in row["collective_intervals_us"])
    assert all(n >= 2 for n in out["overlap"]["launched_in_backward"])


def test_eager_latency_breakdown_two_gloo_ranks_under_the_launcher(jobs):
    proc = jobs("breakdown")
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    lines = [l for l in proc.stdout.splitlines() if l.startswith("BREAKDOWN ")]
    assert len(lines) == 1, proc.stdout[-2000:]
    out = json.loads(lines[0].split(" ", 1)[1])
    assert out["ranks"] == 2 and out["bytes"] == 1024
    for key in ("enq_to_plan", "plan_to_exec", "exec", "done_to_ret", "ready_wait", "total"):
        assert math.isfinite(out[key]) and out[key] > 0, (key, out)


def test_tools_import_without_jax(jobs):
    proc = jobs("imports")
    assert proc.returncode == 0, proc.stderr[-3000:]
