"""Measure the pieces of the scaling model on the card: the step's phases,
its busy share, its exposed NCCL time, and whether the collectives overlap
the backward.

    python -m horovod_tpu_torch.tools.profile_overlap                     # ResNet-50 32 x 224^2
    python -m horovod_tpu_torch.tools.profile_overlap --model transformer --batch-size 8 --scan
    python -m horovod_tpu_torch.tools.profile_overlap --ranks 4           # posthoc vs overlap
    python -m horovod_tpu_torch.tools.profile_overlap --structural --assert-overlap
    python -m horovod_tpu_torch.tools.profile_overlap ... --device cpu    # the CPU rehearsal

The counterpart of ``tools/tpu_profile_overlap.py``. Every mode runs on the
card unless ``--device cpu`` asks for the CPU; it prints one JSON line and
writes it to ``--out`` when given.

Phase A (the default): the port bench's DP step (``bench.build_dp_step``;
ResNet-50 at 32 x 224^2, or ``--model transformer``, GPT-2-small at
8 x 1024) and three programs on one rank, each timed over ``--reps`` calls
with the card synchronized after each (median and mean, seconds): ``fwd``,
the loss under ``torch.no_grad``; ``grad``, the loss and its backward;
``step``, the whole DP step (gradients, the fused allreduce, the optimizer,
the loss average). ``backward_window_s`` is ``grad - fwd``. One
``torch.profiler`` session over three steps gives the device's busy ms a
step, those steps' wall ms a step (``profiled_step_ms``) and the busy share
of it, and the NCCL and exposed NCCL ms
(``tools/dp_parity._exposed_ms``); its chrome trace goes to ``--trace-dir``
(``profiles_torch/overlap_trace/``). With ``--scan`` the step is also
captured as a CUDA graph (``utils/step_graph.capture_step``) and its
replays timed and profiled the same way (``step_graph``). The ring
projection at 16 ranks and ``exposed_comm_fraction_if_overlapped`` keep the
reference's formulas, with the ``h100`` row's NVLink figure
(``topo/model.py``) in place of the v5e ICI constants.

``--ranks N`` (the reference's phase B asks XLA's schedule offline; nothing
offline can answer for the card, so this measures): N ranks, one card each
(gloo ranks with ``--device cpu``), run the posthoc and the ``overlap=True``
DP steps in turn and profile one step a rank. For each NCCL kernel (a
gradient group's reduction, the loss average last) it reports the kernel's
interval and the number of compute kernels that overlap it
(``compute_ops_overlapped_per_pair``), ``pairs_with_overlap`` (kernels
overlapped by at least one) and the NCCL and exposed NCCL ms, per rank. On
the CPU the host's ``gloo`` ranges stand for the kernels and the ``aten::``
ops for the compute: a rehearsal that finds faults, not a measurement.

``--structural [--assert-overlap]`` (the reference's ``overlap-smoke``):
the reference's two programs, its three-layer MLP (D 512) and its small f32
transformer (vocab 512, d 128, 4 heads, 3 layers, T 64, dense attention),
in its four modes: default (posthoc, 64 MiB buckets), overlap (1 MiB /
64 KiB first bucket, and 256 KiB / 16 KiB for the transformer), quantized
(overlap with the int8 wire) and zero1 (overlap with streamed ZeRO-1), on a
world of 8 ranks as the reference's 8 virtual devices. The world is played
by one process through torch's ``fake`` process-group backend: every
collective is issued and recorded, and no data moves, as the JAX tool
lowers its programs without running them. The second step of each build
(the first agrees the streamed launch order) runs under the graph lint's
recorder (``analysis/graph_lint``, the ``RECORD`` tap of
``ops/collectives.py``), interleaved with the autograd nodes the backward
runs between the collectives. The census keeps the reference's keys:

 - ``all_reduce_count``, ``reduce_scatter_count``, ``collective_count`` and
   the ``independent_*_groups``: the collectives a step issues, as the
   reference counts them in the pre-optimization HLO. A gradient
   reduction depends on no other collective; the int8 ring's
   reduce-scatter and all-gather phases count as the reference's two
   ``fori_loop``s, each a loop node plus the one collective-permute of its
   body (the body's own computation: independent), the all-gather phase
   dependent on the reduce-scatter; ZeRO-1's parameter all-gathers depend
   on the shard update;
 - ``bytes_on_wire`` by dtype and by op (result bytes; a ring phase counted
   once per instruction, not per hop, as the reference's census),
   ``wire_model`` at 8 ranks, ``topo_plans`` (every gradient all-reduce
   priced on the reference's synthetic two-slice v5e model) and, under
   zero1, ``zero1_plans``;
 - ``pairs_with_overlap`` and ``interleaved_compute_ops``: adjacent
   gradient groups, in launch order, with at least one autograd node run
   between their launches, and the nodes so run. This is the port's own
   count, read from the order the step really runs in: a group launched
   while the backward still has compute to run. It is not the JAX tool's,
   which reads the CPU compiler's schedule (0 under JAX 0.9);
 - ``compiled_all_reduce_count``: every all-reduce the recorded step
   issued, the scalar loss average included; ``overlappable_compute_per_
   all_reduce``: the autograd nodes run after each gradient all-reduce's
   launch.

The reference's options keep their meaning (``--model``, ``--batch-size``,
``--image-size``, ``--seq-len``, ``--reps``, ``--overlap``, ``--structural``,
``--assert-overlap``), but these: ``--platform`` is ``--device``;
``--devices`` is ``--ranks``; ``--topology``, ``--fusion-mb``,
``--latency-hiding``, ``--preset``, ``--compiler-opt``, ``--dump-hlo``,
``--skip-phase-b`` and ``--phase-b-only`` compile for a TPU topology and
have no meaning on the card. Its ``ici_bytes_per_s_cited`` and
``ici_source`` are ``nvlink_bytes_per_s_cited`` and ``nvlink_source``. It
writes ``PROFILE_OVERLAP*.json`` at the repository root; this tool writes
only where ``--out`` says.

``--assert-overlap`` exits 5 unless the reference's gates hold: the overlap
build of both programs has at least 3 independent all-reduce groups, more
than the default build, and ``pairs_with_overlap > 0``; the quantized build
at least 3 independent collective groups and only s8 on the wire; the zero1
build at least 3 independent reduce-scatter groups, a gradient-reduction
wire strictly below the streamed allreduce's, a total at parity or below,
and its per-bucket plans verified (at least 6, no finding). On the card the
mode also runs the overlap build of both programs on the real world of one
card and reads a profiled step (:func:`backward_overlap`): a streamed
group's NCCL work (its kernels across cards; at one rank, where NCCL
launches none, the ``nccl:`` host range) must be issued while backward
compute kernels are still to run (``trace_groups_overlapped > 0``), counting
only work launched before the autograd engine's last range ends, so the
optimizer's kernels never count. The posthoc build is read the same way and
must show its groups and none overlapped (``trace_posthoc``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.analysis.graph_lint import Recorder

TRACE_DIR = os.path.join("profiles_torch", "overlap_trace")
WORLD = 8                     # the reference's virtual devices
MODES = (("default", False, False, False), ("overlap", True, False, False),
         ("quantized", True, True, False), ("zero1", True, False, True))
PROGRAMS = ("mlp3", "transformer")
_HLO_OP = {"psum": "all-reduce", "reduce_scatter": "reduce-scatter",
           "all_gather": "all-gather", "all_to_all": "all-to-all",
           "ppermute": "collective-permute"}
_HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float16": "f16", "float64": "f64",
              "int8": "s8", "uint8": "u8", "int32": "s32", "int64": "s64", "bool": "pred"}


def _card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def nvlink_bytes_per_s() -> tuple:
    """The ``h100`` row's NVLink bandwidth (bytes/s a rank) and its source."""
    from horovod_tpu_torch.topo.model import GENERATION_DEFAULTS, ICI

    gbps, _ = GENERATION_DEFAULTS["h100"][ICI]
    return gbps * 1e9, ("horovod_tpu_torch/topo/model.py h100 ici row: "
                        f"{gbps} GB/s of ring wire bytes a rank, fitted by tools/topo_parity "
                        "--ranks 4 on four H100 80GB HBM3 over NVLink (NCCL all_reduce)")


def ring_projection(n_params: int, bytes_per_param: int, bwd_s: float, step_s: float) -> dict:
    """The reference's ring projection at 16 ranks over the NVLink figure."""
    payload = bytes_per_param * n_params
    bw, source = nvlink_bytes_per_s()
    t16 = 2 * (16 - 1) / 16 * payload / bw
    wires = (("fp32", t16 * 4 / bytes_per_param), ("bf16", t16 * 2 / bytes_per_param),
             ("int8", t16 / bytes_per_param))
    return {
        "gradient_payload_bytes": payload,
        "nvlink_bytes_per_s_cited": bw,
        "nvlink_source": source,
        "ring_allreduce_s_at_16_chips": dict(wires),
        "exposed_comm_fraction_if_overlapped": {
            w: max(0.0, t - bwd_s) / step_s for w, t in wires},
    }


# --- phase A ------------------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_fn(fn, dev, reps: int) -> dict:
    fn()
    fn()
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return {"median_s": sorted(ts)[len(ts) // 2], "mean_s": sum(ts) / len(ts)}


def profile_steps(fn, dev, steps: int = 3, trace: Optional[str] = None) -> dict:
    """NCCL, exposed NCCL and device-busy ms a step over ``steps`` profiled
    calls of ``fn`` (``tools/dp_parity._exposed_ms``), the same calls' wall
    ms a step, the device's busy share of it, and the trace. The share is
    taken over the profiled calls themselves: the profiler slows a step, so
    an unprofiled step's time would let a device-bound step read above 1."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.tools.dp_parity import _exposed_ms

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    nccl, exposed, busy = _exposed_ms(prof)
    return {"nccl_ms": nccl / steps, "exposed_nccl_ms": exposed / steps,
            "device_busy_ms": busy / steps, "profiled_step_ms": wall_ms,
            "device_busy_share": busy / steps / wall_ms}


def _bench_args(a):
    from horovod_tpu_torch import bench as B

    argv = ["--model", a.model, "--batch-size", str(a.batch_size), "--image-size",
            str(a.image_size), "--seq-len", str(a.seq_len),
            "--scan" if a.scan else "--no-scan"]
    if a.smoke:
        argv.append("--smoke")
    if a.overlap:
        argv.append("--overlap")
    return B.parse_args(argv)


def phase_a(a) -> dict:
    """The three programs, the busy share and the trace on one rank (the
    job initialized by the caller)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import bench as B
    from horovod_tpu_torch.utils.step_graph import capture_step

    dev = hvd.device()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    args = _bench_args(a)
    transformer = args.model == "transformer"
    model, batch, loss_fn = (B._build_transformer if transformer else B._build_cnn)(
        args, dev, hvd.rank(), hvd.size())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    n_params = sum(p.numel() for p in model.parameters())
    bytes_per_param = next(model.parameters()).element_size()

    def fwd():
        with torch.no_grad():
            return loss_fn(model, batch)

    def grad():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        return loss

    rows = {"fwd": _time_fn(fwd, dev, a.reps), "grad": _time_fn(grad, dev, a.reps)}
    model.zero_grad(set_to_none=True)
    step = B.build_dp_step(args, model, loss_fn, {}, False)
    rows["step"] = _time_fn(lambda: step(model, batch), dev, a.reps)
    for name in ("fwd", "grad", "step"):
        print(f"[overlap] {name}: median {rows[name]['median_s'] * 1e3:.3f} ms", flush=True)
    bwd = rows["grad"]["median_s"] - rows["fwd"]["median_s"]
    rows["backward_window_s"] = bwd
    tag = f"{args.model}_b{args.batch_size}"
    trace = os.path.join(a.trace_dir, f"{tag}_step.json")
    rows["step"].update(profile_steps(lambda: step(model, batch), dev, 3, trace))
    out = {"model": "GPT-2-small" if transformer and not args.smoke else args.model,
           "batch_per_rank": args.batch_size,
           "shape": [args.seq_len] if transformer else [args.image_size] * 2,
           "ranks": hvd.size(), "n_params": n_params, "param_dtype": str(
               next(model.parameters()).dtype).replace("torch.", ""),
           "reduction": B.reduction_mode(args), "timings": rows, "trace": trace}
    if args.scan:
        graph = capture_step(step, model, batch, length=1, warmup=2)
        graph.capture()
        g = _time_fn(graph, dev, a.reps)
        gtrace = os.path.join(a.trace_dir, f"{tag}_step_graph.json")
        g.update(profile_steps(graph, dev, 3, gtrace))
        g["form"] = graph.form
        rows["step_graph"] = g
        print(f"[overlap] step_graph: median {g['median_s'] * 1e3:.3f} ms", flush=True)
        graph.release()
    out.update(ring_projection(n_params, bytes_per_param, bwd, rows["step"]["median_s"]))
    if hasattr(step, "close"):
        step.close()
    return out


# --- --ranks N: posthoc against overlap across ranks --------------------------------


def overlap_pairs(prof, on_card: bool) -> dict:
    """Each NCCL kernel of a profiled step (in start order) with the compute
    kernels that overlap it. On the CPU the ``gloo`` host ranges and the
    ``aten::`` ops stand in for them."""
    import torch

    if on_card:
        evs = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        is_coll = lambda name: "nccl" in name.lower()  # noqa: E731
        is_compute = lambda name: "nccl" not in name.lower()  # noqa: E731
    else:
        evs = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU]
        is_coll = lambda name: name.startswith("gloo:")  # noqa: E731
        is_compute = lambda name: name.startswith("aten::")  # noqa: E731
    colls = sorted((a, b) for a, b, n in evs if is_coll(n))
    compute = [(a, b) for a, b, n in evs if is_compute(n)]
    t0 = min((a for a, _, _ in evs), default=0)
    per = [sum(1 for x, y in compute if x < b and y > a) for a, b in colls]
    return {"collective_intervals_us": [[a - t0, b - t0] for a, b in colls],
            "compute_ops_overlapped_per_pair": per,
            "pairs_with_overlap": sum(1 for c in per if c > 0)}


def _ranks_worker(a) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import bench as B
    from horovod_tpu_torch.common.basics import resolve_device
    from horovod_tpu_torch.tools.dp_parity import _exposed_ms
    from horovod_tpu_torch.tools.launch import store_url

    hvd.init(resolve_device(a.device), init_method=store_url())
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    report: Dict[str, Any] = {}
    try:
        for variant in ("posthoc", "overlap"):
            a.overlap, a.scan = variant == "overlap", False
            args = _bench_args(a)
            transformer = args.model == "transformer"
            model, batch, loss_fn = (B._build_transformer if transformer else B._build_cnn)(
                args, dev, r, n)
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            step = B.build_dp_step(args, model, loss_fn, {}, False)
            timing = _time_fn(lambda: step(model, batch), dev, a.reps)
            with profile(activities=acts) as prof:
                step(model, batch)
                _sync(dev)
            nccl, exposed, busy = _exposed_ms(prof)
            row = {"step_ms": timing["median_s"] * 1e3, "nccl_ms": nccl,
                   "exposed_nccl_ms": exposed, "device_busy_ms": busy,
                   **overlap_pairs(prof, on_card)}
            opt = getattr(step, "optimizer", None)
            if variant == "overlap" and opt is not None:
                row["launched_in_backward"] = opt._stream.last_launched_in_backward \
                    if getattr(opt, "_stream", None) is not None else None
            rows = [None] * n
            torch.distributed.all_gather_object(rows, row)
            report[variant] = rows
            if hasattr(step, "close"):
                step.close()
            del step, model
        if r == 0:
            out = {"mode": "ranks", "ranks": n, "model": a.model, "card": _card_line()
                   if on_card else "cpu", "batch_per_rank": a.batch_size}
            for variant, rows in report.items():
                out[variant] = {k: [row[k] for row in rows] for k in rows[0]}
            _emit(out, a.out)
    finally:
        hvd.shutdown()
    return 0


def ranks_mode(a, argv) -> int:
    from horovod_tpu_torch.tools.launch import launch_ranks

    if a.device != "cpu":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < a.ranks:
            print(f"[overlap] --ranks {a.ranks} needs {a.ranks} cards; {have} visible",
                  file=sys.stderr)
            return 2
    return launch_ranks("horovod_tpu_torch.tools.profile_overlap", [*argv, "--worker"], a.ranks)


# --- structural mode ------------------------------------------------------------


@contextlib.contextmanager
def fake_world(size: int = WORLD):
    """A world of ``size`` ranks played by this process through torch's
    ``fake`` process-group backend: collectives are issued and return at
    once, no data moves."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


class _Timeline(Recorder):
    """The graph lint's recorder with the autograd nodes between the
    collectives: ``events`` holds ``("coll", site index, streamed group,
    scalar)`` and ``("node", name)`` in the order they ran."""

    def __init__(self, mesh=None):
        super().__init__(mesh)
        self.events: List[tuple] = []
        self._handles: list = []

    def __call__(self, primitive, x, group, **params):
        issued = super().__call__(primitive, x, group, **params)
        self.events.append(("coll", len(self.sites) - 1, self.stream_calls, x.dim() == 0))
        return issued

    def _hook_graph(self, root) -> None:
        seen, stack = set(), [root]
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            name = fn.name()
            if "AccumulateGrad" not in name:
                self._handles.append(fn.register_prehook(
                    lambda grads, _n=name: self.events.append(("node", _n))))
            stack.extend(f for f, _ in fn.next_functions)

    @contextlib.contextmanager
    def recording(self):
        import torch

        from horovod_tpu_torch.ops import collectives

        orig = torch.Tensor.backward

        def backward(t, *args, **kwargs):
            self._hook_graph(t.grad_fn)
            return orig(t, *args, **kwargs)

        prev, collectives.RECORD = collectives.RECORD, self
        torch.Tensor.backward = backward
        try:
            yield self
        finally:
            torch.Tensor.backward = orig
            collectives.RECORD = prev
            for h in self._handles:
                h.remove()
            self._handles = []


def _hlo_dtype(dtype: str) -> str:
    return _HLO_DTYPE.get(dtype, dtype)


def census(timeline: _Timeline, zero1: bool = False) -> dict:
    """The reference's structural keys from one recorded step (the module's
    docstring says how each is counted)."""
    sites = timeline.sites
    coll_events = [e for e in timeline.events if e[0] == "coll"]
    out: Dict[str, Any] = {
        "all_reduce_count": 0, "scalar_all_reduce_count": 0,
        "independent_all_reduce_groups": 0, "reduce_scatter_count": 0,
        "independent_reduce_scatter_groups": 0, "collective_count": 0,
        "independent_collective_groups": 0}
    by_dtype: Dict[str, int] = {}
    by_op: Dict[str, Dict[str, int]] = {}
    ar_buckets: List[int] = []
    rs_buckets: List[int] = []

    def wire(op: str, dtype: str, nbytes: int) -> None:
        by_dtype[dtype] = by_dtype.get(dtype, 0) + nbytes
        per = by_op.setdefault(op, {})
        per[dtype] = per.get(dtype, 0) + nbytes

    phase_hops: Dict[tuple, int] = {}
    for _, idx, _, scalar in coll_events:
        s = sites[idx]
        n = max(len(s.members), 1)
        dtype = _hlo_dtype(s.dtype)
        if s.primitive == "psum":
            if scalar:
                out["scalar_all_reduce_count"] += 1
                continue
            out["all_reduce_count"] += 1
            out["independent_all_reduce_groups"] += 1
            out["collective_count"] += 1
            out["independent_collective_groups"] += 1
            wire("all-reduce", dtype, s.nbytes)
            ar_buckets.append(s.nbytes)
        elif s.primitive == "reduce_scatter":
            out["reduce_scatter_count"] += 1
            out["independent_reduce_scatter_groups"] += 1
            out["collective_count"] += 1
            out["independent_collective_groups"] += 1
            wire("reduce-scatter", dtype, s.nbytes // n)
            rs_buckets.append(s.nbytes)
        elif s.primitive == "all_gather":
            out["collective_count"] += 1              # depends on the shard update
            wire("all-gather", dtype, s.nbytes * n)
        elif s.primitive == "ppermute" and s.params.get("ring_phase"):
            # One fori_loop a phase: the loop node and its body's permute,
            # counted at the phase's first hop.
            key = (s.members, s.params["ring_phase"], s.nbytes)
            hop = phase_hops.get(key, 0)
            phase_hops[key] = (hop + 1) % max(n - 1, 1)
            if hop:
                continue
            out["collective_count"] += 2
            out["independent_collective_groups"] += (
                2 if s.params["ring_phase"] == "reduce_scatter" else 1)
            wire("collective-permute", dtype, s.nbytes)
        elif s.primitive in _HLO_OP:
            out["collective_count"] += 1
            out["independent_collective_groups"] += 1
            wire(_HLO_OP[s.primitive], dtype, s.nbytes)
    out.update(interleave(timeline))
    out["overlap_eligible_all_reduces"] = sum(
        1 for c in out["overlappable_compute_per_all_reduce"] if c > 0)
    out["bytes_on_wire"] = {"by_dtype": dict(sorted(by_dtype.items())),
                            "by_op": {k: dict(sorted(v.items())) for k, v in sorted(by_op.items())}}
    out["wire_model"] = ring_wire_model(out["bytes_on_wire"]["by_op"])
    out["topo_plans"] = topo_plan_report(ar_buckets)
    if zero1:
        out["zero1_plans"] = zero1_plan_report(rs_buckets)
    return out


def interleave(timeline: _Timeline) -> dict:
    """The port's own overlap figures from the order the step ran in."""
    events = timeline.events
    groups: List[int] = []        # event index of each gradient group's first collective
    seen_groups = set()
    ar_positions: List[int] = []
    compiled = 0
    for i, e in enumerate(events):
        if e[0] != "coll":
            continue
        site = timeline.sites[e[1]]
        if site.primitive == "psum":
            compiled += 1
        if e[3] or site.primitive in ("pbroadcast", "all_gather"):
            continue
        if site.primitive == "psum":
            ar_positions.append(i)
        key = e[2] if e[2] else ("posthoc", e[1])
        if key not in seen_groups:
            seen_groups.add(key)
            groups.append(i)
    nodes = [i for i, e in enumerate(events) if e[0] == "node"]
    pairs = inter = 0
    for a, b in zip(groups, groups[1:]):
        between = sum(1 for c in nodes if a < c < b)
        inter += between
        pairs += between > 0
    return {"compiled_all_reduce_count": compiled, "gradient_groups": len(groups),
            "pairs_with_overlap": pairs, "interleaved_compute_ops": inter,
            "overlappable_compute_per_all_reduce": [
                sum(1 for c in nodes if c > p) for p in ar_positions]}


def ring_wire_model(by_op: dict, n: int = WORLD) -> dict:
    """The reference's per-step ring accounting of the census (per rank)."""
    factors = {"all-reduce": lambda b: 2 * (n - 1) / n * b,
               "reduce-scatter": lambda b: (n - 1) * b,
               "all-gather": lambda b: (n - 1) / n * b,
               "all-to-all": lambda b: (n - 1) / n * b,
               "collective-permute": lambda b: float(b)}
    per_op, grad, param = {}, 0.0, 0.0
    for op, dtypes in by_op.items():
        modeled = factors.get(op, float)(sum(dtypes.values()))
        per_op[op] = int(modeled)
        if op == "all-gather":
            param += modeled
        else:
            grad += modeled
    return {"ranks": n, "per_op": dict(sorted(per_op.items())),
            "grad_reduction_bytes": int(grad), "param_gather_bytes": int(param),
            "total_bytes": int(grad + param)}


def _two_slice():
    from horovod_tpu_torch.topo import synthetic_model

    return synthetic_model(local=4, cross=2, generation="v5e")


def topo_plan_report(buckets: List[int]) -> dict:
    """Every gradient all-reduce bucket priced on the reference's synthetic
    two-slice model: the chosen plans' bytes per hop against the flat
    lowering's all-dcn ride."""
    from horovod_tpu_torch.common.types import ReduceOp
    from horovod_tpu_torch.topo import select_plan
    from horovod_tpu_torch.topo.compositor import _candidates_allreduce

    model = _two_slice()
    per_bucket, totals, flat_dcn = [], {}, 0
    for nb in sorted(buckets, reverse=True):
        plan = select_plan(model, "allreduce", nb, op=ReduceOp.SUM)
        per_bucket.append({"nbytes": nb, "algorithm": plan.algorithm,
                           "bytes_per_hop": plan.bytes_per_hop})
        for hop, v in plan.bytes_per_hop.items():
            totals[hop] = totals.get(hop, 0) + v
        flat_dcn += sum(s.bytes_on_wire for s in
                        _candidates_allreduce(model, nb, ReduceOp.SUM)["flat"])
    return {"model": {"hop_sizes": [h.size for h in model.hops],
                      "generation": model.generation},
            "collective": "allreduce", "bucket_count": len(buckets),
            "per_bucket": per_bucket, "bytes_per_hop_total": dict(sorted(totals.items())),
            "flat_dcn_bytes_total": flat_dcn}


def zero1_plan_report(buckets: List[int]) -> dict:
    """Every per-bucket RS and AG plan of the streamed-zero1 build,
    symbolically verified on the two-slice model."""
    from horovod_tpu_torch.analysis.plan_verify import verify_zero1_stream_plans

    buckets = sorted(buckets, reverse=True)
    findings, verified = verify_zero1_stream_plans(_two_slice(), buckets)
    return {"bucket_count": len(buckets), "bucket_bytes": buckets,
            "plans_verified": verified, "findings": [f.render() for f in findings]}


def dense_attention(q, k, v):
    """The reference's dense causal attention over ``[B, T, H, D]``."""
    import torch

    t, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q, k) / d ** 0.5
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=q.device))
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, -1e30))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)


def build_program(prog: str, overlap: bool, quantized: bool, zero1: bool, dev, world: int):
    """(step, model, batch) of one of the reference's structural programs on
    this rank: the step is ``make_train_step`` over SGD 0.01 and
    ``DistributedOptimizer`` with the reference's knobs."""
    import torch

    import horovod_tpu_torch.train as T
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.tools.smoke_common import mlp3, mse

    rng = np.random.RandomState(1)
    if prog == "mlp3":
        d = 512
        model = mlp3(d, dev, np.random.RandomState(0), 0.05)
        batch = tuple(torch.from_numpy(rng.randn(2, d).astype(np.float32)).to(dev)
                      for _ in range(2))
        loss_fn = mse
        kw = dict(fusion_threshold_bytes=1 << 20, first_bucket_bytes=1 << 16)
    else:
        t = 64
        model = TransformerLM(vocab_size=512, d_model=128, n_heads=4, n_layers=3, max_len=t,
                              dtype=torch.float32, device=dev, seed=0, attn_fn=dense_attention)
        batch = tuple(torch.from_numpy(rng.randint(0, 512, (2, t))).to(dev) for _ in range(2))
        loss_fn = lambda m, b: lm_loss(m(b[0]), b[1])  # noqa: E731
        kw = dict(fusion_threshold_bytes=256 << 10, first_bucket_bytes=16 << 10)
    if not overlap:
        kw = {}
    opt = T.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01), named_parameters=model.named_parameters(),
        overlap=overlap, quantized=quantized, zero1=zero1,
        error_feedback=None if quantized else False, tuned=False, **kw)
    return T.make_train_step(loss_fn, opt), model, batch


def record_program(prog: str, overlap: bool, quantized: bool, zero1: bool, dev,
                   world: int = WORLD) -> dict:
    """Build one program on a fake world of ``world`` ranks, run its first
    step, record its second, and take the census."""
    with fake_world(world):
        step, model, batch = build_program(prog, overlap, quantized, zero1, dev, world)
        step(model, batch)
        timeline = _Timeline({"data": world})
        with timeline.recording():
            step(model, batch)
        _sync(dev)
        out = census(timeline, zero1=zero1)
        if hasattr(step, "close"):
            step.close()
    return out


BACKWARD_RANGE = "autograd::engine::evaluate_function"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def backward_overlap(evs: Sequence[Tuple[bool, str, float, float]]) -> dict:
    """Which streamed groups of one profiled step were overlapped by backward
    compute, from ``(on_device, name, start, end)`` events on one clock. The
    backward ends where the autograd engine's last host range ends; only
    work launched before that counts, so the optimizer's kernels, which run
    after every group in any build, do not. Across cards: each NCCL kernel
    with the backward's compute kernels that overlap it on the device. At one
    rank, where NCCL launches no kernel: each ``nccl:all_reduce`` host range
    with the kernel launches that follow it inside the backward. A posthoc
    build reduces after the backward returns and counts 0."""
    bwd_end = max((e for d, n, _, e in evs if not d and n.startswith(BACKWARD_RANGE)),
                  default=None)
    if bwd_end is None:
        return {"trace_groups": 0, "trace_groups_overlapped": 0,
                "trace_source": "no autograd engine range in the trace"}
    nccl_k = sorted((s, e) for d, n, s, e in evs if d and "nccl" in n.lower())
    if nccl_k:
        compute = [(s, e) for d, n, s, e in evs
                   if d and "nccl" not in n.lower() and s < bwd_end]
        per = [sum(1 for a, b in compute if a < ke and b > ks) for ks, ke in nccl_k]
        source = "nccl kernels overlapped by backward compute kernels"
    else:
        launches = [s for d, n, s, _ in evs if not d and n in LAUNCHES and s < bwd_end]
        host = sorted(s for d, n, s, _ in evs if not d and n.startswith("nccl:all_reduce"))
        per = [sum(1 for t in launches if t > h) for h in host]
        source = "nccl: host ranges followed by backward kernel launches (one rank)"
    return {"trace_groups": len(per), "trace_groups_overlapped": sum(1 for c in per if c > 0),
            "trace_source": source}


def trace_check(prog: str, dev, overlap: bool = True) -> dict:
    """On the card, the overlap (or posthoc) build of ``prog`` on the job's
    real world: one profiled step, read by :func:`backward_overlap`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step, model, batch = build_program(prog, overlap, False, False, dev, 1)
    for _ in range(2):
        step(model, batch)
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model, batch)
        _sync(dev)
    cuda = torch.autograd.DeviceType.CUDA
    out = backward_overlap([(e.device_type == cuda, e.name, e.time_range.start,
                             e.time_range.end) for e in prof.events()
                            if not (e.device_type == cuda and e.is_user_annotation)])
    if hasattr(step, "close"):
        step.close()
    return out


def structural_gates(results: dict) -> List[str]:
    """The reference's ``--assert-overlap`` gates over the four builds."""
    failed = []
    for prog in PROGRAMS:
        st, base = results["overlap"][prog], results["default"][prog]
        if st["independent_all_reduce_groups"] < 3:
            failed.append(f"{prog}: independent_all_reduce_groups="
                          f"{st['independent_all_reduce_groups']} < 3")
        if st["pairs_with_overlap"] < 1:
            failed.append(f"{prog}: pairs_with_overlap=0")
        if st["independent_all_reduce_groups"] <= base["independent_all_reduce_groups"]:
            failed.append(f"{prog}: overlap groups not > default "
                          f"({st['independent_all_reduce_groups']} vs "
                          f"{base['independent_all_reduce_groups']})")
        qt = results["quantized"][prog]
        if qt["independent_collective_groups"] < 3:
            failed.append(f"{prog}: quantized independent_collective_groups="
                          f"{qt['independent_collective_groups']} < 3")
        qwb = qt["bytes_on_wire"]["by_dtype"]
        if qwb.get("s8", 0) <= 0:
            failed.append(f"{prog}: quantized build moves no s8 bytes")
        if qwb.get("f32", 0) > 0:
            failed.append(f"{prog}: quantized build still moves {qwb['f32']} non-scalar "
                          "f32 collective bytes")
        zt = results["zero1"][prog]
        if zt["independent_reduce_scatter_groups"] < 3:
            failed.append(f"{prog}: zero1 independent_reduce_scatter_groups="
                          f"{zt['independent_reduce_scatter_groups']} < 3")
        z_grad, ar_grad = (zt["wire_model"]["grad_reduction_bytes"],
                           st["wire_model"]["grad_reduction_bytes"])
        if not z_grad < ar_grad:
            failed.append(f"{prog}: zero1 gradient-reduction wire {z_grad} not strictly "
                          f"below streamed allreduce {ar_grad}")
        if zt["wire_model"]["total_bytes"] > st["wire_model"]["total_bytes"]:
            failed.append(f"{prog}: zero1 total wire {zt['wire_model']['total_bytes']} above "
                          f"streamed allreduce {st['wire_model']['total_bytes']}")
        if zt["zero1_plans"]["findings"]:
            failed.append(f"{prog}: zero1 per-bucket RS/AG plans failed verification: "
                          f"{zt['zero1_plans']['findings'][:2]}")
        if zt["zero1_plans"]["plans_verified"] < 6:
            failed.append(f"{prog}: only {zt['zero1_plans']['plans_verified']} zero1 plans "
                          "verified (expected >= 6: 3+ buckets x RS+AG)")
    return failed


def structural_mode(a) -> int:
    import torch

    from horovod_tpu_torch.common.basics import resolve_device

    dev = resolve_device(a.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    results: Dict[str, Dict[str, dict]] = {}
    for mode, overlap, quantized, zero1 in MODES:
        t0 = time.time()
        results[mode] = {}
        for prog in PROGRAMS:
            st = record_program(prog, overlap, quantized, zero1, dev)
            results[mode][prog] = st
            print(f"[overlap] structural {mode}/{prog}: "
                  f"independent_groups={st['independent_all_reduce_groups']} "
                  f"independent_rs_groups={st['independent_reduce_scatter_groups']} "
                  f"independent_collectives={st['independent_collective_groups']} "
                  f"pairs_with_overlap={st['pairs_with_overlap']} "
                  f"wire={st['bytes_on_wire']['by_dtype']}", flush=True)
        results[mode]["elapsed_s"] = round(time.time() - t0, 2)
    out: Dict[str, Any] = {"mode": "structural", "device": str(dev), "world": WORLD,
                           "results": results}
    failed = structural_gates(results) if a.assert_overlap else []
    if dev.type == "cuda":
        import horovod_tpu_torch as hvd

        hvd.init(dev)
        try:
            out["trace"] = {prog: trace_check(prog, dev) for prog in PROGRAMS}
            out["trace_posthoc"] = {prog: trace_check(prog, dev, overlap=False)
                                    for prog in PROGRAMS}
        finally:
            hvd.shutdown()
        out["card"] = _card_line()
        if a.assert_overlap:
            failed += [f"{p}: trace shows no streamed group overlapped by backward compute"
                       for p, t in out["trace"].items() if t["trace_groups_overlapped"] < 1]
            # The posthoc build reduces after the backward: a reading that
            # finds overlap there cannot tell the builds apart.
            failed += [f"{p}: trace finds {t['trace_groups_overlapped']} posthoc groups "
                       "overlapped by backward compute"
                       for p, t in out["trace_posthoc"].items()
                       if t["trace_groups_overlapped"] > 0 or t["trace_groups"] < 1]
    out["ok"] = not failed
    _emit(out, a.out)
    if failed:
        print("[overlap] STRUCTURAL ASSERTIONS FAILED:", file=sys.stderr)
        for f in failed:
            print(f"  {f}", file=sys.stderr)
        return 5
    if a.assert_overlap:
        print("[overlap] structural assertions passed", file=sys.stderr)
    return 0


def _emit(out: dict, path: Optional[str]) -> None:
    line = json.dumps(out, default=str)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50",
                    help="the bench's model: resnet50 (default) or transformer (GPT-2-small)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="per-rank batch (default 32 for a CNN, 8 for the transformer)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="the bench's tiny shapes (CPU runs)")
    ap.add_argument("--overlap", action="store_true", help="phase A: the streamed DP step")
    ap.add_argument("--scan", action="store_true",
                    help="phase A: also time the step as a captured CUDA graph")
    ap.add_argument("--ranks", type=int, default=0,
                    help="posthoc against overlap on this many ranks, one card each")
    ap.add_argument("--structural", action="store_true")
    ap.add_argument("--assert-overlap", action="store_true")
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.batch_size is None:
        a.batch_size = 8 if a.model == "transformer" else 32
    return a


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    a = parse_args(argv)
    if a.structural:
        return structural_mode(a)
    if a.worker:
        return _ranks_worker(a)
    if a.ranks:
        return ranks_mode(a, argv)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import resolve_device

    hvd.init(resolve_device(a.device))
    try:
        out = {"mode": "phase_a", "platform": hvd.device().type,
               "card": _card_line() if hvd.device().type == "cuda" else "cpu",
               "phase_a": phase_a(a)}
    finally:
        hvd.shutdown()
    _emit(out, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
