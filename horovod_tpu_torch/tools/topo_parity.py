"""Topology-planner parity across cards: the interconnect model, plan
selection and the calibrator on a live job.

    python -m horovod_tpu_torch.tools.topo_parity --ranks 4                # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.topo_parity --ranks 4 --device cpu   # gloo on the CPU

The job is the ``(cross 2, local n/2)`` world of ``build_hierarchical_mesh``
(``HOROVOD_LOCAL_SIZE`` = n/2; each rank keeps its own card), and runs:

1. ``collective_plan`` for every collective at 1 KiB, 1 MiB and 64 MiB:
   the same dict on every rank.
2. An eager allreduce sweep, 1 KiB to 64 MiB in powers of 4, first with
   ``HOROVOD_TOPOLOGY_PLAN=auto`` (the planner's verdict chooses flat,
   two-level or split a payload; the algorithms recorded in
   ``hvd_topo_plan_info`` are reported), then without it (one NCCL
   allreduce over the n cards), both under ``HOROVOD_TRACE``. Every result
   is held to the float64 sum of every rank's input within n f32 roundings.
3. Under the flat sweep's trace, the same payloads also go through
   ``torch.distributed.all_reduce`` alone on the job's group, timed by CUDA
   events around 20 back-to-back calls; each call's mean is stamped into the
   trace as a hop-labelled ``hvd_collective_stage:all_reduce-ring`` span
   (the ``ici`` hop, 2(n-1) rounds, the ring's wire bytes a rank), and the
   flat eager plans' device times on the executor's stream (the warm-up call
   left out) as ``hvd_collective_stage:eager_plan`` spans. Each rank writes
   its trace window; ``trace/merge.stats_summary`` (``trace_merge --stats``)
   feeds ``sim.calibrate.fit_calibration``: over the NCCL spans it fits the
   NVLink hop's latency and bandwidth (``calibration.json``), over the eager
   plans the eager plane's (its host work between the plan's kernels
   included), over the host-timed ``hvd_plan`` spans what those would
   claim (on the card the executor only queues its work, so their duration
   is the host's, not the link's). ``divergence_report`` sets the card's
   default ``ici`` constants' time for the NCCL samples against the
   measured time.
4. The GPT-2-small DP step (8 x 1024 a card) with ``hierarchical="auto"`` on
   ``build_hierarchical_mesh(n/2)`` against the post-hoc flat step: in f32
   the losses of 5 steps from one set of weights agree within 1e-6
   relative (dp_parity's bound), and each bucket's selected algorithm is
   printed; then in bf16 (the bench's dtype) the two steps are timed in
   turns, each rank's median, beside a local step with no reduction (the
   step's compute).
5. The fleet simulator's predicted step for that program on the calibrated
   model (every hop at the fitted NVLink constants, one node), and on the
   card's defaults, beside the measured step: a finding, not a gate.

On one node the "cross" level is NVLink too: the planner's choice is the
one it would make across nodes, and the times say nothing about a network.
With ``--device cpu`` the step is dp_parity's small GPT. Rank 0 prints one
JSON line (``chiprun_out/topo_parity/`` keeps the traces and the
calibration); any disagreement exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from .launch import launch_ranks, store_url

SIZES = [1 << (10 + 2 * k) for k in range(9)]        # 1 KiB ... 64 MiB
REPS = 5
PLAN_SIZES = (1 << 10, 1 << 20, 64 << 20)
COLLECTIVES = ("allreduce", "allgather", "reducescatter", "broadcast", "alltoall")
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
SMALL = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, max_len=256)
PARITY_STEPS, BENCH_WARMUP, BENCH_STEPS = 5, 3, 10
OUT_DIR = os.path.join("chiprun_out", "topo_parity")


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", str(dev.index or 0)], capture_output=True, text=True,
                          timeout=60).stdout.strip()


class _PlanTimer:
    """Times every executor plan whose tensors are named ``sweep.*``: CUDA
    events on the executor's stream around the plan (perf_counter on the
    CPU, where gloo blocks)."""

    def __init__(self, executor_cls):
        self.samples = []               # (payload bytes, start, end)
        self._cls, self._orig = executor_cls, executor_cls.execute
        timer = self

        def execute(ex, plan, entries, topo):
            import torch

            names = plan.get("names", [])
            if not (names and all(str(nm).startswith("sweep.") and not str(nm).endswith(".0")
                                  for nm in names)):
                return timer._orig(ex, plan, entries, topo)
            nbytes = sum(e.tensor.numel() * e.tensor.element_size() for e in entries)
            if ex._cuda:
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record(ex._stream)
                out = timer._orig(ex, plan, entries, topo)
                t1.record(ex._stream)
            else:
                t0 = time.perf_counter()
                out = timer._orig(ex, plan, entries, topo)
                t1 = time.perf_counter()
            timer.samples.append((nbytes, t0, t1))
            return out

        executor_cls.execute = execute

    def seconds(self):
        """[(payload bytes, seconds)], after the executor's work is done."""
        import torch

        out = []
        for nbytes, t0, t1 in self.samples:
            if isinstance(t0, float):
                out.append((nbytes, t1 - t0))
            else:
                t1.synchronize()
                out.append((nbytes, t0.elapsed_time(t1) / 1e3))
        return out

    def remove(self):
        self._cls.execute = self._orig


def _sweep(hvd, dev, n, r, auto: bool, failures, trace_dir, timer=None):
    """One eager allreduce sweep; returns the plan algorithms recorded."""
    import torch

    from .. import metrics, trace

    os.environ["HOROVOD_TOPOLOGY_PLAN"] = "auto" if auto else "off"
    os.environ["HOROVOD_TRACE"] = "1"
    trace.activate_from_env()
    metrics.install(True)
    hvd.init(str(dev), init_method=store_url() + ("_auto" if auto else "_flat"))
    try:
        trace.TAP.rank = r
        for nb in SIZES if dev.type == "cuda" else SIZES[:6]:
            elems = nb // 4
            xs = [torch.randn(elems, generator=torch.Generator().manual_seed(1000 * j + nb % 997))
                  for j in range(n)]
            exact = torch.stack(xs).double().sum(0)
            bound = n * 2.0 ** -24 * torch.stack(xs).double().abs().sum(0) + 1e-30
            x = xs[r].to(dev)
            for rep in range(1 + REPS):
                out = hvd.allreduce(x, op=hvd.Sum, name=f"sweep.{nb}.{rep}")
            err = (out.double().cpu() - exact).abs()
            if not bool((err <= bound).all()):
                failures.append(f"{'auto' if auto else 'flat'} allreduce of {nb} B: "
                                f"{int((err > bound).sum())} elements past n roundings")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        snap = metrics.snapshot().get("hvd_topo_plan_info", {"series": []})
        algos = sorted({s["labels"]["algorithm"] for s in snap["series"]
                        if s["labels"].get("where") == "eager"})
        if timer is not None:
            rounds = 2 * (n - 1)
            for nbytes, sec in timer.seconds():
                trace.TAP.event("hvd_collective_stage:eager_plan", ph="X", cat="op",
                                dur=sec, hop="ici", rounds=rounds,
                                nbytes=int(nbytes * rounds / n))
            for nbytes, sec in _nccl_sweep(dev):
                trace.TAP.event("hvd_collective_stage:all_reduce-ring", ph="X", cat="op",
                                dur=sec, hop="ici", rounds=rounds,
                                nbytes=int(nbytes * rounds / n))
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(trace_dir, f"rank.{r}.json"), "w") as f:
            json.dump(trace.TAP.window(), f, sort_keys=True)
        hvd.barrier()
        return algos
    finally:
        hvd.shutdown()
        metrics.reset()
        trace.reset()


def _nccl_sweep(dev, reps: int = 20):
    """[(payload bytes, seconds a call)] of ``torch.distributed.all_reduce``
    on the job's group: CUDA events around ``reps`` back-to-back calls after
    three warm-up calls (perf_counter on the CPU)."""
    import torch
    import torch.distributed as dist

    out = []
    for nb in SIZES if dev.type == "cuda" else SIZES[:6]:
        x = torch.ones(nb // 4, device=dev)
        for _ in range(3):
            dist.all_reduce(x)
        if dev.type == "cuda":
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(dev)
            t0.record()
            for _ in range(reps):
                dist.all_reduce(x)
            t1.record()
            t1.synchronize()
            out.append((nb, t0.elapsed_time(t1) / 1e3 / reps))
        else:
            start = time.perf_counter()
            for _ in range(reps):
                dist.all_reduce(x)
            out.append((nb, (time.perf_counter() - start) / reps))
    return out


def _gpt_layer_bytes(dims, itemsize):
    """Gradient bytes of each top-level child of the GPT (forward order)."""
    import torch

    from ..models.transformer import TransformerLM

    meta = TransformerLM(**dims, dtype=torch.float32, device="meta")
    sizes = {}
    for name, p in meta.named_parameters():
        top = name.split(".")[0]
        sizes[top] = sizes.get(top, 0) + p.numel() * itemsize
    return [sizes[k] for k in sorted(sizes)]


def _steps(hvd, dev, n, r, failures):
    """The DP step with hierarchical="auto" against the flat post-hoc step."""
    import numpy as np
    import torch

    from ..models.transformer import TransformerLM, lm_loss
    from ..parallel.mesh import build_hierarchical_mesh

    cuda = dev.type == "cuda"
    dims, batch, seq = (GPT2_SMALL, 8, 1024) if cuda else (SMALL, 2, 256)
    hvd.init(str(dev), init_method=store_url() + "_step")
    out = {}
    try:
        mesh = build_hierarchical_mesh(n // 2)
        rng = np.random.RandomState(r)
        tokens, labels = (torch.from_numpy(rng.randint(0, dims["vocab_size"], (batch, seq)))
                          .to(dev) for _ in range(2))

        def build(dtype, **kw):
            model = TransformerLM(**dims, dtype=dtype, device=dev, seed=0)
            adamw = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8)
            if kw.get("local"):
                def local(m, b):
                    adamw.zero_grad(set_to_none=True)
                    loss = lm_loss(m(b[0]), b[1])
                    loss.backward()
                    adamw.step()
                    return loss.detach()
                return model, local
            step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), adamw,
                                       mesh=mesh if kw.get("auto") else None,
                                       hierarchical="auto" if kw.get("auto") else False)
            return model, step

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        # Parity in f32: one set of weights, the two reductions.
        runs = {k: build(torch.float32, auto=(k == "auto")) for k in ("auto", "flat")}
        losses = {k: [] for k in runs}
        for _ in range(PARITY_STEPS):
            for k, (model, step) in runs.items():
                losses[k].append(float(step(model, (tokens, labels))))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["auto"], losses["flat"]))
        if rel > 1e-6:
            failures.append(f"auto step loss rel err {rel:.3e} > 1e-6: {losses}")
        out["parity"] = {"dtype": "f32", "steps": PARITY_STEPS, "loss_rel_err": rel,
                         "losses_auto": losses["auto"], "losses_flat": losses["flat"],
                         "selected": {str(k): v for k, v in sorted(
                             runs["auto"][1].optimizer.selected_plans.items())}}
        del runs
        # Times in bf16, in turns.
        runs = {k: build(torch.bfloat16, auto=(k == "auto"), local=(k == "local"))
                for k in ("auto", "flat", "local")}
        times = {k: [] for k in runs}
        for i in range(BENCH_WARMUP + BENCH_STEPS):
            order = list(runs) if i % 2 == 0 else list(runs)[::-1]
            for k in order:
                model, step = runs[k]
                sync()
                t0 = time.perf_counter()
                loss = float(step(model, (tokens, labels)))
                sync()
                if i >= BENCH_WARMUP:
                    times[k].append((time.perf_counter() - t0) * 1e3)
                if not np.isfinite(loss):
                    failures.append(f"{k} bf16 step: non-finite loss")
        out["bench"] = {k: statistics.median(v) for k, v in times.items()}
        out["bench_selected"] = {str(k): v for k, v in sorted(
            runs["auto"][1].optimizer.selected_plans.items())}
        out["layer_bytes_bf16"] = _gpt_layer_bytes(dims, 2)
        rows = hvd.allgather_object(out["bench"])
        out["bench_by_rank"] = rows
        del runs
    finally:
        hvd.shutdown()
    return out, dims, batch, seq


def _fit(n, gen, flat_dir, out_dir):
    """Fit the NVLink hop from the flat sweep's trace (rank 0): over the
    NCCL calls alone, over the eager plans' device times, and over the
    host-timed ``hvd_plan`` spans."""
    from ..sim import calibrate
    from ..topo import model as tmodel
    from ..trace import merge as tmerge

    stats = tmerge.stats_summary(*tmerge.read_dir(flat_dir))

    def only(name):
        return {**stats, "ranks": {r: {**doc, "collectives": [
            c for c in doc["collectives"] if c["name"] == name]}
            for r, doc in stats["ranks"].items()}}

    # The (cross, local) ladder, so the calibration applies to the grid's
    # model; only the ici hop has samples.
    ladder = tmodel.synthetic_model(n // 2, cross=2, generation=gen)
    nccl = only("hvd_collective_stage:all_reduce-ring")
    calib = calibrate.fit_calibration(nccl, ladder, source="topo_parity: NCCL all_reduce")
    eager = calibrate.fit_calibration(only("hvd_collective_stage:eager_plan"), ladder)
    host = calibrate.fit_calibration(only("hvd_plan"), tmodel.synthetic_model(n, generation=gen))
    calibrate.save_calibration(calib, os.path.join(out_dir, "calibration.json"))
    default = ladder.hop("ici")
    modeled = measured = 0.0
    samples = []
    for rank, doc in nccl["ranks"].items():
        for c in doc["collectives"]:
            modeled += default.latency_us * c["rounds"] + c["nbytes"] / (
                default.bandwidth_gbps * 1e3)
            measured += c["dur_s"] * 1e6
            if rank == "0":
                samples.append([c["nbytes"], round(c["dur_s"] * 1e6, 3)])
    div = calibrate.divergence_report({"ici": modeled}, {"ici": measured})
    return calib, eager, host, div, samples


def _predict(calib, gen, n, step_out, dims, batch, seq):
    """The simulator's step for the measured program: every hop at the
    fitted NVLink constants (one node), and the card's defaults."""
    from .. import sim
    from ..topo.model import Hop, InterconnectModel, synthetic_model

    layers = step_out["layer_bytes_bf16"]
    mib = sum(layers) / float(1 << 20)
    local_us = step_out["bench"]["local"] * 1e3
    # Compute a MiB such that the program's compute (backward, forward at
    # half of it, optimizer at 4 us a MiB) is the measured local step.
    per_mib = max(local_us - 4.0 * mib, 0.0) / (1.5 * mib)
    program = sim.program_from_layers("gpt", layers, compute_us_per_mib=per_mib,
                                      source="measured-local-step")
    default = synthetic_model(n // 2, cross=2, generation=gen)
    ici = calib.hops["ici"]
    one_node = InterconnectModel(hops=tuple(
        Hop(h.name, h.axis, h.size, float(ici["bandwidth_gbps"]), float(ici["latency_us"]))
        for h in default.hops), generation=gen, eligible=True, source="fitted-one-node")
    out = {}
    for name, model in (("calibrated_one_node", one_node), ("defaults", default)):
        for overlap in (False, True):
            res = sim.simulate(model, program, sim.SimConfig(overlap=overlap), steps=2)
            out[f"{name}{'_overlap' if overlap else ''}_ms"] = round(res.mean_step_us / 1e3, 4)
            out[f"{name}{'_overlap' if overlap else ''}_plans"] = [
                p.algorithm for p, _ in res.plans]
    out["compute_us_per_mib"] = round(per_mib, 4)
    out["ideal_ms"] = round(program.compute_us / 1e3, 4)
    return out


def _worker(device: str) -> int:
    import torch

    import horovod_tpu_torch as hvd
    from ..core import nccl_executor
    from ..topo.model import detect_generation

    n, r = int(os.environ["HOROVOD_SIZE"]), int(os.environ["HOROVOD_RANK"])
    if n < 4 or n % 2:
        raise SystemExit("topo_parity needs an even number of ranks, 4 or more")
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", r)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    os.environ.update({"HOROVOD_LOCAL_SIZE": str(n // 2), "HOROVOD_LOCAL_RANK": str(r % (n // 2))})
    out_dir = os.path.join(os.environ.get("TOPO_PARITY_OUT", OUT_DIR))
    failures, report = [], {}
    gen = detect_generation()

    # 1. collective_plan on every rank, before and after init.
    hvd.init(str(dev), init_method=store_url() + "_plans")
    try:
        plans = {f"{c}:{nb}": hvd.collective_plan(c, nb) for c in COLLECTIVES for nb in PLAN_SIZES}
        every = hvd.allgather_object(plans)
        if any(p != every[0] for p in every):
            failures.append("collective_plan differs between ranks")
        report["collective_plan_allreduce"] = {
            str(nb): plans[f"allreduce:{nb}"]["algorithm"] for nb in PLAN_SIZES}
        report["model"] = plans[f"allreduce:{PLAN_SIZES[0]}"]["model"]
    finally:
        hvd.shutdown()

    # 2-3. The sweeps, with the planner's verdict and flat (timed).
    report["auto_sweep_algorithms"] = _sweep(hvd, dev, n, r, True, failures,
                                             os.path.join(out_dir, "trace_auto"))
    timer = _PlanTimer(nccl_executor.NcclPlanExecutor)
    try:
        flat_dir = os.path.join(out_dir, "trace_flat")
        report["flat_sweep_algorithms"] = _sweep(hvd, dev, n, r, False, failures, flat_dir,
                                                 timer)
    finally:
        timer.remove()
    if r == 0:
        calib, eager, host, div, samples = _fit(n, gen, flat_dir, out_dir)
        report["fit_ici_nccl"] = calib.hops["ici"]
        report["fit_ici_eager_plans"] = eager.hops["ici"]
        report["fit_ici_host_timed_plan_spans"] = host.hops["ici"]
        report["divergence_defaults_vs_measured"] = div["per_hop"]["ici"]
        report["nccl_samples_rank0_wire_bytes_us"] = samples

    # 4. The DP step.
    step_out, dims, batch, seq = _steps(hvd, dev, n, r, failures)
    report["step"] = step_out
    if r == 0:
        report["predicted"] = _predict(calib, gen, n, step_out, dims, batch, seq)
        report["measured_step_ms"] = {k: v for k, v in step_out["bench"].items()}
    for f in failures:
        print(f"[topo_parity] rank {r} FAIL {f}", file=sys.stderr, flush=True)
    if r == 0:
        report.update({"topo_parity": "ok" if not failures else "failed", "ranks": n,
                       "device": dev.type, "card": _card(dev), "generation": gen,
                       "grid": [2, n // 2], "failures_rank0": len(failures),
                       "seconds": round(time.perf_counter() - t_start, 1)})
        report["step"].pop("layer_bytes_bf16", None)
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(json.dumps(report, sort_keys=True), flush=True)
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = ap.parse_args()
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.topo_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda"],
                            args.ranks)
    return _worker(args.device or "cuda")


if __name__ == "__main__":
    sys.exit(main())
