"""Per-phase latency breakdown of one eager allreduce.

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.tools.eager_latency_breakdown
    python -m horovod_tpu_torch.tools.eager_latency_breakdown            # one rank, one card
    python -m horovod_tpu_torch.run -np 2 python -m \\
        horovod_tpu_torch.tools.eager_latency_breakdown --device cpu     # gloo ranks

The counterpart of ``tools/eager_latency_breakdown.py``. It wraps the native
runtime's ``_execute_plan`` and its executor's ``execute``
(``core/nccl_executor.NcclPlanExecutor``; ``LocalPlanExecutor`` for one rank
on the CPU), as the reference wraps ``rt._execute_plan`` and
``rt.executor.execute``, and times ``--reps`` allreduces of ``--bytes``
(default 1 KiB, 256 f32) under one name. Rank 0 prints one line
``BREAKDOWN {json}`` of medians in microseconds:

 - ``enq_to_plan``: ``allreduce`` called -> the plan reaches the consumer
   (the C++ core's cycle, negotiation over its TCP controller, the plan's
   hand-off to the executor thread or to the caller blocked in
   ``synchronize``);
 - ``plan_to_exec``: the plan's entries matched in Python, up to the
   executor's ``execute``;
 - ``exec``: the executor's ``execute``: the pack, one NCCL (gloo on the
   CPU) call and the unpack, issued on the eager plane's stream. On the
   card this is host time to issue them, with the NCCL call's own wait for
   its peers when it blocks the host;
 - ``done_to_ret``: the plan's bookkeeping until ``synchronize`` returns;
 - ``ready_wait``: the wait on the output's done event still left when
   ``synchronize`` returns (the card's stream synchronized; on the CPU the
   output is ready and this is the cost of the check);
 - ``total``: ``allreduce`` called -> the output ready.

The medians are rounded to 0.001 µs, where the reference rounds to 0.1: on
the CPU the ready wait is a check of well under 0.1 µs. The line also
carries ``ranks``, ``bytes``, ``reps`` and ``device``. A rep counts only
when both wraps saw its plan. With one rank on the card the job needs no
launcher: the single-rank path (a file store, NCCL over one rank).
``--device cpu`` is the opt-out from the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

FIELDS = ("enq_to_plan", "plan_to_exec", "exec", "done_to_ret", "ready_wait", "total")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=80)
    ap.add_argument("--bytes", type=int, default=1024,
                    help="payload of each allreduce (f32; default 1 KiB = 256 floats)")
    ap.add_argument("--device", default=None, help="cpu, or a card (default: this rank's)")
    return ap.parse_args(argv)


def median(values):
    """The reference's median: the upper middle of the sorted values."""
    values = sorted(values)
    return values[len(values) // 2]


def breakdown(reps: int = 80, nbytes: int = 1024) -> dict:
    """Time ``reps`` eager allreduces on an initialized job, each after 2 ms
    idle, as the reference's (the core's cycle is then idle when the rep
    enqueues); the median of each field in microseconds (empty when no rep
    was seen whole)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.eager import _rt

    rt = _rt()
    dev = hvd.device()
    x = torch.from_numpy(np.random.RandomState(0).randn(max(nbytes // 4, 1))
                         .astype(np.float32)).to(dev)
    marks = {}
    orig_exec, orig_execute = rt._execute_plan, rt.executor.execute

    def exec_wrap(plan):
        marks["plan_recv"] = time.perf_counter()
        out = orig_exec(plan)
        marks["exec_done"] = time.perf_counter()
        return out

    def executor_wrap(plan, entries, topo):
        marks["exec_start"] = time.perf_counter()
        return orig_execute(plan, entries, topo)

    def ready(out):
        if out.device.type == "cuda":
            torch.cuda.current_stream(out.device).synchronize()

    rt._execute_plan, rt.executor.execute = exec_wrap, executor_wrap
    try:
        ready(hvd.allreduce(x, name="w"))
        rows = []
        for _ in range(reps):
            time.sleep(0.002)
            marks.clear()
            t0 = time.perf_counter()
            out = hvd.allreduce(x, name="w")
            t_sync = time.perf_counter()
            ready(out)
            t1 = time.perf_counter()
            if all(k in marks for k in ("plan_recv", "exec_start", "exec_done")):
                rows.append({
                    "enq_to_plan": (marks["plan_recv"] - t0) * 1e6,
                    "plan_to_exec": (marks["exec_start"] - marks["plan_recv"]) * 1e6,
                    "exec": (marks["exec_done"] - marks["exec_start"]) * 1e6,
                    "done_to_ret": (t_sync - marks["exec_done"]) * 1e6,
                    "ready_wait": (t1 - t_sync) * 1e6,
                    "total": (t1 - t0) * 1e6,
                })
    finally:
        rt._execute_plan, rt.executor.execute = orig_exec, orig_execute
    if not rows:
        return {}
    return {k: round(median(r[k] for r in rows), 3) for k in FIELDS}


def main(argv=None) -> int:
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import resolve_device

    hvd.init(resolve_device(args.device))
    try:
        out = breakdown(args.reps, args.bytes)
        if hvd.rank() == 0:
            if not out:
                print("[breakdown] no rep was seen by both wraps", file=sys.stderr)
                return 1
            out.update(ranks=hvd.size(), bytes=args.bytes, reps=args.reps,
                       device=str(hvd.device()))
            print("BREAKDOWN", json.dumps(out), flush=True)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
