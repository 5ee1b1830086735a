"""Eager-against-floor allreduce micro-benchmark.

    python -m horovod_tpu_torch.utils.micro_bench --ranks 2               # a card per rank, NCCL
    python -m horovod_tpu_torch.utils.micro_bench --ranks 2 --device cpu  # gloo on the CPU
    python -m horovod_tpu_torch.utils.micro_bench --one-rank              # one card

The port of ``horovod_tpu/utils/micro_bench.py``. At payloads of 1 KiB,
64 KiB, 1 MiB and 16 MiB it measures three latencies of an f32 allreduce,
each the mean and the median over the reps:

 - ``eager_np_us``: a numpy array through the whole eager pipeline
   (enqueue, the native core's negotiation, the plan on the executor,
   and on the card the copies to it and back to the host);
 - ``eager_dev_us``: a torch tensor on the rank's device (a CUDA tensor on
   the card) through the same pipeline, until the result is on the device
   (``torch.cuda.synchronize``);
 - ``compiled_us``: the data-plane floor, the NCCL plan executor
   (``core/nccl_executor.py``) invoked directly on the same tensor without
   the control plane: the pack, one all-reduce on the executor's own
   communicator and CUDA stream, and the unpack, until its done event.

``eager_* - compiled`` is therefore the control plane alone (enqueue,
negotiation, plan dispatch, the hand-overs between threads). A plain
``torch.distributed.all_reduce`` on the default group is timed too
(``ref_psum_*``), for cross-checking only: it is a different call (in
place, no pack), so it is not the floor. Its payload is zeros, so that
repeated in-place sums stay finite.

Every timed floor and reference rep follows an untimed alignment barrier
(a one-element all-reduce on the executor's group): the eager path's
negotiation aligns the ranks before its collective, so an unaligned floor
would time the ranks' skew. An overhead within the floor's interquartile
range is reported as 0 and flagged.

The job needs at least 2 ranks, one card each (``--ranks``, started
through ``tools/launch.py``), as the JAX worker asserts. ``--one-rank``
runs it on one card, where NCCL has no peer and only the control plane
costs anything; each row says so. Rank 0 prints one JSON line ``{"rows":
[...]}``, or with ``--out`` writes it to that file instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..tools.eager_parity import _card

SIZES = (1 << 10, 1 << 16, 1 << 20, 1 << 24)


def reps_for(nbytes: int, cap: int = 0) -> int:
    """Reps sized so that the median is stable: at least 10 for the largest
    payload, 100 for the latency-bound small ones (``cap`` > 0 lowers
    them, for tests)."""
    reps = max(10, min(100, (1 << 25) // nbytes))
    return min(reps, cap) if cap > 0 else reps


def _stats(ts):
    srt = sorted(ts)
    n = len(srt)
    return sum(ts) / n, srt[n // 2], srt[(3 * n) // 4] - srt[n // 4]


def sweep(device=None, *, one_rank: bool = False, max_reps: int = 0, sizes=SIZES) -> dict:
    """Initialize, time every payload size, shut down; returns rank 0's
    record (``{"rows": [...], ...}``) on rank 0 and None elsewhere."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from ..common import basics
    from ..common.basics import resolve_device
    from ..common.types import ReduceOp, ResponseType, TensorTableEntry
    from ..core import record_ready
    from ..core.nccl_executor import NcclPlanExecutor
    from ..tools.launch import STORE_DIR_VAR, store_url

    hvd.init(resolve_device(device),
             init_method=store_url() if STORE_DIR_VAR in os.environ else None)
    try:
        size, rank, dev = hvd.size(), hvd.rank(), hvd.device()
        if one_rank:
            if size != 1:
                raise ValueError(f"--one-rank runs one rank, not {size}")
        else:
            assert size > 1, "micro_bench must run under the launcher (--ranks >= 2)"
        ex = basics._runtime.eager.executor
        if not isinstance(ex, NcclPlanExecutor):
            raise RuntimeError(f"the floor is the NCCL plan executor; this runtime runs "
                               f"{type(ex).__name__} (one rank needs the card)")
        topo = basics._runtime.topology
        on_card = dev.type == "cuda"

        def wait():
            if on_card:
                torch.cuda.synchronize(dev)

        bar = torch.zeros(1, device=dev)

        def align():
            dist.all_reduce(bar, group=ex._group)
            wait()

        rows = []
        for nbytes in sizes:
            n = nbytes // 4
            reps = reps_for(nbytes, max_reps)
            x_np = np.random.RandomState(rank).randn(n).astype(np.float32)
            x_dev = torch.from_numpy(x_np).to(dev)

            # The floor: the executor's own plan path on the same tensor.
            name = f"floor_{nbytes}"
            plan = {"id": 0, "type": int(ResponseType.ALLREDUCE), "op": int(ReduceOp.SUM),
                    "prescale": 1.0, "postscale": 1.0, "participants": size, "names": [name]}

            def floor_call():
                entry = TensorTableEntry(name=name, tensor=x_dev, reduce_op=ReduceOp.SUM,
                                         context={"ready": record_ready(x_dev)})
                out = ex.execute(plan, [entry], topo)[name]
                done = ex.done_event()
                if done is not None:
                    done.synchronize()
                return out

            floor_call()
            ts = []
            for _ in range(reps):
                align()
                t0 = time.perf_counter()
                floor_call()
                ts.append(time.perf_counter() - t0)
            t_comp, t_comp_med, noise_band = _stats(ts)

            # The cross-check: a plain all-reduce on the default group.
            ref = torch.zeros_like(x_dev)
            dist.all_reduce(ref)
            ts = []
            for _ in range(reps):
                align()
                t0 = time.perf_counter()
                dist.all_reduce(ref)
                wait()
                ts.append(time.perf_counter() - t0)
            t_ref, t_ref_med, _ = _stats(ts)

            # Eager, numpy in and out. One name reused across reps, as
            # gradient names repeat every step (the core's response cache).
            hvd.allreduce(x_np, op=hvd.Sum, name=f"micro_np_{nbytes}")
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                hvd.allreduce(x_np, op=hvd.Sum, name=f"micro_np_{nbytes}")
                ts.append(time.perf_counter() - t0)
            t_np, t_np_med, _ = _stats(ts)

            # Eager, a tensor on the rank's device, until the result is there.
            hvd.allreduce(x_dev, op=hvd.Sum, name=f"micro_dev_{nbytes}")
            wait()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                hvd.allreduce(x_dev, op=hvd.Sum, name=f"micro_dev_{nbytes}")
                wait()
                ts.append(time.perf_counter() - t0)
            t_dev, t_dev_med, _ = _stats(ts)

            def _ovh(eager_med):
                d = eager_med - t_comp_med
                if abs(d) <= noise_band:
                    return 0.0, True
                return round(d * 1e6, 1), False

            ovh_np, np_noise = _ovh(t_np_med)
            ovh_dev, dev_noise = _ovh(t_dev_med)
            rows.append({
                "bytes": nbytes,
                "np": size,
                "reps": reps,
                "one_rank": one_rank,
                "noise_band_us": round(noise_band * 1e6, 1),
                "overhead_within_noise": {"np": np_noise, "dev": dev_noise},
                "floor_source": f"nccl_plan_executor ({dist.get_backend()})",
                "eager_np_med_us": round(t_np_med * 1e6, 1),
                "eager_dev_med_us": round(t_dev_med * 1e6, 1),
                "compiled_med_us": round(t_comp_med * 1e6, 1),
                "overhead_np_med_us": ovh_np,
                "overhead_dev_med_us": ovh_dev,
                "eager_np_us": round(t_np * 1e6, 1),
                "eager_dev_us": round(t_dev * 1e6, 1),
                "compiled_us": round(t_comp * 1e6, 1),
                "overhead_np_us": round((t_np - t_comp) * 1e6, 1),
                "overhead_dev_us": round((t_dev - t_comp) * 1e6, 1),
                "ref_psum_med_us": round(t_ref_med * 1e6, 1),
                "ref_psum_us": round(t_ref * 1e6, 1),
            })
            # Keep the ranks in lockstep between payload sizes.
            hvd.allreduce(np.zeros(1, np.float32), name=f"micro_bar_{nbytes}")
        if rank != 0:
            return None
        return {"rows": rows, "ranks": size, "device": dev.type, "card": _card(dev),
                "one_rank": one_rank}
    finally:
        hvd.shutdown()


def run(ranks: int, device=None, max_reps: int = 0, out: str = "") -> int:
    """Start ``ranks`` ranks of this module (``tools/launch.py``); rank 0
    writes its record to ``out``. Returns the largest exit code."""
    from ..tools.launch import launch_ranks

    argv = ["--ranks", str(ranks), "--max-reps", str(max_reps)]
    argv += ["--device", device] if device else []
    argv += ["--out", out] if out else []
    return launch_ranks("horovod_tpu_torch.utils.micro_bench", argv, ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2, help="ranks, one card each (at least 2)")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: a card per rank")
    ap.add_argument("--one-rank", action="store_true",
                    help="one rank on one card: only the control plane costs anything")
    ap.add_argument("--max-reps", type=int, default=0, help="cap the reps of every size")
    ap.add_argument("--out", default="", help="rank 0 writes its JSON record here, not to stdout")
    args = ap.parse_args(argv)
    if args.one_rank:
        record = sweep(args.device, one_rank=True, max_reps=args.max_reps)
    elif "HOROVOD_RANK" not in os.environ:
        if args.ranks < 2:
            ap.error("--ranks must be at least 2 (or pass --one-rank)")
        return run(args.ranks, args.device, args.max_reps, args.out)
    else:
        record = sweep(args.device, max_reps=args.max_reps)
    if record is not None and args.out:
        with open(args.out, "w") as f:
            json.dump(record, f)
    elif record is not None:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
