"""A plain PyTorch training loop under the Horovod PyTorch binding
(``horovod_tpu_torch.torch``), launched as a Horovod user launches it:
``horovod_tpu_torch.run.run()`` starts one process a rank.

Each rank wraps AdamW in the hook-driven ``DistributedOptimizer`` (a
post-accumulate-grad hook a parameter enqueues its allreduce to the native
core, which negotiates and fuses them; ``step()`` synchronizes, then
steps), broadcasts parameters and optimizer state from rank 0, and runs
zero_grad, forward, loss, backward and ``opt.step()`` a step, with no host
sync of the harness's. After the warm-up the seed's weights and a zero
optimizer state go back into the same tensors, and the first steps give
the readings; the window goes on with the same objects.

The step's time is read from CUDA events recorded on rank 0's compute
stream at each step boundary, collected after the window.
"""

from __future__ import annotations

import gc
import os
import sys
import time

from .. import common


def run(cell: dict, seed: int, seconds: float, trace: bool, device=None, fault=None) -> dict:
    """Launch the ranks, wait for them and gather their records."""
    from horovod_tpu_torch.run import run as hvdrun

    world = int(cell["traffic"]["ranks"])
    env = {"HOROVOD_METRICS": "1"} if trace else {"HOROVOD_METRICS": ""}
    ranks = hvdrun(worker, args=(cell, seed, seconds, trace, device, fault,
                                 common.process_start_s()), np=world, env=env)
    head = ranks[0]
    return {**head, "world": world, "ranks": [r["rank"] for r in ranks],
            "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks),
            "readings": {**head["readings"],
                         "loss": [sum(r["readings"]["loss"][i] for r in ranks) / world
                                  for i in range(len(head["readings"]["loss"]))]},
            "forbidden": sorted({m for r in ranks for m in r["forbidden"]})}


def worker(cell: dict, seed: int, seconds: float, trace: bool, device, fault,
           start_s: float) -> dict:
    """One rank. Prints nothing to standard output: the benchmark's line
    is the launcher's."""
    sys.stdout.flush()
    os.dup2(2, 1)
    common.set_cache_env()
    import torch

    import horovod_tpu_torch as port
    import horovod_tpu_torch.torch as hvd

    from .. import faults, state
    from .. import trace as tr
    from ..weights import draw, write_into

    config, traffic = cell["config"], cell["traffic"]
    fam = common.family(config)
    rank_zero = os.environ.get("HOROVOD_RANK", "0") == "0"
    if rank_zero:
        common.phase("import", start_s)
    hvd.init(device)
    dev = port.device()
    on_card = dev.type == "cuda"
    rank = hvd.rank()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    try:
        model = fam.build_program(config, dev)
        named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        spec = fam.leaves(config)
        write_into(named, draw(spec, seed, dev))
        batch = fam.make_batch(config, traffic, seed, dev, rank=rank, world=hvd.size())
        inner = state.build_optimizer(config["optimizer"], model.parameters())
        opt = hvd.DistributedOptimizer(inner, named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        if rank_zero:
            common.phase("init, model, weights and broadcasts", start_s)
        loss_fn = faults.plant(fault, inner, fam.program_loss, batch, dist_opt=opt,
                               model=model)

        def step():
            opt.zero_grad()
            loss = loss_fn(model, batch)
            loss.backward()
            opt.step()
            return loss.detach()

        for _ in range(int(traffic["warmup_steps"])):
            step()
        if rank_zero:
            common.phase("warm-up", start_s)

        write_into(named, draw(spec, seed, dev))
        readings = state.first_steps(step, named, inner, config["optimizer"])
        if rank_zero:
            common.phase("the checked steps", start_s)
        steps = hvd.broadcast_object(
            state.window_steps(step, seconds, int(traffic["min_steps"]), sync), root_rank=0)

        spent = {"synchronize": 0.0}
        if trace:
            synchronize = opt.synchronize

            def timed_synchronize():
                t = time.perf_counter()
                synchronize()
                spent["synchronize"] += time.perf_counter() - t

            opt.synchronize = timed_synchronize
        plans0 = _plans(port)
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
                  if on_card else None)
        hvd.barrier()
        sync()
        t0 = time.perf_counter()
        setup_s = common.boot_clock() - start_s
        if events:
            events[0].record()
        for i in range(steps):
            loss = step()
            if events:
                events[i + 1].record()
        sync()
        window_s = time.perf_counter() - t0
        if trace:
            # The span covers the window's steps alone, not the profiled ones.
            opt.synchronize = synchronize
        plans = _plans(port) - plans0
        final_loss = float(loss)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        step_ms = ([events[i].elapsed_time(events[i + 1]) for i in range(steps)]
                   if events else None)

        reduced = {}
        if trace:
            n = int(traffic["profile_steps"])
            prof = tr.profile_steps(step, n, sync)
            reduced = tr.from_profiler(prof, n)
            del prof
        record = {
            "steps": steps, "window_s": window_s, "setup_s": setup_s, "step_ms": step_ms,
            "rows_per_rank": int(traffic["batch_per_card"]),
            "memory_peak_bytes": int(peak), "final_loss": final_loss,
            "readings": readings.as_dict(),
            "rank": {"trace": reduced,
                     "counters": {"plans": plans} if trace else {},
                     "spans": {"synchronize_s": spent["synchronize"]} if trace else {}},
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "platform": "gpu" if on_card else "cpu",
        }
        del opt, inner, model, named, batch, readings
    finally:
        hvd.shutdown()
    gc.collect()
    record["forbidden"] = common.forbidden_modules()
    return record


def _plans(port) -> float:
    """The core's fused plans executed so far (``hvd_plans_total``, every
    label); 0 with ``HOROVOD_METRICS`` off."""
    family = port.metrics_snapshot().get("hvd_plans_total", {})
    return sum(s["value"] for s in family.get("series", []))
