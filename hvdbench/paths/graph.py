"""The captured DP step on one process: ``make_train_step`` over the
compiled-path ``DistributedOptimizer``, captured by
``utils/step_graph.capture_step`` and replayed one step a call, as
``bench --scan`` runs it.

Set-up builds the model, the optimizer and the step once, warms and
captures it, then writes the seed's weights and a zero optimizer state
back into the same tensors and drives the first steps through the
window's own call: those steps give the readings the reference is held
to. The window then goes on from there with the same object.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import common, faults, state
from .. import trace as tr
from ..weights import draw, write_into


def run(cell: dict, seed: int, seconds: float, trace: bool, device=None, fault=None) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.step_graph import capture_step

    config, traffic = cell["config"], cell["traffic"]
    fam = common.family(config)
    start = common.process_start_s()
    common.phase("import", start)
    hvd.init(device)
    dev = hvd.device()
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cudnn.benchmark = True

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    try:
        model = fam.build_program(config, dev)
        named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        spec = fam.leaves(config)
        write_into(named, draw(spec, seed, dev))
        batch = fam.make_batch(config, traffic, seed, dev, rank=0, world=1)
        inner = state.build_optimizer(config["optimizer"], model.parameters(),
                                      capturable=on_card)
        loss_fn = faults.plant(fault, inner, fam.program_loss, batch, model=model)
        opt = hvd.DistributedOptimizer(inner, named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        common.phase("init, model and weights", start)
        step = hvd.make_train_step(loss_fn, opt)
        graph = capture_step(step, model, batch, length=1, warmup=int(traffic["warmup_steps"]))
        graph.capture()
        common.phase("warm-up and capture", start)

        # Back to the seed's start, in the captured tensors.
        write_into(named, draw(spec, seed, dev))
        readings = state.first_steps(graph, named, inner, config["optimizer"])
        common.phase("the checked steps", start)
        steps = state.window_steps(graph, seconds, int(traffic["min_steps"]), sync)

        sync()
        t0 = time.perf_counter()
        setup_s = common.boot_clock() - start
        for _ in range(steps):
            loss = graph()
        sync()
        window_s = time.perf_counter() - t0
        final_loss = float(loss)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

        ranks = []
        if trace:
            prof = tr.profile_steps(graph, int(traffic["profile_steps"]), sync)
            ranks.append({"trace": tr.from_profiler(prof, int(traffic["profile_steps"]))})
            del prof
        record = {
            "world": 1, "steps": steps, "window_s": window_s, "setup_s": setup_s,
            "rows_per_rank": int(traffic["batch_per_card"]),
            "memory_peak_bytes": int(peak), "final_loss": final_loss,
            "readings": readings.as_dict(), "ranks": ranks or [{}],
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "platform": "gpu" if on_card else "cpu", "forbidden": [],
        }
        graph.release()
        del graph, step, opt, inner, model, named, batch, readings
    finally:
        hvd.shutdown()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return record
