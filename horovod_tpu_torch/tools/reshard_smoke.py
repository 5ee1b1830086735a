"""Elastic-reshard smoke: ZeRO-1 state through a quarantine shrink and a
spare-promotion grow, bitwise at every edge, the f32 finals bitwise the
uninterrupted run's, the reshards metered, a byte-stable log. Budget:
under 25 s on the CPU.

    python -m horovod_tpu_torch.tools.reshard_smoke               # 4 cards
    python -m horovod_tpu_torch.tools.reshard_smoke --device cpu  # 4 gloo ranks

The counterpart of ``tools/reshard_smoke.py``, on 4 ranks (one process a
rank, in place of the reference's 4-device virtual mesh): the reference's
3-layer tanh MLP (D 16, seed 23), SGD 0.05 with momentum 0.9, per-leaf
buckets, streamed ZeRO-1 (``DistributedOptimizer(overlap=True,
zero1=True)``), every rank on the same 4-row block (so every reduction
combines identical values and the trajectory does not depend on the world's
size where the reduction is exact). Two variants, f32 and the int8 wire:

1. chaos shrink and grow: 3 steps at world 4; a quarantine shrinks it to
   ranks 0-1 (the gathered state, ``parallel/reshard.gather_zero1_state``,
   re-split by ``reshard_zero1_state(trigger="quarantine")`` and unstacked
   onto a step over a group of those two); 3 steps there; a spare promotion
   grows it back to 4 (``trigger="spare-promotion"``; ranks 2-3 receive the
   rows and the parameters from rank 0); 2 more steps;
2. gather parity: at both edges the gathered state (the rows cut to each
   bucket's true length, the per-row scalars checked equal) is bitwise the
   same before and after the move, and no residual is dropped;
3. finals: the f32 parameters, gathered state and losses are bitwise those
   of an uninterrupted 8-step run at world 4; the int8 parameters within
   5e-4 of it (the ring requantizes per hop, so the world's size moves its
   rounding), with a live residual;
4. observability: ``hvd_reshard_total{trigger=...}`` ticks once a trigger
   and variant, and ``hvd_reshard_bytes_total{axis="data"}`` carries the
   planner's moved bytes exactly;
5. byte-stable log: losses, digests, the reshard reports and the counters;
   the whole pass runs twice in the job and the two logs must be equal.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np

from .smoke_common import (check, init_worker, launch_workers, main_guard, mlp3, mse,
                           need_ranks, parse_args, tensor_digest, write_result)

D = 16
N_FULL, N_SHRUNK = 4, 2
STEPS_PRE, STEPS_SHRUNK, STEPS_POST = 3, 3, 2
SEED = 23


def build(dev):
    """The reference's parameters and one rank's block (every rank's)."""
    import torch

    rng = np.random.RandomState(SEED)
    model = mlp3(D, dev, rng, 0.3)
    block = tuple(torch.from_numpy(rng.randn(4, D).astype(np.float32)).to(dev)
                  for _ in range(2))
    return model, block


def _step(model, quantized: bool, group=None, state=None):
    import torch

    import horovod_tpu_torch.train as T

    opt = T.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters(), overlap=True, zero1=True,
        quantized=quantized, fusion_threshold_bytes=1, first_bucket_bytes=1, group=group,
        tuned=False)
    if state is not None:
        opt._zero1_state, opt._zero1_shards = state, None
    return T.make_train_step(mse, opt)


def gathered(rows, layout) -> list:
    """The world-shape-free form of a gathered state: every ``[n, k]``
    tensor cut to its bucket's true length, every ``[n]`` row of scalars
    (checked equal) one value."""
    import torch

    out = []
    for g, b, bl in layout.bucket_items():
        nodes = [rows.state[g][b]] + ([{"ef": rows.ef[g][b]}] if rows.ef is not None else [])
        for node in nodes:
            for key in sorted(node):
                v = node[key]
                if not torch.is_tensor(v):
                    out.append(torch.tensor([float(v)]))
                elif v.dim() >= 2:
                    out.append(v.reshape(-1)[:bl.total].cpu())
                elif v.dim() == 1:
                    check(bool((v == v[0]).all()), f"rows diverged in {g}/{b}/{key}")
                    out.append(v[:1].cpu())
                else:
                    out.append(v.reshape(1).cpu())
    return out


def check_parity(before: list, after: list, report: dict, edge: str) -> None:
    """Gate 2 at one edge."""
    import torch

    check(len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after)),
          f"{edge}: the gathered state changed across the reshard")
    check(report["ef_dropped_elements"] == 0, f"{edge}: residual dropped: {report}")


def layout_of(model, quantized: bool):
    """The bucket layout of the model's tree at world 4 (the tree the
    optimizer walks: ``ops/fusion.named_tree``)."""
    from horovod_tpu_torch.ops.fusion import named_tree
    from horovod_tpu_torch.parallel import reshard as R

    return R.zero1_layout_from_params(named_tree(list(model.named_parameters())), N_FULL,
                                      threshold_bytes=1, first_bucket_bytes=1,
                                      quantized=quantized)


def _to(x, dev):
    import torch

    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def run_chaos(hvd, model, block, quantized: bool, sub):
    """One chaos pass; (parameters, gathered state at world 4, events,
    reports) on every rank."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import reshard as R

    r, dev = hvd.rank(), hvd.device()
    layout4 = layout_of(model, quantized)
    layout2 = layout4.relayout(N_SHRUNK)
    events, reports = [], []
    step = _step(model, quantized)
    for i in range(STEPS_PRE):
        events.append({"step": i, "world": N_FULL, "loss": f"{float(step(model, block)):.9e}"})
    rows4 = R.gather_zero1_state(step.optimizer.zero1_state)
    step.close()
    rows2, rep = R.reshard_zero1_state(rows4, N_SHRUNK, layout=layout4, trigger="quarantine")
    check_parity(gathered(rows4, layout4), gathered(rows2, layout2), rep, "quarantine")
    reports.append(rep)
    box = [None]
    if r < N_SHRUNK:
        step = _step(model, quantized, group=sub,
                     state=R.unstack_zero1_states(rows2, ranks=[r])[0])
        for i in range(STEPS_SHRUNK):
            events.append({"step": STEPS_PRE + i, "world": N_SHRUNK,
                           "loss": f"{float(step(model, block)):.9e}"})
        rows2 = R.gather_zero1_state(step.optimizer.zero1_state, group=sub)
        step.close()
        if r == 0:
            box = [_to({"rows": rows2._asdict(), "events": events[STEPS_PRE:],
                        "params": {k: v.detach() for k, v in model.named_parameters()}},
                       "cpu")]
    # The spare promotion: ranks 2-3 take rank 0's rows and parameters.
    dist.broadcast_object_list(box, src=0)
    got = _to(box[0], dev)
    rows2 = R.Zero1Rows(**got["rows"])
    events = events[:STEPS_PRE] + got["events"]
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(got["params"][k])
    rows4, rep = R.reshard_zero1_state(rows2, N_FULL, layout=layout2,
                                       trigger="spare-promotion")
    check_parity(gathered(rows2, layout2), gathered(rows4, layout4), rep, "spare-promotion")
    reports.append(rep)
    step = _step(model, quantized, state=R.unstack_zero1_states(rows4, ranks=[r])[0])
    for i in range(STEPS_POST):
        events.append({"step": STEPS_PRE + STEPS_SHRUNK + i, "world": N_FULL,
                       "loss": f"{float(step(model, block)):.9e}"})
    state = gathered(R.gather_zero1_state(step.optimizer.zero1_state), layout4)
    ef = step.optimizer.zero1_state.ef
    step.close()
    return state, events, reports, ef


def run_reference(model, block, quantized: bool):
    from horovod_tpu_torch.parallel import reshard as R

    layout4 = layout_of(model, quantized)
    step = _step(model, quantized)
    losses = [f"{float(step(model, block)):.9e}"
              for _ in range(STEPS_PRE + STEPS_SHRUNK + STEPS_POST)]
    state = gathered(R.gather_zero1_state(step.optimizer.zero1_state), layout4)
    step.close()
    return state, losses


def run_once(hvd, sub) -> str:
    import torch

    from horovod_tpu_torch import metrics

    metrics.install(True)
    try:
        log, all_reports = {"ranks": N_FULL, "variants": {}}, []
        for name, quantized in (("f32", False), ("int8", True)):
            model, block = build(hvd.device())
            ref = copy.deepcopy(model)
            s_c, events, reports, ef = run_chaos(hvd, model, block, quantized, sub)
            s_r, ref_losses = run_reference(ref, block, quantized)
            all_reports.extend(reports)
            pairs = list(zip(model.parameters(), ref.parameters()))
            if name == "f32":
                check(all(torch.equal(a, b) for a, b in pairs),
                      "f32: the chaos run's parameters are not the uninterrupted run's")
                check(all(torch.equal(a, b) for a, b in zip(s_c, s_r)),
                      "f32: the chaos run's gathered state is not the uninterrupted run's")
                check([e["loss"] for e in events] == ref_losses,
                      f"f32 losses {[e['loss'] for e in events]} != {ref_losses}")
                comparison = "bitwise"
            else:
                worst = max(float((a - b).detach().abs().max()) for a, b in pairs)
                check(worst <= 5e-4, f"int8: parameters {worst} from the uninterrupted run")
                l1 = torch.tensor([sum(float(t.abs().sum()) for g in ef.values()
                                       for t in g.values())])
                check(float(hvd.allreduce(l1, op=hvd.Sum, name=f"reshard.ef.{name}")[0]) > 0,
                      "sharded EF residual stayed zero")
                comparison = "quantization-tolerance"
            log["variants"][name] = {
                "events": events, "comparison": comparison,
                "params_digest": tensor_digest(model.parameters()),
                "state_digest": tensor_digest(s_c),
                "reshards": [{k: rep[k] for k in ("trigger", "n_old", "n_new", "moved_bytes",
                                                  "ef_dropped_elements")} for rep in reports]}
        flat = metrics.flat()
        check_metered(flat, all_reports, 2)
        log["metrics"] = {k: v for k, v in sorted(flat.items()) if k.startswith("hvd_reshard")}
        return json.dumps(log, sort_keys=True)
    finally:
        metrics.install(False)


def check_metered(flat: dict, reports: list, variants: int) -> None:
    """Gate 4."""
    for trig in ("quarantine", "spare-promotion"):
        key = f'hvd_reshard_total{{trigger="{trig}"}}'
        check(flat.get(key) == float(variants), f"{key} = {flat.get(key)}")
    key = 'hvd_reshard_bytes_total{axis="data"}'
    want = float(sum(r["moved_bytes"] for r in reports))
    check(flat.get(key) == want, f"{key} = {flat.get(key)}, the planner moved {want}")


def worker(args) -> int:
    import torch.distributed as dist

    hvd = init_worker(args.device)
    try:
        sub = dist.new_group(list(range(N_SHRUNK)))
        log1, log2 = run_once(hvd, sub), run_once(hvd, sub)
        check(log1 == log2, f"reshard smoke is not byte-stable across runs:\n{log1}\n{log2}")
        if hvd.rank() == 0:
            write_result(args.out, json.loads(log1))
    finally:
        hvd.shutdown()
    return 0


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv, worker=True)
    if args.worker:
        return worker(args)
    code = need_ranks(N_FULL, args.device, "reshard")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        doc = launch_workers("horovod_tpu_torch.tools.reshard_smoke", N_FULL, args.device)
        moved = int(sum(r["moved_bytes"] for v in doc["variants"].values()
                        for r in v["reshards"]))
        print(f"[reshard-smoke] OK in {time.time() - t0:.1f}s: "
              f"{STEPS_PRE + STEPS_SHRUNK + STEPS_POST} zero1 steps x2 variants across a "
              "4->2->4 quarantine/spare chaos path, gather parity bitwise at every edge, f32 "
              "finals bitwise vs uninterrupted reference, int8 within quantization tolerance "
              f"with live EF, 4 reshards metered ({moved} bytes moved), log byte-stable")

    return main_guard("reshard", body)


if __name__ == "__main__":
    sys.exit(main())
