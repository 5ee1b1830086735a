"""Streamed-ZeRO-1 smoke: the streamed sharded step against the post-hoc
one and against plain data parallelism, its sharded state, a shard-aware
digest and a byte-stable log. Budget: under 15 s on the CPU.

    python -m horovod_tpu_torch.tools.zero_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.zero_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/zero_smoke.py``, on 2 ranks (one process a
rank): the reference's 3-layer tanh MLP (D 16, seed 11), SGD 0.05 with
momentum 0.9, per-leaf buckets, rank r on rows 4r..4r+3, 4 steps.

1. streamed ZeRO-1 with the int8 wire: ``DistributedOptimizer(overlap=True,
   zero1=True, quantized=True)``, each bucket reduce-scattered over the int8
   ring inside the backward, the sharded error-feedback residual in its
   ``zero1_state``;
2. the same trajectory post hoc (``zero1=True, quantized=True`` without
   ``overlap``: ``parallel/zero.zero1_posthoc_reduce``) matches it bitwise,
   losses, parameters and residuals, and the residual is live; the f32
   streamed ZeRO-1 step tracks the plain replicated DP step within rtol
   2e-6, atol 1e-7 (the gathered reference);
3. the state is sharded: each of at least 3 bucket states holds one
   rank's shard (the reference's ``[n_shards, k]`` rows; a torch rank holds
   its own row, ``k = ops/fusion.zero1_shard_len`` elements), the residual
   is live over all ranks' rows, and the guard's digest
   (``guard/digest.strip_rank_local``) sees two intentionally different
   shard states as equal;
4. byte-stable log: losses, parameter and residual digests and the state
   count, serialized; the job runs twice and the two logs must be equal.
"""

from __future__ import annotations

import copy
import json
import sys
import time

from .quant_smoke import D, build  # noqa: F401  (D: the width it builds)
from .smoke_common import (check, init_worker, launch_workers, main_guard, mse, need_ranks,
                           parse_args, tensor_digest, write_result)

STEPS = 4
RANKS = 2
SEED = 11


def _step(model, **kw):
    import torch

    import horovod_tpu_torch.train as T

    opt = T.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters(), fusion_threshold_bytes=1,
        first_bucket_bytes=1, tuned=False, **kw)
    return T.make_train_step(mse, opt)


def ef_tensors(state):
    return [t for g in sorted(state.ef) for _, t in sorted(state.ef[g].items())]


def check_sharded(state, n: int, leaf_sizes, quantized: bool = True) -> int:
    """Gate 3's layout half: one bucket state a leaf (per-leaf buckets),
    each this rank's shard of ``ops/fusion.zero1_shard_len`` elements (the
    bucket's 1/n, rounded up to whole scale blocks on the int8 wire).
    Returns the number of bucket states."""
    from horovod_tpu_torch.ops.fusion import zero1_shard_len

    shards = [t for g in sorted(state.shards) for _, t in sorted(state.shards[g].items())]
    check(all(t.dim() == 1 for t in shards), f"shards of shapes {[t.shape for t in shards]}")
    want = sorted(zero1_shard_len(k, n, quantized) for k in leaf_sizes)
    check(sorted(t.numel() for t in shards) == want,
          f"shard lengths {sorted(t.numel() for t in shards)} != {want} at {n} ranks")
    check(len(shards) >= 3, f"{len(shards)} bucket states")
    return len(shards)


def check_digest_shard_aware(state) -> None:
    """Gate 3's digest half: the same state with every shard row and
    residual moved (in place, then put back) digests equal."""
    import torch

    from horovod_tpu_torch.guard.digest import strip_rank_local, tree_digest

    rows = [t for g in state.shards.values() for t in g.values()] + ef_tensors(state)
    before = tree_digest(strip_rank_local(state))
    saved = [t.detach().clone() for t in rows]
    with torch.no_grad():
        for t in rows:
            t.add_(1.0)
        moved = tree_digest(strip_rank_local(state))
        for t, s in zip(rows, saved):
            t.copy_(s)
    check(before == moved, "zero1 sharded state reached the cross-rank digest")


def worker(args) -> int:
    hvd = init_worker(args.device)
    try:
        logs = [run_once(hvd) for _ in range(2)]
        check(logs[0] == logs[1], f"zero1 smoke is not byte-stable across runs:\n{logs}")
        if hvd.rank() == 0:
            write_result(args.out, json.loads(logs[0]))
    finally:
        hvd.shutdown()
    return 0


def run_once(hvd) -> str:
    """One pass on an initialized job: the normalized log."""
    import torch

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    model, (x, y) = build(dev, SEED)
    rows = slice(4 * r, 4 * r + 4)
    batch = (x[rows], y[rows])
    models = {k: copy.deepcopy(model) for k in ("stream", "posthoc", "f32", "dp")}
    steps = {"stream": _step(models["stream"], overlap=True, zero1=True, quantized=True),
             "posthoc": _step(models["posthoc"], zero1=True, quantized=True),
             "f32": _step(models["f32"], overlap=True, zero1=True),
             "dp": _step(models["dp"])}
    events = []
    for i in range(STEPS):
        losses = {k: float(steps[k](models[k], batch)) for k in steps}
        check(losses["stream"] == losses["posthoc"],
              f"step {i}: streamed loss {losses['stream']} != posthoc {losses['posthoc']}")
        events.append({"step": i, "loss": f"{losses['stream']:.9e}"})
    for a, b in zip(models["stream"].parameters(), models["posthoc"].parameters()):
        check(torch.equal(a, b), "streamed and posthoc zero1 parameters differ")
    s_state = steps["stream"].optimizer.zero1_state
    p_state = steps["posthoc"].optimizer.zero1_state
    for a, b in zip(ef_tensors(s_state), ef_tensors(p_state)):
        check(torch.equal(a, b), "streamed and posthoc zero1 residuals differ")
    # Over every rank's rows, as the reference sums its [n_shards, k]
    # residual: a rank may hold only padding of a small bucket.
    l1 = torch.tensor([sum(float(e.abs().sum()) for e in ef_tensors(s_state))])
    check(float(hvd.allreduce(l1, op=hvd.Sum, name="zero_smoke.ef_l1")[0]) > 0,
          "sharded EF residual stayed zero: EF dead")
    for a, b in zip(models["f32"].parameters(), models["dp"].parameters()):
        check(torch.allclose(a, b, rtol=2e-6, atol=1e-7),
              f"f32 zero1 left plain DP by {float((a - b).detach().abs().max())}")
    count = check_sharded(s_state, n, [p.numel() for p in model.parameters()])
    check_digest_shard_aware(s_state)
    log = {"events": events, "params_digest": tensor_digest(models["stream"].parameters()),
           "ef_digest": tensor_digest(ef_tensors(s_state)), "bucket_states": count,
           "ranks": n}
    return json.dumps(log, sort_keys=True)


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv, worker=True)
    if args.worker:
        return worker(args)
    code = need_ranks(RANKS, args.device, "zero")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        doc = launch_workers("horovod_tpu_torch.tools.zero_smoke", RANKS, args.device)
        print(f"[zero-smoke] OK in {time.time() - t0:.1f}s: {STEPS} streamed==posthoc zero1 "
              f"steps bitwise, f32 zero1 tracks DP, {doc['bucket_states']} sharded bucket "
              "states, EF sharded+live, digest shard-aware, log byte-stable")

    return main_guard("zero", body)


if __name__ == "__main__":
    sys.exit(main())
