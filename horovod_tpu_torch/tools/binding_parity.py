"""Torch-binding parity: n ranks of ``horovod_tpu_torch.torch`` against one
process on the whole batch.

    python -m horovod_tpu_torch.tools.binding_parity --ranks 4                # a GPU per rank
    python -m horovod_tpu_torch.tools.binding_parity --ranks 4 --device cpu   # gloo on the CPU
    python -m horovod_tpu_torch.tools.binding_parity --ranks 4 --bench

Each rank trains on its shard of one global batch made from one seed; rank
0 then replays the whole batch in one process, with the plain optimizer
and no collective, and every rank's results are held to it (f32, TF32
off):

 - the hook-driven ``DistributedOptimizer`` (AdamW, weight decay 1e-4) on a
   small GPT, ranks starting from their own weights that
   ``broadcast_parameters`` replaces with rank 0's, after
   ``broadcast_optimizer_state`` (whose dummy step on zero gradients the
   replay starts after): the rank-averaged loss at 1e-6 relative, the
   parameters within twice the learning rate times the steps and at most
   1e-4 of them beyond 1% of a step (``dp_parity``'s tolerance), every rank
   identical;
 - the delta-space Adasum optimizer (SGD with momentum, 2 steps): the
   replay steps one optimizer a shard and combines each parameter's deltas
   by ``ops.adasum.adasum_allreduce_reference`` (float64): the shard losses
   at 1e-6 relative, the parameters at rtol 1e-5 / atol 1e-6. The eager
   Adasum of a fused plan combines the plan's flat buffer, as the JAX
   executor does, so this case runs with fusion off
   (``fusion_threshold_bytes=0``), where every parameter travels alone;
 - ``SyncBatchNorm`` (2 steps, then eval) against ``nn.BatchNorm2d`` on the
   whole batch: each rank's rows of the output at rtol 1e-4 / atol 1e-5, of
   dx at 1e-3 / 1e-4, dweight and dbias summed over the ranks at 1e-4 /
   1e-3, the running statistics at 1e-5 / 1e-5 and the eval output at 1e-4
   / 1e-5;
 - ``sparse_as_dense`` (an ``nn.Embedding(sparse=True)``, SGD, 3 steps): the
   rank-averaged loss at 1e-6 relative, the table at atol 1e-6.

Every rank prints its checks; rank 0 prints one JSON line. Any disagreement
exits non-zero.

``--bench`` times, at GPT-2-small (bf16, 8 x 1024 a rank, AdamW 3e-4), the
hook-driven step against ``make_train_step``'s post-hoc step in turns, with
the hook-driven step split into forward + backward (with the enqueues in
the hooks) and ``step()`` (with its synchronize), and the core's plans a
step; then ResNet-50 at 32 x 224² a rank through the binding with every
BatchNorm a ``SyncBatchNorm`` against plain BatchNorm, in turns. Every
rank's medians, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

import numpy as np

from .eager_parity import _card
from .launch import launch_ranks, store_url

DIMS = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, max_len=256)
PER_RANK_BATCH, SEQ, STEPS, LR = 2, 256, 3, 3e-4
BN_SHAPE = (4, 16, 8, 8)         # a rank's rows of the SyncBatchNorm batch
EMB_ROWS, EMB_DIM, EMB_TOKENS = 1000, 64, 64
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP, BENCH_STEPS = 8, 1024, 2, 8
CNN_BATCH, CNN_SIDE, CNN_CLASSES = 32, 224, 1000


def sync_bn_resnet(model, cls=None) -> int:
    """Replace every BatchNorm of a port CNN (``models/layers.BatchNorm``)
    by a ``SyncBatchNorm`` (or ``cls``) with its scale, bias and running
    statistics (flax's momentum 0.9 is torch's 0.1); returns how many."""
    import torch

    from ..models.layers import BatchNorm
    from ..torch import SyncBatchNorm

    cls = cls or SyncBatchNorm
    count = 0
    for mod in list(model.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, BatchNorm):
                bn = cls(child.scale.numel(), eps=child.epsilon, momentum=1 - child.momentum,
                         device=child.scale.device)
                with torch.no_grad():
                    bn.weight.copy_(child.scale)
                    bn.bias.copy_(child.bias)
                    bn.running_mean.copy_(child.mean)
                    bn.running_var.copy_(child.var)
                setattr(mod, name, bn)
                count += 1
    return count


class _Checks:
    def __init__(self, rank: int):
        self.rank, self.results = rank, []

    def add(self, what: str, ok: bool, detail: str) -> None:
        self.results.append({"check": what, "ok": bool(ok), "detail": detail})
        print(f"[binding_parity] rank {self.rank} {what}: {'ok' if ok else 'FAIL'} ({detail})",
              flush=True)

    def close(self, what, got, want, rtol, atol) -> float:
        got, want = got.detach().double().cpu(), want.detach().double().cpu()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ok = got.shape == want.shape and bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        self.add(what, ok, f"max abs err {err:.3e}, rtol {rtol} / atol {atol}")
        return err

    def rel(self, what, got, want, limit) -> float:
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        self.add(what, err <= limit, f"max rel err {err:.3e}, limit {limit}")
        return err


def _identical(hvd, c: _Checks, what: str, params) -> None:
    import torch

    flat = torch.cat([p.detach().reshape(-1) for p in params])
    gathered = hvd.allgather(flat[None], name=f"parity.same.{what}")
    c.add(f"{what}: ranks identical", bool((gathered == gathered[0]).all()),
          f"{flat.numel()} parameters")


def _optimizer_case(hvd, c: _Checks, dev, n: int, r: int) -> None:
    import torch

    from ..models.transformer import TransformerLM, lm_loss

    model = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=r)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8),
        named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    start_opt = copy.deepcopy(opt.state_dict())
    rng = np.random.RandomState(0)
    tokens, labels = (torch.from_numpy(rng.randint(0, DIMS["vocab_size"],
                                                   (n * PER_RANK_BATCH, SEQ))).to(dev)
                      for _ in range(2))
    shard = slice(r * PER_RANK_BATCH, (r + 1) * PER_RANK_BATCH)
    losses = []
    for s in range(STEPS):
        opt.zero_grad()
        loss = lm_loss(model(tokens[shard]), labels[shard])
        loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach(), name=f"parity.opt.loss{s}")))
    _identical(hvd, c, "optimizer", model.parameters())
    ref = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0)
    ref.load_state_dict(start)
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
    ref_opt.load_state_dict(start_opt)
    ref_losses = []
    for _ in range(STEPS):
        ref_opt.zero_grad()
        loss = lm_loss(ref(tokens), labels)
        loss.backward()
        ref_opt.step()
        ref_losses.append(loss.item())
    c.rel("optimizer loss", losses, ref_losses, 1e-6)
    diff = torch.cat([(p - q).detach().reshape(-1).abs()
                      for p, q in zip(model.parameters(), ref.parameters())])
    share = float((diff > LR / 100).float().mean())
    c.add("optimizer parameters", float(diff.max()) <= 2 * LR * STEPS and share <= 1e-4,
          f"max abs err {float(diff.max()):.3e} (limit {2 * LR * STEPS:g}), share beyond 1% "
          f"of a step {share:.2e} (limit 1e-4)")


def _adasum_case(hvd, c: _Checks, dev, n: int, r: int) -> None:
    import torch

    from ..models.transformer import TransformerLM, lm_loss
    from ..ops.adasum import adasum_allreduce_reference

    model = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=1)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
                                   named_parameters=model.named_parameters(), op=hvd.Adasum)
    rng = np.random.RandomState(1)
    tokens, labels = (torch.from_numpy(rng.randint(0, DIMS["vocab_size"],
                                                   (n * PER_RANK_BATCH, SEQ))).to(dev)
                      for _ in range(2))
    rows = [slice(q * PER_RANK_BATCH, (q + 1) * PER_RANK_BATCH) for q in range(n)]
    losses = []
    for _ in range(2):
        opt.zero_grad()
        loss = lm_loss(model(tokens[rows[r]]), labels[rows[r]])
        loss.backward()
        opt.step()
        losses.append(loss.item())
    _identical(hvd, c, "adasum", model.parameters())
    # The replay: one model and optimizer a shard, each step from the
    # combined parameters; the deltas combined parameter by parameter.
    replicas = []
    for _ in range(n):
        m = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=1)
        m.load_state_dict(start)
        replicas.append((m, torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)))
    ref_losses = []
    for _ in range(2):
        starts = [p.detach().clone() for p in replicas[0][0].parameters()]
        deltas = []
        for q, (m, o) in enumerate(replicas):
            o.zero_grad()
            loss = lm_loss(m(tokens[rows[q]]), labels[rows[q]])
            loss.backward()
            o.step()
            if q == r:
                ref_losses.append(loss.item())
            deltas.append([(p.detach() - s).cpu().numpy() for p, s in zip(m.parameters(), starts)])
        with torch.no_grad():
            for i, s in enumerate(starts):
                combined = torch.from_numpy(adasum_allreduce_reference(
                    [d[i] for d in deltas])).to(s.dtype).to(dev)
                for m, _ in replicas:
                    list(m.parameters())[i].copy_(s + combined)
    c.rel("adasum shard loss", losses, ref_losses, 1e-6)
    c.close("adasum parameters", torch.cat([p.reshape(-1) for p in model.parameters()]),
            torch.cat([q.reshape(-1) for q in replicas[0][0].parameters()]), 1e-5, 1e-6)


def _sync_bn_case(hvd, c: _Checks, dev, n: int, r: int) -> None:
    import torch

    gen = np.random.RandomState(2)
    shape = (n * BN_SHAPE[0],) + BN_SHAPE[1:]
    xg = torch.from_numpy((gen.randn(*shape) * 2 + 0.5).astype(np.float32)).to(dev)
    dyg = torch.from_numpy(gen.randn(*shape).astype(np.float32)).to(dev)
    w = torch.from_numpy((gen.rand(BN_SHAPE[1]) + 0.5).astype(np.float32)).to(dev)
    b = torch.from_numpy(gen.randn(BN_SHAPE[1]).astype(np.float32)).to(dev)
    rows = slice(r * BN_SHAPE[0], (r + 1) * BN_SHAPE[0])
    sbn = hvd.SyncBatchNorm(BN_SHAPE[1], eps=1e-5, momentum=0.1, device=dev)
    ref = torch.nn.BatchNorm2d(BN_SHAPE[1], eps=1e-5, momentum=0.1, device=dev)
    for m in (sbn, ref):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    for _ in range(2):
        x = xg[rows].clone().requires_grad_(True)
        y = sbn(x)
        y.backward(dyg[rows])
        xr = xg.clone().requires_grad_(True)
        yr = ref(xr)
        yr.backward(dyg)
    c.close("SyncBatchNorm output", y, yr[rows], 1e-4, 1e-5)
    c.close("SyncBatchNorm dx", x.grad, xr.grad[rows], 1e-3, 1e-4)
    dw = hvd.allreduce(sbn.weight.grad, op=hvd.Sum, name="parity.bn.dw")
    db = hvd.allreduce(sbn.bias.grad, op=hvd.Sum, name="parity.bn.db")
    c.close("SyncBatchNorm dweight (summed over ranks)", dw, ref.weight.grad, 1e-4, 1e-3)
    c.close("SyncBatchNorm dbias (summed over ranks)", db, ref.bias.grad, 1e-4, 1e-3)
    c.close("SyncBatchNorm running mean", sbn.running_mean, ref.running_mean, 1e-5, 1e-5)
    c.close("SyncBatchNorm running var", sbn.running_var, ref.running_var, 1e-5, 1e-5)
    sbn.eval()
    ref.eval()
    c.close("SyncBatchNorm eval output", sbn(xg[rows]), ref(xg)[rows], 1e-4, 1e-5)


def _sparse_case(hvd, c: _Checks, dev, n: int, r: int) -> None:
    import torch

    def table():
        torch.manual_seed(3)
        return torch.nn.Embedding(EMB_ROWS, EMB_DIM, sparse=True).to(dev)

    emb, ref = table(), table()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.5),
                                   named_parameters=emb.named_parameters(), sparse_as_dense=True)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.5)
    idx = torch.from_numpy(np.random.RandomState(3).randint(
        0, EMB_ROWS // 4, (n * EMB_TOKENS,))).to(dev)
    rows = slice(r * EMB_TOKENS, (r + 1) * EMB_TOKENS)
    losses, ref_losses = [], []
    for s in range(3):
        opt.zero_grad()
        loss = emb(idx[rows]).square().mean()
        loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach(), name=f"parity.sparse.loss{s}")))
        ref_opt.zero_grad()
        loss = ref(idx).square().mean()
        loss.backward()
        ref_opt.step()
        ref_losses.append(loss.item())
    c.add("sparse_as_dense: dense gradient", not emb.weight.grad.is_sparse,
          f"layout {emb.weight.grad.layout}")
    c.rel("sparse_as_dense loss", losses, ref_losses, 1e-6)
    c.close("sparse_as_dense table", emb.weight, ref.weight, 0.0, 1e-6)
    _identical(hvd, c, "sparse_as_dense", emb.parameters())


def _worker(device: str) -> int:
    import torch

    from .. import torch as hvd
    from ..common.basics import device as bound_device
    from ..common.env import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, r = int(os.environ["HOROVOD_SIZE"]), int(os.environ["HOROVOD_RANK"])
    t0 = time.perf_counter()
    c = _Checks(r)
    hvd.init(device, init_method=store_url())
    try:
        dev = bound_device()
        _optimizer_case(hvd, c, dev, n, r)
        _sync_bn_case(hvd, c, dev, n, r)
        _sparse_case(hvd, c, dev, n, r)
    finally:
        hvd.shutdown()
    # The eager Adasum of a fused plan combines the plan's flat buffer (as
    # the JAX executor's _reduce_flat does), so the per-parameter reference
    # holds where every tensor travels alone: fusion off.
    cfg = Config.from_env()
    cfg.fusion_threshold_bytes = 0
    hvd.init(device, init_method=store_url() + "_adasum", config=cfg)
    try:
        _adasum_case(hvd, c, dev, n, r)
        failures = hvd.allgather_object(sum(not x["ok"] for x in c.results), name="parity.fail")
        if r == 0:
            print(json.dumps({"binding_parity": "ok" if not any(failures) else "failed",
                              "ranks": n, "device": dev.type, "card": _card(dev),
                              "checks_by_rank": len(c.results), "failures_by_rank": failures,
                              "rank0": c.results,
                              "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    finally:
        hvd.shutdown()
    return 1 if any(failures) else 0


def _bench_gpt(hvd, dev, r: int) -> dict:
    """The hook-driven step against make_train_step, in turns."""
    import torch

    import horovod_tpu_torch as port
    from ..common import basics
    from ..models.transformer import TransformerLM, lm_loss

    on_card = dev.type == "cuda"
    dims, batch, seq = ((GPT2_SMALL, BENCH_BATCH, BENCH_SEQ) if on_card
                        else (DIMS, PER_RANK_BATCH, SEQ))
    rng = np.random.RandomState(r)
    tokens, labels = (torch.from_numpy(rng.randint(0, dims["vocab_size"], (batch, seq)))
                      .to(dev) for _ in range(2))

    def adamw(m):
        return torch.optim.AdamW(m.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    mb = TransformerLM(**dims, dtype=torch.bfloat16, device=dev, seed=0)
    bopt = hvd.DistributedOptimizer(adamw(mb), named_parameters=mb.named_parameters())
    mt = TransformerLM(**dims, dtype=torch.bfloat16, device=dev, seed=0)
    tstep = port.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), port.DistributedOptimizer(
        adamw(mt), named_parameters=mt.named_parameters()))
    spent = {"enqueue": 0.0, "synchronize": 0.0}

    def timed(fn, key):
        def wrapper(*args):
            t0 = time.perf_counter()
            fn(*args)
            spent[key] += time.perf_counter() - t0
        return wrapper

    bopt._allreduce_grad_async = timed(bopt._allreduce_grad_async, "enqueue")
    bopt.synchronize = timed(bopt.synchronize, "synchronize")
    ex = basics._runtime.eager.executor
    plans, orig = [], ex.execute

    def spy(plan, entries, topo):
        plans.append(len(plan["names"]))
        return orig(plan, entries, topo)

    ex.execute = spy
    rows = {"binding": [], "make_train_step": []}
    losses = []
    try:
        for i in range(BENCH_WARMUP + BENCH_STEPS):
            for kind in ("binding", "make_train_step") if i % 2 == 0 else \
                    ("make_train_step", "binding"):
                sync()
                hvd.barrier()
                if kind == "make_train_step":
                    t0 = time.perf_counter()
                    tstep(mt, (tokens, labels))
                    sync()
                    rows[kind].append({"step": time.perf_counter() - t0})
                    continue
                plans.clear()
                spent.update(enqueue=0.0, synchronize=0.0)
                t0 = time.perf_counter()
                bopt.zero_grad()
                loss = lm_loss(mb(tokens), labels)
                loss.backward()
                t1 = time.perf_counter()
                bopt.step()
                t2 = time.perf_counter()
                sync()
                t3 = time.perf_counter()
                losses.append(loss.item())
                rows[kind].append({"step": t3 - t0, "backward": t1 - t0,
                                   "enqueue": spent["enqueue"], "step()": t2 - t1,
                                   "synchronize": spent["synchronize"], "drain": t3 - t2,
                                   "plans": len(plans)})
    finally:
        ex.execute = orig
    if not all(np.isfinite(losses)):
        raise SystemExit(f"rank {r}: non-finite GPT loss {losses}")

    def med(kind, key, scale=1e3):
        return round(statistics.median(x[key] for x in rows[kind][BENCH_WARMUP:]) * scale, 3)

    return {"binding_ms": med("binding", "step"),
            "make_train_step_ms": med("make_train_step", "step"),
            "backward_ms": med("binding", "backward"), "enqueue_ms": med("binding", "enqueue"),
            "step_call_ms": med("binding", "step()"),
            "synchronize_ms": med("binding", "synchronize"),
            "drain_ms": med("binding", "drain"),
            "plans_per_step": [x["plans"] for x in rows["binding"]],
            "losses_first_last": [losses[0], losses[-1]]}


def _bench_cnn(hvd, dev, r: int) -> dict:
    """ResNet-50 through the binding, every BN a SyncBatchNorm against plain
    BN, in turns."""
    import torch
    import torch.nn.functional as F

    from ..models import get_model

    on_card = dev.type == "cuda"
    name, batch, side, classes = (("resnet50", CNN_BATCH, CNN_SIDE, CNN_CLASSES) if on_card
                                  else ("resnet18", 2, 32, 10))
    if on_card:
        torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(r)
    images = torch.from_numpy(rng.randn(batch, side, side, 3).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.randint(0, classes, batch)).to(dev)

    def build(sync_bn):
        m = get_model(name, num_classes=classes, seed=0, device=dev)
        count = sync_bn_resnet(m) if sync_bn else 0
        o = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
                                     named_parameters=m.named_parameters())

        def step():
            o.zero_grad()
            loss = F.cross_entropy(m(images), target)
            loss.backward()
            o.step()
            return loss.item()

        return step, count

    steps = {"sync": build(True), "plain": build(False)}
    times = {"sync": [], "plain": []}
    for i in range(BENCH_WARMUP + BENCH_STEPS // 2):
        for kind in ("sync", "plain") if i % 2 == 0 else ("plain", "sync"):
            if on_card:
                torch.cuda.synchronize(dev)
            hvd.barrier()
            t0 = time.perf_counter()
            loss = steps[kind][0]()
            if on_card:
                torch.cuda.synchronize(dev)
            times[kind].append(time.perf_counter() - t0)
            if not np.isfinite(loss):
                raise SystemExit(f"rank {r}: non-finite {kind} {name} loss")
    torch.backends.cudnn.benchmark = False
    med = {k: round(statistics.median(v[BENCH_WARMUP:]) * 1e3, 3) for k, v in times.items()}
    return {"model": name, "batch": batch, "sync_bn_layers": steps["sync"][1],
            "sync_bn_ms": med["sync"], "plain_bn_ms": med["plain"]}


def _bench_worker(device: str) -> int:
    from .. import torch as hvd
    from ..common.basics import device as bound_device

    n, r = int(os.environ["HOROVOD_SIZE"]), int(os.environ["HOROVOD_RANK"])
    hvd.init(device, init_method=store_url())
    try:
        dev = bound_device()
        row = {"rank": r}
        row.update(_bench_gpt(hvd, dev, r))
        row.update(_bench_cnn(hvd, dev, r))
        rows = hvd.allgather_object(row, name="parity.bench")
        if r == 0:
            print(json.dumps({"binding_bench": "hook-driven DistributedOptimizer vs "
                              "make_train_step; SyncBatchNorm vs BatchNorm; in turns",
                              "ranks": n, "card": _card(dev),
                              "gpt": "GPT-2-small bf16 8 x 1024 a rank" if dev.type == "cuda"
                              else "parity GPT", "timed_steps": BENCH_STEPS,
                              "by_rank": rows}), flush=True)
    finally:
        hvd.shutdown()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--bench", action="store_true",
                    help="time the hook-driven step and SyncBatchNorm instead")
    args = ap.parse_args()
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.binding_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda"]
                            + (["--bench"] if args.bench else []), args.ranks)
    return (_bench_worker if args.bench else _worker)(args.device or "cuda")


if __name__ == "__main__":
    sys.exit(main())
