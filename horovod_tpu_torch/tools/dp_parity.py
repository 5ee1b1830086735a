"""Data-parallel parity: n ranks against one process that replays them.

    python -m horovod_tpu_torch.tools.dp_parity --ranks 4                # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --device cpu   # gloo on the CPU
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --model resnet18

Every rank starts from its own random weights, and ``broadcast_parameters``
gives them rank 0's. The ranks then train a small GPT in f32 for a few
steps of ``make_train_step`` (``DistributedOptimizer`` over AdamW, a 1 MiB
fusion threshold so the gradients travel in several buckets), each on its
shard of one global batch. Rank 0 then trains a copy of its initial weights
on the whole batch in one process, with plain AdamW and no collective: the
average over equal shards of the mean-loss gradient is the whole-batch
gradient, so both runs must agree, and every rank must hold the same
parameters. Prints one JSON line from rank 0; exits non-zero on any
disagreement. The ranks rendezvous through a FileStore in a temporary
directory.

``--model resnet18`` holds the CNN step with BatchNorm state: a narrow
ResNet-18 (8 filters) in f32 at 32 px, SGD 0.01 with momentum 0.9. Each
rank also starts from its own running statistics, which
``broadcast_parameters`` must replace with rank 0's. BatchNorm normalises
each rank's shard with that shard's statistics, so n ranks are not one
whole-batch process: rank 0's reference replays the n shards one by one
from the same parameters and statistics, averages their gradients and
their new running statistics, and takes the SGD step. Every rank must
match it at the same tolerances, its running statistics within a hundredth
of the learning rate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .launch import launch_ranks, store_url

DIMS = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, max_len=256)
PER_RANK_BATCH, SEQ, STEPS, LR = 2, 256, 3, 3e-4
CNN_BATCH, CNN_SIDE, CNN_CLASSES, CNN_LR = 4, 32, 10, 0.01


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _judge(result, same, loss_rel, param_err, share, lr, extra_ok=True) -> None:
    """Print rank 0's JSON line and fail on any disagreement (the tolerance
    of tests/test_torch_train.py, with its reasons)."""
    print(json.dumps(result), flush=True)
    ok = (same and loss_rel <= 1e-5 and param_err <= 2 * lr * STEPS and share <= 1e-4
          and extra_ok)
    if not ok:
        raise SystemExit("data-parallel run disagrees with its one-process reference")


def _cnn_worker(device) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet18

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        r, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        model = ResNet18(num_classes=CNN_CLASSES, num_filters=8, dtype=torch.float32,
                         device=dev, seed=r)
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.fill_(0.1 * r if name.endswith("mean") else 1.0 + 0.1 * r)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=CNN_LR, momentum=0.9),
            named_parameters=model.named_parameters(), fusion_threshold_bytes=1 << 18)
        rng = np.random.RandomState(0)
        images = torch.from_numpy(rng.randn(n * CNN_BATCH, CNN_SIDE, CNN_SIDE, 3)
                                  .astype(np.float32)).to(dev)
        labels = torch.from_numpy(rng.randint(0, CNN_CLASSES, n * CNN_BATCH)).to(dev)
        shards = [slice(s * CNN_BATCH, (s + 1) * CNN_BATCH) for s in range(n)]
        step = hvd.make_train_step(lambda m, b: F.cross_entropy(m(b[0]), b[1]), opt)
        losses = [float(step(model, (images[shards[r]], labels[shards[r]])))
                  for _ in range(STEPS)]

        flat = _flat(model.state_dict().values())
        gathered = hvd.allgather(flat[None])
        same = bool((gathered == gathered[0]).all())
        if r != 0:
            if not same:
                raise SystemExit("ranks hold different parameters or statistics")
            return

        ref = ResNet18(num_classes=CNN_CLASSES, num_filters=8, dtype=torch.float32,
                       device=dev, seed=0)
        ref.load_state_dict(initial)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=CNN_LR, momentum=0.9)
        buffers = dict(ref.named_buffers())
        ref_losses = []
        for _ in range(STEPS):
            ref_opt.zero_grad()
            start = {k: v.clone() for k, v in buffers.items()}
            new = {k: torch.zeros_like(v) for k, v in buffers.items()}
            shard_losses = []
            for sl in shards:
                for k, v in buffers.items():
                    v.copy_(start[k])
                loss = F.cross_entropy(ref(images[sl]), labels[sl])
                (loss / n).backward()
                shard_losses.append(loss.item())
                for k, v in buffers.items():
                    new[k] += v / n
            for k, v in buffers.items():
                v.copy_(new[k])
            ref_opt.step()
            ref_losses.append(sum(shard_losses) / n)
        params = [p for _, p in sorted(model.named_parameters())]
        ref_params = [p for _, p in sorted(ref.named_parameters())]
        diff = (_flat(params) - _flat(ref_params)).abs()
        stats_err = float((_flat(b for _, b in sorted(model.named_buffers()))
                           - _flat(b for _, b in sorted(ref.named_buffers()))).abs().max())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        result = {
            "model": "resnet18", "ranks": n, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "losses": losses, "replayed_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
            "share_beyond_1pct_step": float((diff > CNN_LR / 100).float().mean()),
            "max_stats_abs_err": stats_err,
            "stats_moved": bool(any((b - initial[k]).abs().max() > 0
                                    for k, b in model.named_buffers())),
            "ranks_identical": same,
        }
        _judge(result, same, loss_rel, result["max_param_abs_err"],
               result["share_beyond_1pct_step"], CNN_LR,
               extra_ok=stats_err <= CNN_LR / 100 and result["stats_moved"])
    finally:
        hvd.shutdown()


def _worker(device) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        r, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        model = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=r)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8),
            named_parameters=model.named_parameters(), fusion_threshold_bytes=1 << 20)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        rng = np.random.RandomState(0)
        tokens, labels = (torch.from_numpy(rng.randint(0, DIMS["vocab_size"],
                                                       (n * PER_RANK_BATCH, SEQ))).to(dev)
                          for _ in range(2))
        shard = slice(r * PER_RANK_BATCH, (r + 1) * PER_RANK_BATCH)
        step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
        losses = [float(step(model, (tokens[shard], labels[shard]))) for _ in range(STEPS)]

        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        gathered = hvd.allgather(flat[None])
        same = bool((gathered == gathered[0]).all())
        if r != 0:
            if not same:
                raise SystemExit("ranks hold different parameters")
            return

        ref = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0)
        ref.load_state_dict(initial)
        ref_opt = torch.optim.AdamW(ref.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
        ref_losses = []
        for _ in range(STEPS):
            ref_opt.zero_grad()
            loss = lm_loss(ref(tokens), labels)
            loss.backward()
            ref_opt.step()
            ref_losses.append(loss.item())
        ref_flat = torch.cat([p.detach().reshape(-1) for p in ref.parameters()])
        diff = (flat - ref_flat).abs()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        result = {
            "ranks": n, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "losses": losses, "whole_batch_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
            "share_beyond_1pct_step": float((diff > LR / 100).float().mean()),
            "ranks_identical": same,
        }
        _judge(result, same, loss_rel, result["max_param_abs_err"],
               result["share_beyond_1pct_step"], LR)
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--model", default="gpt", choices=["gpt", "resnet18"])
    args = ap.parse_args()
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.dp_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda",
                             "--model", args.model],
                            args.ranks)
    (_cnn_worker if args.model == "resnet18" else _worker)(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
