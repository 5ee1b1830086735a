"""Data-parallel parity: n ranks against one process with the whole batch.

    python -m horovod_tpu_torch.tools.dp_parity --ranks 4                # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --device cpu   # gloo on the CPU

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .launch import launch_ranks, store_url

DIMS = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, max_len=256)
PER_RANK_BATCH, SEQ, STEPS, LR = 2, 256, 3, 3e-4


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
        print(json.dumps(result), flush=True)
        # The tolerance of tests/test_torch_train.py, with its reasons.
        ok = (same and loss_rel <= 1e-5 and result["max_param_abs_err"] <= 2 * LR * STEPS
              and result["share_beyond_1pct_step"] <= 1e-4)
        if not ok:
            raise SystemExit("data-parallel run disagrees with the whole-batch run")
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = ap.parse_args()
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.dp_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda"],
                            args.ranks)
    _worker(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
