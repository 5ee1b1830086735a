"""Sequence-parallel parity: a DP×SP mesh of n ranks against one process.

    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 2               # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 4
    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 2 --device cpu  # gloo on the CPU

The ranks form a ``{"data": ranks / seq, "seq": seq}`` mesh and train a
small f32 GPT whose attention is ``ring_attention`` over the ``seq`` group
(kernel B2 on the card), for 3 steps of ``make_sp_train_step`` under SGD
0.1 on one global batch: each rank takes its ``[B/data, T/seq]`` shard.
Rank 0 then trains a copy of the same initial weights on the whole batch in
one process, with dense attention (``reference_attention``) and plain SGD.
The mean of the shards' mean losses is the whole batch's, so both runs must
agree, at the tolerances of tests/test_sp_training.py: losses rtol 1e-4,
parameters rtol 2e-3 / atol 2e-5; and every rank must hold the same
parameters. Prints one JSON line from rank 0; exits non-zero on any
disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial

from .launch import launch_ranks, store_url

# The head dim (32) and the local lengths (256 / seq) are ones the kernels take.
DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=256)
BATCH, SEQ, STEPS, LR = 4, 256, 3, 0.1
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-3, 2e-5


def _worker(device, seq: int) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention, reference_attention
    from horovod_tpu_torch.parallel.sp import make_sp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        r, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        mesh = build_mesh({"data": n // seq, "seq": seq})
        model = TransformerLM(
            **DIMS, dtype=torch.float32, device=dev, seed=0,
            attn_fn=partial(ring_attention, group=mesh.get_group("seq"), causal=True))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        rng = np.random.RandomState(0)
        tokens = torch.from_numpy(rng.randint(0, DIMS["vocab_size"], (BATCH, SEQ))).to(dev)
        labels = torch.roll(tokens, -1, dims=1)
        step = make_sp_train_step(
            lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
            torch.optim.SGD(model.parameters(), lr=LR), mesh)
        fa.BLOCK_LAUNCHES = 0
        losses = [float(step(model, tokens, labels)) for _ in range(STEPS)]
        launches = fa.BLOCK_LAUNCHES

        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        gathered = hvd.allgather(flat[None])
        same = bool((gathered == gathered[0]).all())
        if r != 0:
            if not same:
                raise SystemExit("ranks hold different parameters")
            return

        ref = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0,
                            attn_fn=partial(reference_attention, causal=True))
        ref.load_state_dict(initial)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=LR)
        ref_losses = []
        for _ in range(STEPS):
            ref_opt.zero_grad()
            loss = lm_loss(ref(tokens), labels)
            loss.backward()
            ref_opt.step()
            ref_losses.append(loss.item())
        ref_flat = torch.cat([p.detach().reshape(-1) for p in ref.parameters()])
        diff = (flat - ref_flat).abs()
        excess = diff - (PARAM_ATOL + PARAM_RTOL * ref_flat.abs())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        result = {
            "ranks": n, "mesh": {"data": n // seq, "seq": seq}, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "losses": losses, "whole_batch_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
            "params_beyond_tolerance": int((excess > 0).sum()),
            "ranks_identical": same, "block_launches_rank0": launches,
        }
        print(json.dumps(result), flush=True)
        if not (same and loss_rel <= LOSS_RTOL and result["params_beyond_tolerance"] == 0):
            raise SystemExit("sequence-parallel run disagrees with the whole-batch run")
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2, help="size of the seq axis; data = ranks / seq")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = ap.parse_args()
    if args.ranks % args.seq:
        ap.error(f"--seq {args.seq} does not divide --ranks {args.ranks}")
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.sp_parity",
                            ["--ranks", str(args.ranks), "--seq", str(args.seq),
                             "--device", args.device or "cuda"], args.ranks)
    _worker(args.device, args.seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
