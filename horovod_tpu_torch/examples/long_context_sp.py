"""Long-context LM training with ring attention (DP x SP mesh).

The counterpart of ``examples/jax_long_context_sp.py``: a context too long
for one card shards over the ``seq`` axis, and K/V shards travel the ring
between the cards (NCCL) while each card runs the ring block kernel.

Usage (one process per GPU, started here with the HOROVOD_* environment):
  python -m horovod_tpu_torch.examples.long_context_sp [--seq-len 4096] [--dp 1] [--sp 8]
  python -m horovod_tpu_torch.examples.long_context_sp --device cpu --dp 1 --sp 2 \\
      --seq-len 256 --steps 2   # gloo ranks on the CPU
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial

from ..tools.launch import launch_ranks, store_url


def _train(args) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    from horovod_tpu_torch.parallel.sp import make_sp_train_step

    hvd.init(args.device, init_method=store_url())
    try:
        mesh = build_mesh({"data": args.dp, "seq": args.sp})
        if hvd.rank() == 0:
            print(f"mesh: data={args.dp} seq={args.sp}, context length {args.seq_len}",
                  flush=True)
        dev = hvd.device()
        model = TransformerLM(
            vocab_size=args.vocab, d_model=args.d_model, n_heads=8,
            n_layers=args.layers, max_len=args.seq_len, dtype=torch.bfloat16,
            device=dev, seed=0, remat=True,
            attn_fn=partial(ring_attention, group=mesh.get_group("seq"), causal=True),
        )
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        rng = np.random.RandomState(0)
        tokens = torch.from_numpy(
            rng.randint(0, args.vocab, (args.batch * args.dp, args.seq_len))).to(dev)
        labels = torch.roll(tokens, -1, dims=1)
        step = make_sp_train_step(
            lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
            torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8),
            mesh,
        )
        for i in range(args.steps):
            t0 = time.perf_counter()
            loss_v = float(step(model, tokens, labels))
            dt = time.perf_counter() - t0
            if hvd.rank() == 0:
                print(f"step {i}: loss {loss_v:.4f}  {tokens.numel() / dt:,.0f} tok/s",
                      flush=True)
    finally:
        hvd.shutdown()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--sp", type=int, default=None)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = p.parse_args()
    if "HOROVOD_RANK" in os.environ:
        _train(args)
        return 0
    if args.device == "cpu":
        ndev = (args.dp or 1) * (args.sp or 1)
    else:
        import torch

        ndev = torch.cuda.device_count()
        if ndev == 0:
            p.error("no CUDA device is available; pass --device cpu to run on the CPU")
    sp = args.sp or (4 if ndev % 4 == 0 else ndev)
    dp = args.dp or ndev // sp
    return launch_ranks("horovod_tpu_torch.examples.long_context_sp",
                        sys.argv[1:] + ["--dp", str(dp), "--sp", str(sp)], dp * sp)


if __name__ == "__main__":
    sys.exit(main())
