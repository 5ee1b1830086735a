"""Mixture-of-Experts training with expert parallelism (DP x EP) on the port.

The counterpart of ``examples/jax_moe_expert_parallel.py``: experts shard
over the ``expert`` mesh axis, tokens over both axes, and Switch top-1
routing sends each rank's tokens to the experts' owners with an all-to-all
(NCCL on the card, gloo on the CPU).

Usage (one process per GPU, started here with the HOROVOD_* environment):
  python -m horovod_tpu_torch.examples.moe_expert_parallel
  python -m horovod_tpu_torch.examples.moe_expert_parallel --device cpu --ranks 4   # gloo ranks
"""

from __future__ import annotations

import argparse
import os
import sys

from ..tools.launch import launch_ranks, store_url


def _train(args) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.ep import init_moe_params, make_ep_train_step, moe_ffn
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.utils.convert import moe_params_from_numpy

    hvd.init(args.device, init_method=store_url())
    try:
        n, dev = hvd.size(), hvd.device()
        ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
        mesh = build_mesh({"data": n // ep, "expert": ep})
        if hvd.rank() == 0:
            print(f"mesh: data={n // ep} x expert={ep} on {dev.type}", flush=True)
        d_model, d_hidden, num_experts = 32, 64, 8
        g = torch.Generator().manual_seed(0)
        params = {
            "moe": moe_params_from_numpy(
                init_moe_params(g, d_model=d_model, d_hidden=d_hidden, num_experts=num_experts,
                                num_expert_shards=ep, device="cpu"),
                n_shards=ep, index=mesh.get_local_rank("expert"), device=dev),
            "head": torch.zeros(d_model, 1, device=dev, requires_grad=True),
        }
        opt = torch.optim.Adam([params["head"], *params["moe"]], lr=1e-2)

        def loss_fn(p, batch):
            xb, yb = batch
            h, aux = moe_ffn(p["moe"], xb, expert_axis="expert", capacity_factor=2.0)
            pred = (xb + h) @ p["head"]     # residual around the MoE block
            return ((pred - yb) ** 2).mean(), aux

        step = make_ep_train_step(loss_fn, opt, mesh)
        rs = np.random.RandomState(0)
        x = rs.randn(128, d_model).astype(np.float32)
        w_true = rs.randn(d_model, 1).astype(np.float32)
        batch = (torch.from_numpy(x).to(dev), torch.from_numpy(np.tanh(x) @ w_true).to(dev))
        for i in range(args.steps):
            loss = float(step(params, batch))
            if i % 20 == 0 and hvd.rank() == 0:
                print(f"step {i:3d}  loss {loss:.5f}", flush=True)
        if hvd.rank() == 0:
            print(f"final loss {loss:.5f}", flush=True)
    finally:
        hvd.shutdown()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to start (default: every GPU; 4 with --device cpu)")
    p.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = p.parse_args()
    if "HOROVOD_RANK" in os.environ:
        _train(args)
        return 0
    if args.ranks is None:
        if args.device == "cpu":
            args.ranks = 4
        else:
            import torch

            args.ranks = torch.cuda.device_count()
            if args.ranks == 0:
                p.error("no CUDA device is available; pass --device cpu to run on the CPU")
    return launch_ranks("horovod_tpu_torch.examples.moe_expert_parallel",
                        sys.argv[1:] + ["--ranks", str(args.ranks)], args.ranks)


if __name__ == "__main__":
    sys.exit(main())
