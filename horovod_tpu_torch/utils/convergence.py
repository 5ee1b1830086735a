"""Convergence evidence for the lossy and sharded data paths.

The counterpart of ``horovod_tpu/utils/convergence.py``: the same small
transformer LM from one init, on the same batches, trained under three
gradient paths of the port's DP step:

- ``fp32``: ``DistributedOptimizer`` over AdamW, the full-precision
  allreduce;
- ``quantized``: the int8 wire (``quantized=True``, error feedback off, as
  the JAX ``allreduce_gradients(quantized=True)`` has none);
- ``quantized+zero1``: the int8 wire under ZeRO-1
  (``parallel/zero.make_zero1_train_step(quantized=True)``).

The loss curves back the claim that the int8 wire's gradient noise is
acceptable with a trajectory: the quantized curves must end within a small
relative gap of fp32's. The model (d_model 128, 2 layers, 4 heads, vocab 512,
T 64, bf16 compute), AdamW 1e-3 (weight decay 1e-4, optax's default) and the
8 batches of random tokens are the JAX module's; the global batch is 16 (the
JAX module's 2 a device on its 8 virtual devices), split over the ranks.

    python -m horovod_tpu_torch.utils.convergence --ranks 4                 # a GPU per rank
    python -m horovod_tpu_torch.utils.convergence --ranks 4 --device cpu    # gloo on the CPU

prints one JSON line from rank 0 with the curves and the final-loss gaps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Mapping, Optional

import numpy as np


def run(steps: int = 300, record_every: int = 10, seed: int = 0, d_model: int = 128,
        n_layers: int = 2, n_heads: int = 4, vocab: int = 512, seq_len: int = 64,
        global_batch: int = 16, lr: float = 1e-3, n_batches: int = 8,
        init: Optional[Mapping[str, np.ndarray]] = None) -> dict:
    """Train the three configurations in an initialized job; returns
    ``{"curves": {cfg: [loss...]}, "final_loss": {...}, "rel_gap_vs_fp32":
    {...}}`` (losses recorded every ``record_every`` steps and at the last,
    rounded as the JAX module rounds them). ``init`` is a flat ``/``-keyed
    flax tree to start from (the JAX run's weights); None draws the port's
    own from ``seed``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel.zero import make_zero1_train_step
    from horovod_tpu_torch.utils.convert import load_flax_params, params_to_numpy

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} ranks")
    per = global_batch // n
    dims = dict(vocab_size=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                max_len=seq_len)
    rng = np.random.RandomState(seed)
    # A small fixed dataset the model can start memorizing within a few
    # hundred steps: the curves must move, or the comparison is vacuous.
    data = [tuple(torch.from_numpy(rng.randint(0, vocab, (global_batch, seq_len))[
        r * per:(r + 1) * per]).to(dev) for _ in range(2)) for _ in range(n_batches)]
    if init is None:
        init = params_to_numpy(TransformerLM(**dims, device=dev, seed=seed))

    def loss_fn(model, batch):
        return lm_loss(model(batch[0]), batch[1])

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4, eps=1e-8)

    def make(name, model):
        if name == "quantized+zero1":
            return make_zero1_train_step(loss_fn, adamw(model.parameters()), quantized=True)
        opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                       named_parameters=model.named_parameters(),
                                       quantized=name == "quantized",
                                       error_feedback=False if name == "quantized" else None)
        return hvd.make_train_step(loss_fn, opt)

    curves = {}
    for name in ("fp32", "quantized", "quantized+zero1"):
        model = TransformerLM(**dims, device=dev)
        load_flax_params(model, init)
        step = make(name, model)
        losses = []
        for i in range(steps):
            loss = step(model, data[i % n_batches])
            if i % record_every == 0 or i == steps - 1:
                losses.append(round(float(loss), 4))
        curves[name] = losses
    final = {k: v[-1] for k, v in curves.items()}
    gaps = {k: round(abs(v - final["fp32"]) / max(final["fp32"], 1e-9), 4)
            for k, v in final.items()}
    return {
        "n_devices": n,
        "steps": steps,
        "model": {"d_model": d_model, "n_layers": n_layers, "vocab": vocab, "seq_len": seq_len,
                  "global_batch": global_batch, "optimizer": f"adamw(lr={lr})"},
        "curves": curves,
        "final_loss": final,
        "rel_gap_vs_fp32": gaps,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = ap.parse_args()
    from horovod_tpu_torch.tools.launch import STORE_DIR_VAR, launch_ranks, store_url

    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.utils.convergence",
                            ["--steps", str(args.steps), "--ranks", str(args.ranks),
                             "--device", args.device or "cuda"], args.ranks)
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(args.device, init_method=store_url() if STORE_DIR_VAR in os.environ else None)
    try:
        result = run(steps=args.steps)
        dev = hvd.device()
        result["card"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        if hvd.rank() == 0:
            print(json.dumps(result), flush=True)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
