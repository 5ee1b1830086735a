"""DP x TP and DP x PP training demo on the port.

The counterpart of ``examples/jax_tp_pp_demo.py``: two tiny regression
problems, a Megatron tensor-parallel MLP (``parallel/tp.tp_mlp``, each rank
training its row of the ``[n_model, ...]``-stacked weights) and a GPipe
pipeline (``parallel/pp.make_pp_train_step``), then the heterogeneous
pipeline LM (``make_pp_lm_train_step``: embedding on stage 0, head and loss
on the last stage), printing each loss trajectory.

Usage (one process per GPU, started here with the HOROVOD_* environment):
  python -m horovod_tpu_torch.examples.tp_pp_demo
  python -m horovod_tpu_torch.examples.tp_pp_demo --device cpu --ranks 4   # gloo ranks
"""

from __future__ import annotations

import argparse
import os
import sys

from ..tools.launch import launch_ranks, store_url


def _report(name: str, losses) -> None:
    import horovod_tpu_torch as hvd

    if hvd.rank() == 0:
        print(name, flush=True)
        for i, loss in enumerate(losses):
            if i % 5 == 0 or i == len(losses) - 1:
                print(f"  step {i:3d}  loss {loss:.4f}", flush=True)


def _train(args) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel._stacked import init_stacked_state, stacked_train_update
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.pp import (init_pp_lm_state, init_pp_state,
                                               make_pp_lm_train_step, make_pp_train_step)
    from horovod_tpu_torch.parallel.tp import tp_mlp
    from horovod_tpu_torch.utils.convert import stacked_row

    hvd.init(args.device, init_method=store_url())
    try:
        n, dev = hvd.size(), hvd.device()
        par = max(k for k in (1, 2, 4) if n % k == 0)
        dp = n // par
        d = args.d_model
        rng = np.random.RandomState(0)
        w_true = rng.randn(d, d).astype(np.float32)
        x_np = rng.randn(8 * dp, d).astype(np.float32)
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(x_np @ w_true).to(dev)
        g = torch.Generator().manual_seed(0)

        def adam(ps):
            return torch.optim.Adam(ps, lr=1e-2)

        # --- DP x TP: each model rank trains its row of the stacked MLP.
        mesh = build_mesh({"data": dp, "model": par})
        f = 4 * d // par
        w1 = torch.randn(d, 4 * d, generator=g) * d ** -0.5
        w2 = torch.randn(4 * d, d, generator=g) * (4 * d) ** -0.5
        stacked = {"w1": torch.stack(w1.split(f, dim=1)), "b1": torch.zeros(par, f),
                   "w2": torch.stack(w2.split(f, dim=0)), "b2": torch.zeros(par, d // par)}
        row = stacked_row(stacked, mesh.get_local_rank("model"), dev)
        opt = init_stacked_state(adam, row)
        data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
        per = x.shape[0] // dp
        rows = slice(mesh.get_local_rank("data") * per, (mesh.get_local_rank("data") + 1) * per)

        def tp_loss(p):
            loss = ((tp_mlp(p, x[rows], axis_name=model_group) - y[rows]) ** 2).mean()
            loss.backward()
            return loss.detach()

        losses = []
        for _ in range(args.steps):
            loss = stacked_train_update(opt, row, tp_loss, data_group)
            loss = collectives.allreduce(loss, op=hvd.Average, group=data_group)
            losses.append(float(collectives.allreduce(loss, op=hvd.Average, group=model_group)))
        _report(f"DP x TP on {n} ranks (data={dp}, model={par}):", losses)

        # --- DP x PP: GPipe over the stage axis.
        pp_mesh = build_mesh({"stage": par, "data": dp})
        stage = pp_mesh.get_local_rank("stage")

        def stage_fn(p, xb, s):
            return torch.tanh(xb @ p["w"] + p["b"])

        pp_stacked = {"w": torch.randn(par, d, d, generator=g) * d ** -0.5,
                      "b": torch.zeros(par, d)}
        pp_row = stacked_row(pp_stacked, stage, dev)
        pp_step = make_pp_train_step(lambda o, l: ((o - l) ** 2).mean(), stage_fn,
                                     init_pp_state(adam, pp_row), pp_mesh)
        xm = x.reshape(4, -1, d)            # [n_micro, mb, d] microbatches
        ym = torch.tanh(torch.tanh(xm))     # a target the 2+-stage tanh net can hit
        _report(f"DP x PP on {n} ranks (stage={par}, data={dp}):",
                [float(pp_step(pp_row, xm, ym)) for _ in range(args.steps)])

        # --- The heterogeneous pipeline: embed on stage 0, head + loss on the
        # last stage, only the hidden activation on the wire.
        vocab = 32
        het = {"embed": {"table": (torch.randn(vocab, d, generator=g) * 0.5).to(dev)
                         .requires_grad_()},
               "stages": stacked_row(pp_stacked, stage, dev),
               "head": {"proj": (torch.randn(d, vocab, generator=g) * 0.5).to(dev)
                        .requires_grad_()}}
        het_step = make_pp_lm_train_step(
            lambda p, t: p["table"][t], stage_fn, lambda p, h, lab: lm_loss(h @ p["proj"], lab),
            init_pp_lm_state(adam, het), pp_mesh)
        tok, lab = (torch.from_numpy(rng.randint(0, vocab, tuple(xm.shape[:2]) + (6,))).to(dev)
                    for _ in range(2))
        _report(f"DP x PP (heterogeneous LM) on {n} ranks:",
                [float(het_step(het, tok, lab)) for _ in range(args.steps)])
        if hvd.rank() == 0:
            print("DEMO DONE", flush=True)
    finally:
        hvd.shutdown()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--d-model", type=int, default=16)
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
    return launch_ranks("horovod_tpu_torch.examples.tp_pp_demo",
                        sys.argv[1:] + ["--ranks", str(args.ranks)], args.ranks)


if __name__ == "__main__":
    sys.exit(main())
