"""Elastic training example: the copy of ``examples/jax_elastic_train.py``.

A linear-regression loop that survives a lost worker or a changed host set.
``TensorState`` commits snapshot the weights (on the card, a copy on the
card); on a membership change the world re-forms in process and training
goes on from the last commit (a crash) or the live state (a graceful
resize). The gradient is averaged with the eager allreduce.

Run:  python -m horovod_tpu_torch.examples.elastic_train            # on the card
      python -m horovod_tpu_torch.examples.elastic_train --no-cuda  # on the CPU

Outside an elastic launch ``elastic.run`` is a plain call.
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
import horovod_tpu_torch.elastic as elastic

STEPS = 200
COMMIT_EVERY = 10
LR = 0.05


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Elastic linear regression")
    parser.add_argument("--no-cuda", action="store_true", default=False,
                        help="run on the CPU")
    args = parser.parse_args(argv)
    hvd.init(device="cpu" if args.no_cuda else None)
    dev = hvd.device()
    rng = np.random.default_rng(1234)  # the same data on every rank
    true_w = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)).to(dev)
    state = elastic.TensorState(w=torch.zeros(8, device=dev), step=0)
    state.register_reset_callbacks([
        lambda: print(f"[rank {hvd.rank()}] world re-formed: size {hvd.size()}", flush=True)])

    @elastic.run
    def train(state):
        while state.step < STEPS:
            # A rank-sharded batch, drawn afresh each step whatever the world.
            g = np.random.default_rng(state.step * 1000 + hvd.rank())
            x = torch.from_numpy(g.normal(size=(32, 8)).astype(np.float32)).to(dev)
            y = x @ true_w
            grad = 2.0 * ((x @ state.w - y)[:, None] * x).mean(0)
            grad = hvd.allreduce(grad, op=hvd.Average, name="grad")
            state.w.sub_(LR * grad)
            state.step += 1
            if state.step % COMMIT_EVERY == 0:
                state.commit()
        return state

    train(state)
    err = float(torch.linalg.norm(state.w - true_w))
    if hvd.rank() == 0:
        print(f"done: {state.step} steps on {hvd.size()} ranks, |w - w*| = {err:.4f}",
              flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
