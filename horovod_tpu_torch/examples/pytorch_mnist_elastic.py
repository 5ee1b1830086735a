"""Elastic PyTorch MNIST (the copy of ``examples/pytorch_mnist_elastic.py``):
the training loop survives a lost worker or a changed host set. The state
rolls back to the last commit (or is kept, on a graceful change) and the
world re-forms with the workers left. Synthetic data; ``ElasticSampler``
shards the dataset over the current world and resumes an interrupted epoch
without repeating samples.

Run:  python -m horovod_tpu_torch.examples.pytorch_mnist_elastic            # on the card
      python -m horovod_tpu_torch.examples.pytorch_mnist_elastic --no-cuda  # on the CPU

Outside an elastic launch (no ``HOROVOD_ELASTIC=1``) ``elastic.run`` is a
plain call; ``tools/elastic_parity.py`` shows a scripted elastic driver.
"""

import argparse

import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
import horovod_tpu_torch.torch.elastic as elastic
from horovod_tpu_torch.common import basics

EPOCHS = 2
BATCH = 32
DATASET = 512  # synthetic samples an epoch
BASE_LR = 0.01


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(28 * 28, 64)
        self.fc2 = torch.nn.Linear(64, 10)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


def synthetic_sample(idx):
    g = torch.Generator().manual_seed(idx)
    return torch.randn(1, 28, 28, generator=g), idx % 10


def main(argv=None):
    parser = argparse.ArgumentParser(description="Elastic PyTorch MNIST Example")
    parser.add_argument("--no-cuda", action="store_true", default=False,
                        help="disables CUDA training")
    args = parser.parse_args(argv)
    hvd.init(device="cpu" if args.no_cuda else None)
    dev = basics.device()
    torch.manual_seed(42)
    model = Net().to(dev)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=BASE_LR * hvd.size()),
        named_parameters=model.named_parameters())
    sampler = elastic.ElasticSampler(DATASET, shuffle=True)
    state = elastic.TorchState(model, optimizer, sampler=sampler, epoch=0)

    def on_reset():
        # The gradients now average over the new rank count.
        for group in optimizer.param_groups:
            group["lr"] = BASE_LR * hvd.size()
        print(f"[rank {hvd.rank()}] world re-formed: size {hvd.size()}", flush=True)

    state.register_reset_callbacks([on_reset])

    @elastic.run
    def train(state):
        while state.epoch < EPOCHS:
            # One pass over this rank's shard of the REMAINING samples.
            local = list(iter(state.sampler))
            for n, bidx in enumerate(range(0, len(local), BATCH), 1):
                xs, ys = zip(*(synthetic_sample(i) for i in local[bidx:bidx + BATCH]))
                optimizer.zero_grad()
                loss = F.cross_entropy(model(torch.stack(xs).to(dev)),
                                       torch.tensor(ys, device=dev))
                loss.backward()
                optimizer.step()
                state.sampler.record_batch(bidx // BATCH, BATCH)
                if n % 4 == 0:
                    state.commit()
            state.epoch += 1
            state.sampler.set_epoch(state.epoch)
            state.commit()
        return state

    train(state)
    if hvd.rank() == 0:
        print(f"done: {state.epoch} epochs on {hvd.size()} ranks", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
