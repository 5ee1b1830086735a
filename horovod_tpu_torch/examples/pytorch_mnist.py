"""PyTorch MNIST with hook-driven DistributedOptimizer.

The analogue of the reference's ``examples/pytorch_mnist.py``: broadcast
initial parameters + optimizer state, per-parameter async gradient
allreduce via hooks, rank-aware LR scaling. Synthetic data for hermetic
runs.

Run:  python -m horovod_tpu_torch.examples.pytorch_mnist             # on the card
      python -m horovod_tpu_torch.examples.pytorch_mnist --no-cuda   # on the CPU
"""

import argparse
import os
import tempfile

import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd

parser = argparse.ArgumentParser(description="PyTorch MNIST Example")
parser.add_argument("--no-cuda", action="store_true", default=False,
                    help="disables CUDA training")
args = parser.parse_args()
args.cuda = not args.no_cuda


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 16, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(16, 32, 3, padding=1)
        self.fc1 = torch.nn.Linear(32 * 7 * 7, 64)
        self.fc2 = torch.nn.Linear(64, 10)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.flatten(1)
        return self.fc2(F.relu(self.fc1(x)))


def main():
    hvd.init(device=None if args.cuda else "cpu")
    torch.manual_seed(42)
    if args.cuda:
        # Horovod: pin GPU to local rank.
        torch.cuda.set_device(hvd.local_rank())

    model = Net()
    if args.cuda:
        # Move model to GPU.
        model.cuda()
    optimizer = torch.optim.SGD(
        model.parameters(), lr=0.01 * hvd.size(), momentum=0.9
    )
    optimizer = hvd.DistributedOptimizer(
        optimizer,
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16,
    )
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    torch.manual_seed(hvd.rank())  # different shards per rank
    for step in range(20):
        x = torch.randn(32, 1, 28, 28)
        y = torch.randint(0, 10, (32,))
        if args.cuda:
            x, y = x.cuda(), y.cuda()
        optimizer.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        optimizer.step()
        if hvd.rank() == 0 and step % 5 == 0:
            print(f"step {step} loss {loss.item():.4f}")

    if hvd.rank() == 0:
        torch.save(model.state_dict(),
                   os.path.join(tempfile.gettempdir(), "hvd_tpu_torch_mnist.pt"))
        print("checkpoint saved")
    hvd.shutdown()


if __name__ == "__main__":
    main()
