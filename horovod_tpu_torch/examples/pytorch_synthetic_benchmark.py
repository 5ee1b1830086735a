"""PyTorch synthetic benchmark (img/sec).

The analogue of the reference's ``examples/pytorch_synthetic_benchmark.py``:
synthetic data, a torchvision-style model trained with the hook-driven
DistributedOptimizer, img/sec averaged over timed iterations with
mean/stddev reporting. Uses a compact ResNet-ish CNN so the script is
hermetic (no torchvision download needed).

Run:  python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark --num-iters 3
      python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark --no-cuda
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


class SmallResNet(torch.nn.Module):
    def __init__(self, num_classes=1000, width=32):
        super().__init__()
        self.stem = torch.nn.Conv2d(3, width, 7, stride=2, padding=3)
        self.blocks = torch.nn.ModuleList(
            [torch.nn.Conv2d(width, width, 3, padding=1) for _ in range(4)]
        )
        self.head = torch.nn.Linear(width, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.stem(x)), 2)
        for conv in self.blocks:
            x = F.relu(conv(x) + x)
        x = x.mean(dim=(2, 3))
        return self.head(x)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=96)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--no-cuda", action="store_true", default=False,
                        help="disables CUDA training")
    args = parser.parse_args()
    args.cuda = not args.no_cuda

    hvd.init(device=None if args.cuda else "cpu")
    torch.manual_seed(42)
    if args.cuda:
        # Horovod: pin GPU to local rank.
        torch.cuda.set_device(hvd.local_rank())

    model = SmallResNet()
    if args.cuda:
        # Move model to GPU.
        model.cuda()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size())
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters()
    )
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size)
    target = torch.randint(0, 1000, (args.batch_size,))
    if args.cuda:
        data, target = data.cuda(), target.cuda()

    def benchmark_step():
        optimizer.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()

    for _ in range(args.num_warmup_batches):
        benchmark_step()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.time()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        img_sec = args.batch_size * args.num_batches_per_iter / (time.time() - t0)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {img_sec:.1f} img/sec per rank")
        img_secs.append(img_sec)

    if hvd.rank() == 0:
        img_sec_mean, img_sec_conf = np.mean(img_secs), 1.96 * np.std(img_secs)
        print(f"Img/sec per rank: {img_sec_mean:.1f} +- {img_sec_conf:.1f}")
        print(
            f"Total img/sec on {hvd.size()} rank(s): "
            f"{hvd.size() * img_sec_mean:.1f} +- {hvd.size() * img_sec_conf:.1f}"
        )


if __name__ == "__main__":
    main()
