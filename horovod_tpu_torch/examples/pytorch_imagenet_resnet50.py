"""PyTorch ImageNet ResNet-50 — config-parity with the reference
``examples/pytorch_imagenet_resnet50.py``: same CLI (train/val dirs,
fp16-allreduce, batches-per-allreduce, Adasum, LR warmup schedule,
checkpoint on rank 0), ``hvd.DistributedOptimizer`` with compression,
``broadcast_parameters``/``broadcast_optimizer_state`` from rank 0.

Environment-driven differences: torchvision is not in this image, so the
ResNet-50 is defined inline and a synthetic ImageNet-shaped dataset is used
whenever ``--train-dir`` does not exist (zero-egress, no dataset on disk).

Run:  python -m horovod_tpu_torch.examples.pytorch_imagenet_resnet50 \
          --epochs 1 --synthetic-batches 4
      (add --no-cuda to train on the CPU)
"""

import argparse
import os

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.data

import horovod_tpu_torch.torch as hvd

parser = argparse.ArgumentParser(
    description="PyTorch ImageNet Example",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter,
)
parser.add_argument("--train-dir",
                    default=os.path.expanduser("~/imagenet/train"),
                    help="path to training data")
parser.add_argument("--val-dir",
                    default=os.path.expanduser("~/imagenet/validation"),
                    help="path to validation data")
parser.add_argument("--log-dir", default="./logs",
                    help="tensorboard log directory")
parser.add_argument("--checkpoint-format",
                    default="./checkpoint-{epoch}.pth.tar",
                    help="checkpoint file format")
parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                    help="use fp16 compression during allreduce")
parser.add_argument("--batches-per-allreduce", type=int, default=1,
                    help="number of batches processed locally before "
                         "executing allreduce across workers")
parser.add_argument("--use-adasum", action="store_true", default=False,
                    help="use the Adasum reducer")
parser.add_argument("--batch-size", type=int, default=32,
                    help="input batch size for training")
parser.add_argument("--val-batch-size", type=int, default=32,
                    help="input batch size for validation")
parser.add_argument("--epochs", type=int, default=90,
                    help="number of epochs to train")
parser.add_argument("--base-lr", type=float, default=0.0125,
                    help="learning rate for a single worker")
parser.add_argument("--warmup-epochs", type=float, default=5,
                    help="number of warmup epochs")
parser.add_argument("--momentum", type=float, default=0.9,
                    help="SGD momentum")
parser.add_argument("--wd", type=float, default=0.00005,
                    help="weight decay")
parser.add_argument("--no-cuda", action="store_true", default=False,
                    help="disables CUDA training")
parser.add_argument("--seed", type=int, default=42, help="random seed")
parser.add_argument("--image-size", type=int, default=224,
                    help="image side (TPU-build extension for smoke runs)")
parser.add_argument("--synthetic-batches", type=int, default=8,
                    help="per-epoch batches when falling back to synthetic "
                         "data (TPU-build extension)")
args = parser.parse_args()
args.cuda = not args.no_cuda


# --- inline ResNet-50 (torchvision is not in this image) -----------------
class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        out = out + (self.down(x) if self.down is not None else x)
        return F.relu(out)


class ResNet50(nn.Module):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False),
            nn.BatchNorm2d(64), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2, 1),
        )
        stages = []
        cin = 64
        for width, blocks, stride in ((64, 3, 1), (128, 4, 2),
                                      (256, 6, 2), (512, 3, 2)):
            for b in range(blocks):
                stages.append(Bottleneck(cin, width,
                                         stride if b == 0 else 1))
                cin = width * Bottleneck.expansion
        self.stages = nn.Sequential(*stages)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.stages(self.stem(x))
        x = x.mean(dim=(2, 3))
        return self.head(x)


def make_loader(train: bool):
    """Real ImageFolder when the directory exists, synthetic otherwise."""
    path = args.train_dir if train else args.val_dir
    bs = args.batch_size if train else args.val_batch_size
    if os.path.isdir(path):
        raise SystemExit(
            "ImageFolder loading requires torchvision, which is not in "
            "this image; use synthetic mode (no --train-dir)."
        )
    g = torch.Generator().manual_seed(args.seed + (0 if train else 1))
    n = args.synthetic_batches * bs
    x = torch.rand((n, 3, args.image_size, args.image_size), generator=g)
    y = torch.randint(0, 1000, (n,), generator=g)
    ds = torch.utils.data.TensorDataset(x, y)
    sampler = torch.utils.data.distributed.DistributedSampler(
        ds, num_replicas=hvd.size(), rank=hvd.rank()
    )
    return torch.utils.data.DataLoader(ds, batch_size=bs, sampler=sampler), \
        sampler


def adjust_learning_rate(optimizer, epoch, batch_idx, steps_per_epoch):
    """Reference LR schedule: warmup from base_lr to base_lr*size over
    warmup_epochs, then decay x0.1 at epochs 30/60/80."""
    if epoch < args.warmup_epochs:
        ep = epoch + float(batch_idx + 1) / steps_per_epoch
        lr_adj = 1.0 / hvd.size() * (
            ep * (hvd.size() - 1) / args.warmup_epochs + 1
        )
    elif epoch < 30:
        lr_adj = 1.0
    elif epoch < 60:
        lr_adj = 1e-1
    elif epoch < 80:
        lr_adj = 1e-2
    else:
        lr_adj = 1e-3
    for pg in optimizer.param_groups:
        pg["lr"] = args.base_lr * hvd.size() * args.batches_per_allreduce \
            * lr_adj


def main():
    hvd.init(device=None if args.cuda else "cpu")
    torch.manual_seed(args.seed)
    torch.set_num_threads(4)
    if args.cuda:
        # Horovod: pin GPU to local rank.
        torch.cuda.set_device(hvd.local_rank())
        torch.cuda.manual_seed(args.seed)

    train_loader, train_sampler = make_loader(train=True)
    val_loader, _ = make_loader(train=False)

    model = ResNet50()
    if args.cuda:
        # Move model to GPU.
        model.cuda()
    # With Adasum the effective LR scaling differs (reference lr_scaler
    # logic); local_size on CPU TPU-hosts is the rank count per host.
    lr_scaler = args.batches_per_allreduce * (
        1 if args.use_adasum else hvd.size()
    )
    optimizer = torch.optim.SGD(
        model.parameters(), lr=args.base_lr * lr_scaler,
        momentum=args.momentum, weight_decay=args.wd,
    )
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer,
        named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=args.batches_per_allreduce,
        op=hvd.Adasum if args.use_adasum else hvd.Average,
    )
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    steps = len(train_loader)
    for epoch in range(args.epochs):
        model.train()
        train_sampler.set_epoch(epoch)
        for batch_idx, (data, target) in enumerate(train_loader):
            if args.cuda:
                data, target = data.cuda(), target.cuda()
            adjust_learning_rate(optimizer, epoch, batch_idx, steps)
            optimizer.zero_grad()
            for i in range(0, len(data), args.batch_size):
                out = model(data[i:i + args.batch_size])
                loss = F.cross_entropy(out, target[i:i + args.batch_size])
                loss = loss / max(args.batches_per_allreduce, 1)
                loss.backward()
            optimizer.step()
            if hvd.rank() == 0:
                print(f"epoch {epoch} batch {batch_idx}/{steps} "
                      f"loss {loss.item():.4f}", flush=True)

        # Validation (metric averaged over ranks like the reference).
        model.eval()
        correct, total = 0, 0
        with torch.no_grad():
            for data, target in val_loader:
                if args.cuda:
                    data, target = data.cuda(), target.cuda()
                pred = model(data).argmax(dim=1)
                correct += (pred == target).sum().item()
                total += len(target)
        acc = hvd.allreduce(
            torch.tensor(correct / max(total, 1)), name="val_acc"
        )
        if hvd.rank() == 0:
            print(f"epoch {epoch} val_acc {float(acc):.4f}", flush=True)
            torch.save(
                {"model": model.state_dict(), "epoch": epoch},
                args.checkpoint_format.format(epoch=epoch),
            )


if __name__ == "__main__":
    main()
