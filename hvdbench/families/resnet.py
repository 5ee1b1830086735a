"""ResNet-50 v1.5 through the port's ``models/resnet.ResNet50``.

The leaves carry the program's names, BatchNorm's running statistics
among them (role "buffer"). Convolution kernels (OIHW) are He-normal over
their fan-in, the head normal 0.01; BatchNorm scales start at 1, except
each block's last, which starts at the configuration's ``last_bn_scale``:
near the recipe's zero, so that each block starts close to its shortcut
and the first steps stay well conditioned, but not zero, so that every
convolution of the branch has a first-step gradient. Inputs are NHWC
images, standard normal, with labels uniform over the classes.
"""

from __future__ import annotations

import math

import torch

from ..common import derived_seed
from ..reference.resnet import blocks, same_pads

ITEM = "image"


def _bn(name: str, c: int, scale: float = 1.0):
    return [(name + ".scale", (c,), ("const", scale), "param"),
            (name + ".bias", (c,), ("const", 0.0), "param"),
            (name + ".mean", (c,), ("const", 0.0), "buffer"),
            (name + ".var", (c,), ("const", 1.0), "buffer")]


def _conv(name: str, cout: int, cin: int, k: int):
    return [(name + ".kernel", (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cin * k * k))),
             "param")]


def leaves(config: dict):
    w, e = config["width"], config["expansion"]
    out = _conv("conv_init", w, 3, 7) + _bn("bn_init", w)
    for name, cin, f, stride in blocks(config):
        b = name + "."
        out += (_conv(b + "Conv_0", f, cin, 1) + _bn(b + "BatchNorm_0", f)
                + _conv(b + "Conv_1", f, f, 3) + _bn(b + "BatchNorm_1", f)
                + _conv(b + "Conv_2", f * e, f, 1)
                + _bn(b + "BatchNorm_2", f * e, float(config["last_bn_scale"])))
        if cin != f * e or stride != 1:
            out += _conv(b + "conv_proj", f * e, cin, 1) + _bn(b + "norm_proj", f * e)
    feats = w * 2 ** (len(config["layers"]) - 1) * e
    out += [("head.kernel", (feats, config["num_classes"]), ("normal", 0.01), "param"),
            ("head.bias", (config["num_classes"],), ("const", 0.0), "param")]
    return out


def items_per_row(config: dict, traffic: dict) -> int:
    """Images a row trains."""
    return 1


def make_batch(config: dict, traffic: dict, seed: int, device, rank=None, world: int = 1):
    B, S = int(traffic["batch_per_card"]), int(config["image_size"])
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    images = torch.randn((world * B, S, S, 3), generator=gen, device=device)
    labels = torch.randint(0, config["num_classes"], (world * B,), generator=gen, device=device)
    if rank is not None:
        images, labels = images[rank * B:(rank + 1) * B], labels[rank * B:(rank + 1) * B]
    return images.contiguous(), labels.contiguous()


def build_program(config: dict, device):
    from horovod_tpu_torch.models.resnet import ResNet, BottleneckBlock

    if config["compute_dtype"] != "bfloat16" or (config["bn_momentum"], config["bn_epsilon"]) \
            != (0.9, 1e-5) or config["expansion"] != 4:
        raise ValueError("models/resnet.py builds bottlenecks of expansion 4 in bfloat16 "
                         "with BatchNorm momentum 0.9 and eps 1e-5")
    model = ResNet(config["layers"], num_classes=config["num_classes"],
                   num_filters=config["width"], dtype=torch.bfloat16, block=BottleneckBlock,
                   device="meta")
    return model.to_empty(device=device)


def program_loss(model, batch):
    import torch.nn.functional as F

    return F.cross_entropy(model(batch[0]), batch[1])


def macs_per_image(config: dict) -> int:
    """Multiply-adds of every convolution and the head for one image."""
    size = config["image_size"]
    w, e = config["width"], config["expansion"]

    def out(n: int, k: int, s: int, pads=None) -> int:
        lo, hi = pads or same_pads(n, k, s)
        return (n + lo + hi - k) // s + 1

    n = out(size, 7, 2, (3, 3))
    macs = n * n * w * 3 * 49
    n = (n + 2 - 3) // 2 + 1                       # max pool, 3x3 stride 2 padded 1
    for _, cin, f, stride in blocks(config):
        m = out(n, 3, stride)
        macs += n * n * f * cin + m * m * f * f * 9 + m * m * f * e * f
        if cin != f * e or stride != 1:
            macs += m * m * f * e * cin
        n = m
    feats = w * 2 ** (len(config["layers"]) - 1) * e
    return macs + feats * config["num_classes"]


def train_flops_per_item(config: dict, traffic: dict) -> int:
    """Model FLOPs to train one image: 3 × 2 × the multiply-adds."""
    return 6 * macs_per_image(config)
