"""ResNet-50 v1.5 in plain float32 PyTorch: the stride on the 3×3 conv of
each bottleneck, projection shortcuts, BatchNorm with batch statistics in
training and running statistics updated as ``m · old + (1 − m) · batch``
with the biased batch variance, and the padding the configuration states
(``"SAME"`` splits an odd total with the smaller half first).

Takes NHWC images; the whole batch runs at once, since BatchNorm's
statistics are the batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, name: str, stride: int, prods, pads=None):
    kernel = w[name + ".kernel"]
    k = kernel.shape[-1]
    (hl, hh), (wl, wh) = pads or (same_pads(x.shape[2], k, stride),
                                  same_pads(x.shape[3], k, stride))
    if (hl, wl) != (hh, wh):
        x = F.pad(x, (wl, wh, hl, hh))
        hl = wl = 0
    return prods.conv(x, kernel, stride, (hl, wl))


def _bn(x, w, bufs, name: str, config: dict):
    eps, m = config["bn_epsilon"], config["bn_momentum"]
    with torch.no_grad():
        bufs[name + ".mean"].mul_(m).add_(x.mean(dim=(0, 2, 3)), alpha=1 - m)
        bufs[name + ".var"].mul_(m).add_(x.var(dim=(0, 2, 3), unbiased=False), alpha=1 - m)
    return F.batch_norm(x, None, None, w[name + ".scale"], w[name + ".bias"], training=True,
                        eps=eps)


def blocks(config: dict):
    """(name, input features, filters, stride) of every bottleneck, in order."""
    out, features, k = [], config["width"], 0
    for i, count in enumerate(config["layers"]):
        filters = config["width"] * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            out.append((f"BottleneckBlock_{k}", features, filters, stride))
            features = filters * config["expansion"]
            k += 1
    return out


def forward(w, bufs, images, config: dict, prods):
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, w, "conv_init", 2, prods, pads=((3, 3), (3, 3))), w, bufs,
                   "bn_init", config))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for name, features, filters, stride in blocks(config):
        b = name + "."
        y = F.relu(_bn(_conv(x, w, b + "Conv_0", 1, prods), w, bufs, b + "BatchNorm_0", config))
        y = F.relu(_bn(_conv(y, w, b + "Conv_1", stride, prods), w, bufs, b + "BatchNorm_1",
                       config))
        y = _bn(_conv(y, w, b + "Conv_2", 1, prods), w, bufs, b + "BatchNorm_2", config)
        if b + "conv_proj.kernel" in w:
            x = _bn(_conv(x, w, b + "conv_proj", stride, prods), w, bufs, b + "norm_proj", config)
        x = F.relu(x + y)
    x = x.mean(dim=(2, 3))
    return prods.mm(x, w["head.kernel"], wide=True) + w["head.bias"]


def loss_and_backward(params, buffers, batch, config: dict, prods) -> float:
    images, labels = batch
    loss = F.cross_entropy(forward(params, buffers, images, config, prods), labels)
    loss.backward()
    return float(loss.detach())
