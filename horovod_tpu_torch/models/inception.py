"""Inception V3: the counterpart of ``horovod_tpu/models/inception.py``.

Stem, 3× InceptionA, ReductionA, 4× InceptionB, ReductionB, 2×
InceptionC, the global mean, dropout 0.5 and an f32 ``head``; no aux head.
Parameters under the flax names (``ConvBN_{k}/Conv_0``,
``ConvBN_{k}/BatchNorm_0``, ``InceptionA_{k}/ConvBN_{k}/...``, ...), numbered
in the order the flax modules create them. ``forward(x)`` takes NHWC
images (at least 75 px: the stem's VALID convolutions) and computes in
``dtype`` with f32 parameters, f32 batch statistics and f32 logits.

Padding: every stride-2 op is VALID, and the SAME convolutions are stride
1 with odd kernels, so their pads are symmetric ((0, 3) and (3, 0) for the
1×7 and 7×1 kernels). The branch pools average over a 3×3 SAME window
that counts the padding in the divisor, as flax's ``avg_pool`` does.
BatchNorm's epsilon is 1e-3 here (1e-5 in ResNet).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common.basics import resolve_device
from .layers import (
    BatchNorm, Conv, Dense, Dropout, Model, Padding, dropout_generator, global_mean,
    to_channels_last,
)


def avg_pool_same_3x3(x: torch.Tensor) -> torch.Tensor:
    """``nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: the
    zero padding counts in the divisor (``count_include_pad``)."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class ConvBN(nn.Module):
    """Conv (no bias), BatchNorm (momentum 0.9, eps 1e-3), relu."""

    def __init__(self, in_features: int, features: int, kernel: Tuple[int, int] = (1, 1),
                 strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME", *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding, use_bias=False,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-3, dtype=dtype,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _cbn(owner: nn.Module, in_features: int, features: int, kernel=(1, 1), strides=(1, 1),
         padding: Padding = "SAME") -> ConvBN:
    """A ConvBN added to ``owner`` as ``ConvBN_{k}``, k counting the ones
    it already has (flax's naming in creation order)."""
    k = sum(isinstance(c, ConvBN) for c in owner.children())
    layer = ConvBN(in_features, features, kernel, strides, padding, dtype=owner.dtype,
                   device=owner.device)
    owner.add_module(f"ConvBN_{k}", layer)
    return layer


def _chain(layers, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


class _Mixed(nn.Module):
    """A block of ConvBN branches. Each branch is a list of layers in the
    order it runs (plain lists, so that every layer is registered once,
    under its flax name)."""

    def __init__(self, dtype, device):
        super().__init__()
        self.dtype, self.device = dtype, device


class InceptionA(_Mixed):
    def __init__(self, in_features: int, pool_features: int, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__(dtype, device)
        cbn = partial(_cbn, self)
        self.branches = [[cbn(in_features, 64)],
                         [cbn(in_features, 48), cbn(48, 64, (5, 5))],
                         [cbn(in_features, 64), cbn(64, 96, (3, 3)), cbn(96, 96, (3, 3))]]
        self.pool_branch = [cbn(in_features, pool_features)]
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_chain(b, x) for b in self.branches]
                         + [_chain(self.pool_branch, avg_pool_same_3x3(x))], dim=1)


class ReductionA(_Mixed):
    def __init__(self, in_features: int, *, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        cbn = partial(_cbn, self)
        self.branches = [[cbn(in_features, 384, (3, 3), (2, 2), "VALID")],
                         [cbn(in_features, 64), cbn(64, 96, (3, 3)),
                          cbn(96, 96, (3, 3), (2, 2), "VALID")]]
        self.out_features = 384 + 96 + in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_chain(b, x) for b in self.branches] + [F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionB(_Mixed):
    def __init__(self, in_features: int, channels_7x7: int, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__(dtype, device)
        c, cbn = channels_7x7, partial(_cbn, self)
        self.branches = [[cbn(in_features, 192)],
                         [cbn(in_features, c), cbn(c, c, (1, 7)), cbn(c, 192, (7, 1))],
                         [cbn(in_features, c), cbn(c, c, (7, 1)), cbn(c, c, (1, 7)),
                          cbn(c, c, (7, 1)), cbn(c, 192, (1, 7))]]
        self.pool_branch = [cbn(in_features, 192)]
        self.out_features = 4 * 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_chain(b, x) for b in self.branches]
                         + [_chain(self.pool_branch, avg_pool_same_3x3(x))], dim=1)


class ReductionB(_Mixed):
    def __init__(self, in_features: int, *, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        cbn = partial(_cbn, self)
        self.branches = [[cbn(in_features, 192), cbn(192, 320, (3, 3), (2, 2), "VALID")],
                         [cbn(in_features, 192), cbn(192, 192, (1, 7)), cbn(192, 192, (7, 1)),
                          cbn(192, 192, (3, 3), (2, 2), "VALID")]]
        self.out_features = 320 + 192 + in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([_chain(b, x) for b in self.branches] + [F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionC(_Mixed):
    """Branches 2 and 3 end in a 1×3 and a 3×1 ConvBN side by side over the
    same input."""

    def __init__(self, in_features: int, *, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        cbn = partial(_cbn, self)
        self.b1 = [cbn(in_features, 320)]
        self.b2 = [cbn(in_features, 384)]
        self.b2_split = [cbn(384, 384, (1, 3)), cbn(384, 384, (3, 1))]
        self.b3 = [cbn(in_features, 448), cbn(448, 384, (3, 3))]
        self.b3_split = [cbn(384, 384, (1, 3)), cbn(384, 384, (3, 1))]
        self.pool_branch = [cbn(in_features, 192)]
        self.out_features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2, b3 = _chain(self.b2, x), _chain(self.b3, x)
        return torch.cat([_chain(self.b1, x), *(layer(b2) for layer in self.b2_split),
                          *(layer(b3) for layer in self.b3_split),
                          _chain(self.pool_branch, avg_pool_same_3x3(x))], dim=1)


# The stem's two 3x3 stride-2 VALID max pools, between its ConvBNs.
_POOL = "max_pool"


class InceptionV3(Model):
    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16, *, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.device = dtype, device
        cbn = partial(_cbn, self)
        # Stem: 299 -> 35 spatial at the standard input size.
        self.stem = [cbn(3, 32, (3, 3), (2, 2), "VALID"), cbn(32, 32, (3, 3), padding="VALID"),
                     cbn(32, 64, (3, 3), padding="SAME"), _POOL,
                     cbn(64, 80, (1, 1), padding="VALID"), cbn(80, 192, (3, 3), padding="VALID"),
                     _POOL]
        blocks, features = [], 192
        for cls, args in ((InceptionA, (32,)), (InceptionA, (64,)), (InceptionA, (64,)),
                          (ReductionA, ()), (InceptionB, (128,)), (InceptionB, (160,)),
                          (InceptionB, (160,)), (InceptionB, (192,)), (ReductionB, ()),
                          (InceptionC, ()), (InceptionC, ())):
            block = cls(features, *args, dtype=dtype, device=device)
            k = sum(isinstance(b, cls) for b in blocks)
            self.add_module(f"{cls.__name__}_{k}", block)
            blocks.append(block)
            features = block.out_features
        self.blocks = blocks
        self.dropout_generator = dropout_generator(device, seed + 1)
        self.dropout = Dropout(0.5, self.dropout_generator)
        self.head = Dense(features, num_classes, dtype=torch.float32, device=device)
        self._draw(device, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_last(x, self.dtype)
        for layer in self.stem:
            x = F.max_pool2d(x, 3, 2) if layer is _POOL else layer(x)
        for block in self.blocks:
            x = block(x)
        return self.head(self.dropout(global_mean(x)))
