"""ResNet family: the counterpart of ``horovod_tpu/models/resnet.py``.

The headline benchmark model (``bench.py --model resnet50``). The modules
hold their parameters and running statistics under the flax names
(``conv_init``, ``bn_init``, ``BottleneckBlock_{k}/Conv_{0,1,2}``,
``.../BatchNorm_{0,1,2}``, ``.../conv_proj``, ``.../norm_proj``, ``head``),
so every leaf maps one to one onto the flax tree (``.`` for ``/``).

``forward(x)`` takes NHWC images, computes in ``dtype`` (bf16 by default)
over channels-last memory with f32 parameters and f32 batch statistics,
and returns f32 logits. ``model.train()`` (the default) normalises with
each batch's statistics and updates the running ones; ``model.eval()``
normalises with the running statistics, as flax's ``train=False``.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple, Type

import torch
import torch.nn.functional as F
from torch import nn

from ..common.basics import resolve_device
from .layers import BatchNorm, Conv, Dense, Model, global_mean, to_channels_last


class _Block(nn.Module):
    """What the two block types share: the flax norm settings and the
    projection of the residual when the block changes its shape."""

    def _norm(self, features: int, zero_scale: bool = False) -> BatchNorm:
        return BatchNorm(features, momentum=0.9, epsilon=1e-5, zero_scale=zero_scale,
                         dtype=self.dtype, device=self.device)

    def _conv(self, in_features: int, features: int, kernel: Tuple[int, int],
              strides: Tuple[int, int] = (1, 1)) -> Conv:
        return Conv(in_features, features, kernel, strides, use_bias=False, dtype=self.dtype,
                    device=self.device)

    def _maybe_project(self, in_features: int, strides: Tuple[int, int]) -> None:
        out = self.out_features
        if in_features != out or tuple(strides) != (1, 1):
            self.conv_proj = self._conv(in_features, out, (1, 1), strides)
            self.norm_proj = self._norm(out)
        else:
            self.conv_proj = self.norm_proj = None

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))


class BottleneckBlock(_Block):
    """1×1, 3×3 (carrying the stride, flax SAME padding), 1×1 to
    ``4 · filters``; the last norm starts at zero scale."""

    def __init__(self, in_features: int, filters: int, strides: Tuple[int, int] = (1, 1), *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype, self.device = dtype, device
        self.out_features = 4 * filters
        self.Conv_0 = self._conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = self._norm(filters)
        self.Conv_1 = self._conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = self._norm(filters)
        self.Conv_2 = self._conv(filters, self.out_features, (1, 1))
        self.BatchNorm_2 = self._norm(self.out_features, zero_scale=True)
        self._maybe_project(in_features, strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(self._residual(x) + y)


class BasicBlock(_Block):
    """3×3 (carrying the stride), 3×3; the last norm starts at zero scale."""

    def __init__(self, in_features: int, filters: int, strides: Tuple[int, int] = (1, 1), *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype, self.device = dtype, device
        self.out_features = filters
        self.Conv_0 = self._conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = self._norm(filters)
        self.Conv_1 = self._conv(filters, filters, (3, 3))
        self.BatchNorm_1 = self._norm(filters, zero_scale=True)
        self._maybe_project(in_features, strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return F.relu(self._residual(x) + y)


class ResNet(Model):
    """The stem (7×7 stride-2 conv padded (3, 3), BN, relu, 3×3 stride-2
    max pool padded (1, 1)), ``stage_sizes`` blocks per stage (filters
    doubling and stride 2 at each later stage's first block), the global
    mean and an f32 ``head``. Parameters are drawn from ``seed`` with
    flax's default initialisers; ``device=None`` means the card."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16,
                 block: Type[_Block] = BottleneckBlock, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), padding=((3, 3), (3, 3)),
                              use_bias=False, dtype=dtype, device=device)
        self.bn_init = BatchNorm(num_filters, momentum=0.9, epsilon=1e-5, dtype=dtype,
                                 device=device)
        features, blocks = num_filters, []
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blk = block(features, num_filters * 2**i, strides, dtype=dtype, device=device)
                self.add_module(f"{block.__name__}_{len(blocks)}", blk)
                blocks.append(blk)
                features = blk.out_features
        self.blocks = blocks
        self.head = Dense(features, num_classes, dtype=torch.float32, device=device)
        self._draw(device, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn_init(self.conv_init(to_channels_last(x, self.dtype))))
        # flax's max_pool pads with -inf, as torch's does.
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        return self.head(global_mean(x))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
