"""VGG family: the counterpart of ``horovod_tpu/models/vgg.py``.

Parameters under the flax names (``conv{i}_{j}``, ``Dense_0``, ``Dense_1``,
``head``). ``forward(x)`` takes NHWC images and computes in ``dtype`` with
f32 parameters and f32 logits: 3×3 SAME convolutions with bias and relu, a
2×2 stride-2 max pool after each stage, the flatten in flax's (H, W, C)
order, two relu Dense layers each followed by dropout 0.5 in training, and
an f32 ``head``. flax sizes ``Dense_0`` from the input it first sees; the
port needs ``image_size``, the input's side, to create it.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F

from ..common.basics import resolve_device
from .layers import (
    Conv, Dense, Dropout, Model, dropout_generator, flatten_hwc, to_channels_last,
)


class VGG(Model):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dense_features: int = 4096, dtype=torch.bfloat16, *,
                 image_size: int = 224, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.convs = []
        features, side = 3, image_size
        for i, n_convs in enumerate(stage_sizes):
            filters = min(num_filters * 2**i, 512)
            stage = []
            for j in range(n_convs):
                conv = Conv(features, filters, (3, 3), padding="SAME", dtype=dtype, device=device)
                self.add_module(f"conv{i}_{j}", conv)
                stage.append(conv)
                features = filters
            self.convs.append(stage)
            side //= 2
        self.Dense_0 = Dense(side * side * features, dense_features, dtype=dtype, device=device)
        self.Dense_1 = Dense(dense_features, dense_features, dtype=dtype, device=device)
        self.head = Dense(dense_features, num_classes, dtype=torch.float32, device=device)
        # One generator for both dropout layers, so their masks differ.
        self.dropout_generator = dropout_generator(device, seed + 1)
        self.dropout_0 = Dropout(0.5, self.dropout_generator)
        self.dropout_1 = Dropout(0.5, self.dropout_generator)
        self._draw(device, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_last(x, self.dtype)
        for stage in self.convs:
            for conv in stage:
                x = F.relu(conv(x))
            x = F.max_pool2d(x, 2, 2)
        x = flatten_hwc(x)
        x = self.dropout_0(F.relu(self.Dense_0(x)))
        x = self.dropout_1(F.relu(self.Dense_1(x)))
        return self.head(x)


VGG11 = partial(VGG, stage_sizes=[1, 1, 2, 2, 2])
VGG16 = partial(VGG, stage_sizes=[2, 2, 3, 3, 3])
VGG19 = partial(VGG, stage_sizes=[2, 2, 4, 4, 4])
