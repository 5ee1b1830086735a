"""Small MNIST CNN: the counterpart of ``horovod_tpu/models/mnist_cnn.py``
(conv32-conv64-pool-dense128-dense10).

Parameters under the flax names (``Conv_0``, ``Conv_1``, ``Dense_0``,
``Dense_1``). ``forward(x)`` takes NHWC images and computes in ``dtype``
(f32 by default): two 3×3 SAME convolutions with bias and relu, a 2×2
stride-2 max pool, the flatten in flax's (H, W, C) order, a relu Dense of
128 and an f32 output layer. flax sizes ``Conv_0`` and ``Dense_0`` from
the input it first sees; the port needs its channels (``in_features``, 1
for MNIST) and side (``image_size``) to create them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common.basics import resolve_device
from .layers import Conv, Dense, Model, flatten_hwc, to_channels_last


class MnistCNN(Model):
    def __init__(self, num_classes: int = 10, dtype=torch.float32, *, in_features: int = 1,
                 image_size: int = 28, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.Conv_0 = Conv(in_features, 32, (3, 3), dtype=dtype, device=device)
        self.Conv_1 = Conv(32, 64, (3, 3), dtype=dtype, device=device)
        side = image_size // 2
        self.Dense_0 = Dense(side * side * 64, 128, dtype=dtype, device=device)
        self.Dense_1 = Dense(128, num_classes, dtype=torch.float32, device=device)
        self._draw(device, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Conv_0(to_channels_last(x, self.dtype)))
        x = F.relu(self.Conv_1(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.Dense_0(flatten_hwc(x)))
        return self.Dense_1(x)
