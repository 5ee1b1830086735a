"""The flax layers the port's models are built from, as ``nn.Module``s
that hold their parameters under flax's names and draw them with flax's
default initialisers.

The CNN layers take the reference's NHWC images through
:func:`to_channels_last` (a permuted view: logical NCHW over
``torch.channels_last`` memory, which is what cuDNN's bf16 tensor-core
convolutions want, with no copy) and keep flax's semantics:

- :class:`Conv` stores its kernel OIHW (flax: HWIO) and pads as flax does.
  ``"SAME"`` pads ``total = max((ceil(n / s) - 1) s + k - n, 0)`` with the
  smaller half first, so a 3×3 stride-2 convolution over an even side pads
  (0, 1), not torch's symmetric (1, 1); such pads go through ``F.pad``.
- :class:`BatchNorm` normalises in f32 with f32 statistics, casts the
  result to ``dtype``, and updates its running statistics itself as
  ``0.9 ra + 0.1 batch`` with the *biased* batch variance (torch's
  ``batch_norm`` would store the unbiased one).
- :class:`Dropout` draws its keep mask from an explicit
  ``torch.Generator``; :meth:`Dropout.keep_mask` is the one place a mask
  is drawn.

Every layer computes in its ``dtype`` (the input and the f32 parameters
cast to it), as flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal keeps std 1 over [-2, 2]: the stddev of a unit
# normal truncated there is this factor, which lecun_normal divides out.
_TRUNC_STD = 0.87962566103423978

Padding = Union[str, Sequence[Tuple[int, int]]]


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init, in place: truncated normal over [-2, 2]
    standard deviations, std 1/sqrt(fan_in)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``[in, out]``, optional bias; the forward
    computes ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over channels-last NCHW: kernel OIHW (the flax
    kernel HWIO transposed), optional bias, ``padding`` ``"SAME"``,
    ``"VALID"`` or explicit ((low, high), (low, high))."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME", *,
                 use_bias: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, *kernel_size,
                                               device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def pads(self, height: int, width: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """((low, high) over H, (low, high) over W) for an input of this size."""
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            _, _, kh, kw = self.kernel.shape
            return (same_pads(height, kh, self.strides[0]),
                    same_pads(width, kw, self.strides[1]))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hl, hh), (wl, wh) = self.pads(x.shape[2], x.shape[3])
        x = x.to(self.dtype)
        if hl == hh and wl == wh:
            padding = (hl, wl)
        else:
            x = F.pad(x, (wl, wh, hl, hh))
            padding = (0, 0)
        w = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, stride=self.strides, padding=padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW: parameters
    ``scale`` and ``bias``, running statistics in the buffers ``mean`` and
    ``var`` (all f32). ``momentum`` is flax's (the weight of the old
    running value); ``zero_scale`` initialises the scale to zeros, as the
    last norm of a residual block does."""

    def __init__(self, features: int, *, momentum: float = 0.9, epsilon: float = 1e-5,
                 zero_scale: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.momentum, self.epsilon, self.zero_scale, self.dtype = (
            momentum, epsilon, zero_scale, dtype)
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))
        if device is None or torch.device(device).type != "meta":
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=self.epsilon).to(self.dtype)
        # Normalise with the batch statistics (f32, biased variance); the
        # op returns the batch mean and 1/sqrt(var + eps), from which the
        # running statistics are updated here.
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.epsilon)
            stats = [self.mean, self.var]
            torch._foreach_mul_(stats, self.momentum)
            torch._foreach_add_(stats, [mean, var], alpha=1.0 - self.momentum)
        return y.to(self.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``. The mask is
    drawn from ``generator``, which the model owns and seeds."""

    def __init__(self, rate: float, generator: torch.Generator):
        super().__init__()
        self.rate, self.generator = rate, generator

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.rand(x.shape, generator=self.generator, device=x.device) >= self.rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = self.keep_mask(x)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))


def to_channels_last(x: torch.Tensor, dtype) -> torch.Tensor:
    """NHWC images as logical NCHW over channels-last memory (a view of
    the cast input, no copy)."""
    return x.to(dtype).permute(0, 3, 1, 2)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, H·W·C] in flax's (H, W, C) order, so a flax
    Dense kernel that follows a flatten carries over unchanged."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of an NHWC ``x``: accumulated in f32,
    returned in ``x``'s dtype."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


class Model(nn.Module):
    """A model of layers drawn with flax's initialisers: the base of the
    CNN zoo."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every layer's parameters from ``generator``, in module order,
        and reset the running statistics."""
        for sub in self.modules():
            if isinstance(sub, (Dense, Conv, BatchNorm)):
                sub.reset_parameters(generator)

    def _draw(self, device: torch.device, seed: int) -> None:
        if device.type != "meta":
            self.reset_parameters(torch.Generator(device=device).manual_seed(seed))


def dropout_generator(device: torch.device, seed: int) -> Optional[torch.Generator]:
    """The generator a model's dropout layers share (None on the meta
    device, where nothing is drawn)."""
    return None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
