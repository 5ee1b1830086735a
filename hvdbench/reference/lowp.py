"""The products of the references, in float32 or in the control's lower
precision.

The control stands the reference in the program's place one precision
below what the configuration states: the products the configuration runs
in bfloat16 take fp8 operands (e4m3 forward, e5m2 for the gradients that
flow back, each tensor scaled to its format's largest value, as fp8
training scales them), and the products it runs in float32 with TF32 off
take TF32 operands (a 10-bit mantissa). Every product accumulates in
float32, as the fp8 and TF32 tensor-core paths do.

``bf16`` is a witness, not a control: the products the configuration runs
in bfloat16 take bfloat16 operands, as the program's do, so that a gap the
program reads can be told from one that its precision alone gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def set_fp32_math() -> None:
    """Float32 products as float32: no TF32 on the card, and cuDNN's
    default algorithms (no autotune that the program's run switched on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def fp8_round(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under one scale for the tensor (its largest
    magnitude onto the format's largest value), back in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / torch.finfo(fmt).max
    return ((x / scale).to(fmt).to(x.dtype)) * scale


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


PRECISIONS = ("f32", "control", "bf16")


class Products:
    """``mm`` and ``conv`` for one precision. ``wide=True`` marks a product
    the configuration states in float32 (the LM head)."""

    def __init__(self, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def _op(self, x: torch.Tensor, wide: bool) -> torch.Tensor:
        if self.precision == "f32":
            return x
        if self.precision == "bf16":
            return x if wide else _Bf16.apply(x)
        return _Tf32.apply(x) if wide else _Fp8.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor, wide: bool = False) -> torch.Tensor:
        return self._op(a, wide) @ self._op(b, wide)

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
        return F.conv2d(self._op(x, False), self._op(w, False), None, stride, padding)
