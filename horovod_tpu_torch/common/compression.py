"""Gradient compression on the wire, for torch tensors.

The counterpart of ``horovod_tpu/common/compression.py``: a cast before the
collective and a cast back after it. ``fp16`` and ``bf16`` compress float32
and float64 tensors and leave every other dtype as it is.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

_COMPRESSIBLE = (torch.float32, torch.float64)


class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    @staticmethod
    def compress(tensor: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Returns (compressed_tensor, context) for decompression."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx: Any) -> torch.Tensor:
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Default no-op compression."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype in _COMPRESSIBLE:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx: Optional[torch.dtype]):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """Cast fp32/fp64 to fp16 for the collective."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast fp32/fp64 to bf16 for the collective (fp32's exponent range)."""

    wire_dtype = torch.bfloat16


class Compression:
    """Optional gradient compression used during allreduce (API parity with
    ``hvd.Compression``)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
