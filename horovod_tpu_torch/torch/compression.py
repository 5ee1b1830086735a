"""Gradient compression for the torch binding (``hvd.Compression``).

The counterpart of ``horovod_tpu/torch/compression.py``: ``none``, ``fp16``
and ``bf16``, a cast of float32/float64 tensors to the wire dtype before
the collective and a cast back after it. ``common/compression.py`` has
exactly these semantics, so the binding re-exports it.
"""

from ..common.compression import (  # noqa: F401
    BF16Compressor,
    Compression,
    Compressor,
    FP16Compressor,
    NoneCompressor,
)
