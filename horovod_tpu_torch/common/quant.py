"""Int8 wire-format constants and byte accounting.

The port's copy of ``horovod_tpu/common/quant.py``, kept whole: the int8
ring of ``ops/quantized.py`` and any planner must agree on one wire format,
symmetric blockwise int8 with one float32 scale per ``BLOCK`` elements,
the scales packed behind the payload in the same buffer.
"""

from __future__ import annotations

# Elements sharing one scale. Small enough that a low-magnitude gradient
# leaf (layernorm/bias) packed into a fusion bucket next to a large-
# magnitude one keeps its own scales instead of rounding to zero against
# the bucket's global amax; 4 scale bytes per 256 payload bytes = 1.6%
# wire overhead.
BLOCK = 256

# Each scale is one float32.
SCALE_BYTES = 4

# Wire dtype labels used by compositor plans and the plan verifier.
# bf16 is a PURE cast rung: half the bytes of f32, no scales, no error
# feedback — valid for every collective (a cast commutes with any data
# movement and any SUM/AVERAGE), unlike int8 whose blockwise scales only
# compose with the allreduce/reduce-scatter constructions.
WIRE_F32 = "f32"
WIRE_BF16 = "bf16"
WIRE_INT8 = "int8"
WIRE_DTYPES = (WIRE_F32, WIRE_BF16, WIRE_INT8)


def int8_wire_bytes(nbytes: int, dtype_bytes: int = 4) -> int:
    """Bytes a stage that declared ``nbytes`` of full-precision traffic
    actually moves with the int8+scales format: one byte per element
    plus one f32 scale per BLOCK elements. ``dtype_bytes`` is the
    payload's full-precision element width (plans price f32)."""
    nbytes = max(int(nbytes), 0)
    if nbytes == 0:
        return 0
    elems = -(-nbytes // int(dtype_bytes))  # ceil
    blocks = -(-elems // BLOCK)
    return elems + SCALE_BYTES * blocks


def bf16_wire_bytes(nbytes: int, dtype_bytes: int = 4) -> int:
    """Bytes a stage that declared ``nbytes`` of full-precision traffic
    moves with the bf16 cast format: two bytes per element, no scales."""
    nbytes = max(int(nbytes), 0)
    if nbytes == 0:
        return 0
    elems = -(-nbytes // int(dtype_bytes))  # ceil
    return 2 * elems


def int8_saved_bytes(nbytes: int, dtype_bytes: int = 4) -> int:
    """Full-precision bytes minus the int8 wire bytes (>= 0 for any
    dtype wider than 1 byte)."""
    return max(int(nbytes) - int8_wire_bytes(nbytes, dtype_bytes), 0)
