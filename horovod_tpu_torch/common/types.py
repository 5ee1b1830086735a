"""Reduction ops of the public API.

The port's copy of ``ReduceOp`` from ``horovod_tpu/common/types.py``, with
the same values and the same public aliases. Adasum is declared so that
the names match, but no collective of the port accepts it yet.
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    """Average/Sum/Adasum mirror the reference's enum; Min/Max/Product are
    the JAX package's extensions, here backed by ``torch.distributed``."""

    AVERAGE = 1
    SUM = 2
    ADASUM = 3
    MIN = 4
    MAX = 5
    PRODUCT = 6


# Public aliases, parity with hvd.Average / hvd.Sum / hvd.Adasum.
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
