"""Core types of the public API and of the eager control plane.

The port's copy of ``horovod_tpu/common/types.py``: the reduce ops with
the same values and public aliases, the ``Status`` of a named operation,
the wire dtype enum with maps to and from torch dtypes (the values are the
JAX package's, so a plan names the same dtype on either side of the native
core), and the request/response enums and the table entry of the eager
runtime.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch


class StatusType(enum.IntEnum):
    # The reference's common.h:96-98.
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclass(frozen=True)
class Status:
    type: StatusType = StatusType.OK
    reason: str = ""

    def ok(self) -> bool:
        return self.type == StatusType.OK

    def in_progress(self) -> bool:
        return self.type == StatusType.IN_PROGRESS

    def timed_out(self) -> bool:
        """A wait gave up while the operation was still in progress: the
        type stays IN_PROGRESS and the reason says what timed out."""
        return self.type == StatusType.IN_PROGRESS and bool(self.reason)

    @staticmethod
    def OK() -> "Status":  # noqa: N802 - the reference's names
        return Status(StatusType.OK)

    @staticmethod
    def UnknownError(msg: str) -> "Status":  # noqa: N802
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def PreconditionError(msg: str) -> "Status":  # noqa: N802
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def Aborted(msg: str) -> "Status":  # noqa: N802
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def InvalidArgument(msg: str) -> "Status":  # noqa: N802
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def InProgress() -> "Status":  # noqa: N802
        return Status(StatusType.IN_PROGRESS)

    @staticmethod
    def TimedOut(msg: str) -> "Status":  # noqa: N802
        return Status(StatusType.IN_PROGRESS, msg)


# The reference's common.h:153-158.
SHUT_DOWN_ERROR = Status.Aborted(
    "Horovod has been shut down. This was caused by an exception on one of "
    "the ranks or an attempt to allreduce, allgather or broadcast a tensor "
    "after one of the ranks finished execution."
)

DUPLICATE_NAME_ERROR_FMT = (
    "Requested to {op} a tensor with the same name as another tensor that is "
    "currently being processed. If you want to request another tensor, use a "
    "different tensor name."
)


class DataType(enum.IntEnum):
    """Wire dtype enum, values of the reference's message.h:27-41 and the
    JAX package's additions (BFLOAT16, COMPLEX64)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10
    COMPLEX64 = 11


_TORCH_TO_DTYPE = {
    torch.uint8: DataType.UINT8,
    torch.int8: DataType.INT8,
    torch.uint16: DataType.UINT16,
    torch.int16: DataType.INT16,
    torch.int32: DataType.INT32,
    torch.int64: DataType.INT64,
    torch.float16: DataType.FLOAT16,
    torch.float32: DataType.FLOAT32,
    torch.float64: DataType.FLOAT64,
    torch.bool: DataType.BOOL,
    torch.bfloat16: DataType.BFLOAT16,
    torch.complex64: DataType.COMPLEX64,
}
_DTYPE_TO_TORCH = {v: k for k, v in _TORCH_TO_DTYPE.items()}
_NP_NAME_TO_DTYPE = {
    "uint8": DataType.UINT8, "int8": DataType.INT8, "uint16": DataType.UINT16,
    "int16": DataType.INT16, "int32": DataType.INT32, "int64": DataType.INT64,
    "float16": DataType.FLOAT16, "float32": DataType.FLOAT32,
    "float64": DataType.FLOAT64, "bool": DataType.BOOL,
    "bfloat16": DataType.BFLOAT16, "complex64": DataType.COMPLEX64,
}


def dtype_from_array(array: Any) -> DataType:
    """The wire dtype of a torch tensor or a numpy array."""
    dt = getattr(array, "dtype", None)
    found = (_TORCH_TO_DTYPE.get(dt) if isinstance(dt, torch.dtype)
             else _NP_NAME_TO_DTYPE.get(str(np.dtype(dt))) if dt is not None else None)
    if found is None:
        raise ValueError(f"Unsupported dtype for collective: {dt}")
    return found


def dtype_size(dtype: DataType) -> int:
    return _DTYPE_TO_TORCH[DataType(dtype)].itemsize


def torch_dtype(dtype: DataType) -> torch.dtype:
    """The torch dtype of a wire dtype (a plan's ``dtype``)."""
    return _DTYPE_TO_TORCH[DataType(dtype)]


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


class RequestType(enum.IntEnum):
    # The reference's message.h:48-50 and the JAX package's ALLTOALL,
    # REDUCESCATTER and ADASUM.
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ALLTOALL = 4
    REDUCESCATTER = 5
    ADASUM = 6


class ResponseType(enum.IntEnum):
    # The reference's message.h:131-136 (a plan's "type").
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ALLTOALL = 4
    REDUCESCATTER = 5
    ADASUM = 6
    ERROR = 7


@dataclass
class TensorTableEntry:
    """One pending named submission (the reference's common.h:209-234).

    ``tensor`` is a torch tensor. On the card, ``context["ready"]`` holds the
    CUDA event recorded on the caller's stream at enqueue (the reference's
    ready event, operations.cc:261-285): the executor's stream waits on it
    before it reads the tensor. ``context["host"]`` says the caller passed a
    numpy array, which comes back as one."""

    name: str
    tensor: Any
    root_rank: int = -1
    callback: Optional[Callable[[Status, Any], None]] = None
    reduce_op: ReduceOp = ReduceOp.SUM
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    output: Any = None
    context: dict = field(default_factory=dict)
