"""Collectives on ``torch.distributed``: allreduce, allgather, broadcast.

The counterpart of ``horovod_tpu/ops/collectives.py``. The JAX package
lowers each collective to an XLA collective over a named mesh axis; here
each is one call on the default process group (NCCL on the card, gloo on
the CPU), over every rank of the job. The functions return new tensors and
leave their input as it was, as the JAX ones do; ``broadcast_`` writes in
place for the callers that own the tensor.

Reference semantics kept:
 - op=Average sums, then divides by the number of ranks;
 - the prescale and postscale factors of ``_maybe_scale`` (scaled in f32
   for half-precision inputs);
 - allgather concatenates equal shapes along dim 0;
 - broadcast gives every rank the root's value, and rejects a root out of
   range.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..common.types import ReduceOp

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def _maybe_scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    if factor == 1.0:
        return x
    # Scale in fp32 for low-precision inputs so the factor is not rounded
    # to bf16/fp16 first.
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.float() * factor).to(x.dtype)
    return x * torch.tensor(factor, dtype=x.dtype)


def allreduce_(
    x: torch.Tensor,
    *,
    op: ReduceOp = ReduceOp.SUM,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """In-place allreduce of ``x`` over every rank; returns the result,
    which is ``x`` itself unless a scale factor applies."""
    if op not in _TORCH_OPS:
        raise ValueError(f"Unsupported reduce op: {op}")
    x = _maybe_scale(x, prescale_factor)
    dist.all_reduce(x, op=_TORCH_OPS[op])
    if op == ReduceOp.AVERAGE:
        n = dist.get_world_size()
        if x.is_floating_point():
            x.div_(n)
        else:
            x.div_(n, rounding_mode="trunc")
    return _maybe_scale(x, postscale_factor)


def allreduce(
    x: torch.Tensor,
    *,
    op: ReduceOp = ReduceOp.SUM,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """Allreduce over every rank; ``x`` is left unchanged."""
    return allreduce_(
        x.clone(), op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
    )


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0. All ranks pass the same
    shape, as the JAX package requires."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


def _check_root(root_rank: int) -> None:
    n = dist.get_world_size()
    if not 0 <= int(root_rank) < n:
        raise ValueError(
            f"broadcast root_rank {root_rank} out of range for {n} ranks"
        )


def broadcast_(x: torch.Tensor, *, root_rank: int = 0) -> torch.Tensor:
    """Overwrite ``x`` on every rank with the root's value, in place."""
    _check_root(root_rank)
    dist.broadcast(x, src=int(root_rank))
    return x


def broadcast(x: torch.Tensor, *, root_rank: int = 0) -> torch.Tensor:
    """Every rank receives the root's value; ``x`` is left unchanged."""
    return broadcast_(x.clone(), root_rank=root_rank)
