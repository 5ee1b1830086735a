"""Collectives on ``torch.distributed``: allreduce, allgather, broadcast,
alltoall and the ring shift.

The counterpart of ``horovod_tpu/ops/collectives.py``. The JAX package
lowers each collective to an XLA collective over a named mesh axis; here
each is one call on a process group (NCCL on the card, gloo on the CPU):
``group=None`` is every rank of the job, and a mesh axis's group
(``parallel/mesh.py``) plays the part of ``axis_name``. The functions return
new tensors and leave their input as it was, as the JAX ones do;
``broadcast_`` writes in place for the callers that own the tensor.

``alltoall`` and ``ring_shift`` are differentiable (``autograd.Function``s
whose backward is the transposed exchange), because sequence parallelism
differentiates through them, as JAX differentiates ``all_to_all`` and
``ppermute``.

Reference semantics kept:
 - op=Average sums, then divides by the number of ranks in the group;
 - the prescale and postscale factors of ``_maybe_scale`` (scaled in f32
   for half-precision inputs);
 - allgather concatenates equal shapes along dim 0;
 - broadcast gives every rank the root's value, and rejects a root out of
   range (``root_rank`` is a rank of the group);
 - alltoall is ``lax.all_to_all(..., tiled=True)``: split along
   ``split_axis`` into one chunk per rank, chunk j to rank j, the chunks
   received concatenated along ``concat_axis`` in rank order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..common.types import ReduceOp

Group = Optional[dist.ProcessGroup]

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
    group: Group = None,
) -> torch.Tensor:
    """In-place allreduce of ``x`` over the group's ranks; returns the
    result, which is ``x`` itself unless a scale factor applies."""
    if op not in _TORCH_OPS:
        raise ValueError(f"Unsupported reduce op: {op}")
    x = _maybe_scale(x, prescale_factor)
    dist.all_reduce(x, op=_TORCH_OPS[op], group=group)
    if op == ReduceOp.AVERAGE:
        n = dist.get_world_size(group)
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
    group: Group = None,
) -> torch.Tensor:
    """Allreduce over the group's ranks; ``x`` is left unchanged."""
    return allreduce_(
        x.clone(), op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, group=group,
    )


def allgather(x: torch.Tensor, *, group: Group = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0. All ranks pass the same
    shape, as the JAX package requires."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _check_root(root_rank: int, group: Group) -> None:
    n = dist.get_world_size(group)
    if not 0 <= int(root_rank) < n:
        raise ValueError(
            f"broadcast root_rank {root_rank} out of range for {n} ranks"
        )


def broadcast_(x: torch.Tensor, *, root_rank: int = 0, group: Group = None) -> torch.Tensor:
    """Overwrite ``x`` on the group's ranks with the root's value, in place."""
    _check_root(root_rank, group)
    dist.broadcast(x, group=group, group_src=int(root_rank))
    return x


def broadcast(x: torch.Tensor, *, root_rank: int = 0, group: Group = None) -> torch.Tensor:
    """Every rank of the group receives the root's value; ``x`` is left
    unchanged."""
    return broadcast_(x.clone(), root_rank=root_rank, group=group)


def _alltoall(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(
            f"alltoall: dim {split_axis} of size {x.shape[split_axis]} does not "
            f"split into {n} equal chunks"
        )
    chunks = torch.stack(x.chunk(n, dim=split_axis))   # [n, ...], chunk j for rank j
    received = torch.empty_like(chunks)
    dist.all_to_all_single(received, chunks, group=group)
    return torch.cat(received.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _alltoall(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        # The transpose of a tiled all-to-all is the inverse all-to-all.
        return _alltoall(grad.contiguous(), *ctx.args), None, None, None


def alltoall(
    x: torch.Tensor,
    *,
    group: Group = None,
    split_axis: int = 0,
    concat_axis: int = 0,
) -> torch.Tensor:
    """Tiled all-to-all over the group (``lax.all_to_all(tiled=True)``):
    ``x`` splits along ``split_axis`` into one chunk per rank, chunk j goes
    to rank j, and the received chunks concatenate along ``concat_axis`` in
    rank order. Differentiable."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _shift(x: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """Send ``x`` to group rank r + step, receive from r - step (mod n)."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    out = torch.empty_like(x)
    # Point-to-point calls name global ranks, also on a subgroup.
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + step) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - step) % n), group),
    ])
    for w in works:
        w.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, +1)

    @staticmethod
    def backward(ctx, grad):
        # The transpose of ppermute(i -> i+1) sends the cotangent back.
        return _shift(grad.contiguous(), ctx.group, -1), None


def ring_shift(x: torch.Tensor, *, group: Group = None) -> torch.Tensor:
    """One step of the ring: ``lax.ppermute`` with perm ``[(i, (i+1) % n)]``
    over the group. Every rank sends ``x`` to the next rank and returns what
    the previous rank sent, in one ``batch_isend_irecv`` (every rank of the
    group must call it, in the same order as the others). Differentiable:
    the backward sends the cotangent the other way. With one rank it is the
    identity and sends nothing."""
    return _RingShift.apply(x.contiguous(), group)
