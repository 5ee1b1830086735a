"""Collectives on ``torch.distributed``: allreduce, allgather,
reducescatter, broadcast, alltoall, the ring shift and the two-level
(``hierarchical_*``) family.

The counterpart of ``horovod_tpu/ops/collectives.py``. The JAX package
lowers each collective to an XLA collective over a named mesh axis; here
each is one call on a process group (NCCL on the card, gloo on the CPU):
``group=None`` is every rank of the job, and a mesh axis's group
(``parallel/mesh.py``) plays the part of ``axis_name``. The functions return
new tensors and leave their input as it was, as the JAX ones do;
``broadcast_`` writes in place for the callers that own the tensor.

``allgather``, ``alltoall`` and ``ring_shift`` are differentiable
(``autograd.Function``s whose backward is the transposed exchange: the
reduce-scatter for the gather, the inverse exchange for the others), because
sequence and tensor parallelism differentiate through them, as JAX
differentiates ``all_gather``, ``all_to_all`` and ``ppermute``.

Reference semantics kept:
 - op=Average sums, then divides by the number of ranks in the group;
 - the prescale and postscale factors of ``_maybe_scale`` (scaled in f32
   for half-precision inputs);
 - allgather concatenates equal shapes along ``dim`` (0 by default) in
   rank order, as ``lax.all_gather(..., tiled=True)`` does;
 - reducescatter is ``lax.psum_scatter(..., tiled=True)``: the sum over
   ranks, split along ``dim`` into one chunk per rank, chunk r to rank r;
 - broadcast gives every rank the root's value, and rejects a root out of
   range (``root_rank`` is a rank of the group);
 - alltoall is ``lax.all_to_all(..., tiled=True)``: split along
   ``split_axis`` into one chunk per rank, chunk j to rank j, the chunks
   received concatenated along ``concat_axis`` in rank order.

The ``hierarchical_*`` collectives take a local and a cross group (the JAX
package's ``local_axis``/``cross_axis``) and run the topology compositor's
two-level schedules (``topo/compositor.py``) through :class:`Hop`, one
object a level. A tuple of groups, outermost first, plays the part of a
JAX axis-name tuple (:class:`AxisGroups`).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.types import ReduceOp, Status  # noqa: F401  (Status: the eager ops' status type)

Group = Optional[dist.ProcessGroup]


class AxisGroups(tuple):
    """The groups of several mesh axes, outermost first: the port's form of
    a JAX axis-name tuple such as ``("cross", "local")``. Every function
    that takes ``group=`` takes a tuple of groups for such a tuple; ``flat``
    is the one group over all of its ranks (what a ``psum`` over the tuple
    reduces in), which ``parallel.mesh.axis_groups`` builds from the mesh.
    A plain tuple has no ``flat``: it serves the per-level schedules only."""

    def __new__(cls, groups, flat: Group = None):
        self = super().__new__(cls, groups)
        self.flat = flat
        return self


def flat_group(group) -> Group:
    """The one group a flat collective over ``group`` runs in: the group
    itself, or the flattened group of an :class:`AxisGroups`."""
    if not isinstance(group, tuple):
        return group
    if len(group) == 1:
        return flat_group(group[0])
    flat = getattr(group, "flat", None)
    if flat is None:
        raise ValueError(
            "a flat collective over a tuple of groups needs their flattened group: "
            "build the tuple with parallel.mesh.axis_groups(mesh, axes)")
    return flat


def group_rank_size(group) -> Tuple[int, int]:
    """(this rank's index, the size) over a group or a hop, or over a tuple
    of them outer-major: index = sum of each level's rank times the sizes
    inside it, the flat rank order of the JAX package's axis tuples."""
    if isinstance(group, tuple):
        idx, n = 0, 1
        for g in group:
            r, s = group_rank_size(g)
            idx, n = idx * s + r, n * s
        return idx, n
    if hasattr(group, "exchange"):     # a hop
        return group.rank, group.n
    return dist.get_rank(group), dist.get_world_size(group)


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


def _allgather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _reducescatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(
            f"reducescatter: dim {dim} of size {x.shape[dim]} does not split "
            f"into {n} equal chunks"
        )
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        out = _allgather(x, group, dim)
        return out if out is not x else x.clone()

    @staticmethod
    def backward(ctx, grad):
        # The transpose of a tiled all-gather is the tiled reduce-scatter.
        return _reducescatter(grad, *ctx.args), None, None


def allgather(x: torch.Tensor, *, group: Group = None, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's tensor along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``). All ranks pass the same shape, as
    the JAX package requires. Differentiable: the backward is the tiled
    reduce-scatter (SUM) of the cotangent."""
    return _AllGather.apply(x, group, dim % x.dim())


def allgatherv(x: torch.Tensor, *, group: Group = None,
               max_dim0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allgather with dim 0 differing between ranks: every rank pads its
    ``x`` to ``max_dim0`` rows and the padded blocks are gathered, so the
    first result has ``size * max_dim0`` rows with each rank's padding
    zeroed; the second holds each rank's true dim 0 (int32, one a rank). The
    caller compacts the rows (the reference's displacement-based
    Allgatherv, ``mpi_operations.cc:83-162``). Not differentiable."""
    n = x.shape[0]
    if n > max_dim0:
        raise ValueError(f"allgatherv: dim 0 of {n} exceeds max_dim0={max_dim0}")
    padded = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, max_dim0 - n))
    sizes = torch.tensor([n], dtype=torch.int32, device=x.device)
    return _allgather(padded.contiguous(), group, 0), _allgather(sizes, group, 0)


def reducescatter(
    x: torch.Tensor,
    *,
    op: ReduceOp = ReduceOp.SUM,
    group: Group = None,
    dim: int = 0,
) -> torch.Tensor:
    """Sum ``x`` over the group's ranks and keep this rank's chunk of
    ``dim`` (``lax.psum_scatter(..., tiled=True)``): ``dim`` splits into one
    equal chunk per rank, chunk r to rank r. ``op=Average`` divides the sum
    by the group's size. ``x`` is left unchanged."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"reducescatter reduces SUM or AVERAGE, not {op}")
    out = _reducescatter(x, group, dim % x.dim())
    if op == ReduceOp.AVERAGE:
        out = out / dist.get_world_size(group)
    return out if out is not x else x.clone()


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


def ring_exchange(sends: Sequence[Tuple[torch.Tensor, int]], group: Group = None):
    """Post every ``(tensor, step)`` of ``sends`` in ONE
    ``batch_isend_irecv`` over the group: send the tensor to group rank
    r + step and receive a tensor of its shape from r - step (mod n), in the
    order given; every rank of the group posts the same steps. Point-to-point
    calls name global ranks, so this works on a subgroup. Returns the
    receive buffers and the works to wait on: on the card the transfers run
    on the process group's stream, and ``work.wait()`` makes the current
    stream wait for them, not the host."""
    group = group or dist.group.WORLD
    n, r = dist.get_world_size(group), dist.get_rank(group)
    recvs = [torch.empty_like(t) for t, _ in sends]
    ops = []
    for (t, step), buf in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, (r + step) % n), group))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (r - step) % n), group))
    return recvs, dist.batch_isend_irecv(ops)


def p2p_exchange(sends: Sequence[Tuple[torch.Tensor, int]] = (),
                 recvs: Sequence[Tuple[torch.Tensor, int]] = (), group: Group = None):
    """The non-cyclic sibling of :func:`ring_exchange`: post every ``(tensor,
    group rank)`` send and every ``(buffer, group rank)`` receive of this rank
    in ONE ``batch_isend_irecv`` over the group, and return the works (none
    when there is nothing to post). The peers must post the matching halves
    in their own call. NCCL takes a batch that involves only some of the
    group's ranks once the group's communicator exists, so a caller runs one
    collective on the group before its first such batch (``parallel/pp.py``'s
    ``StageLine`` does)."""
    group = group or dist.group.WORLD
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group)
            for buf, peer in recvs]
    return dist.batch_isend_irecv(ops) if ops else []


class Ring:
    """A ring over a group (a mesh axis's subgroup, or the world) as the
    ring schedules use it: ``post`` starts one hop, ``wait`` returns what
    arrived. Every hop is ONE :func:`ring_exchange` of all the hop's sends
    (NCCL on the card, gloo on the CPU). On the card the transfers run on
    the process group's own stream, which waits for the work the current
    stream has queued at ``post``, so a kernel queued after ``post``
    overlaps them; ``wait`` makes the current stream, not the host, wait for
    them. Anything with ``rank``, ``n``, ``post`` and ``wait`` can stand in
    for it (``chip_smoke.py`` plays 4 ranks on one card through one)."""

    def __init__(self, group: Group = None):
        self.group = group or dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def post(self, sends: Sequence[Tuple[torch.Tensor, int]]):
        return ring_exchange(sends, self.group)

    @staticmethod
    def wait(handle):
        recvs, works = handle
        for work in works:
            work.wait()
        return recvs


class Hop:
    """One level of a hierarchy of groups as the two-level schedules
    (``topo/compositor.py``, the int8 wire's and Adasum's hierarchical
    forms) use it: ``rank`` and ``n`` on the level and its primitives, each
    on dim 0 and returning a new tensor, over the level's process group.
    Anything with these members can stand in for it (``chip_smoke.py``
    plays a ``(cross, local)`` grid of ranks on one card through one)."""

    def __init__(self, group: Group = None):
        self.group = group or dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def all_reduce(self, x: torch.Tensor, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        """SUM, MIN or MAX over the level."""
        return allreduce(x, op=op, group=self.group)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The SUM over the level, chunk r of dim 0 to rank r."""
        return reducescatter(x, group=self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on dim 0 in rank order."""
        return _allgather(x, self.group, 0)

    def broadcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """The value of the level's rank ``root``."""
        return broadcast(x, root_rank=root, group=self.group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk j of dim 0 to rank j; the received chunks in rank order."""
        return _alltoall(x.contiguous(), self.group, 0, 0)

    def exchange(self, x: torch.Tensor, peer: int) -> torch.Tensor:
        """Send ``x`` to the level's rank ``peer`` and return its tensor."""
        global_peer = dist.get_global_rank(self.group, peer)
        buf = torch.empty_like(x)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x.contiguous(), global_peer, self.group),
                dist.P2POp(dist.irecv, buf, global_peer, self.group)]):
            work.wait()
        return buf

    @property
    def ring(self) -> "Ring":
        """The level as a ring (the int8 ring's transport)."""
        return Ring(self.group)


def as_hop(group: Any):
    """``group`` as a :class:`Hop`: a hop-like object is taken as it is, a
    process group (or None, every rank) is wrapped."""
    return group if hasattr(group, "exchange") else Hop(group)


def _two_level(lowering: str, x: torch.Tensor, cross_group, local_group, **kw) -> torch.Tensor:
    from ..topo import compositor

    return getattr(compositor, lowering)(x, (cross_group, local_group), algorithm="two-level",
                                         **kw)


def hierarchical_allreduce(x: torch.Tensor, *, op: ReduceOp = ReduceOp.SUM,
                           local_group, cross_group) -> torch.Tensor:
    """Two-level allreduce (``NCCLHierarchicalAllreduce``): reduce-scatter
    over the local group, allreduce of the shard over the cross group, then
    all-gather over the local group. MIN/MAX run as a per-level chain;
    PRODUCT and ADASUM raise (Adasum's hierarchical form is
    ``ops/adasum.hierarchical_adasum_allreduce``)."""
    return _two_level("lower_allreduce", x, cross_group, local_group, op=op)


def hierarchical_allgather(x: torch.Tensor, *, local_group, cross_group) -> torch.Tensor:
    """Two-level allgather: over the local group, then the blocks over the
    cross group; rank order ``cross * local_size + local`` makes it the flat
    allgather's result."""
    return _two_level("lower_allgather", x, cross_group, local_group)


def hierarchical_reducescatter(x: torch.Tensor, *, op: ReduceOp = ReduceOp.SUM,
                               local_group, cross_group) -> torch.Tensor:
    """Two-level reduce-scatter: a local block transpose lets the local
    group reduce-scatter first, so only the 1/local_size shard crosses the
    cross group, and the shard is the flat op's."""
    return _two_level("lower_reducescatter", x, cross_group, local_group, op=op)


def hierarchical_broadcast(x: torch.Tensor, *, root_rank: int = 0, local_group,
                           cross_group) -> torch.Tensor:
    """Two-level broadcast of the flat rank ``root_rank``'s value: inside
    the root's local group, then across the cross groups."""
    return _two_level("lower_broadcast", x, cross_group, local_group, root_rank=root_rank)


def hierarchical_alltoall(x: torch.Tensor, *, local_group, cross_group) -> torch.Tensor:
    """Two-level all-to-all: one exchange over the cross group grouped by
    destination, a local block transpose, then the local exchange; the
    result is the flat all-to-all's, in source-rank order."""
    return _two_level("lower_alltoall", x, cross_group, local_group)


def _shift(x: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """Send ``x`` to group rank r + step, receive from r - step (mod n)."""
    if dist.get_world_size(group) == 1:
        return x
    (out,), works = ring_exchange([(x, step)], group)
    for w in works:
        w.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        # The transpose of ppermute(i -> i+step) sends the cotangent back.
        return _shift(grad.contiguous(), ctx.group, -ctx.step), None, None


def ring_shift(x: torch.Tensor, *, group: Group = None, step: int = 1) -> torch.Tensor:
    """One step of the ring: ``lax.ppermute`` with perm
    ``[(i, (i + step) % n)]`` over the group (``step=-1`` turns the ring the
    other way). Every rank sends ``x`` to rank r + step and returns what rank
    r - step sent, in one ``batch_isend_irecv`` (every rank of the group must
    call it, in the same order as the others). Differentiable: the backward
    sends the cotangent the other way. With one rank it is the identity and
    sends nothing."""
    return _RingShift.apply(x.contiguous(), group, int(step))
