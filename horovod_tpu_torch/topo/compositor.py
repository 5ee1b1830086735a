"""The two-level schedules of every collective over a hierarchy of groups.

The port of the lowering half of ``horovod_tpu/topo/compositor.py``. Each
collective over a hierarchy is composed from single-level primitives
(reduce-scatter, allreduce, all-gather, broadcast, all-to-all) and local
block permutes:

- ``flat`` — one collective over the whole hierarchy: the one group of an
  ``AxisGroups`` (``parallel.mesh.axis_groups``), or a hierarchy of one
  level. A flat collective over several levels with no such group raises;
  it never runs two-level in its place. Broadcast is the exception, as in
  the JAX package: flat over several levels is the per-level chain.
- ``two-level`` — the hierarchical composition at any depth: allreduce =
  RS(inner) -> allreduce(outer levels) -> AG(inner); reduce-scatter
  pre-permutes blocks locally so the large payload stays on the inner
  level; allgather, broadcast and alltoall chain per-level stages.
- ``two-level-sa`` (broadcast) — the root's inner level gets the value,
  only 1/L shards cross the outer levels, an inner all-gather reassembles.

Every schedule equals the flat collective: bitwise where the regrouping
commutes (MIN/MAX, data movement), to float rounding for SUM. The int8
wire's two-level form compresses only the outermost level
(``ops/quantized.quantized_hierarchical_allreduce``); the bf16 wire is a
cast on entry and exit.

``axes`` is a tuple of levels, outermost first: process groups, or hop
objects with ``rank``, ``n``, ``reduce_scatter``, ``all_gather``,
``all_reduce``, ``broadcast``, ``all_to_all``, ``exchange`` and ``ring``
(``ops/collectives.Hop``, which a group is wrapped in; ``chip_smoke.py``
plays a grid of ranks on one card through its own). The sizes come from
the levels. The rank order is outer-major, ``rank = outer * inner_size +
inner``, as the hierarchical meshes lay ranks out.

Plan selection (``ring``, ``recursive-halving``, ``split``,
``candidate_plans``, ``select_plan``, ``auto_reduce_fn``,
``planned_reduce_fn``) needs the interconnect model and is ROADMAP A13.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence

import torch

from ..common.quant import WIRE_BF16, WIRE_F32, WIRE_INT8
from ..common.types import ReduceOp
from ..ops import collectives

# Reduce ops the hierarchical compositions support. PRODUCT stays flat
# only; ADASUM has its own hierarchical schedule in ops/adasum.py.
_HIER_REDUCE_OPS = (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN, ReduceOp.MAX)

# The algorithms that come with plan selection.
_PLANNED = ("ring", "recursive-halving", "split")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} belongs to the topology compositor's plan selection, which is not "
        "ported yet (ROADMAP A13)")


def candidate_plans(*args, **kwargs):
    """Plan selection: ROADMAP A13."""
    raise _not_ported("candidate_plans")


def select_plan(*args, **kwargs):
    """Plan selection: ROADMAP A13."""
    raise _not_ported("select_plan")


def auto_reduce_fn(*args, **kwargs):
    """Plan selection: ROADMAP A13."""
    raise _not_ported("auto_reduce_fn")


def planned_reduce_fn(*args, **kwargs):
    """Plan selection: ROADMAP A13."""
    raise _not_ported("planned_reduce_fn")


def hops(axes: Any) -> List[Any]:
    """The levels of ``axes`` (a group, a hop, or a tuple of either,
    outermost first) as hop objects."""
    levels = axes if isinstance(axes, tuple) else (axes,)
    if not levels:
        raise ValueError("a hierarchy needs at least one level")
    return [collectives.as_hop(g) for g in levels]


def _size(levels: Sequence[Any]) -> int:
    return math.prod(h.n for h in levels)


def _flat_hop(axes: Any, levels: Sequence[Any]):
    """The one level a flat collective over ``axes`` runs on."""
    if len(levels) == 1:
        return levels[0]
    return collectives.Hop(collectives.flat_group(axes))


def _check_reduce_op(op: ReduceOp, collective: str) -> None:
    if op not in _HIER_REDUCE_OPS:
        raise ValueError(
            f"hierarchical {collective} supports {[o.name for o in _HIER_REDUCE_OPS]}; got "
            f"{op!r} (PRODUCT/ADASUM have no hierarchical regrouping here: use the flat "
            f"lowering or ops/adasum.py)")


def _check_algorithm(algorithm: str, known: Sequence[str]) -> None:
    if algorithm in _PLANNED:
        raise _not_ported(f"algorithm {algorithm!r}")
    if algorithm not in known:
        raise ValueError(f"unknown algorithm {algorithm!r}; choose from {list(known)}")


def _pad(flat: torch.Tensor, multiple: int):
    pad = (-flat.shape[0]) % multiple
    return (torch.nn.functional.pad(flat, (0, pad)) if pad else flat), pad


def _allreduce_sum_levels(flat: torch.Tensor, levels: Sequence[Any]) -> torch.Tensor:
    """k-level SUM allreduce of a flat vector: RS(inner) -> recurse on the
    shard over the outer levels -> AG(inner)."""
    if len(levels) == 1:
        return levels[0].all_reduce(flat, ReduceOp.SUM)
    inner = levels[-1]
    n = flat.shape[0]
    flat, pad = _pad(flat, inner.n)
    shard = _allreduce_sum_levels(inner.reduce_scatter(flat), levels[:-1])
    full = inner.all_gather(shard)
    return full[:n] if pad else full


def lower_allreduce(x: torch.Tensor, axes, *, op: ReduceOp = ReduceOp.SUM,
                    algorithm: str = "two-level", wire_dtype: str = WIRE_F32) -> torch.Tensor:
    """Allreduce ``x`` over the hierarchy ``axes`` (outermost first). Equal
    to the flat allreduce: exactly for MIN/MAX, to float rounding for
    SUM/AVERAGE; to int8 quantization with ``wire_dtype="int8"``
    (SUM/AVERAGE; two-level compresses only the outermost level); to bf16
    rounding with ``wire_dtype="bf16"`` (a cast down on entry and up on
    exit)."""
    levels = hops(axes)
    _check_algorithm(algorithm, ("flat", "two-level"))
    if wire_dtype == WIRE_BF16:
        out = lower_allreduce(x.to(torch.bfloat16), axes, op=op, algorithm=algorithm)
        return out.to(x.dtype)
    if wire_dtype == WIRE_INT8:
        from ..ops.quantized import quantized_hierarchical_allreduce, quantized_ring_allreduce

        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"wire_dtype='int8' supports SUM/AVERAGE; got {op}")
        average = op == ReduceOp.AVERAGE
        if algorithm == "flat":
            return quantized_ring_allreduce(x, average=average, ring=_flat_hop(axes, levels).ring)
        return quantized_hierarchical_allreduce(x, axes, average=average)
    if wire_dtype != WIRE_F32:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}")
    if algorithm == "flat":
        hop = _flat_hop(axes, levels)
        if op == ReduceOp.AVERAGE:
            return hop.all_reduce(x, ReduceOp.SUM) / hop.n
        return hop.all_reduce(x, op)
    _check_reduce_op(op, "allreduce")
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        # A per-level chain, inner -> outer: MIN/MAX regroup exactly.
        out = x
        for hop in reversed(levels):
            out = hop.all_reduce(out, op)
        return out
    out = _allreduce_sum_levels(x.reshape(-1), levels).reshape(x.shape)
    return out / _size(levels) if op == ReduceOp.AVERAGE else out


def lower_allgather(x: torch.Tensor, axes, *, algorithm: str = "two-level") -> torch.Tensor:
    """Allgather along dim 0 over the hierarchy: per-level gathers chained
    inner -> outer give the flat rank order exactly."""
    levels = hops(axes)
    _check_algorithm(algorithm, ("flat", "two-level"))
    if algorithm == "flat":
        return _flat_hop(axes, levels).all_gather(x)
    out = x
    for hop in reversed(levels):
        out = hop.all_gather(out)
    return out


def lower_reducescatter(x: torch.Tensor, axes, *, op: ReduceOp = ReduceOp.SUM,
                        algorithm: str = "two-level", scatter_axis: int = 0) -> torch.Tensor:
    """Reduce-scatter dim 0 over the hierarchy. The two-level schedule
    permutes dim 0's blocks locally so that the inner level reduce-scatters
    first (the large payload stays on it, only the 1/L shard crosses the
    outer levels) while the shard is still the flat op's, in outer-major
    rank order."""
    levels = hops(axes)
    _check_algorithm(algorithm, ("flat", "two-level"))
    if scatter_axis != 0:
        raise ValueError("compositor reduce-scatter scatters dim0")
    if op == ReduceOp.AVERAGE:
        x = x / _size(levels)
    elif op not in (ReduceOp.SUM, ReduceOp.ADASUM):
        raise ValueError(f"reducescatter supports SUM/AVERAGE, got {op}")
    if algorithm == "flat":
        return _flat_hop(axes, levels).reduce_scatter(x)
    n = _size(levels)
    if x.shape[0] % n:
        raise ValueError(
            f"reduce-scatter dim0 ({x.shape[0]}) must be divisible by the grid size ({n})")

    def rs(v, lv):
        if len(lv) == 1:
            return lv[0].reduce_scatter(v)
        inner_n, outer_n = lv[-1].n, _size(lv[:-1])
        m = v.shape[0] // (outer_n * inner_n)
        # Destination blocks are outer-major (o * L + l); putting l
        # outermost lets the inner level scatter first.
        v = v.reshape((outer_n, inner_n, m) + v.shape[1:]).transpose(0, 1)
        return rs(lv[-1].reduce_scatter(v.reshape((-1,) + v.shape[3:])), lv[:-1])

    return rs(x, levels)


def _axis_roots(root_rank: int, sizes: Sequence[int]) -> List[int]:
    """A flat root rank (outer-major mixed radix) as one root per level."""
    roots: List[int] = []
    rem = root_rank
    for s in reversed(sizes):
        roots.append(rem % s)
        rem //= s
    return roots[::-1]


def lower_broadcast(x: torch.Tensor, axes, *, root_rank: int = 0,
                    algorithm: str = "two-level") -> torch.Tensor:
    """Broadcast the flat rank ``root_rank``'s value over the hierarchy.
    ``two-level`` chains per-level broadcasts inner -> outer;
    ``two-level-sa`` broadcasts inside the root's inner level, moves only
    1/L shards over the outer levels and reassembles with an inner
    all-gather. Exact: a broadcast moves bits."""
    levels = hops(axes)
    _check_algorithm(algorithm, ("flat", "two-level", "two-level-sa"))
    sizes = [h.n for h in levels]
    n = math.prod(sizes)
    if not 0 <= int(root_rank) < n:
        raise ValueError(f"root_rank {root_rank} out of range for grid of size {n}")
    roots = _axis_roots(int(root_rank), sizes)
    if algorithm in ("flat", "two-level") or len(levels) == 1:
        # Flat over several levels is the chain, as in the JAX package.
        out = x
        for hop, root in zip(reversed(levels), reversed(roots)):
            out = hop.broadcast(out, root)
        return out
    inner = levels[-1]
    out = inner.broadcast(x, roots[-1])
    flat, pad = _pad(out.reshape(-1), inner.n)
    m = flat.shape[0] // inner.n
    shard = flat[inner.rank * m:(inner.rank + 1) * m]
    for hop, root in zip(reversed(levels[:-1]), reversed(roots[:-1])):
        shard = hop.broadcast(shard, root)
    full = inner.all_gather(shard)
    return (full[:full.shape[0] - pad] if pad else full).reshape(x.shape)


def lower_alltoall(x: torch.Tensor, axes, *, algorithm: str = "two-level") -> torch.Tensor:
    """All-to-all on dim 0 over the hierarchy: an outer-level exchange
    grouped by destination, a local block transpose, the inner levels, and
    a transpose back to source-rank order. Exact: data movement."""
    levels = hops(axes)
    _check_algorithm(algorithm, ("flat", "two-level"))
    if algorithm == "flat":
        return _flat_hop(axes, levels).all_to_all(x)
    n = _size(levels)
    if x.shape[0] % n:
        raise ValueError(f"alltoall dim0 ({x.shape[0]}) must be divisible by the grid size ({n})")

    def a2a(v, lv):
        if len(lv) == 1:
            return lv[0].all_to_all(v)
        outer_n, rest = lv[0].n, _size(lv[1:])
        m = v.shape[0] // (outer_n * rest)
        tail = v.shape[1:]
        # Rows of y: [source outer][destination rest]; bring the
        # destinations first so that the inner levels exchange by them.
        y = lv[0].all_to_all(v).reshape((outer_n, rest, m) + tail).transpose(0, 1)
        z = a2a(y.reshape((-1,) + tail), lv[1:])
        # Rows of z: [source rest][source outer]; back to outer-major.
        z = z.reshape((rest, outer_n, m) + tail).transpose(0, 1)
        return z.reshape((-1,) + tail)

    return a2a(x, levels)
