"""Tensor fusion: bucket planning, the fused reductions and the streamed
reduction.

The port of ``horovod_tpu/ops/fusion.py``. Same-dtype tensors are packed
greedily, in the order given, into buckets of up to the fusion threshold,
and each bucket is reduced by one collective. ``plan_buckets`` is copied
rule for rule, so a leaf list in the JAX package's order gives the same
bucket index lists. ``fused_reduce_scatter`` (ZeRO-1's per-bucket
reduce-scatter) and ``quantized_ef_allreduce`` (the int8 wire with error
feedback) reduce the same buckets. A tuple of groups, the JAX package's axis
tuple, reduces flat over its flattened group, or two-level through a
``reduce_fn`` (:func:`_hier_reduce_fn`) and, for ZeRO-1's reduce-scatter,
the compositor's two-level schedule. Under plan selection
(``hierarchical="planned"``, the JAX ``StreamConfig.planned``) the
``reduce_fn`` is ``topo/compositor.auto_reduce_fn``: each bucket, post hoc
or streamed, is priced on ``model_for_axes`` of the groups it reduces over
and lowered as its selected plan says.

The streamed half (``reduce_in_backward``, ``stream_param_groups``): the
JAX package wraps parameter subtrees in a ``custom_vjp`` identity whose
backward rule reduces the subtree's cotangents as soon as they exist. Here
that is the reference Horovod's own hook design: each parameter's
``register_post_accumulate_grad_hook`` counts the gradients of its group,
and a group whose gradients are all in launches its bucket reductions from
inside the backward, on a side stream on the card, while the backward of
the layers before it goes on. :class:`StreamedReduction` keeps the groups;
``finish`` reduces a group the backward left incomplete (a parameter that
got no gradient) and hands every group's result to the optimizer. The
groups come from :func:`plan_layer_groups` over the parameter tree's
top-level children, walked as the JAX package walks them.

The JAX package reduces its gradient pytree in ``jax.tree.leaves`` order,
which walks dicts by sorted key: ``block_0, block_1, block_10, ...,
embeddings, lm_head, ...``. ``tree_order`` gives that order for
``/``- or ``.``-joined parameter names, so the port's buckets match the
reference's and not ``named_parameters()`` order.

The taps (``hvd_fusion_buckets``, ``hvd_fusion_bucket_bytes``,
``hvd_axis_wire_bytes_total``, ``hvd_quantized_*``, ``hvd_overlap_groups``
and the trace's plan notes) sit at the JAX package's sites. There they fire
at trace time, once per compile; the eager step here fires them the first
time it runs a plan (:func:`first_sight`: a leaf list, a threshold, a group
and a path label), so one run's counters equal the JAX step's whatever the
step count.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import metrics as _metrics
from .. import trace as _trace
from ..common import env as _env
from ..common.quant import int8_wire_bytes
from ..common.types import ReduceOp
from . import collectives

# Ops a streamed reduction may use: per-group reduction must equal the
# whole-tree reduction, which holds exactly for elementwise reductions.
# ADASUM normalizes per bucket and stays post-hoc only.
_STREAMABLE_OPS = (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN, ReduceOp.MAX)

# Ops the int8 wire supports: per-hop requantization accumulates in f32,
# which is only sound for additive reductions.
_QUANTIZABLE_OPS = (ReduceOp.SUM, ReduceOp.AVERAGE)


def default_threshold_bytes(threshold_bytes: Optional[int] = None) -> int:
    """Resolve the fusion threshold: explicit value > HOROVOD_FUSION_THRESHOLD
    env knob > the reference's 64 MB default."""
    if threshold_bytes is not None:
        return int(threshold_bytes)
    return _env._get_int(_env.HOROVOD_FUSION_THRESHOLD, 64 * 1024 * 1024)


def default_first_bucket_bytes(first_bucket_bytes: Optional[int] = None) -> int:
    """Resolve the streamed first-bucket size: explicit value >
    HOROVOD_FUSION_FIRST_BUCKET_BYTES > 1 MiB (the DDP idiom: a small first
    group puts bytes on the wire as early in the backward as possible)."""
    if first_bucket_bytes is not None:
        return int(first_bucket_bytes)
    return _env._get_int(_env.HOROVOD_FUSION_FIRST_BUCKET_BYTES, 1024 * 1024)


def tree_order(names: Sequence[str]) -> List[int]:
    """Indices of ``names`` in the order ``jax.tree.leaves`` visits the same
    paths in a nested dict: sorted level by level."""
    paths = [tuple(re.split(r"[./]", n)) for n in names]
    return sorted(range(len(names)), key=lambda i: paths[i])


def plan_buckets(
    leaves: Sequence[torch.Tensor], threshold_bytes: int
) -> List[List[int]]:
    """Group leaf indices into fusion buckets.

    Same-dtype tensors are packed greedily in submission order up to
    ``threshold_bytes`` per bucket. An oversized leaf (a bucket of its own)
    closes its dtype's active bucket: later same-dtype leaves keep fusing,
    but into a FRESH bucket, so bucket emission order stays monotone in
    submission order.
    """
    buckets: List[List[int]] = []
    # Active bucket per dtype: (bucket_index, bytes_used)
    active: Dict[str, Tuple[int, int]] = {}
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        key = str(leaf.dtype)
        if nbytes >= threshold_bytes:
            buckets.append([i])
            active.pop(key, None)
            continue
        if key in active:
            bidx, used = active[key]
            if used + nbytes <= threshold_bytes:
                buckets[bidx].append(i)
                active[key] = (bidx, used + nbytes)
                continue
        buckets.append([i])
        active[key] = (len(buckets) - 1, nbytes)
    return buckets


# --- the plan taps ----------------------------------------------------------------

DATA_AXIS = "data"

# (metrics tap, trace tap, plan key) triples whose taps have fired.
_seen_plans: set = set()


def first_sight(key: Tuple) -> bool:
    """True the first time the live taps see the plan ``key``: the eager
    counterpart of "once per compile". A tap installed anew sees every plan
    anew."""
    k = (_metrics.TAP, _trace.TAP, key)
    if k in _seen_plans:
        return False
    _seen_plans.add(k)
    return True


def axis_label(group: Any) -> str:
    """The ``axis`` label of a reduction's group, in the JAX package's axis
    names: ``"cross+local"`` for the hierarchical pair, else ``"data"``."""
    return "cross+local" if isinstance(group, tuple) and len(group) == 2 else DATA_AXIS


def ring_wire_bytes(payload_bytes: int, n: int, collective: str = "allreduce",
                    wire_dtype: str = "f32") -> int:
    """Ring accounting of what one reduction of ``payload_bytes`` moves per
    rank over ``n`` ranks: ``2 (n - 1) / n`` of the payload for an
    allreduce, ``(n - 1) / n`` for one reduce-scatter or all-gather pass;
    the int8 wire prices the payload's int8 + scales form."""
    if n <= 1:
        return 0
    payload = int(payload_bytes)
    if wire_dtype == "int8":
        payload = int8_wire_bytes(payload)
    if collective in ("allreduce", "psum"):
        return 2 * (n - 1) * payload // n
    return (n - 1) * payload // n


def record_axis_wire_bytes(payload_bytes: int, group: Any, collective: str,
                           wire_dtype: str = "f32", axis: Optional[str] = None) -> None:
    """Per-axis bytes-on-wire of one reduction plan (``horovod_tpu/ops/
    fusion.py:132``): ring accounting of what ONE step moves per rank over
    ``group``, ``hvd_axis_wire_bytes_total{axis,collective}`` plus a plan
    note. ``axis`` names the group's mesh axis (default
    :func:`axis_label`). Nothing for a group of one rank; no-op when neither
    tap is armed. Called once per plan (:func:`first_sight`), or for a
    collective a step issues call by call, in its first call
    (:func:`charge`)."""
    if not (_metrics.ACTIVE or _trace.ACTIVE):
        return
    n = collectives.group_rank_size(group)[1]
    if n <= 1:
        return
    onwire = ring_wire_bytes(payload_bytes, n, collective, wire_dtype)
    label = axis or axis_label(group)
    if _metrics.ACTIVE:
        _metrics.TAP.inc("hvd_axis_wire_bytes_total", float(onwire), axis=label,
                         collective=collective)
    if _trace.ACTIVE:
        _trace.TAP.note_plan(**{f"axis_wire_bytes:{label}:{collective}": int(onwire)})


# Nonzero while a built step's call is the first its taps see
# (:func:`first_call`): the collectives a step issues call by call (the
# tensor-parallel psums, the fused rings, ZeRO-1's parameter all-gather)
# charge ``hvd_axis_wire_bytes_total`` then, each once (:func:`charge`), as
# the JAX package charges them when it traces the step. A count, not a
# thread-local: the backward's collectives run on autograd's threads.
_FIRST_CALL = [0]


@contextlib.contextmanager
def first_call(step_key: Any):
    """The scope of one call of the built step ``step_key``. It is a first
    call when the live taps have not seen the step (:func:`first_sight`,
    keyed per tap as the plans are), so a tap installed between two calls
    is charged the step's collectives at the next call."""
    if not first_sight(("step", step_key)):
        yield
        return
    _FIRST_CALL[0] += 1
    try:
        yield
    finally:
        _FIRST_CALL[0] -= 1


def charge(payload_bytes: int, group: Any, collective: str, axis: Optional[str] = None) -> None:
    """Charge one collective that a step issues call by call to
    ``hvd_axis_wire_bytes_total`` (:func:`record_axis_wire_bytes`), in the
    step's first call only (:func:`first_call`); ``axis`` is the group's
    mesh axis name. The JAX package charges these at trace time
    (``horovod_tpu/parallel/tp.py:52``, ``:127``, ``:238``;
    ``ops/collective_matmul.py:117``; ``parallel/zero.py:448``)."""
    if _FIRST_CALL[0] > 0:
        record_axis_wire_bytes(payload_bytes, group, collective, axis=axis)


def _record_plan(label: Optional[str], leaves: Sequence[torch.Tensor], buckets: List[List[int]],
                 threshold_bytes: int, group: Any, collective: str, wire_dtype: str,
                 gauge: bool = True, **notes: Any) -> bool:
    """The plan taps of one fused reduction (the wire bytes, the trace's
    plan note, the ``hvd_fusion_buckets`` gauge unless ``gauge`` is off, as
    the JAX EF path sets none) the first time the live taps see the plan;
    True then. A ``label`` of None records nothing."""
    if not (_metrics.ACTIVE or _trace.ACTIVE) or label is None or not leaves:
        return False
    key = (label, threshold_bytes, id(group), collective, wire_dtype,
           tuple((tuple(l.shape), str(l.dtype)) for l in leaves))
    if not first_sight(key):
        return False
    record_axis_wire_bytes(_tree_bytes(leaves), group, collective, wire_dtype)
    if _trace.ACTIVE:
        _trace.TAP.note_plan(fusion_path=label, fusion_buckets=len(buckets), **notes)
    if _metrics.ACTIVE and gauge:
        _metrics.TAP.set("hvd_fusion_buckets", float(len(buckets)), path=label)
    return True


def pack_bucket(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten and concatenate a same-dtype bucket into one 1-D buffer."""
    return torch.cat([l.reshape(-1) for l in leaves])


def unpack_bucket(
    buf: torch.Tensor, shapes: Sequence[Tuple[int, ...]]
) -> List[torch.Tensor]:
    """Views of ``buf`` with the given shapes, in order."""
    sizes = [torch.Size(s).numel() for s in shapes]
    return [p.view(s) for p, s in zip(torch.split(buf, sizes), shapes)]


def fused_allreduce(
    leaves: Sequence[torch.Tensor],
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    threshold_bytes: Optional[int] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    group: collectives.Group = None,
    reduce_fn: Optional[Callable[..., torch.Tensor]] = None,
    label: Optional[str] = "posthoc",
    wire_dtype: str = "f32",
) -> List[torch.Tensor]:
    """Allreduce every tensor of ``leaves`` with bucket fusion: one
    collective per bucket. Returns the reduced tensors in the input order;
    the inputs are left unchanged. ``threshold_bytes=None`` resolves the
    HOROVOD_FUSION_THRESHOLD knob. ``group`` is the process group to reduce
    over (a mesh axis's, as the JAX package's ``axis_name``; None: every
    rank; a tuple of groups, an axis tuple, reduces flat over its flattened
    group); Average divides by its size. ``reduce_fn(x, *, op, group,
    prescale_factor, postscale_factor)`` reduces one bucket (default
    ``collectives.allreduce``; the int8 ring's, Adasum's and the two-level
    :func:`_hier_reduce_fn` take its place, with ``group`` as given).
    ``label`` is the fusion path the taps name (None: no taps, for
    reductions the JAX step does outside its fusion layer); ``wire_dtype``
    (``int8`` under the int8 wire) prices the wire bytes."""
    threshold_bytes = default_threshold_bytes(threshold_bytes)
    buckets = plan_buckets(leaves, threshold_bytes)
    if _record_plan(label, leaves, buckets, threshold_bytes, group, "allreduce", wire_dtype):
        if _metrics.ACTIVE:
            wire_label = getattr(reduce_fn, "wire_label", None)
            for bucket in buckets:
                nbytes = _tree_bytes([leaves[i] for i in bucket])
                _metrics.TAP.observe("hvd_fusion_bucket_bytes", float(nbytes))
                if wire_label is not None and leaves[bucket[0]].is_floating_point():
                    from .quantized import record_wire_bytes

                    record_wire_bytes(sum(leaves[i].numel() for i in bucket) * 4, wire_label)
    if reduce_fn is None:
        # A psum over an axis tuple: one flat collective over its group.
        group = collectives.flat_group(group)
    # A packed bucket is a fresh buffer, so the default reduces it in place.
    bucket_fn = reduce_fn or collectives.allreduce_
    reduce_fn = reduce_fn or collectives.allreduce
    results: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for bucket in buckets:
        if collectives.RECORD is not None:
            # The static checks' recorder: the bucket's fusion path and, for
            # a packed bucket, its leaf count (the fusion-budget rule).
            collectives.RECORD.note(path=label or "fused", fused_leaves=len(bucket))
        if len(bucket) == 1:
            i = bucket[0]
            results[i] = reduce_fn(
                leaves[i], op=op, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, group=group,
            )
            continue
        reduced = bucket_fn(
            pack_bucket([leaves[i] for i in bucket]), op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, group=group,
        )
        unpacked = unpack_bucket(reduced, [leaves[i].shape for i in bucket])
        for i, r in zip(bucket, unpacked):
            results[i] = r
    return results


def _hier_reduce_fn(x: torch.Tensor, *, op, group, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> torch.Tensor:
    """The two-level ``reduce_fn`` (``hierarchical=True``): reduce-scatter
    over the local group, the shard allreduced over the cross group, then
    all-gathered back; ``group`` is the ``(cross, local)`` pair."""
    cross_group, local_group = group
    if prescale_factor != 1.0:
        x = x * prescale_factor
    out = collectives.hierarchical_allreduce(x, op=op, local_group=local_group,
                                             cross_group=cross_group)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out


# --- parameter trees ----------------------------------------------------------
#
# The JAX package groups a pytree; the port's trees are nested dicts, lists
# and tuples of tensors (``named_tree`` nests ``named_parameters()``), walked
# as ``jax.tree.leaves`` walks them: dict keys sorted, sequences in order.


def named_tree(named: Sequence[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    """Nest ``(name, tensor)`` pairs into a dict tree by their ``.``- or
    ``/``-separated paths (``block_0.attention.query.kernel``)."""
    tree: Dict[str, Any] = {}
    for name, t in named:
        node = tree
        *parents, last = re.split(r"[./]", name)
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in tree_leaves(x)]
    return [] if tree is None else [tree]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree: Any) -> int:
    return sum(_nbytes(l) for l in tree_leaves(tree))


def _top_level_children(tree: Any) -> Optional[List[Any]]:
    """The top-level children of a tree (the layer granularity streamed
    grouping works at), or None when it has no splittable top level. Dict
    children come in SORTED key order, as the JAX package walks them, so
    the port groups the same children."""
    if isinstance(tree, dict) and tree:
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)) and tree:
        return list(tree)
    return None


def plan_layer_groups(
    layer_bytes: Sequence[int],
    threshold_bytes: int,
    first_bucket_bytes: int,
) -> List[List[int]]:
    """Pack layer indices into streamed-reduction groups, walking in
    REVERSE forward order (the order their gradients materialize in the
    backward pass, torch DDP's bucket assignment). The first group to
    reduce is capped at ``first_bucket_bytes`` so the first collective
    launches as early as possible; later groups fill to the fusion
    threshold. Groups are returned in reduction order; each group's member
    list is sorted in forward order."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cap = max(int(first_bucket_bytes), 1)
    for i in reversed(range(len(layer_bytes))):
        cur.append(i)
        cur_bytes += int(layer_bytes[i])
        if cur_bytes >= cap:
            groups.append(sorted(cur))
            cur, cur_bytes = [], 0
            cap = max(int(threshold_bytes), 1)
    if cur:
        groups.append(sorted(cur))
    return groups


def layer_group_bytes(
    layer_bytes: Sequence[int],
    threshold_bytes: int,
    first_bucket_bytes: int,
) -> List[int]:
    """Per-group payload bytes of the :func:`plan_layer_groups` partition,
    in reduction order."""
    return [sum(int(layer_bytes[i]) for i in group)
            for group in plan_layer_groups(layer_bytes, threshold_bytes, first_bucket_bytes)]


def stream_groups(tree: Any, threshold_bytes: Optional[int] = None,
                  first_bucket_bytes: Optional[int] = None) -> List[List[torch.Tensor]]:
    """The streamed groups of a parameter tree, each a list of its leaves in
    the order the JAX package's registered subtree ``{str(i): children[i]}``
    flattens (its keys sort as strings: "10" before "2"), so a group's
    bucket plan is the reference's. A tree with no splittable top level is
    one group. Groups are in reduction order."""
    children = _top_level_children(tree)
    if children is None:
        return [tree_leaves(tree)]
    groups = plan_layer_groups([_tree_bytes(c) for c in children],
                               default_threshold_bytes(threshold_bytes),
                               default_first_bucket_bytes(first_bucket_bytes))
    return [[l for key in sorted(str(i) for i in g) for l in tree_leaves(children[int(key)])]
            for g in groups]


# --- ZeRO-1: per-bucket reduce-scatter -----------------------------------------


def zero1_shard_len(total: int, n_shards: int, quantized: bool) -> int:
    """Per-rank shard length of a packed bucket of ``total`` elements:
    ceil-divided over the shards and, on the int8 wire, rounded up to the
    quantizer's BLOCK so that every shard keeps whole scale blocks."""
    k = -(-max(int(total), 1) // n_shards)
    if quantized:
        from ..common.quant import BLOCK

        k = -(-k // BLOCK) * BLOCK
    return k


def zero1_group_layout(params: Any, threshold_bytes: Optional[int] = None,
                       first_bucket_bytes: Optional[int] = None):
    """The streamed ZeRO-1 layout over ``params``: ``[(label, leaves,
    buckets)]`` per group, in reduction order, with ``buckets`` the
    :func:`plan_buckets` index lists over the group's leaves. The backward's
    reduce-scatter and the shard-local update both derive their layout from
    here, so the shard a rank updates is bitwise the shard it reduced."""
    threshold = default_threshold_bytes(threshold_bytes)
    return [(f"g{gi}", leaves, plan_buckets(leaves, threshold))
            for gi, leaves in enumerate(stream_groups(params, threshold, first_bucket_bytes))]


def _pad_to(buf: torch.Tensor, length: int) -> torch.Tensor:
    return torch.nn.functional.pad(buf, (0, length - buf.shape[0])) if length > buf.shape[0] \
        else buf


def fused_reduce_scatter(
    leaves: Sequence[torch.Tensor],
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    group: collectives.Group = None,
    threshold_bytes: Optional[int] = None,
    quantized: bool = False,
    ef: Optional[Dict[str, torch.Tensor]] = None,
    label: str = "zero1",
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """Per-bucket reduce-scatter of ``leaves``: each bucket of
    :func:`plan_buckets` is packed, padded to ``n`` shards of
    :func:`zero1_shard_len` and reduce-scattered, so that rank r keeps the
    complete reduction of chunk r. Returns ``({"b<i>": shard}, new_ef)``
    for the non-empty buckets (the JAX package returns the shard scattered
    into a zero image of the tree; the shard is the same numbers).

    SUM/AVERAGE run ``reducescatter`` (or the int8 ring reduce-scatter with
    ``quantized=True``), or over a tuple of groups the compositor's
    two-level reduce-scatter, whose shard is the flat op's for this rank's
    outer-major index; MIN/MAX reduce then slice (exact, no wire saving);
    integer buckets reduce exactly. ``ef`` (quantized only) is the SHARDED
    error-feedback residual ``{"b<i>": f32[k]}``: each rank adds its
    residual to its own chunk of the local payload before the ring and
    carries ``corrected - roundtrip(corrected)`` forward."""
    if op not in _STREAMABLE_OPS:
        raise ValueError(
            f"fused_reduce_scatter supports elementwise ops {_STREAMABLE_OPS}; got {op}")
    if quantized and op not in _QUANTIZABLE_OPS:
        raise ValueError(f"quantized reduce-scatter supports {_QUANTIZABLE_OPS}; got {op}")
    hierarchy = isinstance(group, tuple) and len(group) > 1
    if quantized and hierarchy:
        raise ValueError(
            "quantized zero1 runs the flat int8 ring reduce-scatter; hierarchical (DCN-only) "
            "compression is not defined for the RS+AG decomposition — drop hierarchical or "
            "quantized")
    if ef is not None and not quantized:
        raise ValueError(
            "sharded error feedback (ef=...) only applies to the quantized zero1 wire")
    from ..topo import compositor
    from .quantized import quantize_roundtrip, quantized_ring_reduce_scatter

    idx, n = collectives.group_rank_size(group)
    threshold_bytes = default_threshold_bytes(threshold_bytes)
    buckets = plan_buckets(leaves, threshold_bytes)
    _record_plan(label, leaves, buckets, threshold_bytes, group, "reduce_scatter",
                 "int8" if quantized else "f32", zero1_reduction="reduce-scatter")
    if isinstance(group, tuple) and len(group) == 1:
        group = group[0]
    shards: Dict[str, torch.Tensor] = {}
    new_ef: Dict[str, torch.Tensor] = {}
    for bi, bucket in enumerate(buckets):
        packed = pack_bucket([leaves[i] for i in bucket])
        total = packed.shape[0]
        if total == 0:
            continue            # zero-length leaves: no ring, no state
        dtype = packed.dtype
        is_float = packed.is_floating_point()
        k = zero1_shard_len(total, n, quantized and is_float)
        buf = _pad_to(packed, n * k)
        key = f"b{bi}"
        if quantized and is_float:
            work = buf.to(torch.float32)
            if ef is not None:
                if key not in ef:
                    raise ValueError(
                        f"sharded EF residual is missing bucket {key!r}: build it "
                        f"with parallel/zero.init_zero1_stream_state")
                corrected = work[idx * k:(idx + 1) * k] + ef[key]
                work[idx * k:(idx + 1) * k] = corrected
                new_ef[key] = corrected - quantize_roundtrip(corrected)
            shard = quantized_ring_reduce_scatter(
                work, group=group, average=op == ReduceOp.AVERAGE).to(dtype)
        elif op in (ReduceOp.SUM, ReduceOp.AVERAGE):
            shard = (compositor.lower_reducescatter(buf, group) if hierarchy
                     else collectives.reducescatter(buf, op=ReduceOp.SUM, group=group))
            if op == ReduceOp.AVERAGE:
                shard = shard / n if is_float else shard // n
        else:
            full = (compositor.lower_allreduce(buf, group, op=op) if hierarchy
                    else collectives.allreduce(buf, op=op, group=group))
            shard = full[idx * k:(idx + 1) * k]
        shards[key] = shard
    if ef is None:
        return shards, None
    stale = set(ef) - set(new_ef)
    if stale:
        raise ValueError(
            f"sharded EF residual carries buckets {sorted(stale)} the bucket plan does "
            f"not: the residual layout is stale for this partition")
    return shards, new_ef


# --- the int8 wire with error feedback ----------------------------------------
#
# EF-SGD: each rank keeps a rank-local residual e, sends Q(g + e) instead of
# Q(g) and carries e' = (g + e) - Q(g + e) into the next step, so the
# quantization error is re-injected instead of lost.


def quantized_ef_allreduce(
    leaves: Sequence[torch.Tensor],
    ef: Sequence[torch.Tensor],
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    group: collectives.Group = None,
    threshold_bytes: Optional[int] = None,
    label: str = "quantized-ef",
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Bucket-fused int8-wire allreduce with error feedback: returns
    ``(reduced, new_residual)``. ``ef`` holds one float32 residual per leaf
    (``ops/quantized.ef_like``). Float buckets move ``g + e`` through the
    int8 ring and keep ``(g + e) - dequant(quant(g + e))`` as the next
    residual; integer buckets reduce exactly and keep their residual. The
    post-hoc and the streamed (per-group) paths call this same function, so
    equal bucket plans give bitwise-equal steps."""
    from .quantized import quantize_roundtrip, quantized_ring_allreduce, record_wire_bytes

    if op not in _QUANTIZABLE_OPS:
        raise ValueError(f"quantized reduction supports {_QUANTIZABLE_OPS}; got {op}")
    threshold_bytes = default_threshold_bytes(threshold_bytes)
    buckets = plan_buckets(leaves, threshold_bytes)
    record = _record_plan(label, leaves, buckets, threshold_bytes, group, "allreduce", "int8",
                          gauge=False)
    group = collectives.flat_group(group)
    if len(ef) != len(leaves):
        raise ValueError(
            f"error-feedback residual has {len(ef)} leaves but the gradient list has "
            f"{len(leaves)}: build it with ef_like(params)")
    results: List[Optional[torch.Tensor]] = [None] * len(leaves)
    residuals: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for bucket in buckets:
        if not leaves[bucket[0]].is_floating_point():
            for i in bucket:    # exact sums stay exact; the residual stays zero
                results[i] = collectives.allreduce(leaves[i], op=op, group=group)
                residuals[i] = ef[i]
            continue
        packed = pack_bucket([leaves[i].to(torch.float32) + ef[i] for i in bucket])
        if packed.numel() == 0:
            for i in bucket:
                results[i], residuals[i] = leaves[i], ef[i]
            continue
        if record:
            record_wire_bytes(packed.numel() * 4, label)
        new_res = packed - quantize_roundtrip(packed)
        reduced = quantized_ring_allreduce(packed, group=group, average=op == ReduceOp.AVERAGE)
        shapes = [leaves[i].shape for i in bucket]
        for i, r, e in zip(bucket, unpack_bucket(reduced, shapes), unpack_bucket(new_res, shapes)):
            results[i] = r.to(leaves[i].dtype)
            residuals[i] = e
    return results, residuals


# --- the streamed reduction ----------------------------------------------------


class StreamedReduction:
    """Gradient reduction launched from inside the backward, one group at a
    time.

    ``groups`` are lists of parameters in reduction order; ``reduce(gi,
    grads)`` reduces group ``gi``'s gradients (in the group's order) and
    returns whatever the caller wants back. A post-accumulate-grad hook on
    every parameter counts its group's gradients; with
    ``backward_passes > 1`` a parameter counts on its last backward pass
    only. The ranks' collectives must come in one order, so groups launch
    in a fixed order on every rank and a complete group waits for the ones
    before it: the plan order in the first step, then the order in which
    the first step's groups completed, rank 0's, broadcast over ``group``
    by that step's :meth:`finish` (as DDP rebuilds its buckets after its
    first iteration). The plan's order is the JAX package's, reverse sorted
    names, which is not the order a backward produces them (the position
    embeddings sort last and are the last gradient), so without this no
    group would launch before the backward's end. On the card each launch
    runs on a side stream that first waits for the gradients, so the
    backward of earlier layers goes on meanwhile. :meth:`finish` launches
    the groups the backward left incomplete (a parameter with no gradient
    counts as zeros), makes the current stream wait for the side stream,
    and returns the results by group. ``launched_in_backward`` counts the
    groups the hooks launched since the last ``finish``, ``launched_early``
    those launched while another group's gradients were still to come; the
    ``last_`` counts keep the step ``finish`` closed.

    A parameter carries the hooks of one streamed reduction at a time, as
    the JAX step, a function, leaves nothing behind when it is rebuilt: a
    new reduction over a parameter that another open one hooks closes that
    one (:meth:`remove`), whose :meth:`finish` then raises."""

    def __init__(self, groups: Sequence[Sequence[torch.Tensor]],
                 reduce: Callable[[int, List[torch.Tensor]], Any], backward_passes: int = 1,
                 group: collectives.Group = None):
        self.groups = [list(g) for g in groups]
        self._reduce = reduce
        self.backward_passes = int(backward_passes)
        self._group = group
        self._group_of = {id(p): gi for gi, g in enumerate(self.groups) for p in g}
        self._order = list(range(len(self.groups)))
        self._ordered = False
        self._side = None
        self.closed = False
        params = [p for g in self.groups for p in g]
        for stale in {id(o): o for o in (_STREAM_OF.get(p) for p in params)
                      if o is not None and not o.closed}.values():
            stale.remove()
        self._handles = [p.register_post_accumulate_grad_hook(self._on_grad) for p in params]
        for p in params:
            _STREAM_OF[p] = self
        self.last_launched_in_backward = self.last_launched_early = 0
        self._reset()

    def _reset(self) -> None:
        self._counts: Dict[int, int] = {}
        self._ready = [0] * len(self.groups)
        self._complete: List[int] = []
        self._results: List[Any] = [None] * len(self.groups)
        self._next = 0
        self.launched_in_backward = self.launched_early = 0

    def remove(self) -> None:
        """Take the hooks off the parameters and close the reduction.
        Idempotent."""
        for h in self._handles:
            h.remove()
        self._handles = []
        self.closed = True

    def _on_grad(self, p: torch.Tensor) -> None:
        count = self._counts.get(id(p), 0) + 1
        self._counts[id(p)] = count
        if count != self.backward_passes:
            return
        gi = self._group_of[id(p)]
        self._ready[gi] += 1
        if self._ready[gi] == len(self.groups[gi]):
            self._complete.append(gi)
        while (self._next < len(self.groups)
               and self._ready[self._order[self._next]] == len(self.groups[self._order[self._next]])):
            self._launch(in_backward=True)

    def _launch(self, in_backward: bool) -> None:
        gi = self._order[self._next]
        self._next += 1
        if collectives.RECORD is not None:
            collectives.RECORD.stream_calls += 1
        params = self.groups[gi]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if params[0].device.type == "cuda":
            if self._side is None:
                self._side = torch.cuda.Stream(device=params[0].device)
            self._side.wait_stream(torch.cuda.current_stream(params[0].device))
            with torch.cuda.stream(self._side):
                self._results[gi] = self._reduce(gi, grads)
        else:
            self._results[gi] = self._reduce(gi, grads)
        if in_backward:
            self.launched_in_backward += 1
            self.launched_early += len(self._complete) < len(self.groups)

    def finish(self) -> List[Any]:
        if self.closed:
            raise RuntimeError(
                "this streamed reduction is closed: its step was closed or rebuilt over the "
                "same parameters, and its hooks are off them; step with the new build")
        while self._next < len(self.groups):
            self._launch(in_backward=False)
        results = self._results
        if self._side is not None:
            current = torch.cuda.current_stream(self._side.device)
            current.wait_stream(self._side)
            # The results were allocated on the side stream and are read on
            # this one: keep the allocator from handing their memory back to
            # the side stream before this stream is done with them.
            for t in _tensors(results):
                t.record_stream(current)
        if not self._ordered:
            seen = self._complete + [g for g in range(len(self.groups))
                                     if g not in self._complete]
            order = torch.tensor(seen, dtype=torch.int64, device=self.groups[0][0].device)
            if isinstance(self._group, tuple):
                from ..topo.compositor import lower_broadcast

                order = lower_broadcast(order, self._group, root_rank=0)
            else:
                collectives.broadcast_(order, root_rank=0, group=self._group)
            self._order = order.tolist()
            self._ordered = True
        self.last_launched_in_backward = self.launched_in_backward
        self.last_launched_early = self.launched_early
        self._reset()
        return results


# The open streamed reduction whose hooks each parameter carries.
_STREAM_OF = WeakIdKeyDictionary()


def stream_registrations(params: Iterable[torch.Tensor]) -> Dict[str, int]:
    """What the open streamed reductions register on ``params``: ``calls``
    (distinct reductions), ``leaves`` (parameters that one hooks) and
    ``hooks`` (post-accumulate-grad hooks on them, of any owner). The
    counterpart of the JAX package's ``take_stream_registrations``, read
    from the parameters rather than from a trace."""
    params = list(params)
    owners = [_STREAM_OF.get(p) for p in params]
    live = [o for o in owners if o is not None and not o.closed]
    return {"calls": len({id(o) for o in live}), "leaves": len(live),
            "hooks": sum(len(getattr(p, "_post_accumulate_grad_hooks", None) or ())
                         for p in params)}


def _tensors(x: Any) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def stream_param_groups(
    params: Any,
    reduce: Callable[[int, List[torch.Tensor]], Any],
    *,
    threshold_bytes: Optional[int] = None,
    first_bucket_bytes: Optional[int] = None,
    backward_passes: int = 1,
    group: collectives.Group = None,
) -> StreamedReduction:
    """Partition ``params`` (a tree of parameters) by top-level child, pack
    the children into DDP-style reverse-order groups with a smaller first
    group (:func:`stream_groups`), and register every group for streamed
    reduction in the backward through ``reduce(gi, grads)``. A tree with no
    splittable top level is one group: it still overlaps the optimizer's
    tail, not the backward. ``DistributedOptimizer(overlap=True)`` calls
    this with the reduction its options select. ``group`` is the process
    group the launch order is agreed over."""
    groups = stream_groups(params, threshold_bytes, first_bucket_bytes)
    if _metrics.ACTIVE:
        _metrics.TAP.set("hvd_overlap_groups", float(len(groups)))
    return StreamedReduction(groups, reduce, backward_passes, group)


def reduce_in_backward(params: Any, reduce: Callable[[int, List[torch.Tensor]], Any], *,
                       backward_passes: int = 1,
                       group: collectives.Group = None) -> StreamedReduction:
    """Register ONE group, every leaf of ``params``, for streamed
    reduction: it launches as soon as the last of its gradients exists."""
    return StreamedReduction([tree_leaves(params)], reduce, backward_passes, group)
