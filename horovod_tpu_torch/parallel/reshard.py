"""Elastic resharding: sharded ZeRO-1 state survives world-shape changes.

The port of ``horovod_tpu/parallel/reshard.py``. Given an old layout (mesh
axes and sizes with a per-leaf spec, or a :class:`Zero1Layout` bucket
layout) and a new one, it computes and executes the redistribution:

- re-partitioning ZeRO-1 bucket shards ``[n_old, k_old] -> [n_new,
  k_new]`` across a changed data-axis size,
- re-slicing TP-sharded leaves per their specs on the new mesh
  (checkpoint restore assembles global leaves from per-rank payloads with
  the same interval math),
- folding or zeroing error-feedback residuals with an explicit counter
  and a warning, never a silent loss.

PLANNING is the JAX package's own code, copied (it never imported JAX):
shard-interval arithmetic (:func:`shard_intervals`,
:func:`transfer_plan`), bytes-on-wire accounting (:func:`plan_bytes`,
:func:`resize_redistribution`), the layouts (:class:`BucketLayout`,
:class:`Zero1Layout`, :class:`LayoutManifest`) and the rank-coordinate and
leaf-slice math (:func:`rank_coords`, :func:`leaf_slices`). A layout, a plan
and a manifest here serialize to the same JSON, byte for byte, as there.

EXECUTION differs with the state. The JAX ``Zero1State`` stacks every
rank's rows (``[n, k]`` leaves); the port's ``parallel.zero.Zero1State``
holds only this rank's: its flat parameter shards, the inner
``torch.optim.Optimizer`` over them (whose per-shard state, ``exp_avg``,
``exp_avg_sq``, ``momentum_buffer``, is ``[k]``, its ``step`` a scalar) and
its sharded residuals. A reshard therefore works on the GATHERED form,
:class:`Zero1Rows`: every rank's rows stacked, from
:func:`gather_zero1_state` (an all-gather over the live group, the elastic
layer's graceful path), :func:`stack_zero1_states` (the per-rank states
held in one process) or a sharded checkpoint's payloads.
:func:`reshard_zero1_state` re-splits it (``[n, k]`` tensors bitwise,
``[n]`` scalars re-tiled after a check that every row agrees) and
:func:`unstack_zero1_states` rebuilds one ``Zero1State`` a new rank, each
with a fresh inner optimizer over its new shards holding its rows of the
state. A rank's rows after a crash are gone with it: nothing here can
rebuild them; a sharded checkpoint can.

Observability: each executed reshard increments
``hvd_reshard_total{trigger=...}`` and ``hvd_reshard_bytes_total{axis=...}``
and emits an ``hvd_reshard`` event on the trace.
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

logger = logging.getLogger("horovod_tpu_torch.reshard")

__all__ = [
    "BucketLayout",
    "LayoutManifest",
    "ReshardPlan",
    "ShardMove",
    "Zero1Layout",
    "leaf_slices",
    "plan_bytes",
    "plan_zero1_reshard",
    "rank_coords",
    "gather_zero1_state",
    "reshard_zero1_state",
    "reshard_zero1_tree",
    "stack_zero1_states",
    "unstack_zero1_states",
    "resize_redistribution",
    "shard_intervals",
    "shard_len",
    "transfer_plan",
    "zero1_layout_from_params",
]

# Mirrors common/quant.BLOCK: the int8 wire scales per 256-element block,
# so quantized shard lengths are BLOCK-aligned (cross-checked against
# ops/fusion.zero1_shard_len in tests/test_torch_reshard.py).
_BLOCK = 256

MANIFEST_SCHEMA = 1


def shard_len(total: int, n_shards: int, quantized: bool = False) -> int:
    """Per-shard length for a ``total``-element vector split ``n_shards``
    ways — the pure mirror of ``ops/fusion.zero1_shard_len`` (ceil
    division, BLOCK-aligned when the bucket rides the quantized wire)."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    k = -(-max(int(total), 1) // int(n_shards))
    if quantized:
        k = -(-k // _BLOCK) * _BLOCK
    return k


def shard_intervals(total: int, n_shards: int, k: int) -> List[Tuple[int, int]]:
    """Half-open global intervals ``[start, end)`` of REAL (un-padded)
    elements each shard row holds: row ``r`` covers ``[r*k, r*k+k)``
    clipped to ``[0, total)``. Rows past the data are empty intervals."""
    out = []
    for r in range(int(n_shards)):
        start = min(r * k, total)
        out.append((start, min(start + k, total)))
    return out


@dataclass(frozen=True)
class ShardMove:
    """One contiguous slice movement in a reshard: ``length`` elements
    starting at global offset ``start`` travel from row ``src`` (local
    offset ``src_off``) to row ``dst`` (local offset ``dst_off``)."""

    src: int
    dst: int
    src_off: int
    dst_off: int
    start: int
    length: int


def transfer_plan(total: int, n_old: int, k_old: int,
                  n_new: int, k_new: int) -> List[ShardMove]:
    """The slice-level redistribution plan from an ``[n_old, k_old]``
    row layout to ``[n_new, k_new]``: for every new row, the old-row
    slices that cover its global interval, in global order. The plan is
    exhaustive and disjoint — every real element moves exactly once —
    which the property tests assert by executing it."""
    old_iv = shard_intervals(total, n_old, k_old)
    moves: List[ShardMove] = []
    for dst, (ds, de) in enumerate(shard_intervals(total, n_new, k_new)):
        if ds >= de:
            continue
        for src, (ss, se) in enumerate(old_iv):
            lo, hi = max(ds, ss), min(de, se)
            if lo >= hi:
                continue
            moves.append(ShardMove(
                src=src, dst=dst, src_off=lo - ss, dst_off=lo - ds,
                start=lo, length=hi - lo,
            ))
    return moves


def plan_bytes(moves: Sequence[ShardMove], itemsize: int) -> Tuple[int, int]:
    """``(moved_bytes, local_bytes)`` for a transfer plan: elements whose
    source and destination row differ cross the wire on a real fleet;
    same-row elements are local copies (possibly at a shifted offset)."""
    moved = sum(m.length for m in moves if m.src != m.dst) * int(itemsize)
    local = sum(m.length for m in moves if m.src == m.dst) * int(itemsize)
    return moved, local


@dataclass(frozen=True)
class BucketLayout:
    """Shard layout of ONE fusion bucket: ``total`` real elements of
    ``dtype``, held as ``n_shards`` rows of ``k`` (``n*k - total`` pad)."""

    total: int
    k: int
    dtype: str

    def to_dict(self) -> dict:
        return {"total": self.total, "k": self.k, "dtype": self.dtype}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "BucketLayout":
        return cls(total=int(d["total"]), k=int(d["k"]),
                   dtype=str(d["dtype"]))


@dataclass
class Zero1Layout:
    """The full streamed-ZeRO-1 shard layout: which fusion bucket holds
    how many elements of what dtype at which per-row length. Derived
    from the live params by :func:`zero1_layout_from_params` (execution
    half) and carried in checkpoints / elastic snapshots so a restore at
    a DIFFERENT world size can plan the redistribution without the
    original params in hand."""

    n_shards: int
    quantized: bool
    buckets: Dict[str, Dict[str, BucketLayout]] = field(default_factory=dict)

    def bucket_items(self) -> List[Tuple[str, str, BucketLayout]]:
        out = []
        for g in sorted(self.buckets):
            for b in sorted(self.buckets[g]):
                out.append((g, b, self.buckets[g][b]))
        return out

    def total_elements(self) -> int:
        return sum(bl.total for _, _, bl in self.bucket_items())

    def relayout(self, n_new: int) -> "Zero1Layout":
        """Same buckets/totals/dtypes on a new shard count: each
        bucket's row length is re-derived by the SAME rule the streamed
        step will apply at the new world size."""
        return Zero1Layout(
            n_shards=int(n_new), quantized=self.quantized,
            buckets={
                g: {
                    b: BucketLayout(
                        total=bl.total,
                        k=shard_len(bl.total, n_new, self.quantized),
                        dtype=bl.dtype,
                    )
                    for b, bl in sub.items()
                }
                for g, sub in self.buckets.items()
            },
        )

    def to_dict(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "quantized": self.quantized,
            "buckets": {
                g: {b: bl.to_dict() for b, bl in sub.items()}
                for g, sub in self.buckets.items()
            },
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Zero1Layout":
        return cls(
            n_shards=int(d["n_shards"]),
            quantized=bool(d["quantized"]),
            buckets={
                g: {b: BucketLayout.from_dict(bl) for b, bl in sub.items()}
                for g, sub in dict(d["buckets"]).items()
            },
        )

    def describe(self) -> str:
        n_buckets = len(self.bucket_items())
        return (
            f"zero1[n_shards={self.n_shards}, quantized={self.quantized}, "
            f"{n_buckets} buckets, {self.total_elements()} elements]"
        )


@dataclass
class ReshardPlan:
    """The executable redistribution from one :class:`Zero1Layout` to
    another: per-bucket slice moves plus the bytes-on-wire accounting
    the fleet simulator prices (one state copy per optimizer slot rides
    the same plan)."""

    old: Zero1Layout
    new: Zero1Layout
    moves: Dict[Tuple[str, str], List[ShardMove]]
    moved_bytes: int
    local_bytes: int

    def summary(self) -> dict:
        return {
            "n_old": self.old.n_shards,
            "n_new": self.new.n_shards,
            "buckets": len(self.moves),
            "elements": self.old.total_elements(),
            "moved_bytes": self.moved_bytes,
            "local_bytes": self.local_bytes,
        }


def _dtype_itemsize(dtype: str) -> int:
    sizes = {
        "float64": 8, "int64": 8, "uint64": 8, "complex64": 8,
        "float32": 4, "int32": 4, "uint32": 4,
        "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
        "int8": 1, "uint8": 1, "bool": 1,
    }
    try:
        return sizes[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r} in bucket layout")


def plan_zero1_reshard(old: Zero1Layout, new: Zero1Layout) -> ReshardPlan:
    """Plan the redistribution between two ZeRO-1 layouts. The layouts
    must describe the SAME parameter partition (identical group/bucket
    keys, totals, and dtypes) — a mismatch means the two worlds bucketed
    different params and no byte-moving plan can reconcile them."""
    if bool(old.quantized) != bool(new.quantized):
        raise ValueError(
            f"cannot reshard across wire formats: old layout "
            f"quantized={old.quantized}, new quantized={new.quantized} — "
            f"shard lengths are BLOCK-aligned only on the quantized wire"
        )
    old_keys = [(g, b) for g, b, _ in old.bucket_items()]
    new_keys = [(g, b) for g, b, _ in new.bucket_items()]
    if old_keys != new_keys:
        raise ValueError(
            f"bucket partitions differ: old has {old_keys}, new has "
            f"{new_keys} — the layouts were built for different params"
        )
    moves: Dict[Tuple[str, str], List[ShardMove]] = {}
    moved = local = 0
    for g, b, obl in old.bucket_items():
        nbl = new.buckets[g][b]
        if obl.total != nbl.total or obl.dtype != nbl.dtype:
            raise ValueError(
                f"bucket {g}/{b} mismatch: old total={obl.total} "
                f"dtype={obl.dtype}, new total={nbl.total} "
                f"dtype={nbl.dtype} — the layouts were built for "
                f"different params"
            )
        plan = transfer_plan(
            obl.total, old.n_shards, obl.k, new.n_shards, nbl.k
        )
        moves[(g, b)] = plan
        m, l = plan_bytes(plan, _dtype_itemsize(obl.dtype))
        moved += m
        local += l
    return ReshardPlan(
        old=old, new=new, moves=moves, moved_bytes=moved, local_bytes=local
    )


def resize_redistribution(elements: int, itemsize: int, n_old: int,
                          n_new: int, *, quantized: bool = False,
                          copies: int = 1) -> dict:
    """Bytes-on-wire accounting for resizing one sharded vector of
    ``elements`` items from ``n_old`` to ``n_new`` rows — the pure
    pricing primitive the fleet simulator and the selfdrive re-plan
    ladder use (``copies`` = number of state vectors riding the same
    layout: e.g. Adam's mu+nu+EF ride the param partition 3x)."""
    k_old = shard_len(elements, n_old, quantized)
    k_new = shard_len(elements, n_new, quantized)
    plan = transfer_plan(elements, n_old, k_old, n_new, k_new)
    moved, local = plan_bytes(plan, itemsize)
    return {
        "elements": int(elements),
        "n_old": int(n_old),
        "n_new": int(n_new),
        "k_old": k_old,
        "k_new": k_new,
        "copies": int(copies),
        "moved_bytes": moved * int(copies),
        "local_bytes": local * int(copies),
        "total_bytes": int(elements) * int(itemsize) * int(copies),
    }


# --- rank-coordinate / leaf-slice math (pure mirror of rules engine) --------


def rank_coords(mesh_axes: Sequence[Tuple[str, int]], rank: int
                ) -> Dict[str, int]:
    """Axis coordinates of flat ``rank`` on a row-major mesh described
    as an ordered ``[(axis, size), ...]`` list — the pure mirror of
    ``Mesh.devices`` indexing for checkpoint shard assembly."""
    world = 1
    for _, size in mesh_axes:
        world *= int(size)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for mesh {mesh_axes}")
    coords: Dict[str, int] = {}
    rem = int(rank)
    for axis, size in reversed(list(mesh_axes)):
        coords[axis] = rem % int(size)
        rem //= int(size)
    return coords


def _spec_dims(spec: Any) -> List[Tuple[str, ...]]:
    """Normalize a per-leaf spec (as serialized in the manifest: a list
    with one entry per array dim, each entry None, an axis name, or a
    list of axis names) to a tuple-of-axis-tuples."""
    dims: List[Tuple[str, ...]] = []
    for entry in (spec or []):
        if entry is None:
            dims.append(())
        elif isinstance(entry, str):
            dims.append((entry,))
        else:
            dims.append(tuple(entry))
    return dims


def leaf_slices(spec: Any, shape: Sequence[int],
                mesh_sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index slices of one rank's shard of a leaf with global
    ``shape`` under ``spec`` — the jax-free mirror of
    ``parallel/rules.local_shard_tree`` (axes absent from ``mesh_sizes``
    contribute size 1, i.e. replicated)."""
    dims = _spec_dims(spec)
    out: List[slice] = []
    for d, dim_size in enumerate(shape):
        axes = dims[d] if d < len(dims) else ()
        idx, sz = 0, 1
        for a in axes:
            a_sz = int(mesh_sizes.get(a, 1))
            idx = idx * a_sz + (int(coords.get(a, 0)) % a_sz)
            sz *= a_sz
        if sz == 1:
            out.append(slice(0, dim_size))
            continue
        if dim_size % sz:
            raise ValueError(
                f"dim {d} of shape {tuple(shape)} not divisible by "
                f"mesh extent {sz} for spec {spec!r}"
            )
        shard = dim_size // sz
        out.append(slice(idx * shard, (idx + 1) * shard))
    return tuple(out)


# --- the layout manifest (checkpoint metadata) ------------------------------


@dataclass
class LayoutManifest:
    """Mesh/layout metadata written next to a sharded checkpoint so a
    restore at a DIFFERENT world shape can plan the redistribution: the
    ordered mesh axes, the rules-table id that produced the specs, one
    entry per (non-zero1) leaf with its global shape/dtype/spec, and the
    :class:`Zero1Layout` of every Zero1State node keyed by tree path.
    ``axes_hash`` fingerprints (mesh, rules) so mismatches are named,
    not guessed."""

    mesh_axes: List[Tuple[str, int]]
    leaves: List[dict]
    zero1: Dict[str, dict] = field(default_factory=dict)
    rules_id: Optional[str] = None
    step: int = 0
    schema: int = MANIFEST_SCHEMA

    @property
    def world(self) -> int:
        w = 1
        for _, size in self.mesh_axes:
            w *= int(size)
        return w

    @property
    def axes_hash(self) -> str:
        blob = json.dumps(
            {"mesh_axes": [[a, int(s)] for a, s in self.mesh_axes],
             "rules_id": self.rules_id},
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def describe(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.mesh_axes)
        return (
            f"mesh({axes}) rules={self.rules_id or '-'} "
            f"hash={self.axes_hash} leaves={len(self.leaves)} "
            f"zero1_nodes={len(self.zero1)}"
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": self.schema,
                "mesh_axes": [[a, int(s)] for a, s in self.mesh_axes],
                "rules_id": self.rules_id,
                "axes_hash": self.axes_hash,
                "step": self.step,
                "leaves": self.leaves,
                "zero1": self.zero1,
            },
            sort_keys=True, indent=1,
        )

    @classmethod
    def from_json(cls, text: str) -> "LayoutManifest":
        doc = json.loads(text)
        schema = int(doc.get("schema", -1))
        if schema != MANIFEST_SCHEMA:
            raise ValueError(
                f"checkpoint layout manifest schema {schema} is not the "
                f"supported schema {MANIFEST_SCHEMA}"
            )
        man = cls(
            mesh_axes=[(str(a), int(s)) for a, s in doc["mesh_axes"]],
            leaves=list(doc["leaves"]),
            zero1={str(k): dict(v) for k, v in doc.get("zero1", {}).items()},
            rules_id=doc.get("rules_id"),
            step=int(doc.get("step", 0)),
        )
        recorded = doc.get("axes_hash")
        if recorded and recorded != man.axes_hash:
            raise ValueError(
                f"checkpoint layout manifest axes_hash {recorded} does "
                f"not match its own mesh/rules content ({man.axes_hash}) "
                f"— the manifest is torn or hand-edited"
            )
        return man


def spec_to_list(spec: Any) -> Optional[List[Any]]:
    """Serialize a ``PartitionSpec``-like per-leaf spec to the manifest
    form: one entry per array dim — ``None``, an axis name, or a list of
    axis names. ``None`` spec means replicated."""
    if spec is None:
        return None
    out: List[Any] = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            out.append(entry)
        else:
            out.append([str(a) for a in entry])
    return out


def _flatten_with_path(tree: Any, is_leaf, prefix: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` in ``jax.tree_util.tree_flatten_with_path`` order:
    dict keys sorted, named tuples by field name, sequences by index."""
    if is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_path(tree[k], is_leaf,
                                                                    prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in _flatten_with_path(v, is_leaf, prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_path(v, is_leaf,
                                                                          prefix + (str(i),))]
    return [] if tree is None else [(prefix, tree)]


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``[("a/b", leaf)]`` with ``Zero1State`` nodes as leaves, the unit a
    manifest and a sharded checkpoint's payloads are keyed by."""
    return [("/".join(p), leaf) for p, leaf in _flatten_with_path(tree, _is_zero1_state)]


def build_manifest(tree: Any, mesh_axes: Sequence[Tuple[str, int]], *,
                   specs: Optional[Mapping[str, Any]] = None,
                   zero1_layouts: Optional[Mapping[str, Any]] = None,
                   zero1_axis: str = "data",
                   rules_id: Optional[str] = None,
                   step: int = 0) -> LayoutManifest:
    """Build the :class:`LayoutManifest` for a sharded checkpoint of
    ``tree`` (tensors, numpy arrays and ``Zero1State`` nodes in dicts,
    lists and tuples): one entry per other leaf, in tree order, with its
    global shape, numpy dtype name and spec (``specs`` maps tree path to a
    partition spec in tuple form; unlisted leaves are replicated), plus the
    :class:`Zero1Layout` of every ``Zero1State`` node (``zero1_layouts``
    maps path to layout; a bare layout is taken when the tree holds one
    node). The same tree of the same values gives the JAX package's JSON."""
    from ..guard.digest import dtype_name

    leaves: List[dict] = []
    zero1: Dict[str, dict] = {}
    for name, leaf in named_leaves(tree):
        if _is_zero1_state(leaf):
            if hasattr(zero1_layouts, "bucket_items"):      # one bare layout
                layout = zero1_layouts
            elif zero1_layouts is not None:
                layout = zero1_layouts.get(name)
            else:
                layout = None
            if layout is None:
                raise ValueError(
                    f"tree holds a Zero1State at {name!r} but no layout was provided for it: "
                    f"derive one with zero1_layout_from_params(...) and pass "
                    f"zero1_layouts={{{name!r}: layout}}")
            layout = layout.to_dict() if hasattr(layout, "to_dict") else dict(layout)
            layout["axis"] = zero1_axis
            zero1[name] = layout
            continue
        spec = specs.get(name) if specs else None
        leaves.append({
            "path": name,
            "dtype": dtype_name(leaf),
            "shape": [int(d) for d in getattr(leaf, "shape", ())],
            "spec": spec_to_list(spec),
        })
    return LayoutManifest(mesh_axes=[(str(a), int(s)) for a, s in mesh_axes],
                          leaves=leaves, zero1=zero1, rules_id=rules_id, step=int(step))


# --- execution half ---------------------------------------------------------


def zero1_layout_from_params(params: Any, n_shards: int, *,
                             threshold_bytes: Optional[int] = None,
                             first_bucket_bytes: Optional[int] = None,
                             quantized: bool = False) -> Zero1Layout:
    """The live :class:`Zero1Layout` of a parameter tree, from the same
    planner ``init_zero1_stream_state`` walks (``ops/fusion``'s
    ``zero1_group_layout``): its groups, their buckets, each bucket's total
    and dtype, and the row length at ``n_shards``. Buckets that carry no
    state (empty or not floating point) are skipped, as the init skips
    them."""
    from ..guard.digest import dtype_name
    from ..ops import fusion as F

    layout = Zero1Layout(n_shards=int(n_shards), quantized=bool(quantized))
    for label, leaves, buckets in F.zero1_group_layout(params, threshold_bytes,
                                                       first_bucket_bytes):
        group: Dict[str, BucketLayout] = {}
        for bi, bucket in enumerate(buckets):
            total = sum(int(leaves[i].numel()) for i in bucket)
            if total == 0 or not leaves[bucket[0]].is_floating_point():
                continue
            group[f"b{bi}"] = BucketLayout(total=total, k=shard_len(total, n_shards, quantized),
                                           dtype=dtype_name(leaves[bucket[0]]))
        layout.buckets[label] = group
    return layout


def _is_zero1_state(node: Any) -> bool:
    from .zero import Zero1State

    return isinstance(node, Zero1State)


# The inner optimizer's state keys in the order of the optax leaves they
# stand for (``optax.adam``'s ``count, mu, nu``; ``sgd``'s momentum
# ``trace``), so the gathered rows line up with the JAX package's stacked
# leaves; other keys follow by name.
STATE_ORDER = {"step": 0, "exp_avg": 1, "momentum_buffer": 1, "exp_avg_sq": 2}


def state_keys(keys) -> List[str]:
    return sorted(keys, key=lambda k: (STATE_ORDER.get(k, 3), k))


class Zero1Rows(NamedTuple):
    """The gathered form of a ZeRO-1 state: every rank's rows stacked.
    ``shards[g][b]`` is ``[n, k]``; ``state[g][b][key]`` an ``[n, k]``
    tensor, an ``[n]`` tensor of per-row scalars, or a plain value every
    row shares; ``ef[g][b]`` ``[n, k]`` or None. ``opt_type`` and ``hyper``
    rebuild the inner optimizer."""

    shards: Dict[str, Dict[str, Any]]
    state: Dict[str, Dict[str, Dict[str, Any]]]
    ef: Optional[Dict[str, Dict[str, Any]]]
    opt_type: Any
    hyper: Dict[str, Any]

    @property
    def n_shards(self) -> int:
        for g in self.shards.values():
            for t in g.values():
                return int(t.shape[0])
        return 0


def _state_n_shards(rows: Any) -> Optional[int]:
    n = rows.n_shards if isinstance(rows, Zero1Rows) else 0
    return n or None


def _rows_of(state: Any) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """``{(g, b): {key: value}}`` of one rank's inner optimizer state."""
    out = {}
    for g, sub in state.shards.items():
        for b, shard in sub.items():
            out[(g, b)] = dict(state.opt.state.get(shard, {}))
    return out


def stack_zero1_states(states: Sequence[Any]) -> Zero1Rows:
    """The gathered form of per-rank ``Zero1State``s held in one process,
    rank order."""
    import torch

    from .zero import _hyperparameters

    if not states or not all(_is_zero1_state(s) for s in states):
        raise TypeError("stack_zero1_states expects a non-empty sequence of Zero1State")
    per = [_rows_of(s) for s in states]
    shards: Dict[str, Dict[str, Any]] = {}
    state: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for g, sub in states[0].shards.items():
        shards[g], state[g] = {}, {}
        for b in sub:
            shards[g][b] = torch.stack([s.shards[g][b].detach() for s in states])
            keys = set(per[0][(g, b)])
            if any(set(p[(g, b)]) != keys for p in per):
                raise ValueError(f"bucket {g}/{b}: the ranks' optimizer state keys differ")
            state[g][b] = {}
            for key in state_keys(keys):
                vals = [p[(g, b)][key] for p in per]
                if torch.is_tensor(vals[0]):
                    state[g][b][key] = torch.stack([v.detach() for v in vals])
                else:
                    if any(v != vals[0] for v in vals):
                        raise ValueError(f"bucket {g}/{b}: per-rank {key!r} values differ {vals}")
                    state[g][b][key] = vals[0]
    ef = None
    if states[0].ef is not None:
        ef = {g: {b: torch.stack([s.ef[g][b] for s in states]) for b in sub}
              for g, sub in states[0].ef.items()}
    return Zero1Rows(shards=shards, state=state, ef=ef, opt_type=type(states[0].opt),
                     hyper=_hyperparameters(states[0].opt))


def gather_zero1_state(state: Any, group: Any = None) -> Zero1Rows:
    """All-gather this rank's ``Zero1State`` over ``group`` (None: every
    rank of the job) into the gathered form, on every rank. Each tensor
    crosses the wire on the group's device and comes back to its own."""
    import torch

    from ..common import basics
    from ..ops import collectives
    from .zero import _hyperparameters

    if not _is_zero1_state(state):
        raise TypeError(f"gather_zero1_state expects a Zero1State, got {type(state).__name__}")
    _, n = collectives.group_rank_size(group)
    wire = basics.device() if basics.is_initialized() else None

    def gather(t):
        src = t.detach().reshape(-1)
        out = collectives.allgather(src.to(wire) if wire is not None else src, group=group)
        return out.reshape((n,) + tuple(t.shape)).to(t.device)

    mine = _rows_of(state)
    shards, rows = {}, {}
    for g, sub in state.shards.items():
        shards[g], rows[g] = {}, {}
        for b, shard in sub.items():
            shards[g][b] = gather(shard)
            rows[g][b] = {key: gather(v) if torch.is_tensor(v) else v
                          for key, v in ((k, mine[(g, b)][k])
                                         for k in state_keys(mine[(g, b)]))}
    ef = None
    if state.ef is not None:
        ef = {g: {b: gather(t) for b, t in sub.items()} for g, sub in state.ef.items()}
    return Zero1Rows(shards=shards, state=rows, ef=ef, opt_type=type(state.opt),
                     hyper=_hyperparameters(state.opt))


def unstack_zero1_states(rows: Zero1Rows, ranks: Optional[Sequence[int]] = None) -> List[Any]:
    """One ``Zero1State`` per row (or per rank of ``ranks``): new flat
    parameter shards, a fresh inner optimizer over them (``opt_type`` with
    ``hyper``, as ``init_zero1_stream_state`` builds it) whose state holds
    the row's values, and the row's residuals."""
    import torch

    from .zero import Zero1State

    out = []
    for r in (range(rows.n_shards) if ranks is None else ranks):
        shards = {g: {b: torch.nn.Parameter(t[r].clone()) for b, t in sub.items()}
                  for g, sub in rows.shards.items()}
        opt = rows.opt_type([s for g in shards.values() for s in g.values()], **rows.hyper)
        for g, sub in shards.items():
            for b, shard in sub.items():
                st = rows.state.get(g, {}).get(b, {})
                if st:
                    opt.state[shard] = {k: (v[r].clone() if torch.is_tensor(v) else v)
                                        for k, v in st.items()}
        ef = None if rows.ef is None else {
            g: {b: t[r].clone() for b, t in sub.items()} for g, sub in rows.ef.items()}
        out.append(Zero1State(opt=opt, shards=shards, ef=ef))
    return out


def _resplit_rows(rows, total: int, n_new: int, k_new: int, moves: Sequence[ShardMove]):
    """Execute a transfer plan on an ``[n_old, k_old]`` tensor: an
    ``[n_new, k_new]`` tensor of its dtype and device with every real
    element placed per the plan and the pad zeroed. Bitwise: bytes move,
    nothing is recomputed."""
    import torch

    out = torch.zeros((int(n_new), int(k_new)), dtype=rows.dtype, device=rows.device)
    for m in moves:
        out[m.dst, m.dst_off:m.dst_off + m.length] = rows[m.src, m.src_off:m.src_off + m.length]
    return out


def reshard_zero1_state(state: Any, n_new: int, *,
                        layout: Optional[Zero1Layout] = None,
                        params: Any = None,
                        threshold_bytes: Optional[int] = None,
                        first_bucket_bytes: Optional[int] = None,
                        quantized: Optional[bool] = None,
                        ef_policy: str = "fold",
                        trigger: str = "manual",
                        axis: str = "data") -> Tuple[Any, dict]:
    """Re-split a gathered ZeRO-1 state onto ``n_new`` shards. ``state``
    is a :class:`Zero1Rows` (returned as one) or a sequence of every old
    rank's ``Zero1State`` (returned as a list of ``n_new`` of them).
    Returns ``(new_state, report)``.

    The bucket layout comes from ``layout`` (a checkpoint manifest's, an
    elastic snapshot's) or is derived from ``params``
    (:func:`zero1_layout_from_params`). The parameter shards and the inner
    optimizer's ``[n, k]`` state move by the transfer plan; its per-row
    scalars (``step``) are re-tiled after a check that every row holds the
    same value; a tensor of any other shape raises naming its bucket.
    Error-feedback residuals follow ``ef_policy``: ``"fold"`` moves each
    residual element with its parameter (pad-region mass, zero by
    construction, is counted and warned about if nonzero); ``"zero"``
    resets them and reports the discarded mass. Either way the report
    carries ``ef_dropped_elements`` and ``ef_dropped_mass``."""
    import torch

    from .. import metrics as _metrics
    from .. import trace as _trace

    as_list = isinstance(state, (list, tuple)) and state and all(
        _is_zero1_state(s) for s in state)
    if as_list:
        state = stack_zero1_states(state)
    if not isinstance(state, Zero1Rows):
        raise TypeError(
            f"reshard_zero1_state expects the gathered form of a Zero1State (Zero1Rows, or "
            f"every rank's Zero1State), got {type(state).__name__}: a rank holds only its "
            f"own rows; gather_zero1_state collects them")
    if ef_policy not in ("fold", "zero"):
        raise ValueError(f"ef_policy must be 'fold' or 'zero', got {ef_policy!r}")
    if layout is None:
        if params is None:
            raise ValueError(
                "reshard_zero1_state needs the bucket layout: pass layout= (from "
                "zero1_layout_from_params / a checkpoint manifest / an elastic snapshot) or "
                "params= to derive it")
        layout = zero1_layout_from_params(
            params, state.n_shards, threshold_bytes=threshold_bytes,
            first_bucket_bytes=first_bucket_bytes,
            quantized=bool(quantized) if quantized is not None else state.ef is not None)
    elif isinstance(layout, Mapping):
        layout = Zero1Layout.from_dict(layout)

    n_old = layout.n_shards
    live_n = _state_n_shards(state)
    if live_n is not None and live_n != n_old:
        raise ValueError(
            f"layout says n_shards={n_old} but the state's leading axis is {live_n}: the "
            f"layout describes a different world")
    new_layout = layout.relayout(n_new)
    plan = plan_zero1_reshard(layout, new_layout)
    report = dict(plan.summary())
    report.update({"trigger": trigger, "axis": axis, "ef_policy": ef_policy,
                   "ef_dropped_elements": 0, "ef_dropped_mass": 0.0})

    def bucket(g, b):
        if g not in layout.buckets or b not in layout.buckets[g]:
            raise ValueError(
                f"state holds bucket {g}/{b} but the layout does not describe it "
                f"({layout.describe()}): the layout was built for different params")
        return layout.buckets[g][b], new_layout.buckets[g][b], plan.moves[(g, b)]

    def one(g, b, key, value):
        bl, nbl, moves = bucket(g, b)
        if not torch.is_tensor(value):
            return value
        if value.dim() == 2 and value.shape == (n_old, bl.k):
            return _resplit_rows(value, bl.total, n_new, nbl.k, moves)
        if value.dim() == 1 and value.shape[0] == n_old:
            if value.numel() and not bool((value == value[0]).all()):
                raise ValueError(f"bucket {g}/{b}: per-shard scalar state {key!r} rows "
                                 f"disagree ({value.tolist()}); cannot reshard")
            return value[:1].expand(int(n_new)).clone()
        raise ValueError(
            f"bucket {g}/{b}: optimizer-state {key!r} of shape {tuple(value.shape)} is "
            f"neither an [n_shards, k={bl.k}] vector nor an [n_shards] scalar stack: this "
            f"optimizer's state has no defined reshard")

    shards = {g: {b: one(g, b, "shard", t) for b, t in sub.items()}
              for g, sub in state.shards.items()}
    rows = {g: {b: {k: one(g, b, k, v) for k, v in st.items()} for b, st in sub.items()}
            for g, sub in state.state.items()}
    dropped_elems, dropped_mass = 0, 0.0
    new_ef = None
    if state.ef is not None:
        new_ef = {}
        for g, sub in state.ef.items():
            new_ef[g] = {}
            for b, t in sub.items():
                bl, nbl, moves = bucket(g, b)
                flat = t.reshape(-1)
                pad = flat[bl.total:]
                pad_nonzero = int(torch.count_nonzero(pad))
                if ef_policy == "zero":
                    dropped_elems += int(torch.count_nonzero(flat[:bl.total])) + pad_nonzero
                    dropped_mass += float(flat.abs().double().sum())
                    new_ef[g][b] = torch.zeros((int(n_new), nbl.k), dtype=t.dtype,
                                               device=t.device)
                    continue
                if pad_nonzero:
                    # Pad-region residual mass has no parameter to ride with:
                    # count it, warn, and drop it explicitly.
                    dropped_elems += pad_nonzero
                    dropped_mass += float(pad.abs().double().sum())
                new_ef[g][b] = _resplit_rows(t, bl.total, n_new, nbl.k, moves)
    report["ef_dropped_elements"] = dropped_elems
    report["ef_dropped_mass"] = dropped_mass
    if dropped_elems:
        logger.warning(
            "reshard %s->%s shards (trigger=%s): %d EF residual elements (L1 mass %.3e) "
            "could not ride a parameter and were %s; the next quantized steps re-accumulate "
            "the error from scratch", n_old, n_new, trigger, dropped_elems, dropped_mass,
            "zeroed" if ef_policy == "zero" else "dropped")
    if _metrics.ACTIVE:
        _metrics.TAP.inc("hvd_reshard_total", trigger=str(trigger))
        _metrics.TAP.inc("hvd_reshard_bytes_total", value=float(plan.moved_bytes),
                         axis=str(axis))
        if dropped_elems:
            _metrics.TAP.inc("hvd_reshard_ef_dropped_elements_total",
                             value=float(dropped_elems), policy=ef_policy)
    if _trace.ACTIVE:
        _trace.TAP.event("hvd_reshard", cat="elastic", trigger=str(trigger), axis=str(axis),
                         n_old=n_old, n_new=int(n_new), moved_bytes=plan.moved_bytes,
                         ef_dropped_elements=dropped_elems)
    logger.info("resharded zero1 state %d->%d shards (trigger=%s, axis=%s): %d buckets, "
                "%d bytes on the wire, %d local", n_old, n_new, trigger, axis,
                len(plan.moves), plan.moved_bytes, plan.local_bytes)
    out = Zero1Rows(shards=shards, state=rows, ef=new_ef, opt_type=state.opt_type,
                    hyper=state.hyper)
    return (unstack_zero1_states(out) if as_list else out), report


def reshard_zero1_tree(tree: Any, n_new: int, layouts: Optional[Mapping[str, Any]] = None,
                       **kw) -> Tuple[Any, List[dict]]:
    """Reshard every gathered ZeRO-1 node (:class:`Zero1Rows`) inside a
    tree of dicts, lists and tuples to ``n_new`` shards. ``layouts`` maps
    the node's tree path (``"a/b"``) to its :class:`Zero1Layout` (or dict);
    a tree of one node takes a bare layout under the empty path. Returns
    the rebuilt tree and the per-node reports."""
    reports: List[dict] = []

    def walk(node, path):
        if isinstance(node, Zero1Rows):
            layout = None
            if layouts is not None:
                layout = layouts.get(path)
                if layout is None and len(layouts) == 1 and "" in layouts:
                    layout = layouts[""]
                if layout is None:
                    raise ValueError(f"no layout recorded for Zero1State at {path!r}; "
                                     f"known paths: {sorted(layouts)}")
            new, report = reshard_zero1_state(node, n_new, layout=layout, **kw)
            report["path"] = path
            reports.append(report)
            return new
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f"{path}/{f}" if path else f)
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        return node

    out = walk(tree, "")
    return (out if reports else tree), reports
