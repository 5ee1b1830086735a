"""Collective compositor: hierarchical lowering plans for every collective.

The port of ``horovod_tpu/topo/compositor.py``, both halves.

**Planning** (:func:`candidate_plans`, :func:`select_plan`, :class:`Plan`)
is pure Python, deterministic, stable JSON, and the JAX package's rule for
rule, so the same model gives the same plans: every collective is composed
from single-level primitives (reduce-scatter, allreduce, all-gather, tree
broadcast, all-to-all, local permute) mapped onto the hops of
``topo/model.py``, and an alpha-beta cost model selects the algorithm per
(model, payload bytes, op, wire dtype). ``tools/topo_plan`` and
``hvd.collective_plan`` read this layer only.

**Lowering** (:func:`lower_allreduce` and the others) runs a selected
algorithm over the levels. Every lowering equals the flat collective:
bitwise where the regrouping commutes (MIN/MAX, integer sums, data
movement), to float rounding for SUM:

- ``flat`` — one collective over the whole hierarchy: the one group of an
  ``AxisGroups`` (``parallel.mesh.axis_groups``), or a hierarchy of one
  level. A flat collective over several levels with no such group raises;
  it never runs two-level in its place. Broadcast is the exception, as in
  the JAX package: flat over several levels is the per-level chain.
- ``ring`` / ``recursive-halving`` — explicit single-level schedules:
  the bandwidth-optimal ring (reduce-scatter then all-gather, n - 1 rounds
  each, one ``batch_isend_irecv`` a round through the level's ``ring``)
  and MPICH's halving-doubling for power-of-two levels (one pairwise
  ``exchange`` a round), in the JAX package's round order. Every rank's
  result is bitwise the same: each element's reduction is computed once
  and copied.
- ``two-level`` — the hierarchical composition at any depth: allreduce =
  RS(inner) -> allreduce(outer levels) -> AG(inner); reduce-scatter
  pre-permutes blocks locally so the large payload stays on the inner
  level; allgather, broadcast and alltoall chain per-level stages.
- ``split`` — FlexLink's concurrent-link mode (two levels): the payload
  splits into two buckets in proportion to the levels' bandwidths, each
  reduced two-level. Here the two buckets run one after the other on the
  levels' process groups.
- ``two-level-sa`` (broadcast) — the root's inner level gets the value,
  only 1/L shards cross the outer levels, an inner all-gather reassembles.

The int8 wire's two-level form compresses only the outermost level
(``ops/quantized.quantized_hierarchical_allreduce``); its flat, ring and
halving labels run the int8 ring; the bf16 wire is a cast on entry and
exit.

``axes`` is a tuple of levels, outermost first: process groups, or hop
objects with ``rank``, ``n``, ``reduce_scatter``, ``all_gather``,
``all_reduce``, ``broadcast``, ``all_to_all``, ``exchange`` and ``ring``
(``ops/collectives.Hop``, which a group is wrapped in; ``chip_smoke.py``
plays a grid of ranks on one card through its own). The sizes come from
the levels. The rank order is outer-major, ``rank = outer * inner_size +
inner``, as the hierarchical meshes lay ranks out.

:func:`planned_reduce_fn` and :func:`auto_reduce_fn` select a plan per
fusion bucket (``hierarchical="auto"`` on a ``(cross, local)`` mesh);
:func:`record_plan` stamps it into ``hvd_topo_plan_info`` and
``hvd_topo_bytes_per_hop``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..common.quant import (
    WIRE_BF16,
    WIRE_DTYPES,
    WIRE_F32,
    WIRE_INT8,
    bf16_wire_bytes,
    int8_wire_bytes,
)
from ..common.types import ReduceOp
from ..ops import collectives
from .model import Hop, InterconnectModel

COLLECTIVES = (
    "allreduce", "allgather", "reducescatter", "broadcast", "alltoall",
)

# Reduce ops the hierarchical compositions support. PRODUCT stays
# flat-only (the butterfly in ops/collectives.py); ADASUM has its own
# hierarchical schedule in ops/adasum.py.
_HIER_REDUCE_OPS = (
    ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN, ReduceOp.MAX,
)

# Stable stage metadata (consumed by analysis/plan_verify.py): the base
# primitive kind behind each stage label. Suffixes encode the schedule
# variant (``-ring`` / ``-halving`` / ``-doubling`` / ``-tree``), for
# split mode the bucket (``-b0`` / ``-b1``), and for the chunked
# collective-matmul direction stages the round count (``-r<N>`` — the
# rounds depend on the chunk count, not just the hop size). ``local``
# stages move no bytes over any hop.
STAGE_KINDS = {
    "all_reduce": "allreduce",
    "reduce_scatter": "reducescatter",
    "all_gather": "allgather",
    "broadcast": "broadcast",
    "all_to_all": "alltoall",
    "block_permute": "local",
    "collective_matmul_fwd": "collmm",
    "collective_matmul_bwd": "collmm",
}


def _rounds_tag(name: str) -> Tuple[str, Optional[int]]:
    """Strip a trailing ``-r<N>`` round-count tag: ``"x-r6"`` ->
    ``("x", 6)``."""
    head, sep, tail = name.rpartition("-r")
    if sep and tail.isdigit():
        return head, int(tail)
    return name, None


def stage_kind(primitive: str) -> Tuple[str, str, Optional[int]]:
    """Decompose a stage label into ``(kind, variant, bucket)``:
    ``"reduce_scatter-ring-b1"`` -> ``("reducescatter", "ring", 1)``.
    Unknown labels return kind ``"?"`` (the verifier rejects them)."""
    name = primitive
    bucket: Optional[int] = None
    for b in (0, 1):
        if name.endswith(f"-b{b}"):
            name, bucket = name[: -3], b
            break
    variant = ""
    for suffix in ("ring", "halving", "doubling", "tree"):
        if name.endswith("-" + suffix):
            name, variant = name[: -(len(suffix) + 1)], suffix
            break
    name, _ = _rounds_tag(name)
    return STAGE_KINDS.get(name, "?"), variant, bucket


def perm_rounds(primitive: str, size: int) -> Optional[List[List[Tuple[int, int]]]]:
    """The explicit per-round point-to-point schedule a ring/halving stage
    stands for, as ``[[(src, dst), ...], ...]`` over ``range(size)`` —
    the metadata the symbolic plan verifier checks for bijectivity and
    round counts. Non-permute stages (native collectives, trees,
    local relayouts) return None."""
    kind, variant, _ = stage_kind(primitive)
    n = int(size)
    if kind == "collmm":
        # Chunked collective-matmul direction stage: the round count
        # rides the ``-r<N>`` tag (hops x chunks — not derivable from
        # the hop size alone); every round is the same +1 (fwd) or -1
        # (bwd) ring shift.
        base = primitive
        for suffix in ("-ring",):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
        _, r = _rounds_tag(base)
        if r is None or n <= 1:
            return []
        step = 1 if "_fwd" in primitive else -1
        perm = [(i, (i + step) % n) for i in range(n)]
        return [list(perm) for _ in range(r)]
    if variant == "ring":
        if n <= 1:
            return []
        fwd = [(i, (i + 1) % n) for i in range(n)]
        return [list(fwd) for _ in range(n - 1)]
    if variant in ("halving", "doubling"):
        if n <= 1:
            return []
        if n & (n - 1):
            return [[(i, i) for i in range(n)]]  # caught as a bad round
        k = n.bit_length() - 1
        dists = [n >> (t + 1) for t in range(k)]
        if variant == "doubling":
            dists = list(reversed(dists))
        return [[(i, i ^ d) for i in range(n)] for d in dists]
    return None


@dataclass(frozen=True)
class Stage:
    """One primitive of a lowering schedule: ``bytes_on_wire`` is the
    per-rank traffic this stage puts on its hop, ``rounds`` its latency
    cost in units of the hop's per-round latency. ``wire_dtype`` is the
    stage's wire format: ``"f32"`` (full precision — the payload's own
    width) or ``"int8"`` (blockwise int8+scales, ``common/quant.py``),
    in which case ``bytes_on_wire`` is the COMPRESSED traffic."""

    primitive: str
    hop: str
    axis: str
    bytes_on_wire: int
    rounds: int
    wire_dtype: str = WIRE_F32

    def to_dict(self) -> dict:
        return {
            "primitive": self.primitive,
            "hop": self.hop,
            "axis": self.axis,
            "bytes_on_wire": int(self.bytes_on_wire),
            "rounds": int(self.rounds),
            "wire_dtype": self.wire_dtype,
        }


@dataclass(frozen=True)
class Plan:
    """A selected lowering: the compositor's machine-readable verdict,
    exposed via ``hvd.collective_plan()`` / ``tools/topo_plan.py`` and
    recorded as ``hvd_topo_plan_info`` / ``hvd_topo_bytes_per_hop``."""

    collective: str
    op: str
    algorithm: str
    nbytes: int
    hop_sizes: Tuple[int, ...]
    stages: Tuple[Stage, ...]
    cost_us: float
    # FlexLink split mode only: (flat-bucket bytes, hierarchical-bucket
    # bytes), proportional to per-hop bandwidth.
    split_bytes: Tuple[int, ...] = ()
    # Requested wire format ("f32" or "int8"). An int8 plan must carry
    # at least one int8 stage — a plan claiming compression without a
    # quantize stage fails the symbolic verifier
    # (analysis/plan_verify.py).
    wire_dtype: str = WIRE_F32

    @property
    def bytes_per_hop(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.stages:
            if s.hop == "-":  # wireless local relayout stages
                continue
            out[s.hop] = out.get(s.hop, 0) + int(s.bytes_on_wire)
        return out

    def to_dict(self) -> dict:
        return {
            "collective": self.collective,
            "op": self.op,
            "algorithm": self.algorithm,
            "nbytes": int(self.nbytes),
            "hop_sizes": list(self.hop_sizes),
            "cost_us": round(float(self.cost_us), 4),
            "bytes_per_hop": {
                k: int(v) for k, v in sorted(self.bytes_per_hop.items())
            },
            "split_bytes": list(self.split_bytes),
            "wire_dtype": self.wire_dtype,
            "stages": [s.to_dict() for s in self.stages],
        }


def _op_name(op: Any) -> str:
    if isinstance(op, ReduceOp):
        return op.name
    return str(op or "-")


def _stage_cost_us(stage: Stage, hop: Hop) -> float:
    # GB/s == 1e3 bytes/us.
    return (
        hop.latency_us * stage.rounds
        + stage.bytes_on_wire / (hop.bandwidth_gbps * 1e3)
    )


def _plan_cost_us(stages: Sequence[Stage],
                  model: InterconnectModel) -> float:
    by_name = {h.name: h for h in model.hops}
    return sum(_stage_cost_us(s, by_name[s.hop]) for s in stages)


def _bottleneck(model: InterconnectModel) -> Hop:
    """The hop a flat (whole-tuple) collective is bound by: the slowest
    one — on a multi-level model a collective over the whole grid cannot move
    cross-slice traffic faster than DCN."""
    return min(model.hops, key=lambda h: h.bandwidth_gbps)


def split_fractions(model: InterconnectModel) -> Tuple[float, float]:
    """FlexLink split for 2-level allreduce: payload fractions of the
    two pipelined hierarchical buckets, proportional to per-hop
    bandwidth (inner/ICI share first). Balanced this way, bucket 0's
    DCN stage runs while bucket 1's ICI stages do — both links stay
    driven instead of the fast one idling through the slow hop."""
    inner_bw = model.inner.bandwidth_gbps
    outer_bw = model.hops[0].bandwidth_gbps
    total = inner_bw + outer_bw
    return inner_bw / total, outer_bw / total


# --- candidate schedules (planning layer, pure python) -----------------------


def _flat_stages(model: InterconnectModel, primitive: str, nbytes: int,
                 bytes_factor: float, rounds: int) -> List[Stage]:
    b = _bottleneck(model)
    return [Stage(
        primitive=primitive, hop=b.name, axis="+".join(model.axes),
        bytes_on_wire=int(nbytes * bytes_factor), rounds=rounds,
    )]


def _compress_stage(s: Stage) -> Stage:
    """Re-declare a stage with the int8+scales wire format: same
    schedule, compressed bytes."""
    return Stage(
        primitive=s.primitive, hop=s.hop, axis=s.axis,
        bytes_on_wire=int8_wire_bytes(s.bytes_on_wire), rounds=s.rounds,
        wire_dtype=WIRE_INT8,
    )


def _cast_stage(s: Stage) -> Stage:
    """Re-declare a stage with the bf16 cast wire format: same schedule,
    half the bytes, no scales. A cast commutes with any data movement
    and any SUM/AVERAGE, so unlike int8 this applies to EVERY stage of
    every candidate."""
    return Stage(
        primitive=s.primitive, hop=s.hop, axis=s.axis,
        bytes_on_wire=bf16_wire_bytes(s.bytes_on_wire), rounds=s.rounds,
        wire_dtype=WIRE_BF16,
    )


def _candidates_allreduce(model: InterconnectModel, nbytes: int,
                          op: ReduceOp,
                          wire_dtype: str = WIRE_F32
                          ) -> Dict[str, List[Stage]]:
    n = model.size
    int8 = wire_dtype == WIRE_INT8
    cands: Dict[str, List[Stage]] = {}
    if op not in _HIER_REDUCE_OPS:
        # PRODUCT/ADASUM have no compositor regrouping: one flat plan.
        if model.levels == 1:
            h = model.hops[0]
            return {"flat": [Stage(
                "all_reduce", h.name, h.axis,
                int(nbytes * 2 * (n - 1) / max(n, 1)), max(2 * (n - 1), 0),
            )]} if n > 1 else {"flat": []}
        return {"flat": _flat_stages(
            model, "all_reduce", nbytes, 2 * (n - 1) / n, 2 * (n - 1)
        )}
    if model.levels == 1:
        h = model.hops[0]
        if n <= 1:
            return {"flat": []}
        cands["ring"] = [
            Stage("reduce_scatter-ring", h.name, h.axis,
                  int(nbytes * (n - 1) / n), n - 1),
            Stage("all_gather-ring", h.name, h.axis,
                  int(nbytes * (n - 1) / n), n - 1),
        ]
        if int8:
            # The EQuARX ring: both phases move int8+scales (the only
            # single-level quantized lowering shipped; halving-doubling
            # has no quantized schedule).
            return {"ring": [_compress_stage(s) for s in cands["ring"]]}
        if n & (n - 1) == 0 and op in _HIER_REDUCE_OPS:
            k = int(math.log2(n))
            cands["recursive-halving"] = [
                Stage("reduce_scatter-halving", h.name, h.axis,
                      int(nbytes * (n - 1) / n), k),
                Stage("all_gather-doubling", h.name, h.axis,
                      int(nbytes * (n - 1) / n), k),
            ]
        return cands
    # Multi-level: flat rides the bottleneck hop as a ring.
    cands["flat"] = _flat_stages(
        model, "all_reduce", nbytes, 2 * (n - 1) / n, 2 * (n - 1)
    )
    if int8:
        # Flat quantized = chained int8 rings, every hop compressed;
        # two-level quantized = compressed-on-DCN-only (the outermost
        # all_reduce stage moves int8+scales, the inner reduce-scatter/
        # all-gather stay full precision over ICI). Split has no
        # quantized lowering and is not offered.
        cands["flat"] = [_compress_stage(s) for s in cands["flat"]]
        two = _two_level_allreduce_stages(model, nbytes, op)
        outer = model.hops[0].name
        cands["two-level"] = [
            _compress_stage(s)
            if s.primitive == "all_reduce" and s.hop == outer else s
            for s in two
        ]
        return cands
    if op in _HIER_REDUCE_OPS:
        cands["two-level"] = _two_level_allreduce_stages(model, nbytes, op)
        if (
            model.levels == 2
            and op in (ReduceOp.SUM, ReduceOp.AVERAGE)
            and nbytes >= 2 * model.size
        ):
            cands["split"] = _split_allreduce_stages(model, nbytes)
    return cands


def _two_level_allreduce_stages(model: InterconnectModel, nbytes: int,
                                op: ReduceOp) -> List[Stage]:
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        # Per-hop reduction chain: full payload on every hop, log-depth
        # rounds each (the level's own all-reduce).
        return [
            Stage("all_reduce", h.name, h.axis, int(nbytes),
                  max(1, math.ceil(math.log2(max(h.size, 2)))))
            for h in reversed(model.hops)
        ]
    # SUM/AVERAGE: RS(inner) -> allreduce(outer...) -> AG(inner),
    # recursively — the shard shrinks by each inner size.
    stages: List[Stage] = []
    remaining = nbytes
    inner_path: List[Tuple[Hop, int]] = []
    for h in reversed(model.hops[1:]):  # inner hops, innermost first
        s = h.size
        stages.append(Stage(
            "reduce_scatter", h.name, h.axis,
            int(remaining * (s - 1) / s), s - 1,
        ))
        inner_path.append((h, remaining))
        remaining = math.ceil(remaining / s)
    top = model.hops[0]
    n0 = top.size
    stages.append(Stage(
        "all_reduce", top.name, top.axis,
        int(remaining * 2 * (n0 - 1) / n0), 2 * (n0 - 1),
    ))
    for h, nb in reversed(inner_path):
        s = h.size
        stages.append(Stage(
            "all_gather", h.name, h.axis, int(nb * (s - 1) / s), s - 1,
        ))
    return stages


def _split_allreduce_stages(model: InterconnectModel,
                            nbytes: int) -> List[Stage]:
    f0, _ = split_fractions(model)
    nb0 = int(nbytes * f0)
    stages = [Stage(
        s.primitive + "-b0", s.hop, s.axis, s.bytes_on_wire, s.rounds,
    ) for s in _two_level_allreduce_stages(model, nb0, ReduceOp.SUM)]
    stages += [Stage(
        s.primitive + "-b1", s.hop, s.axis, s.bytes_on_wire, s.rounds,
    ) for s in _two_level_allreduce_stages(
        model, nbytes - nb0, ReduceOp.SUM
    )]
    return stages


def _candidates_allgather(model: InterconnectModel,
                          nbytes: int) -> Dict[str, List[Stage]]:
    n = model.size
    if model.levels == 1:
        h = model.hops[0]
        return {"ring": [Stage(
            "all_gather-ring", h.name, h.axis, int(nbytes * (n - 1)),
            max(n - 1, 0),
        )]}
    cands = {"flat": _flat_stages(
        model, "all_gather", nbytes, n - 1, n - 1
    )}
    stages: List[Stage] = []
    gathered = nbytes
    for h in reversed(model.hops):  # innermost first
        s = h.size
        stages.append(Stage(
            "all_gather", h.name, h.axis, int(gathered * (s - 1)), s - 1,
        ))
        gathered *= s
    cands["two-level"] = stages
    return cands


def _candidates_reducescatter(model: InterconnectModel, nbytes: int,
                              wire_dtype: str = WIRE_F32
                              ) -> Dict[str, List[Stage]]:
    n = model.size
    int8 = wire_dtype == WIRE_INT8
    if model.levels == 1:
        h = model.hops[0]
        ring = [Stage(
            "reduce_scatter-ring", h.name, h.axis,
            int(nbytes * (n - 1) / max(n, 1)), max(n - 1, 0),
        )]
        if int8:
            # The int8 ring RS (ops/quantized.py, ZeRO-1's gradient
            # hop): the single reduce-scatter phase of the EQuARX ring,
            # every hop int8+scales.
            return {"ring": [_compress_stage(s) for s in ring]}
        return {"ring": ring}
    cands = {"flat": _flat_stages(
        model, "reduce_scatter", nbytes, (n - 1) / n, n - 1
    )}
    stages: List[Stage] = [Stage(
        "block_permute", "-", "-", 0, 0,  # local relayout, no wire
    )]
    remaining = nbytes
    for h in reversed(model.hops):  # innermost first
        s = h.size
        stages.append(Stage(
            "reduce_scatter", h.name, h.axis,
            int(remaining * (s - 1) / s), s - 1,
        ))
        remaining = math.ceil(remaining / s)
    cands["two-level"] = stages
    if int8:
        # Planning-level quantized RS on a hierarchy: flat rides the
        # bottleneck as the int8 ring; two-level compresses only the
        # outermost (DCN) stage — the 1/L shard that actually crosses
        # the slow hop — like the allreduce DCN-only construction.
        outer = model.hops[0].name
        cands["flat"] = [_compress_stage(s) for s in cands["flat"]]
        cands["two-level"] = [
            _compress_stage(s) if s.hop == outer else s
            for s in cands["two-level"]
        ]
    return cands


def _candidates_broadcast(model: InterconnectModel,
                          nbytes: int) -> Dict[str, List[Stage]]:
    if model.levels == 1:
        h = model.hops[0]
        k = max(1, math.ceil(math.log2(max(h.size, 2))))
        if h.size <= 1:
            return {"tree": []}
        return {"tree": [Stage(
            "broadcast-tree", h.name, h.axis, int(nbytes) * k, k,
        )]}
    b = _bottleneck(model)
    n = model.size
    k_all = max(1, math.ceil(math.log2(max(n, 2))))
    cands = {"flat": [Stage(
        "broadcast-tree", b.name, "+".join(model.axes),
        int(nbytes) * k_all, k_all,
    )]}
    # Per-hop trees, inner -> outer (full payload each hop).
    tree: List[Stage] = []
    for h in reversed(model.hops):
        k = max(1, math.ceil(math.log2(max(h.size, 2))))
        tree.append(Stage(
            "broadcast-tree", h.name, h.axis, int(nbytes) * k, k,
        ))
    cands["two-level"] = tree
    # Scatter-allgather: tree inside the root slice, 1/L shards over the
    # outer hops, inner allgather to reassemble.
    inner = model.inner
    L = inner.size
    k_in = max(1, math.ceil(math.log2(max(L, 2))))
    sa: List[Stage] = [Stage(
        "broadcast-tree", inner.name, inner.axis, int(nbytes) * k_in, k_in,
    )]
    shard = math.ceil(nbytes / L)
    for h in reversed(model.hops[:-1]):
        k = max(1, math.ceil(math.log2(max(h.size, 2))))
        sa.append(Stage(
            "broadcast-tree", h.name, h.axis, int(shard) * k, k,
        ))
    sa.append(Stage(
        "all_gather", inner.name, inner.axis,
        int(nbytes * (L - 1) / L), L - 1,
    ))
    cands["two-level-sa"] = sa
    return cands


def _candidates_alltoall(model: InterconnectModel,
                         nbytes: int) -> Dict[str, List[Stage]]:
    n = model.size
    if model.levels == 1:
        h = model.hops[0]
        return {"flat": [Stage(
            "all_to_all", h.name, h.axis,
            int(nbytes * (n - 1) / max(n, 1)), max(n - 1, 0),
        )]}
    cands = {"flat": _flat_stages(
        model, "all_to_all", nbytes, (n - 1) / n, n - 1
    )}
    stages: List[Stage] = []
    for h in model.hops:  # outermost first (the lowering's phase order)
        s = h.size
        stages.append(Stage(
            "all_to_all", h.name, h.axis,
            int(nbytes * (s - 1) / s), s - 1,
        ))
    cands["two-level"] = stages
    return cands


def _effective_model(model: InterconnectModel) -> InterconnectModel:
    if model.eligible or model.levels <= 1:
        return model
    # Collapse to the flat view: hierarchy exists but is unsafe.
    return InterconnectModel(
        hops=(Hop(
            name=_bottleneck(model).name,
            axis="+".join(model.axes),
            size=model.size,
            bandwidth_gbps=_bottleneck(model).bandwidth_gbps,
            latency_us=_bottleneck(model).latency_us,
        ),),
        generation=model.generation, eligible=False,
        source=model.source,
    )


def candidate_plans(
    model: InterconnectModel,
    collective: str,
    nbytes: int,
    op: Any = ReduceOp.SUM,
    wire_dtype: str = WIRE_F32,
) -> Dict[str, Plan]:
    """Every candidate lowering the compositor can emit for
    ``collective`` at this payload on this model, as fully-formed costed
    :class:`Plan` objects keyed by algorithm name. :func:`select_plan`
    picks the cheapest of these; the symbolic plan verifier
    (``analysis/plan_verify.py``) checks every one of them.
    ``wire_dtype="int8"`` (allreduce and reduce-scatter, SUM/AVERAGE
    only — reduce-scatter is ZeRO-1's gradient hop) prices the
    quantized wire: every hop compressed for flat/ring, only the
    outermost (DCN) hop for two-level. ``wire_dtype="bf16"`` is the
    pure-cast rung (docs/topology.md): half the bytes on EVERY stage of
    EVERY candidate of EVERY collective — a cast commutes with any data
    movement and any additive reduction, needs no scales and no error
    feedback."""
    if collective not in COLLECTIVES:
        raise ValueError(
            f"unknown collective {collective!r}; one of {COLLECTIVES}"
        )
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; one of {WIRE_DTYPES}"
        )
    nbytes = max(int(nbytes), 0)
    op_enum = op if isinstance(op, ReduceOp) else None
    if isinstance(op, str) and op not in ("-", ""):
        op_enum = ReduceOp[op.upper()]
    if op_enum is None:
        op_enum = ReduceOp.SUM
    if wire_dtype == WIRE_INT8 and (
        collective not in ("allreduce", "reducescatter")
        or op_enum not in (ReduceOp.SUM, ReduceOp.AVERAGE)
    ):
        raise ValueError(
            "wire_dtype='int8' is an allreduce/reduce-scatter "
            f"SUM/AVERAGE construction (got {collective}/"
            f"{_op_name(op_enum)}): per-hop int8 requantization "
            "accumulates in f32, which is only sound for additive "
            "reductions"
        )
    eff = _effective_model(model)
    if collective == "allreduce":
        cands = _candidates_allreduce(eff, nbytes, op_enum, wire_dtype)
    elif collective == "allgather":
        cands = _candidates_allgather(eff, nbytes)
    elif collective == "reducescatter":
        cands = _candidates_reducescatter(eff, nbytes, wire_dtype)
    elif collective == "broadcast":
        cands = _candidates_broadcast(eff, nbytes)
    else:
        cands = _candidates_alltoall(eff, nbytes)
    if not cands:
        cands = {"flat": []}
    if wire_dtype == WIRE_BF16:
        # The cast applies uniformly after the fact: same schedules,
        # every wire stage at half the bytes (local relayouts move no
        # wire bytes and stay as-is).
        cands = {
            name: [_cast_stage(s) if s.hop != "-" else s for s in stages]
            for name, stages in cands.items()
        }
    op_label = _op_name(
        op_enum if collective in ("allreduce", "reducescatter") else None
    )
    plans: Dict[str, Plan] = {}
    for name in sorted(cands):
        stages = cands[name]
        if name == "split":
            cost = _split_cost_us(
                eff,
                bf16_wire_bytes(nbytes) if wire_dtype == WIRE_BF16
                else nbytes,
            )
            f0, _ = split_fractions(eff)
            nb0 = int(nbytes * f0)
            split_bytes: Tuple[int, ...] = (nb0, nbytes - nb0)
        else:
            cost = _plan_cost_us(
                [s for s in stages if s.hop != "-"], eff
            )
            split_bytes = ()
        plans[name] = Plan(
            collective=collective,
            op=op_label,
            algorithm=name,
            nbytes=nbytes,
            hop_sizes=tuple(h.size for h in eff.hops),
            stages=tuple(stages),
            cost_us=float(cost),
            split_bytes=split_bytes,
            wire_dtype=wire_dtype,
        )
    return plans


def select_plan(
    model: InterconnectModel,
    collective: str,
    nbytes: int,
    op: Any = ReduceOp.SUM,
    wire_dtype: str = WIRE_F32,
) -> Plan:
    """Cost every candidate algorithm for ``collective`` at this payload
    on this model and return the cheapest as a :class:`Plan`. An
    ineligible model (ragged/interleaved layout, or a single hop) only
    considers single-level algorithms — the "safe to go hierarchical"
    gate from ``Topology.is_homogeneous``."""
    plans = candidate_plans(model, collective, nbytes, op, wire_dtype)
    best: Optional[Plan] = None
    for name in sorted(plans):  # deterministic tie-break
        plan = plans[name]
        if best is None or plan.cost_us < best.cost_us:
            best = plan
    return best


def _split_cost_us(model: InterconnectModel, nbytes: int) -> float:
    """Pipelined estimate for the split mode: across the two buckets,
    each hop's bandwidth terms sum to the same totals as one two-level
    pass (splitting is size-linear), but the hops run CONCURRENTLY —
    take the max of the per-hop busy times — while the latency terms pay
    twice (two dispatched schedules). That is what makes split lose to
    plain two-level for small payloads (latency-bound) and win for large
    ones (the faster hop's busy time hides inside the slower's)."""
    one = _two_level_allreduce_stages(model, nbytes, ReduceOp.SUM)
    by_name = {h.name: h for h in model.hops}
    busy: Dict[str, float] = {}
    alpha = 0.0
    for s in one:
        hop = by_name[s.hop]
        busy[s.hop] = busy.get(s.hop, 0.0) + (
            s.bytes_on_wire / (hop.bandwidth_gbps * 1e3)
        )
        alpha += hop.latency_us * s.rounds
    return max(busy.values()) + 2 * alpha


# --- collective-matmul plan kind (fused TP overlap) --------------------------
#
# docs/parallelism.md "Fused TP overlap": ops/collective_matmul.py's
# all_gather_matmul / matmul_reduce_scatter dissolve the Megatron TP
# psum into bidirectional chunked ring hops that ride the wire
# WHILE the tensor cores multiply. These plans price one such primitive:
# cost = max(compute, wire) + ramp, where ramp is the pipeline fill (the
# first sub-chunk's hop, which nothing can hide) — more chunks shrink
# the ramp but pay more per-round latency, the trade the tuner searches.

COLLECTIVE_MATMUL_FLAVORS = ("all_gather_matmul", "matmul_reduce_scatter")


def ring_hops(n: int) -> Tuple[int, int]:
    """Hops each ring direction carries for a bidirectional pass over
    ``n`` ranks: ``(ceil((n-1)/2), floor((n-1)/2))`` — together exactly
    the ``n-1`` deliveries, split so both link directions work."""
    n = int(n)
    if n <= 1:
        return (0, 0)
    return (-(-(n - 1) // 2), (n - 1) // 2)


def collective_matmul_cost_us(
    model: InterconnectModel,
    nbytes: int,
    *,
    chunks: int = 1,
    compute_us: float = 0.0,
    wire_dtype: str = WIRE_F32,
) -> Dict[str, float]:
    """Price ONE chunked collective-matmul primitive on the innermost
    hop (the TP axis rides ICI): ``wire`` is the busier ring direction's
    time (the directions run concurrently), ``ramp`` the first
    sub-chunk's un-hideable delivery, ``cost = max(compute, wire) +
    ramp`` and ``exposed = cost - compute`` — what the step pays beyond
    the matmul it had to run anyway. Compare against the classic
    exposed-psum constant (``sim.tp_fixed_comm_us``)."""
    hop = model.hops[-1]
    n = hop.size
    compute_us = float(compute_us)
    if n <= 1:
        return {
            "cost_us": round(compute_us, 4), "exposed_us": 0.0,
            "wire_us": 0.0, "ramp_us": 0.0,
        }
    h_fwd, h_bwd = ring_hops(n)
    c = max(int(chunks), 1)
    wire_bytes = (
        bf16_wire_bytes(nbytes) if wire_dtype == WIRE_BF16
        else int8_wire_bytes(nbytes) if wire_dtype == WIRE_INT8
        else int(nbytes)
    )
    bw = hop.bandwidth_gbps * 1e3  # bytes/us
    wire_fwd = hop.latency_us * h_fwd * c + wire_bytes * h_fwd / n / bw
    wire_bwd = hop.latency_us * h_bwd * c + wire_bytes * h_bwd / n / bw
    wire_us = max(wire_fwd, wire_bwd)
    ramp_us = hop.latency_us + wire_bytes / (n * c) / bw
    cost = max(compute_us, wire_us) + ramp_us
    return {
        "cost_us": round(cost, 4),
        "exposed_us": round(cost - compute_us, 4),
        "wire_us": round(wire_us, 4),
        "ramp_us": round(ramp_us, 4),
    }


def collective_matmul_plan(
    model: InterconnectModel,
    flavor: str,
    nbytes: int,
    *,
    chunks: int = 1,
    compute_us: float = 0.0,
    wire_dtype: str = WIRE_F32,
) -> Plan:
    """The machine-checkable schedule behind one fused primitive: one
    direction stage per ring (the bwd stage vanishes at n=2 where the
    backward ring carries nothing), each ``hops x chunks`` rounds of the
    same +-1 shift with EXACT symbolic bytes ``nbytes*hops/n`` — what
    ``analysis/plan_verify`` Pass 3 executes for per-round bijectivity
    and byte accounting. ``cost_us`` embeds the overlap model of
    :func:`collective_matmul_cost_us`."""
    if flavor not in COLLECTIVE_MATMUL_FLAVORS:
        raise ValueError(
            f"unknown collective_matmul flavor {flavor!r}; one of "
            f"{COLLECTIVE_MATMUL_FLAVORS}"
        )
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; one of {WIRE_DTYPES}"
        )
    if wire_dtype == WIRE_INT8:
        raise ValueError(
            "wire_dtype='int8' is an allreduce/reduce-scatter "
            "SUM/AVERAGE construction — the collective-matmul chunks "
            "are consumed by a matmul per hop, which has no blockwise "
            "requantization schedule; use 'bf16' for the cast rung"
        )
    nbytes = max(int(nbytes), 0)
    hop = model.hops[-1]
    n = hop.size
    h_fwd, h_bwd = ring_hops(n)
    c = max(int(chunks), 1)
    stages: List[Stage] = []
    for direction, hops in (("fwd", h_fwd), ("bwd", h_bwd)):
        if hops <= 0:
            continue
        s = Stage(
            primitive=(
                f"collective_matmul_{direction}-r{hops * c}-ring"
            ),
            hop=hop.name, axis=hop.axis,
            bytes_on_wire=int(nbytes * hops / n), rounds=hops * c,
        )
        stages.append(_cast_stage(s) if wire_dtype == WIRE_BF16 else s)
    priced = collective_matmul_cost_us(
        model, nbytes, chunks=c, compute_us=compute_us,
        wire_dtype=wire_dtype,
    )
    return Plan(
        collective="collective_matmul",
        op="SUM" if flavor == "matmul_reduce_scatter" else "-",
        algorithm=f"{flavor}-c{c}",
        nbytes=nbytes,
        hop_sizes=tuple(h.size for h in model.hops),
        stages=tuple(stages),
        cost_us=float(priced["cost_us"]),
        wire_dtype=wire_dtype,
    )


# --- lowering layer -------------------------------------------------------------


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
    """The one level a flat collective over ``axes`` runs on: the
    flattened group of an ``AxisGroups`` (or its hop-like ``flat``)."""
    if len(levels) == 1:
        return levels[0]
    return collectives.as_hop(collectives.flat_group(axes))


def _check_reduce_op(op: ReduceOp, collective: str) -> None:
    if op not in _HIER_REDUCE_OPS:
        raise ValueError(
            f"hierarchical {collective} supports {[o.name for o in _HIER_REDUCE_OPS]}; got "
            f"{op!r} (PRODUCT/ADASUM have no hierarchical regrouping here: use the flat "
            f"lowering or ops/adasum.py)")


def _check_algorithm(algorithm: str, known: Sequence[str]) -> None:
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


_COMBINE = {
    ReduceOp.SUM: torch.add,
    ReduceOp.AVERAGE: torch.add,
    ReduceOp.MIN: torch.minimum,
    ReduceOp.MAX: torch.maximum,
}


def _ring_allreduce(x: torch.Tensor, hop, combine) -> torch.Tensor:
    """The explicit ring allreduce over one level: a reduce-scatter ring
    then an all-gather ring, n - 1 rounds each, every round one post of the
    level's ring (send to rank + 1, receive from rank - 1). Each chunk's
    reduction is one accumulation chain along the ring and then copied, so
    every rank's result is bitwise the same."""
    n = hop.n
    if n == 1:
        return x
    flat, pad = _pad(x.reshape(-1), n)
    m = flat.shape[0] // n
    r = hop.rank
    ring = hop.ring
    buf = flat.clone()
    for t in range(n - 1):
        send_idx, recv_idx = (r - t) % n, (r - t - 1) % n
        (recv,) = ring.wait(ring.post([(buf[send_idx * m:(send_idx + 1) * m], 1)]))
        buf[recv_idx * m:(recv_idx + 1) * m] = combine(buf[recv_idx * m:(recv_idx + 1) * m],
                                                       recv)
    # Rank r now holds the reduced chunk (r + 1) % n; pass it around.
    for t in range(n - 1):
        send_idx, recv_idx = (r + 1 - t) % n, (r - t) % n
        (recv,) = ring.wait(ring.post([(buf[send_idx * m:(send_idx + 1) * m], 1)]))
        buf[recv_idx * m:(recv_idx + 1) * m] = recv
    if pad:
        buf = buf[:flat.shape[0] - pad]
    return buf.reshape(x.shape)


def _rhd_allreduce(x: torch.Tensor, hop, combine) -> torch.Tensor:
    """MPICH's recursive halving-doubling over one power-of-two level:
    log2(n) halving exchanges reduce-scatter the vector (the partner at
    distance n/2 first), log2(n) doubling exchanges gather it back, each
    one pairwise ``exchange``. Bitwise the same on every rank: each
    element's reduction tree is computed once, by its segment's owner."""
    n = hop.n
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError(f"recursive-halving needs a power-of-two hop size, got {n}")
    k = n.bit_length() - 1
    buf, pad = _pad(x.reshape(-1), n)
    total = buf.shape[0]
    r = hop.rank
    bits = []
    for t in range(k):
        d = n >> (t + 1)
        half = buf.shape[0] // 2
        bit = (r >> (k - 1 - t)) & 1            # 0: keep the low half, 1: the high
        bits.append(bit)
        keep = buf[bit * half:(bit + 1) * half]
        send = buf[(1 - bit) * half:(2 - bit) * half]
        buf = combine(keep, hop.exchange(send.contiguous(), r ^ d))
    for t in reversed(range(k)):
        d = n >> (t + 1)
        recv = hop.exchange(buf.contiguous(), r ^ d)
        buf = torch.cat([buf, recv] if bits[t] == 0 else [recv, buf])
    if pad:
        buf = buf[:total - pad]
    return buf.reshape(x.shape)


def lower_allreduce(x: torch.Tensor, axes, *, op: ReduceOp = ReduceOp.SUM,
                    algorithm: str = "two-level", split_fraction: Optional[float] = None,
                    wire_dtype: str = WIRE_F32) -> torch.Tensor:
    """Allreduce ``x`` over the hierarchy ``axes`` (outermost first) with
    the given algorithm. Equal to the flat allreduce: exactly for MIN/MAX
    and integer sums, to float rounding for float SUM/AVERAGE; to int8
    quantization with ``wire_dtype="int8"`` (SUM/AVERAGE: ``flat``,
    ``ring`` and ``recursive-halving`` run the int8 ring over every level,
    ``two-level`` compresses only the outermost level); to bf16 rounding
    with ``wire_dtype="bf16"`` (any op and algorithm: a cast down on entry
    and up on exit). ``ring`` and ``recursive-halving`` are single-level
    schedules: over several levels they run on the flattened group.
    ``split_fraction`` is bucket 0's share of the elements under ``split``
    (default one half)."""
    levels = hops(axes)
    _check_algorithm(algorithm, ("flat", "ring", "recursive-halving", "two-level", "split"))
    if wire_dtype == WIRE_BF16:
        out = lower_allreduce(x.to(torch.bfloat16), axes, op=op, algorithm=algorithm,
                              split_fraction=split_fraction)
        return out.to(x.dtype)
    if wire_dtype == WIRE_INT8:
        from ..ops.quantized import quantized_hierarchical_allreduce, quantized_ring_allreduce

        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"wire_dtype='int8' supports SUM/AVERAGE; got {op}")
        average = op == ReduceOp.AVERAGE
        if algorithm in ("flat", "ring", "recursive-halving"):
            return quantized_ring_allreduce(x, average=average, ring=_flat_hop(axes, levels).ring)
        if algorithm == "two-level":
            return quantized_hierarchical_allreduce(x, axes, average=average)
        raise ValueError(f"allreduce algorithm {algorithm!r} has no int8 lowering")
    if wire_dtype != WIRE_F32:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}")
    if algorithm == "flat":
        hop = _flat_hop(axes, levels)
        if op == ReduceOp.AVERAGE:
            return hop.all_reduce(x, ReduceOp.SUM) / hop.n
        return hop.all_reduce(x, op)
    if algorithm in ("ring", "recursive-halving"):
        _check_reduce_op(op, f"{algorithm} allreduce")
        hop = _flat_hop(axes, levels)
        schedule = _ring_allreduce if algorithm == "ring" else _rhd_allreduce
        out = schedule(x, hop, _COMBINE[op])
        return out / hop.n if op == ReduceOp.AVERAGE else out
    _check_reduce_op(op, "allreduce")
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        # A per-level chain, inner -> outer: MIN/MAX regroup exactly.
        out = x
        for hop in reversed(levels):
            out = hop.all_reduce(out, op)
        return out
    flat = x.reshape(-1)
    if algorithm == "split":
        if len(levels) != 2:
            raise ValueError("split mode composes exactly two hops")
        frac = 0.5 if split_fraction is None else split_fraction
        n = flat.shape[0]
        n0 = max(min(int(n * frac), n - 1), 1) if n > 1 else 0
        if n0:
            # Elementwise SUM splits cleanly: the two buckets' reductions
            # concatenate to the unsplit one.
            out = torch.cat([_allreduce_sum_levels(flat[:n0], levels),
                             _allreduce_sum_levels(flat[n0:], levels)])
        else:
            out = _allreduce_sum_levels(flat, levels)
    else:
        out = _allreduce_sum_levels(flat, levels)
    out = out.reshape(x.shape)
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


# --- metrics and plan selection for the fusion buckets ---------------------------


def record_plan(plan: Plan, where: str = "compositor") -> Plan:
    """Stamp a selected plan into the taps: the trace's plan note (the
    algorithm, collective and wire dtype ride every later step span) and
    the ``hvd_topo_plan_info``/``hvd_topo_bytes_per_hop`` gauges. With the
    taps off this costs two boolean reads."""
    from .. import metrics as _metrics
    from .. import trace as _trace

    if _trace.ACTIVE:
        _trace.TAP.note_plan(topo_algorithm=plan.algorithm, topo_collective=plan.collective,
                             wire_dtype=plan.wire_dtype)
    if _metrics.ACTIVE:
        _metrics.TAP.set("hvd_topo_plan_info", 1.0, collective=plan.collective,
                         algorithm=plan.algorithm, op=plan.op, where=where)
        for hop, nb in plan.bytes_per_hop.items():
            _metrics.TAP.set("hvd_topo_bytes_per_hop", float(nb), collective=plan.collective,
                             hop=hop, where=where)
    return plan


# Mesh axis names by position from the innermost level (parallel/mesh.py).
_LEVEL_AXES = ("local", "cross", "pod")


def model_for_axes(axes, generation: Optional[str] = None) -> InterconnectModel:
    """The interconnect model of a hierarchy of levels (groups or hops,
    outermost first): the innermost level maps to the ``ici`` hop on the
    ``local`` axis, the next to ``dcn`` on ``cross``, a third to
    ``dcn-pod`` on ``pod``; the sizes are the levels' own. The
    ``HOROVOD_TOPOLOGY_MODEL`` override applies. This is how a fusion
    bucket is priced against the groups it actually reduces over, not a
    detected process topology."""
    from .model import DCN, ICI, POD_DCN, _mk_hop, apply_override, detect_generation

    sizes = [h.n for h in hops(axes)]
    generation = generation or detect_generation()
    names = (ICI, DCN, POD_DCN)
    levels = [_mk_hop(names[min(i, 2)], s, generation, axis=_LEVEL_AXES[min(i, 2)])
              for i, s in enumerate(reversed(sizes))]
    model = InterconnectModel(hops=tuple(reversed(levels)), generation=generation,
                              eligible=len(sizes) > 1 and sizes[-1] > 1, source="axes")
    return apply_override(model)


def auto_reduce_fn(quantized: bool = False, algorithm: Optional[str] = None):
    """A fusion ``reduce_fn`` that builds the model from the groups it is
    given (:func:`model_for_axes`) and defers to :func:`planned_reduce_fn`:
    the form ``hierarchical="auto"`` uses. ``algorithm`` pins one allreduce
    lowering instead of the per-bucket cost selection."""

    def fn(x, *, op, group, prescale_factor=1.0, postscale_factor=1.0):
        inner = planned_reduce_fn(model_for_axes(group), group, quantized=quantized,
                                  algorithm=algorithm)
        out = inner(x, op=op, group=group, prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor)
        fn.selected.update(inner.selected)
        return out

    fn.selected = {}        # bucket bytes -> the algorithm selected for it
    return fn


def planned_reduce_fn(model: InterconnectModel, axes=None, quantized: bool = False,
                      algorithm: Optional[str] = None):
    """A fusion ``reduce_fn``: per bucket, select the allreduce plan for
    the bucket's payload on ``model`` (recorded with ``where="stream"``)
    and lower it over ``axes`` (the groups the reduction is given win).

    ``quantized=True`` selects among the int8 candidates for float
    SUM/AVERAGE buckets (integer buckets and other ops stay full
    precision): the int8 ring on every level, or int8 on the outermost
    level only (two-level).

    The single-level labels ``ring`` and ``recursive-halving`` lower
    through the group's own allreduce (NCCL's schedule, which the label's
    price estimates), as in the JAX package: inside a training step the
    explicit schedules are reached through :func:`lower_allreduce` only.
    The int8 ring is the exception: no library collective quantizes.

    ``algorithm`` bypasses the cost selection where the compositor offers
    that candidate at the bucket's payload, and falls back to it where it
    does not (``split`` below its minimum size)."""

    def fn(x, *, op, group=None, prescale_factor=1.0, postscale_factor=1.0):
        use_axes = group if group is not None else axes
        if prescale_factor != 1.0:
            x = x * prescale_factor
        nbytes = x.numel() * x.element_size()
        int8 = quantized and op in (ReduceOp.SUM, ReduceOp.AVERAGE) and x.is_floating_point()
        wire = WIRE_INT8 if int8 else WIRE_F32
        plan = None
        if algorithm:
            plan = candidate_plans(model, "allreduce", nbytes, op=op,
                                   wire_dtype=wire).get(algorithm)
        if plan is None:
            plan = select_plan(model, "allreduce", nbytes, op=op, wire_dtype=wire)
        record_plan(plan, where="stream")
        if int8:
            from ..ops import fusion
            from ..ops.quantized import record_wire_bytes

            if fusion.first_sight(("planned-int8", nbytes, id(use_axes))):
                record_wire_bytes(nbytes, "stream")
        lower_algo, frac = plan.algorithm, None
        if lower_algo == "split" and plan.nbytes:
            frac = plan.split_bytes[0] / plan.nbytes
        elif (lower_algo in ("ring", "recursive-halving") or len(hops(use_axes)) == 1) \
                and not int8:
            lower_algo = "flat"
        out = lower_allreduce(x, use_axes, op=op, algorithm=lower_algo, split_fraction=frac,
                              wire_dtype=wire)
        if postscale_factor != 1.0:
            out = out * postscale_factor
        fn.selected[nbytes] = plan.algorithm
        return out

    fn.selected = {}        # bucket bytes -> the algorithm selected for it
    return fn
