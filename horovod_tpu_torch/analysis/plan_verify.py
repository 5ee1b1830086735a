"""Symbolic verification of compositor lowering plans.

The port of ``horovod_tpu/analysis/plan_verify.py``, whole. The
hierarchical schedules (``topo/compositor.py``) are verifiable artifacts,
not just runnable code (HiCCL's framing, arXiv:2408.05962): every
:class:`~horovod_tpu_torch.topo.compositor.Plan` is a
finite sequence of single-hop primitives whose combined effect must equal
the collective's spec. This module executes a plan *symbolically* — per
rank, an abstract buffer of ``(source_rank, segment)`` chunk sets — and
checks, with no device and no process group:

 - every stage names a real hop/axis of the model and a known primitive
   (:data:`RULE_PLAN_STAGE`);
 - the per-round point-to-point schedules that ring/halving stages stand
   for (``topo.compositor.perm_rounds``) are complete bijections over
   their hop, and the declared round counts match
   (:data:`RULE_PLAN_BIJECTION` / :data:`RULE_PLAN_STAGE`);
 - each stage's declared ``bytes_on_wire`` matches the traffic the
   abstract state implies, to integer-rounding slack
   (:data:`RULE_PLAN_BYTES`);
 - the final abstract state equals the collective's spec — allreduce:
   every rank holds every segment with contributions from every rank;
   allgather / reduce-scatter / broadcast / alltoall likewise
   (:data:`RULE_PLAN_RESULT`).

``verify_plan_grid`` sweeps the whole ``candidate_plans`` grid (all
collectives x all candidate algorithms x the topo-smoke topology ladder)
— which makes a corrupted schedule a lint failure instead of a
2/4/8-rank execution flake.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import (
    Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple,
)

from ..common.quant import (
    WIRE_BF16,
    WIRE_DTYPES,
    WIRE_F32,
    WIRE_INT8,
    bf16_wire_bytes,
    int8_wire_bytes,
)
from ..common.types import ReduceOp
from ..topo import compositor as _comp
from ..topo.compositor import Plan, Stage, perm_rounds, stage_kind
from ..topo.model import InterconnectModel, synthetic_model
from .findings import (
    Finding,
    RULE_PLAN_BIJECTION,
    RULE_PLAN_BYTES,
    RULE_PLAN_RESULT,
    RULE_PLAN_STAGE,
    SEVERITY_ERROR,
    apply_suppressions,
)

Coords = Tuple[int, ...]

# The topology ladder the JAX package's topology smoke sweeps
# plus payloads spanning latency-bound to bandwidth-bound selections.
DEFAULT_TOPOLOGIES: Tuple[Tuple[str, Dict[str, int]], ...] = (
    ("1-slice", dict(local=8)),
    ("2-slice", dict(local=4, cross=2)),
    ("4-slice", dict(local=2, cross=4)),
    ("2-pod", dict(local=2, cross=2, pod=2)),
)
DEFAULT_PAYLOADS: Tuple[int, ...] = (1024, 1 << 20, 64 << 20)
DEFAULT_OPS: Tuple[ReduceOp, ...] = (
    ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN, ReduceOp.MAX,
    ReduceOp.PRODUCT,
)


def _digits(idx: int, sizes: Sequence[int]) -> Coords:
    out = []
    for s in reversed(sizes):
        out.append(idx % s)
        idx //= s
    return tuple(reversed(out))


def _index(digits: Coords, sizes: Sequence[int]) -> int:
    idx = 0
    for d, s in zip(digits, sizes):
        idx = idx * s + d
    return idx


def _all_coords(sizes: Sequence[int]) -> List[Coords]:
    coords: List[Coords] = [()]
    for s in sizes:
        coords = [c + (d,) for c in coords for d in range(s)]
    return coords


def _groups(coords: Sequence[Coords],
            levels: Tuple[int, ...]) -> List[List[Coords]]:
    """Partition the rank space into the groups a stage over ``levels``
    communicates within: ranks sharing every coordinate OUTSIDE the
    stage's levels."""
    by_key: Dict[Coords, List[Coords]] = {}
    lv = set(levels)
    for c in coords:
        key = tuple(d for i, d in enumerate(c) if i not in lv)
        by_key.setdefault(key, []).append(c)
    return list(by_key.values())


class _PlanChecker:
    """One plan's verification pass: accumulates findings, never raises."""

    def __init__(self, plan: Plan, model: InterconnectModel,
                 rounds_fn: Optional[Callable] = None):
        self.plan = plan
        self.model = _comp._effective_model(model)
        self.rounds_fn = rounds_fn or perm_rounds
        self.sizes = tuple(h.size for h in self.model.hops)
        self.n = 1
        for s in self.sizes:
            self.n *= s
        self.coords = _all_coords(self.sizes)
        self.findings: List[Finding] = []
        # Rounding slack between declared int()/ceil bookkeeping and the
        # exact Fraction accounting: bounded by one byte per level of
        # ceil-division plus the final truncation, scaled by group size.
        self.byte_tol = 8 + self.n

    # ----------------------------------------------------------- findings
    def _loc(self, i: int, stage: Stage) -> str:
        return (
            f"plan:{self.plan.collective}/{self.plan.algorithm}/"
            f"stage[{i}]:{stage.primitive}@{stage.hop}"
        )

    def _flag(self, rule: str, i: int, stage: Stage, msg: str,
              **details: Any) -> None:
        self.findings.append(Finding(
            rule=rule,
            severity=SEVERITY_ERROR,
            message=msg,
            location=self._loc(i, stage),
            details={
                "stage_index": i,
                "primitive": stage.primitive,
                "hop": stage.hop,
                "axis": stage.axis,
                **details,
            },
        ))

    def _flag_final(self, msg: str, **details: Any) -> None:
        self.findings.append(Finding(
            rule=RULE_PLAN_RESULT,
            severity=SEVERITY_ERROR,
            message=msg,
            location=(
                f"plan:{self.plan.collective}/{self.plan.algorithm}/final"
            ),
            details=details,
        ))

    # ------------------------------------------------------ stage helpers
    def _stage_levels(self, i: int, stage: Stage) -> Optional[Tuple[int, ...]]:
        if stage.hop == "-":
            return ()
        model_axes = tuple(h.axis for h in self.model.hops)
        # Exact single-hop match first: a collapsed ineligible model's
        # one hop legitimately carries a joined "cross+local" axis name.
        for lvl, h in enumerate(self.model.hops):
            if h.axis == stage.axis:
                if h.name != stage.hop:
                    self._flag(
                        RULE_PLAN_STAGE, i, stage,
                        f"stage rides axis {stage.axis!r} which belongs "
                        f"to hop {h.name!r}, not {stage.hop!r}",
                    )
                return (lvl,)
        axes = tuple(a for a in stage.axis.split("+") if a)
        if len(axes) > 1:
            if set(axes) != set(model_axes):
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"flat stage spans axes {axes} but the model has "
                    f"{model_axes}",
                )
                return None
            return tuple(range(len(self.sizes)))
        self._flag(
            RULE_PLAN_STAGE, i, stage,
            f"stage axis {stage.axis!r} is not an axis of the model "
            f"(axes: {model_axes})",
        )
        return None

    def _group_size(self, levels: Tuple[int, ...]) -> int:
        g = 1
        for lvl in levels:
            g *= self.sizes[lvl]
        return g

    def _check_rounds_and_perm(self, i: int, stage: Stage, g: int) -> None:
        """Round-count + bijectivity checks for one stage over a group of
        size ``g``."""
        kind, variant, _ = stage_kind(stage.primitive)
        if variant in ("ring", "halving", "doubling"):
            rounds = self.rounds_fn(stage.primitive, g)
            if rounds is None:
                rounds = []
            for t, perm in enumerate(rounds):
                srcs = [s for s, _ in perm]
                dsts = [d for _, d in perm]
                ok = (
                    sorted(srcs) == list(range(g))
                    and sorted(dsts) == list(range(g))
                    and all(s != d or g == 1 for s, d in perm)
                )
                if not ok:
                    self._flag(
                        RULE_PLAN_BIJECTION, i, stage,
                        f"{variant} schedule round {t} is not a complete "
                        f"bijection over the hop (size {g}): "
                        f"sources {sorted(set(srcs))}, "
                        f"destinations {sorted(set(dsts))}",
                        round=t, group_size=g,
                    )
                    return
            if stage.rounds != len(rounds):
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"declares {stage.rounds} rounds but the {variant} "
                    f"schedule over a size-{g} hop has {len(rounds)}",
                    expected_rounds=len(rounds), group_size=g,
                )
            return
        k = max(1, math.ceil(math.log2(max(g, 2))))
        if kind == "allreduce":
            expected = {2 * (g - 1), k}
        elif kind in ("reducescatter", "allgather", "alltoall"):
            expected = {g - 1, k}
        elif kind == "broadcast":
            expected = {k}
        else:
            return
        if g <= 1:
            expected |= {0}
        if stage.rounds not in expected:
            self._flag(
                RULE_PLAN_STAGE, i, stage,
                f"declares {stage.rounds} rounds; a {kind} over a "
                f"size-{g} hop realizes {sorted(expected)}",
                expected_rounds=sorted(expected), group_size=g,
            )

    def _check_bytes(self, i: int, stage: Stage, expected: Fraction,
                     allow_tree: Optional[Fraction] = None) -> None:
        declared = int(stage.bytes_on_wire)
        candidates = [expected]
        if allow_tree is not None:
            candidates.append(allow_tree)
        if getattr(stage, "wire_dtype", WIRE_F32) == WIRE_INT8:
            # Compressed stage: the symbolic state still moves the full-
            # precision payload; what the wire carries is its int8+scales
            # image. A stage claiming int8 with full-size bytes (or the
            # converse — small bytes without the wire_dtype marker, which
            # lands in the plain branch above) fails here.
            candidates = [
                Fraction(int8_wire_bytes(int(c))) for c in candidates
            ]
        elif getattr(stage, "wire_dtype", WIRE_F32) == WIRE_BF16:
            # The cast rung: the wire carries the payload's bf16 image —
            # two bytes per full-precision element, no scales.
            candidates = [
                Fraction(bf16_wire_bytes(int(c))) for c in candidates
            ]
        if any(abs(declared - c) <= self.byte_tol for c in candidates):
            return
        self._flag(
            RULE_PLAN_BYTES, i, stage,
            f"declares {declared} bytes on wire but the symbolic state "
            f"implies {int(candidates[0])}"
            + (f" (or {int(candidates[-1])} for a latency tree)"
               if allow_tree is not None else ""),
            declared_bytes=declared, expected_bytes=int(candidates[0]),
        )

    # -------------------------------------------------- reduction machine
    def _verify_reduction(self, stages: Sequence[Tuple[int, Stage]],
                          nbytes: int, want: str) -> None:
        """allreduce (`want='allreduce'`) and reduce-scatter
        (`want='reducescatter'`): per rank, segment -> contributing
        ranks. Segments are the ``n`` outer-major destination shards."""
        n = self.n
        state: Dict[Coords, Dict[int, FrozenSet[int]]] = {
            c: {seg: frozenset([_index(c, self.sizes)])
                for seg in range(n)}
            for c in self.coords
        }
        for i, stage in stages:
            kind, variant, _ = stage_kind(stage.primitive)
            if kind == "local":
                continue
            if kind not in ("allreduce", "reducescatter", "allgather"):
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"unexpected primitive in an {want} schedule",
                )
                return
            levels = self._stage_levels(i, stage)
            if levels is None:
                return
            g = self._group_size(levels)
            self._check_rounds_and_perm(i, stage, g)
            frac = Fraction(nbytes)
            for group in _groups(self.coords, levels):
                segsets = {frozenset(state[c].keys()) for c in group}
                held = len(next(iter(segsets)))
                b_pre = Fraction(nbytes) * held / n
                if kind in ("allreduce", "reducescatter"):
                    if len(segsets) != 1:
                        self._flag(
                            RULE_PLAN_STAGE, i, stage,
                            f"group members disagree on held segments "
                            f"before a {kind} stage (SPMD asymmetry)",
                        )
                        return
                if kind == "allreduce":
                    frac = 2 * b_pre * (g - 1) / g if g else Fraction(0)
                    tree = b_pre
                    for seg in next(iter(segsets)):
                        merged = frozenset().union(
                            *(state[c][seg] for c in group)
                        )
                        for c in group:
                            state[c][seg] = merged
                elif kind == "reducescatter":
                    frac = b_pre * (g - 1) / g if g else Fraction(0)
                    tree = None
                    pre = {m: state[m] for m in group}
                    for c in group:
                        mine = tuple(c[lvl] for lvl in levels)
                        kept: Dict[int, FrozenSet[int]] = {}
                        for seg in pre[c]:
                            sd = _digits(seg, self.sizes)
                            if tuple(sd[lvl] for lvl in levels) == mine:
                                kept[seg] = frozenset().union(
                                    *(pre[m][seg] for m in group)
                                )
                        state[c] = kept
                else:  # allgather
                    frac = b_pre * (g - 1)
                    tree = None
                    union: Dict[int, FrozenSet[int]] = {}
                    ok = True
                    for c in group:
                        for seg, contrib in state[c].items():
                            if seg in union and union[seg] != contrib:
                                self._flag(
                                    RULE_PLAN_STAGE, i, stage,
                                    f"gather merges segment {seg} with "
                                    f"conflicting contribution sets",
                                    segment=seg,
                                )
                                ok = False
                            union[seg] = contrib
                    if not ok:
                        return
                    for c in group:
                        state[c] = dict(union)
            self._check_bytes(i, stage, frac, allow_tree=tree
                              if kind == "allreduce" else None)
        everyone = frozenset(range(n))
        for c in self.coords:
            r = _index(c, self.sizes)
            if want == "allreduce":
                missing = sorted(set(range(n)) - set(state[c]))
                if missing:
                    self._flag_final(
                        f"rank {r} is missing segments {missing} after "
                        f"the schedule (allreduce must leave the full "
                        f"buffer everywhere)", rank=r, missing=missing,
                    )
                    return
                for seg, contrib in state[c].items():
                    if contrib != everyone:
                        self._flag_final(
                            f"rank {r} segment {seg} only reduces "
                            f"contributions from ranks "
                            f"{sorted(contrib)}, not all {n}",
                            rank=r, segment=seg,
                            contributors=sorted(contrib),
                        )
                        return
            else:  # reducescatter
                if set(state[c]) != {r}:
                    self._flag_final(
                        f"rank {r} ends holding segments "
                        f"{sorted(state[c])}; reduce-scatter must leave "
                        f"exactly its own shard [{r}]",
                        rank=r, held=sorted(state[c]),
                    )
                    return
                if state[c][r] != everyone:
                    self._flag_final(
                        f"rank {r}'s shard only reduces contributions "
                        f"from ranks {sorted(state[c][r])}, not all {n}",
                        rank=r, contributors=sorted(state[c][r]),
                    )
                    return

    # --------------------------------------------------- movement machines
    def _verify_allgather(self, stages: Sequence[Tuple[int, Stage]],
                          nbytes: int) -> None:
        """Per rank: the set of source blocks held (plan nbytes is the
        per-rank shard size)."""
        state: Dict[Coords, FrozenSet[int]] = {
            c: frozenset([_index(c, self.sizes)]) for c in self.coords
        }
        for i, stage in stages:
            kind, _, _ = stage_kind(stage.primitive)
            if kind == "local":
                continue
            if kind != "allgather":
                self._flag(RULE_PLAN_STAGE, i, stage,
                           "unexpected primitive in an allgather schedule")
                return
            levels = self._stage_levels(i, stage)
            if levels is None:
                return
            g = self._group_size(levels)
            self._check_rounds_and_perm(i, stage, g)
            expected = Fraction(0)
            for group in _groups(self.coords, levels):
                counts = {len(state[c]) for c in group}
                if len(counts) != 1:
                    self._flag(
                        RULE_PLAN_STAGE, i, stage,
                        "group members hold unequal block counts before "
                        "a gather stage (SPMD asymmetry)",
                    )
                    return
                union = frozenset().union(*(state[c] for c in group))
                expected = Fraction(nbytes) * counts.pop() * (g - 1)
                for c in group:
                    state[c] = union
            self._check_bytes(i, stage, expected)
        everyone = frozenset(range(self.n))
        for c in self.coords:
            if state[c] != everyone:
                r = _index(c, self.sizes)
                self._flag_final(
                    f"rank {r} ends holding source blocks "
                    f"{sorted(state[c])}; allgather must deliver all "
                    f"{self.n}", rank=r, held=sorted(state[c]),
                )
                return

    def _verify_collective_matmul(
        self, stages: Sequence[Tuple[int, Stage]], nbytes: int
    ) -> None:
        """Fused TP primitive (``topo.compositor.collective_matmul_plan``):
        one direction stage per ring, each ``hops x chunks`` rounds of
        the same +-1 shift. Per rank, fwd hop k delivers the segment k
        behind (offset ``-k``), bwd hop k the segment k ahead (``+k``) —
        for all_gather_matmul those are activation chunks gathered, for
        matmul_reduce_scatter partial-product contributions reduced; the
        movement algebra is identical. Completeness: the offsets plus
        the rank's own segment must cover all ``n`` — a dropped chunk
        (short round tag) leaves a hole, doubled bytes break the exact
        ``nbytes*hops/n`` accounting, a corrupted round breaks
        bijectivity."""
        plan = self.plan
        algo, sep, tail = plan.algorithm.rpartition("-c")
        if not sep or not tail.isdigit() or algo not in getattr(
            _comp, "COLLECTIVE_MATMUL_FLAVORS",
            ("all_gather_matmul", "matmul_reduce_scatter"),
        ):
            self._flag_final(
                f"unknown collective_matmul algorithm "
                f"{plan.algorithm!r}; expected "
                f"'<flavor>-c<chunks>'",
            )
            return
        chunks = max(int(tail), 1)
        offsets = {0}
        g_seen: Optional[int] = None
        for i, stage in stages:
            kind, _, _ = stage_kind(stage.primitive)
            if kind == "local":
                continue
            if kind != "collmm":
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    "unexpected primitive in a collective_matmul "
                    "schedule",
                )
                return
            levels = self._stage_levels(i, stage)
            if levels is None:
                return
            g = self._group_size(levels)
            if g_seen is None:
                g_seen = g
            elif g != g_seen:
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"direction stages ride hops of different sizes "
                    f"({g_seen} vs {g})",
                )
                return
            self._check_rounds_and_perm(i, stage, g)
            base = stage.primitive
            if base.endswith("-ring"):
                base = base[: -len("-ring")]
            _, r = _comp._rounds_tag(base)
            if r is None or r <= 0 or r % chunks:
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"round tag {r!r} is not a positive multiple of the "
                    f"chunk count ({chunks})",
                )
                return
            hops = r // chunks
            fwd = "_fwd" in stage.primitive
            for k in range(1, hops + 1):
                offsets.add((-k if fwd else k) % g)
            # Exact symbolic bytes: hops deliveries of the 1/g segment,
            # chunking is byte-invariant.
            self._check_bytes(i, stage, Fraction(nbytes * hops, g))
        if g_seen is None:
            if self.n > 1:
                self._flag_final(
                    "collective_matmul schedule moved nothing over "
                    f"{self.n} ranks",
                )
            return
        missing = sorted(set(range(g_seen)) - offsets)
        if missing:
            self._flag_final(
                f"chunked schedule leaves segment offsets {missing} "
                f"unreached (of {g_seen}) — each rank must see every "
                "chunk exactly once",
                missing_offsets=missing,
            )

    def _verify_broadcast(self, stages: Sequence[Tuple[int, Stage]],
                          nbytes: int) -> None:
        """Per rank: which of the root's L segments are held (L = inner
        size for scatter-allgather, else 1). Root is global rank 0 (the
        planning layer carries no root; lowering decomposes any)."""
        sa = self.plan.algorithm == "two-level-sa"
        L = self.sizes[-1] if sa and self.sizes else 1
        state: Dict[Coords, FrozenSet[int]] = {
            c: frozenset(range(L)) if _index(c, self.sizes) == 0
            else frozenset()
            for c in self.coords
        }
        inner_level = len(self.sizes) - 1
        for i, stage in stages:
            kind, variant, _ = stage_kind(stage.primitive)
            if kind == "local":
                continue
            if kind not in ("broadcast", "allgather"):
                self._flag(RULE_PLAN_STAGE, i, stage,
                           "unexpected primitive in a broadcast schedule")
                return
            levels = self._stage_levels(i, stage)
            if levels is None:
                return
            g = self._group_size(levels)
            self._check_rounds_and_perm(i, stage, g)
            k = max(1, math.ceil(math.log2(max(g, 2))))
            if kind == "broadcast":
                shard_stage = sa and inner_level not in levels
                for group in _groups(self.coords, levels):
                    donor = next(
                        c for c in group
                        if all(c[lvl] == 0 for lvl in levels)
                    )
                    moved = state[donor]
                    if shard_stage:
                        # Only the group's common inner-shard crosses the
                        # outer hop in scatter-allgather mode.
                        shard = group[0][inner_level]
                        moved = moved & frozenset([shard])
                    for c in group:
                        state[c] = state[c] | moved
                if shard_stage:
                    expected = Fraction(math.ceil(nbytes / L)) * k
                else:
                    expected = Fraction(nbytes) * k
            else:  # the reassembly allgather of two-level-sa
                for group in _groups(self.coords, levels):
                    union = frozenset().union(*(state[c] for c in group))
                    for c in group:
                        state[c] = union
                expected = Fraction(nbytes) * (g - 1) / g
            self._check_bytes(i, stage, expected)
        want = frozenset(range(L))
        for c in self.coords:
            if state[c] != want:
                r = _index(c, self.sizes)
                self._flag_final(
                    f"rank {r} never receives the full broadcast payload "
                    f"(holds {len(state[c])}/{L} shards) — a hole the "
                    f"lowered schedule would hang on",
                    rank=r, held=sorted(state[c]),
                )
                return

    def _verify_alltoall(self, stages: Sequence[Tuple[int, Stage]],
                         nbytes: int) -> None:
        """Per rank: the set of (source, destination) blocks held."""
        n = self.n
        state: Dict[Coords, FrozenSet[Tuple[int, int]]] = {
            c: frozenset(
                (_index(c, self.sizes), d) for d in range(n)
            )
            for c in self.coords
        }
        for i, stage in stages:
            kind, _, _ = stage_kind(stage.primitive)
            if kind == "local":
                continue
            if kind != "alltoall":
                self._flag(RULE_PLAN_STAGE, i, stage,
                           "unexpected primitive in an alltoall schedule")
                return
            levels = self._stage_levels(i, stage)
            if levels is None:
                return
            g = self._group_size(levels)
            self._check_rounds_and_perm(i, stage, g)
            new_state: Dict[Coords, set] = {c: set() for c in self.coords}
            for c in self.coords:
                for (s, d) in state[c]:
                    dd = _digits(d, self.sizes)
                    target = tuple(
                        dd[lvl] if lvl in levels else c[lvl]
                        for lvl in range(len(self.sizes))
                    )
                    new_state[target].add((s, d))
            counts = {c: len(v) for c, v in new_state.items()}
            if any(v != n for v in counts.values()):
                bad = next(c for c, v in counts.items() if v != n)
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"exchange loses or duplicates blocks: rank "
                    f"{_index(bad, self.sizes)} holds "
                    f"{counts[bad]}/{n} after the stage",
                )
                return
            state = {c: frozenset(v) for c, v in new_state.items()}
            self._check_bytes(
                i, stage, Fraction(nbytes) * (g - 1) / g if g else
                Fraction(0),
            )
        for c in self.coords:
            r = _index(c, self.sizes)
            want = frozenset((s, r) for s in range(n))
            if state[c] != want:
                got_src = sorted(s for s, d in state[c] if d == r)
                self._flag_final(
                    f"rank {r} ends with blocks from sources {got_src} "
                    f"(and {len(state[c]) - len(got_src)} misrouted "
                    f"blocks); alltoall must deliver one block from "
                    f"every source", rank=r,
                )
                return

    # ---------------------------------------------------------------- run
    def run(self) -> List[Finding]:
        plan = self.plan
        if tuple(self.sizes) != tuple(plan.hop_sizes):
            self.findings.append(Finding(
                rule=RULE_PLAN_STAGE,
                severity=SEVERITY_ERROR,
                message=(
                    f"plan was selected for hop sizes {plan.hop_sizes} "
                    f"but the model has {tuple(self.sizes)}"
                ),
                location=f"plan:{plan.collective}/{plan.algorithm}",
            ))
            return self.findings
        for i, stage in enumerate(plan.stages):
            kind, _, _ = stage_kind(stage.primitive)
            if kind == "?":
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"unknown stage primitive {stage.primitive!r}",
                )
                return self.findings
            wd = getattr(stage, "wire_dtype", WIRE_F32)
            if wd not in WIRE_DTYPES:
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"unknown stage wire_dtype {wd!r}; one of "
                    f"{WIRE_DTYPES}",
                )
                return self.findings
            if wd == WIRE_INT8 and plan.op not in ("SUM", "AVERAGE"):
                self._flag(
                    RULE_PLAN_STAGE, i, stage,
                    f"int8 wire on a {plan.op} schedule: per-hop "
                    f"requantization accumulates in f32, which is only "
                    f"sound for additive reductions",
                )
                return self.findings
        plan_wire = getattr(plan, "wire_dtype", WIRE_F32)
        if (
            plan_wire in (WIRE_INT8, WIRE_BF16)
            and plan.stages
            and not any(
                getattr(s, "wire_dtype", WIRE_F32) == plan_wire
                for s in plan.stages
                if s.hop != "-"
            )
        ):
            # A plan CLAIMING a reduced wire must actually carry it
            # somewhere — otherwise its advertised bytes-on-wire savings
            # are fiction.
            self._flag_final(
                f"plan declares wire_dtype={plan_wire} but no stage "
                f"carries the {plan_wire} wire — reduced-precision "
                "savings claimed without a converting stage",
            )
            return self.findings
        if self.n > 1 and not plan.stages:
            self._flag_final(
                f"empty schedule over {self.n} ranks cannot realize "
                f"{plan.collective}",
            )
            return self.findings
        if plan.algorithm == "split":
            if sum(plan.split_bytes) != plan.nbytes:
                self._flag_final(
                    f"split buckets {plan.split_bytes} do not sum to the "
                    f"payload ({plan.nbytes} bytes)",
                )
                return self.findings
            for b, nb in enumerate(plan.split_bytes):
                bucket = [
                    (i, s) for i, s in enumerate(plan.stages)
                    if stage_kind(s.primitive)[2] == b
                ]
                stray = [
                    i for i, s in enumerate(plan.stages)
                    if stage_kind(s.primitive)[2] is None
                ]
                if stray:
                    s = plan.stages[stray[0]]
                    self._flag(
                        RULE_PLAN_STAGE, stray[0], s,
                        "split schedule contains a stage with no bucket "
                        "suffix",
                    )
                    return self.findings
                self._verify_reduction(bucket, nb, "allreduce")
            return self.findings
        stages = list(enumerate(plan.stages))
        if plan.collective == "allreduce":
            self._verify_reduction(stages, plan.nbytes, "allreduce")
        elif plan.collective == "reducescatter":
            self._verify_reduction(stages, plan.nbytes, "reducescatter")
        elif plan.collective == "allgather":
            self._verify_allgather(stages, plan.nbytes)
        elif plan.collective == "broadcast":
            self._verify_broadcast(stages, plan.nbytes)
        elif plan.collective == "alltoall":
            self._verify_alltoall(stages, plan.nbytes)
        elif plan.collective == "collective_matmul":
            self._verify_collective_matmul(stages, plan.nbytes)
        else:
            self._flag_final(
                f"unknown collective {plan.collective!r}",
            )
        return self.findings


def verify_plan(
    plan: Plan,
    model: InterconnectModel,
    *,
    rounds_fn: Optional[Callable] = None,
    suppress: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Symbolically execute ``plan`` against ``model`` and return the
    rule violations ([] when the schedule provably realizes the
    collective). ``rounds_fn`` overrides the ring/halving round expander
    (tests inject corrupted schedules through it)."""
    checker = _PlanChecker(plan, model, rounds_fn=rounds_fn)
    return apply_suppressions(checker.run(), suppress)


def verify_plan_grid(
    models: Optional[Sequence[Tuple[str, InterconnectModel]]] = None,
    payloads: Sequence[int] = DEFAULT_PAYLOADS,
    ops: Sequence[ReduceOp] = DEFAULT_OPS,
    *,
    suppress: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], int]:
    """Verify every candidate plan ``select_plan`` can emit across the
    topology grid. Returns ``(findings, plans_verified)``; the count is
    reported by the CLI so a silently-shrunken grid is visible."""
    if models is None:
        models = [
            (name, synthetic_model(generation="v5e", **sizes))
            for name, sizes in DEFAULT_TOPOLOGIES
        ]
    findings: List[Finding] = []
    verified = 0
    for topo_name, model in models:
        for collective in _comp.COLLECTIVES:
            op_list = ops if collective == "allreduce" else (ReduceOp.SUM,)
            for op in op_list:
                # Quantized (int8+scales) candidates exist for allreduce
                # SUM/AVERAGE; the bf16 cast rung exists for EVERY
                # collective and op. Sweep them alongside the f32 grid
                # so a corrupted reduced-wire byte declaration is a lint
                # failure too.
                wire_dtypes: Tuple[str, ...] = (WIRE_F32, WIRE_BF16)
                if collective in ("allreduce", "reducescatter") and op in (
                    ReduceOp.SUM, ReduceOp.AVERAGE
                ):
                    # Reduce-scatter joined the int8 grid with streamed
                    # ZeRO-1 (the gradient hop of the RS+AG
                    # decomposition).
                    wire_dtypes = (WIRE_F32, WIRE_BF16, WIRE_INT8)
                for wire_dtype in wire_dtypes:
                    for nbytes in payloads:
                        cands = _comp.candidate_plans(
                            model, collective, nbytes, op=op,
                            wire_dtype=wire_dtype,
                        )
                        for plan in cands.values():
                            fs = verify_plan(plan, model,
                                             suppress=suppress)
                            for f in fs:
                                f.location = f"{topo_name}/{f.location}"
                                f.details.setdefault("topology", topo_name)
                                f.details.setdefault("op", str(op))
                                f.details.setdefault(
                                    "wire_dtype", wire_dtype
                                )
                            findings.extend(fs)
                            verified += 1
        # The fused-TP collective_matmul plan kind (innermost hop):
        # both flavors, f32 + bf16 wire, the chunk counts the tuner
        # searches.
        for flavor in _comp.COLLECTIVE_MATMUL_FLAVORS:
            for wire_dtype in (WIRE_F32, WIRE_BF16):
                for chunks in (1, 2, 4):
                    for nbytes in payloads:
                        plan = _comp.collective_matmul_plan(
                            model, flavor, nbytes, chunks=chunks,
                            wire_dtype=wire_dtype,
                        )
                        fs = verify_plan(plan, model, suppress=suppress)
                        for f in fs:
                            f.location = f"{topo_name}/{f.location}"
                            f.details.setdefault("topology", topo_name)
                            f.details.setdefault("wire_dtype", wire_dtype)
                        findings.extend(fs)
                        verified += 1
    return findings, verified


# --- streamed ZeRO-1: the implied per-bucket RS+AG plan grid -----------------


def zero1_bucket_plans(
    model: InterconnectModel,
    bucket_bytes: Sequence[int],
    *,
    quantized: bool = False,
    op: ReduceOp = ReduceOp.SUM,
) -> List[Tuple[Plan, Plan]]:
    """The compositor plans a streamed-zero1 build implies, per bucket:
    the gradient reduce-scatter (int8 wire when ``quantized``) and the
    parameter all-gather of the 1/N shard that returns after the
    shard-local update. These are the artifacts the symbolic checker
    verifies before a zero1 configuration ships (the same gate
    ``verify_plan_grid`` provides for the allreduce paths)."""
    from ..common.quant import WIRE_INT8 as _I8

    plans: List[Tuple[Plan, Plan]] = []
    n = max(model.size, 1)
    for nb in bucket_bytes:
        rs = _comp.select_plan(
            model, "reducescatter", int(nb), op=op,
            wire_dtype=_I8 if quantized else WIRE_F32,
        )
        shard = math.ceil(int(nb) / n)
        ag = _comp.select_plan(model, "allgather", shard)
        plans.append((rs, ag))
    return plans


def verify_zero1_stream_plans(
    model: InterconnectModel,
    bucket_bytes: Sequence[int],
    *,
    quantized: bool = False,
    op: ReduceOp = ReduceOp.SUM,
    suppress: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], int]:
    """Symbolically verify every per-bucket RS and AG plan a
    streamed-zero1 build implies on ``model``. Returns
    ``(findings, plans_verified)``."""
    findings: List[Finding] = []
    verified = 0
    for rs, ag in zero1_bucket_plans(
        model, bucket_bytes, quantized=quantized, op=op
    ):
        for plan in (rs, ag):
            fs = verify_plan(plan, model, suppress=suppress)
            for f in fs:
                f.location = f"zero1/{f.location}"
                f.details.setdefault("zero1", True)
            findings.extend(fs)
            verified += 1
    return findings, verified
