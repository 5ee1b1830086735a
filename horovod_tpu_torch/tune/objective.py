"""Free (no-hardware) objectives for the compiled-path tuner.

The port of ``horovod_tpu/tune/objective.py``, over the port's
``sim/``, ``topo/compositor.py`` and ``ops/fusion.plan_layer_groups``: the
same prices and the same bytes as the JAX package for the same spec and
model (``tests/test_torch_tune.py``).

Two cost models the repo already trusts, composed into one scalar score:

1. **Structural overlap** — the streamed path's group partition
   (``ops/fusion.plan_layer_groups``: the same DDP-style reverse-order
   packing ``stream_param_groups`` performs at trace time) gives the
   independent-AR-group count, and the overlappable-compute staircase:
   group ``i`` (reduction order) can hide its transfer behind the
   backward compute of every group still to come. This is the pure-
   python form of what ``tools/tpu_profile_overlap.py --structural``
   measures from HLO — the group partition IS the independent-collective
   structure the HLO analysis counts.
2. **Compositor pricing** — each group's packed payload is priced by the
   topology compositor's exact alpha-beta cost model
   (``topo.compositor.candidate_plans`` / ``select_plan``), honoring the
   pinned topology algorithm and wire dtype.

The scalar the GP maximizes is ``-exposed_us``: per group, the modeled
collective cost discounted by the fraction of backward compute available
to hide it (``cost_us_i * (1 - overlappable_i / total)``), summed. More
groups ⇒ earlier wire starts ⇒ more hiding; cheaper plans / int8 wire ⇒
less to hide. A measured step time (when a backend is reachable) can be
mixed in by the caller via ``measured_us`` — the free model stays the
inner loop either way (HiCCL's framing: the analytic model is the
trustworthy stand-in when hardware is scarce).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.quant import WIRE_F32, WIRE_INT8
from ..common.types import ReduceOp


@dataclass(frozen=True)
class TPTerm:
    """The composed DP x TP program's per-step tensor-parallel
    communication shape, declared so the tuner can price it PER CONFIG
    instead of taking a pre-computed constant: ``degree`` model-axis
    neighbours, ``psum_bytes`` activation payload per in-block psum,
    ``psums_per_step`` psums a step pays (forward AND backward
    conjugates), and ``compute_us`` — the matmul time adjacent to ONE
    psum, i.e. what the fused collective-matmul pair
    (docs/parallelism.md "Fused TP overlap") gets to hide its wire
    behind. ``tp_chunks == 0`` in a config prices the classic exposed
    psum (``sim.tp_fixed_comm_us``); ``tp_chunks >= 1`` prices the
    chunked ring pair via ``topo.compositor.collective_matmul_cost_us``.
    """

    degree: int
    psum_bytes: int
    psums_per_step: int = 1
    compute_us: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "degree": int(self.degree),
            "psum_bytes": int(self.psum_bytes),
            "psums_per_step": int(self.psums_per_step),
            "compute_us": round(float(self.compute_us), 4),
        }


def tp_inner_model(model, degree: int):
    """A single-hop model of the TP axis: the innermost (ICI) hop's
    alpha-beta constants over ``degree`` neighbours — the model the
    fused collective-matmul plans are priced and verified on (the DP
    model's inner hop size is the data-local fanout, not the TP
    degree, so the size must be re-pinned)."""
    import dataclasses as _dc

    hop = model.hops[-1]
    return _dc.replace(model, hops=(_dc.replace(hop, size=int(degree)),))


def tp_term_us(model, tp: TPTerm, chunks: int = 0) -> Dict:
    """Price the per-step TP term under one chunk-count choice.

    ``chunks == 0`` is the classic exposed-psum ring constant
    (``sim.tp_fixed_comm_us`` — fully exposed, nothing overlaps);
    ``chunks >= 1`` replaces each psum with one all_gather_matmul +
    one matmul_reduce_scatter, each priced by the overlap-aware model
    ``cost = max(compute, wire) + ramp`` with half the psum's adjacent
    matmul time to hide behind — only the un-hideable remainder is
    charged. Returns ``{"mode", "chunks", "fixed_comm_us", ...}``."""
    n = int(tp.degree)
    if n <= 1 or int(tp.psum_bytes) <= 0 or int(tp.psums_per_step) <= 0:
        return {"mode": "none", "chunks": 0, "fixed_comm_us": 0.0}
    if int(chunks) <= 0:
        from ..sim.core import tp_fixed_comm_us

        return {
            "mode": "exposed-psum",
            "chunks": 0,
            "fixed_comm_us": tp_fixed_comm_us(
                model, int(tp.psum_bytes), n,
                psums_per_step=int(tp.psums_per_step),
            ),
        }
    from ..topo.compositor import collective_matmul_cost_us

    priced = collective_matmul_cost_us(
        tp_inner_model(model, n), int(tp.psum_bytes),
        chunks=int(chunks), compute_us=float(tp.compute_us) / 2.0,
    )
    fixed = round(
        2.0 * priced["exposed_us"] * int(tp.psums_per_step), 4
    )
    return {
        "mode": "collective_matmul",
        "chunks": int(chunks),
        "fixed_comm_us": fixed,
        "per_primitive": priced,
    }


@dataclass(frozen=True)
class ProgramSpec:
    """The abstract training program the tuner scores: top-level layer
    granularity (name, gradient bytes) in FORWARD order — exactly the
    granularity ``stream_param_groups`` partitions at."""

    name: str
    layers: Tuple[Tuple[str, int], ...]
    signature: Dict = field(default_factory=dict)

    @property
    def layer_bytes(self) -> List[int]:
        return [int(b) for _, b in self.layers]

    @property
    def total_bytes(self) -> int:
        return sum(self.layer_bytes)


def _bottleneck_hop(model):
    return min(model.hops, key=lambda h: h.bandwidth_gbps)


def calibrated_model(model, calibration, where: str = "tune"):
    """Resolve a ``calibration`` argument (Calibration / path / dict /
    None = ``HOROVOD_CALIBRATION_FILE``) and apply it to ``model`` with
    the hop-ladder staleness discipline (``sim/calibrate.py``: a stale
    signature warns loudly and keeps generation defaults). Returns
    ``(model, info)`` where ``info`` records what was applied — the
    provenance block ``tuned.json`` carries so a tuning pinned on
    measured constants says so."""
    from ..sim.calibrate import apply_calibration, resolve_calibration

    calib = resolve_calibration(calibration)
    if calib is None:
        return model, {"applied": False, "source": "generation-defaults"}
    patched = apply_calibration(model, calib, where=where)
    return patched, {
        "applied": patched is not model,
        "source": "calibration.json",
        "signature": calib.signature_hash,
        "stale": patched is model,
    }


def plan_for_bucket(model, nbytes: int, config: Dict,
                    op: ReduceOp = ReduceOp.AVERAGE,
                    collective: str = "allreduce"):
    """The plan a bucket of ``nbytes`` would lower with under
    ``config``: the pinned algorithm when the compositor offers it at
    this payload, else the cost-selected plan (the same fallback the
    lowering performs). Returns ``(plan, pinned_honored)``.
    ``collective`` defaults to the allreduce fast path; the zero1
    objective prices ``"reducescatter"`` (int8/bf16-eligible) and
    ``"allgather"`` (always full precision — parameters). The bf16
    rung is a pure cast, valid for any reduce op; int8's blockwise
    requantization needs SUM/AVERAGE."""
    from ..topo.compositor import candidate_plans, select_plan

    wire = config.get("wire_dtype", WIRE_F32)
    if collective == "allgather":
        wire = WIRE_F32
    elif (
        wire == WIRE_INT8
        and op not in (ReduceOp.SUM, ReduceOp.AVERAGE)
    ):
        wire = WIRE_F32
    algo = config.get("topo_algorithm") or "auto"
    if algo != "auto":
        cands = candidate_plans(model, collective, nbytes, op=op,
                                wire_dtype=wire)
        if algo in cands:
            return cands[algo], True
    return select_plan(model, collective, nbytes, op=op,
                       wire_dtype=wire), algo == "auto"


def free_objectives(spec: ProgramSpec, config: Dict, model,
                    op: ReduceOp = ReduceOp.AVERAGE,
                    zero1: bool = False,
                    calibration=None,
                    fixed_comm_us: float = 0.0,
                    tp: Optional[TPTerm] = None) -> Dict:
    """Score ``config`` on ``spec`` over ``model`` with the two free
    cost models. Returns a plain dict (stable key order for the
    tuned.json record) whose ``score`` the GP maximizes.

    ``zero1=True`` prices the streamed-ZeRO-1 reduction shape: each
    group lowers as reduce-scatter (int8-eligible, hidden behind the
    backward staircase like the allreduce) plus the parameter
    all-gather of the 1/N shard (full precision — parameters; priced
    fully exposed, a conservative stand-in for next-forward overlap).
    This is what lets ``tuned.json`` stop exempting the zero1 mode.

    ``calibration`` (a ``calibration.json`` path, a
    ``sim.calibrate.Calibration``, or None = the
    ``HOROVOD_CALIBRATION_FILE`` knob) prices hops with MEASURED
    alpha-beta constants instead of generation defaults — the FlexLink
    discipline applied to the tuner's objective. A stale hop-ladder
    signature falls back loudly (``calibration.stale`` in the output).

    ``fixed_comm_us`` is a caller-computed constant per-step
    communication term OUTSIDE the DP staircase; it shifts every
    config's cost/exposed time identically (knob-invariant). ``tp``
    (a :class:`TPTerm`) REPLACES that constant with a term priced per
    config from the config's own ``tp_chunks`` choice
    (:func:`tp_term_us`) — the fused collective-matmul path makes the
    TP term knob-DEPENDENT, so the argmax now weighs chunk count
    against the DP knobs. The two are mutually exclusive."""
    import math as _math

    from ..ops.fusion import plan_layer_groups

    if tp is not None and float(fixed_comm_us) > 0.0:
        raise ValueError(
            "pass either tp=TPTerm(...) (the TP term priced per config "
            "from its tp_chunks choice) or the legacy knob-invariant "
            "fixed_comm_us constant — not both"
        )
    calib_info = None
    if calibration is not None:
        model, calib_info = calibrated_model(
            model, calibration, where="free_objectives"
        )
    layer_bytes = spec.layer_bytes
    total = max(spec.total_bytes, 1)
    groups = plan_layer_groups(
        layer_bytes,
        int(config["fusion_threshold_bytes"]),
        int(config["first_bucket_bytes"]),
    )
    bneck = _bottleneck_hop(model).name
    per_group: List[Dict] = []
    cost_us = 0.0
    exposed_us = 0.0
    wire_bytes = 0
    remaining = total
    pinned_honored = True
    for gi, group in enumerate(groups):
        nb = sum(layer_bytes[i] for i in group)
        remaining -= nb
        if zero1:
            plan, honored = plan_for_bucket(
                model, nb, config, op=op, collective="reducescatter"
            )
            shard = _math.ceil(nb / max(model.size, 1))
            ag_plan, _ = plan_for_bucket(
                model, shard, config, op=op, collective="allgather"
            )
        else:
            plan, honored = plan_for_bucket(model, nb, config, op=op)
            ag_plan = None
        pinned_honored = pinned_honored and honored
        overlappable = remaining / total
        g_exposed = plan.cost_us * (1.0 - overlappable)
        g_wire = int(plan.bytes_per_hop.get(bneck, 0))
        g_cost = plan.cost_us
        if ag_plan is not None:
            g_cost += ag_plan.cost_us
            g_exposed += ag_plan.cost_us  # AG: conservatively exposed
            g_wire += int(ag_plan.bytes_per_hop.get(bneck, 0))
        cost_us += g_cost
        exposed_us += g_exposed
        wire_bytes += g_wire
        entry = {
            "group": gi,
            "layers": [spec.layers[i][0] for i in group],
            "nbytes": nb,
            "algorithm": plan.algorithm,
            "wire_dtype": plan.wire_dtype,
            "cost_us": round(plan.cost_us, 4),
            "overlappable_fraction": round(overlappable, 6),
            "bottleneck_bytes": g_wire,
        }
        if ag_plan is not None:
            entry["ag_algorithm"] = ag_plan.algorithm
            entry["ag_cost_us"] = round(ag_plan.cost_us, 4)
        per_group.append(entry)
    tp_info = None
    if tp is not None:
        tp_info = tp_term_us(model, tp, int(config.get("tp_chunks", 0)))
        fixed = float(tp_info["fixed_comm_us"])
    else:
        fixed = max(float(fixed_comm_us), 0.0)
    cost_us += fixed
    exposed_us += fixed
    if zero1:
        return {
            "zero1": True,
            **({"calibration": calib_info} if calib_info else {}),
            **({"tp": tp_info} if tp_info is not None else {}),
            **({"fixed_comm_us": round(fixed, 4)} if fixed else {}),
            "n_groups": len(groups),
            "cost_us": round(cost_us, 4),
            "exposed_us": round(exposed_us, 4),
            "wire_bytes": int(wire_bytes),
            "bottleneck_hop": bneck,
            "pinned_honored": pinned_honored,
            "per_group": per_group,
            "score": round(-exposed_us, 6),
        }
    return {
        **({"calibration": calib_info} if calib_info else {}),
        **({"tp": tp_info} if tp_info is not None else {}),
        **({"fixed_comm_us": round(fixed, 4)} if fixed else {}),
        "n_groups": len(groups),
        "cost_us": round(cost_us, 4),
        "exposed_us": round(exposed_us, 4),
        "wire_bytes": int(wire_bytes),
        "bottleneck_hop": bneck,
        "pinned_honored": pinned_honored,
        "per_group": per_group,
        # The GP maximizes this: hide-adjusted modeled communication
        # time, negated. Rounded so the score (and therefore the whole
        # sample trace) serializes byte-identically.
        "score": round(-exposed_us, 6),
    }


def group_plans(spec: ProgramSpec, config: Dict, model,
                op: ReduceOp = ReduceOp.AVERAGE,
                zero1: bool = False,
                calibration=None) -> List:
    """The concrete compositor plans ``config`` pins for every stream
    group — the artifacts the symbolic verifier checks before the tuner
    is allowed to emit them. ``zero1=True`` yields the RS and AG plan
    for each group (interleaved, reduction order). ``calibration``
    follows :func:`free_objectives` (calibrated constants can flip a
    cost-selected algorithm, so the verified plans must come from the
    same model the objective priced). The TP term's fused plans are
    listed separately (:func:`tp_group_plans`) — they verify on the
    TP-axis model, not this one."""
    import math as _math

    from ..ops.fusion import plan_layer_groups

    if calibration is not None:
        model, _ = calibrated_model(
            model, calibration, where="group_plans"
        )
    layer_bytes = spec.layer_bytes
    groups = plan_layer_groups(
        layer_bytes,
        int(config["fusion_threshold_bytes"]),
        int(config["first_bucket_bytes"]),
    )
    plans = []
    for group in groups:
        nb = sum(layer_bytes[i] for i in group)
        if zero1:
            rs, _ = plan_for_bucket(
                model, nb, config, op=op, collective="reducescatter"
            )
            ag, _ = plan_for_bucket(
                model, _math.ceil(nb / max(model.size, 1)), config,
                op=op, collective="allgather",
            )
            plans.extend([rs, ag])
        else:
            plan, _ = plan_for_bucket(model, nb, config, op=op)
            plans.append(plan)
    return plans


def tp_group_plans(config: Dict, model, tp: Optional[TPTerm]) -> Tuple:
    """The fused TP plans a config pins, with the model they verify on:
    ``(plans, tp_model)``. Empty when there is no TP term or the config
    keeps the classic exposed psum (``tp_chunks == 0`` — nothing fused,
    nothing new to verify; the psum is the long-standing flat ring).
    Both chunked flavors are listed — a step pays one all_gather_matmul
    AND one matmul_reduce_scatter per psum it replaces."""
    chunks = int(config.get("tp_chunks", 0))
    if tp is None or chunks <= 0 or int(tp.degree) <= 1:
        return (), None
    from ..topo.compositor import (
        COLLECTIVE_MATMUL_FLAVORS,
        collective_matmul_plan,
    )

    inner = tp_inner_model(model, int(tp.degree))
    plans = tuple(
        collective_matmul_plan(
            inner, flavor, int(tp.psum_bytes), chunks=chunks,
            compute_us=float(tp.compute_us) / 2.0,
        )
        for flavor in COLLECTIVE_MATMUL_FLAVORS
    )
    return plans, inner
