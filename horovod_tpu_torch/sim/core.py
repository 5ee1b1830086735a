"""Deterministic discrete-event simulation of a distributed training step.

The port of ``horovod_tpu/sim/core.py`` (the JAX package's
``docs/simulation.md`` has the full assumptions list). The model:

- One SPMD step = forward → backward (stream-group segments in reduction
  order) → optimizer. Backward segment ``g`` produces group ``g``'s
  cotangents; its collective becomes *ready* on a rank when that rank
  finishes segments ``0..g``.
- A collective starts when EVERY rank is ready (collectives synchronize)
  and its plan's stages then occupy their hops in schedule order; each
  hop is a serially shared resource (one stage in flight per hop), which
  is what makes a deep stream pipeline back-pressure instead of
  overlapping for free.
- Stage cost is the compositor's own alpha-beta pricing
  (``latency_us * rounds + bytes_on_wire / (bandwidth_gbps * 1e3)``)
  over the — optionally calibrated — interconnect model, so the
  simulator and the planner can never disagree about what a plan costs.
- Seeded ``delay`` faults (``fault/plan.py``, site ``step``) stretch the
  faulted rank's first backward segment of the step — including the
  chronic-slowness shape (``every``/``until``: a persistent or periodic
  straggler); every draw comes from the plan's pure per-(seed, action,
  rank) decision streams, so a simulated incident is byte-reproducible.

Time is simulated microseconds from 0 — no wall clock, no randomness
outside the fault plan — and reports round every float, so a fixed seed
gives byte-identical output across runs, and the same bytes as the JAX
package's simulator for the same inputs (``tests/test_torch_sim.py``).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.types import ReduceOp
from ..fault.plan import FaultPlan
from ..topo.compositor import Plan, candidate_plans, select_plan
from ..topo.model import InterconnectModel

logger = logging.getLogger("horovod_tpu_torch.sim")

SIM_SCHEMA = 1

# Default compute-intensity assumption: microseconds of backward compute
# per MiB of parameter-gradient bytes. Dense layers do ~2 matmul passes
# per parameter in the backward, so compute scales with parameter bytes;
# the absolute constant only shifts the compute/comm balance and is
# overridden by calibration or --compute-us-per-mib. Chosen so a ~1 MiB
# bucket costs about as much compute as a generic-ICI transfer.
DEFAULT_COMPUTE_US_PER_MIB = 120.0

_MIB = float(1 << 20)


@dataclass(frozen=True)
class SimGroup:
    """One stream group, reduction order: ``nbytes`` of gradient payload
    whose producing backward segment takes ``compute_us`` per rank."""

    name: str
    nbytes: int
    compute_us: float

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "nbytes": int(self.nbytes),
            "compute_us": round(float(self.compute_us), 4),
        }


@dataclass(frozen=True)
class SimProgram:
    """The abstract training program a fleet executes: stream groups in
    REDUCTION order (the ``plan_layer_groups`` partition) plus the
    forward and optimizer phases that bracket the backward."""

    name: str
    groups: Tuple[SimGroup, ...]
    forward_us: float = 0.0
    optimizer_us: float = 0.0
    source: str = "layers"
    # Fixed per-step SYNCHRONOUS communication outside the DP staircase
    # — the composed DP x TP program's in-block psums, priced on the
    # innermost (ICI) hop (:func:`tp_fixed_comm_us`). Counts as exposed
    # communication (never as compute), so scaling efficiency stays
    # honest for the composed shape.
    fixed_comm_us: float = 0.0

    @property
    def total_bytes(self) -> int:
        return sum(g.nbytes for g in self.groups)

    @property
    def compute_us(self) -> float:
        """Per-rank compute of one step with communication free — the
        denominator of scaling efficiency."""
        return (
            self.forward_us
            + sum(g.compute_us for g in self.groups)
            + self.optimizer_us
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "source": self.source,
            "forward_us": round(float(self.forward_us), 4),
            "optimizer_us": round(float(self.optimizer_us), 4),
            "fixed_comm_us": round(float(self.fixed_comm_us), 4),
            "total_bytes": int(self.total_bytes),
            "groups": [g.to_dict() for g in self.groups],
        }


@dataclass(frozen=True)
class SimConfig:
    """Lowering knobs, mirroring the tuner's joint space: pinned topo
    algorithm (or ``"auto"`` = per-payload cost selection), wire dtype,
    ZeRO-1 reduction shape, and whether reduction streams inside the
    backward (``overlap=False`` = the post-hoc whole-tree path)."""

    algorithm: str = "auto"
    wire_dtype: str = "f32"
    zero1: bool = False
    overlap: bool = True
    op: ReduceOp = ReduceOp.AVERAGE

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "wire_dtype": self.wire_dtype,
            "zero1": bool(self.zero1),
            "overlap": bool(self.overlap),
            "op": self.op.name,
        }


def program_from_layers(
    name: str,
    layer_bytes: Sequence[int],
    *,
    fusion_threshold_bytes: int = 64 << 20,
    first_bucket_bytes: int = 1 << 20,
    compute_us_per_mib: float = DEFAULT_COMPUTE_US_PER_MIB,
    forward_fraction: float = 0.5,
    optimizer_us_per_mib: float = 4.0,
    source: str = "layers",
    fixed_comm_us: float = 0.0,
) -> SimProgram:
    """Build the program from per-layer gradient bytes (forward order)
    using the EXACT ``plan_layer_groups`` partition the streamed path
    registers and the tuner prices. Backward compute is apportioned to
    groups proportionally to their parameter bytes (dense-layer FLOPs
    scale with parameter count); the forward costs ``forward_fraction``
    of the backward (fwd ≈ half the training FLOPs of bwd)."""
    from ..ops.fusion import plan_layer_groups

    layer_bytes = [int(b) for b in layer_bytes]
    groups = plan_layer_groups(
        layer_bytes, int(fusion_threshold_bytes), int(first_bucket_bytes)
    )
    sim_groups: List[SimGroup] = []
    for gi, group in enumerate(groups):
        nb = sum(layer_bytes[i] for i in group)
        sim_groups.append(SimGroup(
            name=f"g{gi}",
            nbytes=nb,
            compute_us=(nb / _MIB) * float(compute_us_per_mib),
        ))
    total = sum(g.nbytes for g in sim_groups)
    backward_us = sum(g.compute_us for g in sim_groups)
    return SimProgram(
        name=name,
        groups=tuple(sim_groups),
        forward_us=backward_us * float(forward_fraction),
        optimizer_us=(total / _MIB) * float(optimizer_us_per_mib),
        source=source,
        fixed_comm_us=float(fixed_comm_us),
    )


def tp_fixed_comm_us(
    model: "InterconnectModel",
    psum_bytes: int,
    tp_degree: int,
    psums_per_step: int = 1,
    *,
    overlap: bool = False,
    chunks: int = 1,
    compute_us_per_psum: float = 0.0,
) -> float:
    """Price the composed program's per-step tensor-parallel term: the
    in-block activation psums ride the INNERMOST (fastest, ICI) hop as
    plain ring allreduces over ``tp_degree`` neighbours — never
    bucketized, never re-planned onto DCN. The
    returned microseconds feed ``SimProgram.fixed_comm_us`` (and
    ``tune(fixed_comm_us=...)``) as a constant every step pays, so the
    simulator's scale predictions and the tuner's knob costs stay honest
    for the composed shape. ``psums_per_step`` counts forward AND
    backward conjugates (2 per Megatron half-block per direction).

    ``overlap=True`` prices the fused collective-matmul path instead
    (the fused collective-matmul path): each psum becomes one
    all_gather_matmul + one matmul_reduce_scatter, ``chunks`` ring
    chunks each, hiding their wire behind ``compute_us_per_psum`` (the
    psum's adjacent matmul time, split across the pair) — only the
    un-hideable remainder (``topo.compositor.collective_matmul_cost_us``:
    ``max(compute, wire) + ramp - compute``) is charged."""
    tp = int(tp_degree)
    if tp <= 1 or psum_bytes <= 0 or psums_per_step <= 0:
        return 0.0
    hop = model.hops[-1]
    if overlap:
        import dataclasses as _dc

        from ..topo.compositor import collective_matmul_cost_us

        inner = _dc.replace(model, hops=(_dc.replace(hop, size=tp),))
        priced = collective_matmul_cost_us(
            inner, int(psum_bytes), chunks=max(int(chunks), 1),
            compute_us=float(compute_us_per_psum) / 2.0,
        )
        return round(
            float(psums_per_step) * 2.0 * priced["exposed_us"], 4
        )
    rounds = 2 * (tp - 1)
    onwire = 2 * (tp - 1) * int(psum_bytes) / tp
    one = hop.latency_us * rounds + onwire / (hop.bandwidth_gbps * 1e3)
    return round(float(psums_per_step) * one, 4)


def program_from_spec(
    spec, config: Optional[Dict] = None, **kw
) -> SimProgram:
    """Program from a tuner ``ProgramSpec`` (anything with ``name`` and
    ``layer_bytes``) —
    same layer granularity, same partition knobs (``config`` may carry
    ``fusion_threshold_bytes`` / ``first_bucket_bytes``)."""
    config = config or {}
    if "fusion_threshold_bytes" in config:
        kw.setdefault(
            "fusion_threshold_bytes", int(config["fusion_threshold_bytes"])
        )
    if "first_bucket_bytes" in config:
        kw.setdefault(
            "first_bucket_bytes", int(config["first_bucket_bytes"])
        )
    kw.setdefault("source", "program-spec")
    return program_from_layers(spec.name, spec.layer_bytes, **kw)


# --------------------------------------------------------------- faults


_SUPPORTED_FAULT_KINDS = ("delay",)


def _delay_matrix(
    plan: Optional[FaultPlan], ranks: int, steps: int
) -> Dict[int, List[float]]:
    """Per-rank per-step delay (us) a seeded fault plan injects,
    computed from the plan's PURE decision traces (independent of call
    order, like ``canonical_schedule``). Only ``delay`` actions
    simulate; other kinds are outside the model and are skipped with a
    loud note — a silently half-applied chaos plan would make the twin
    dishonest. Both the single-shot (``at_step``/``after``+``count``)
    and the chronic-slowness (``every``/``until``) shapes are honored:
    the window test and the decision-stream advance go through the same
    ``FaultAction.in_window`` the injector uses, so a recurring
    straggler stretches exactly the steps the live injector would."""
    delays: Dict[int, List[float]] = {}
    if plan is None:
        return delays
    skipped = sorted({
        a.kind for a in plan.actions if a.kind not in _SUPPORTED_FAULT_KINDS
    })
    if skipped:
        logger.warning(
            "fleet sim: fault plan carries unsupported kind(s) %s — only "
            "%s simulate; the skipped actions do NOT shape this "
            "prediction", skipped, list(_SUPPORTED_FAULT_KINDS),
        )
    for action in plan.actions:
        if action.kind not in _SUPPORTED_FAULT_KINDS:
            continue
        targets = (
            [action.rank] if action.rank is not None else list(range(ranks))
        )
        for r in targets:
            if r >= ranks or not action.matches_process(r, None, None):
                continue
            trace = plan.decision_trace(action, r, steps)
            row = delays.setdefault(r, [0.0] * steps)
            hit_draws = 0
            for s in range(steps):
                # Site hit counters are 1-based (step K = K-th hit);
                # the decision stream advances one draw per IN-WINDOW
                # hit, exactly as the injector consumes it.
                if action.in_window(s + 1):
                    if trace[hit_draws]:
                        row[s] += float(action.seconds) * 1e6
                    hit_draws += 1
    return delays


# ------------------------------------------------------------ the DES


def _group_plans(
    model: InterconnectModel, program: SimProgram, config: SimConfig
) -> List[Tuple[Plan, Optional[Plan]]]:
    """The (reduction plan, optional zero1 all-gather plan) per group —
    pinned algorithm when the compositor offers it at that payload, else
    cost-selected: the same fallback the lowering and the tuner's
    ``plan_for_bucket`` perform."""
    import math

    out: List[Tuple[Plan, Optional[Plan]]] = []
    collective = "reducescatter" if config.zero1 else "allreduce"
    for g in program.groups:
        wire = config.wire_dtype
        cands = candidate_plans(
            model, collective, g.nbytes, op=config.op, wire_dtype=wire
        )
        if config.algorithm != "auto" and config.algorithm in cands:
            plan = cands[config.algorithm]
        else:
            plan = select_plan(
                model, collective, g.nbytes, op=config.op, wire_dtype=wire
            )
        ag = None
        if config.zero1:
            shard = math.ceil(g.nbytes / max(model.size, 1))
            ag = select_plan(model, "allgather", shard, op=config.op)
        out.append((plan, ag))
    return out


@dataclass
class _StageSpan:
    group: int
    primitive: str
    hop: str
    axis: str
    nbytes: int
    rounds: int
    wire_dtype: str
    t0: float
    t1: float


@dataclass
class SimResult:
    """One simulated run: the numbers (stable, rounded) plus enough
    span structure to render Perfetto lanes and feed the replay
    divergence report."""

    ranks: int
    steps: int
    model: InterconnectModel
    program: SimProgram
    config: SimConfig
    seed: int
    step_spans: Dict[int, List[Tuple[int, float, float]]]  # rank -> [(i, t0us, t1us)]
    compute_spans: Dict[int, List[Tuple[str, float, float]]]
    stage_spans: List[_StageSpan] = field(default_factory=list)
    fault_instants: Dict[int, List[Tuple[int, float, float]]] = field(
        default_factory=dict
    )  # rank -> [(step, t_us, delay_us)]
    plans: List[Tuple[Plan, Optional[Plan]]] = field(default_factory=list)
    # Lowest unfaulted rank — the lane every untracked rank mirrors.
    base_rank: int = 0

    # ------------------------------------------------------- aggregates
    @property
    def step_times_us(self) -> List[float]:
        spans = self.step_spans[self.base_rank]
        return [t1 - t0 for _, t0, t1 in spans]

    @property
    def mean_step_us(self) -> float:
        ts = self.step_times_us
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def ideal_step_us(self) -> float:
        return self.program.compute_us

    @property
    def scaling_efficiency(self) -> float:
        """Fraction of the step spent on work that would remain at one
        rank: ``ideal / simulated`` — 1.0 means every wire byte hid
        behind compute."""
        step = self.mean_step_us
        return (self.ideal_step_us / step) if step > 0 else 1.0

    @property
    def exposed_comm_us(self) -> float:
        return max(self.mean_step_us - self.ideal_step_us, 0.0)

    def per_hop_busy_us(self) -> Dict[str, float]:
        """Mean per-step busy time of each hop — the wire-side truth the
        replay divergence compares against measurements."""
        busy: Dict[str, float] = {}
        for s in self.stage_spans:
            if s.hop == "-":
                continue
            busy[s.hop] = busy.get(s.hop, 0.0) + (s.t1 - s.t0)
        return {
            h: v / max(self.steps, 1) for h, v in sorted(busy.items())
        }

    def to_report(self) -> dict:
        """The stable (byte-identical for a fixed seed) summary block
        for one rank count."""
        first_plans = [
            {
                "group": gi,
                "collective": p.collective,
                "algorithm": p.algorithm,
                "wire_dtype": p.wire_dtype,
                "nbytes": int(p.nbytes),
                "cost_us": round(p.cost_us, 4),
                "bytes_per_hop": {
                    k: int(v) for k, v in sorted(p.bytes_per_hop.items())
                },
                **({
                    "ag_algorithm": ag.algorithm,
                    "ag_cost_us": round(ag.cost_us, 4),
                } if ag is not None else {}),
            }
            for gi, (p, ag) in enumerate(self.plans)
        ]
        return {
            "ranks": int(self.ranks),
            "hops": [[h.name, int(h.size)] for h in self.model.hops],
            "steps": int(self.steps),
            "seed": int(self.seed),
            "step_time_us": round(self.mean_step_us, 4),
            "ideal_step_us": round(self.ideal_step_us, 4),
            "exposed_comm_us": round(self.exposed_comm_us, 4),
            "scaling_efficiency": round(self.scaling_efficiency, 6),
            "per_hop_busy_us": {
                k: round(v, 4) for k, v in self.per_hop_busy_us().items()
            },
            "per_group": first_plans,
        }

    # ------------------------------------------------------ trace lanes
    def windows(self, max_ranks: int = 64) -> Dict[int, dict]:
        """Per-rank windows in the ``TraceTap.window()`` shape, so
        ``trace/merge.py`` renders a simulated fleet exactly like a real
        one. Lanes beyond ``max_ranks`` are dropped with a note (a
        4096-lane Perfetto file helps nobody); stage-level comm spans
        ride rank 0's lane (the schedule is global)."""
        n = min(self.ranks, max(int(max_ranks), 1))
        if n < self.ranks:
            logger.info(
                "fleet sim: rendering %d of %d simulated lanes "
                "(raise --trace-ranks to widen)", n, self.ranks,
            )
        out: Dict[int, dict] = {}
        base = self.compute_spans[self.base_rank]
        base_steps = self.step_spans[self.base_rank]
        for r in range(n):
            events: List[dict] = []
            for name, t0, t1 in self.compute_spans.get(r, base):
                events.append({
                    "name": name, "ph": "X", "ts": t0 / 1e6,
                    "dur": (t1 - t0) / 1e6, "cat": "phase", "tid": 0,
                })
            for step, t, d_us in self.fault_instants.get(r, []):
                events.append({
                    "name": "fault:delay", "ph": "i", "ts": t / 1e6,
                    "cat": "fault", "tid": 0,
                    "args": {"step": step, "delay_us": round(d_us, 4)},
                })
            if r == 0:
                for s in self.stage_spans:
                    if s.hop == "-":
                        continue
                    events.append({
                        "name": f"hvd_collective_stage:{s.primitive}",
                        "ph": "X", "ts": s.t0 / 1e6,
                        "dur": (s.t1 - s.t0) / 1e6, "cat": "op", "tid": 1,
                        "args": {
                            "group": s.group, "hop": s.hop,
                            "axis": s.axis, "nbytes": int(s.nbytes),
                            "rounds": int(s.rounds),
                            "wire_dtype": s.wire_dtype,
                        },
                    })
            steps = [
                [i, t0 / 1e6, t1 / 1e6]
                for i, t0, t1 in self.step_spans.get(r, base_steps)
            ]
            out[r] = {
                "schema": 1,
                "rank": r,
                "clock": {
                    "offset_s": 0.0, "rtt_s": 0.0, "estimated": False,
                    "simulated": True,
                },
                "plan": {
                    "topo_algorithm": self.config.algorithm,
                    "wire_dtype": self.config.wire_dtype,
                    "zero1": self.config.zero1,
                    "simulated": True,
                },
                "events": events,
                "steps": steps,
            }
        return out

    def driver_window(self) -> dict:
        """The simulated driver lane: plan instants mirroring what
        ``record_plan`` notes on a live fleet."""
        events = [{
            "name": "hvd_sim_run", "ph": "i", "ts": 0.0, "cat": "driver",
            "args": {
                "ranks": self.ranks, "steps": self.steps,
                "seed": self.seed, **self.config.to_dict(),
            },
        }]
        for gi, (p, ag) in enumerate(self.plans):
            events.append({
                "name": "hvd_sim_plan", "ph": "i", "ts": 0.0,
                "cat": "driver",
                "args": {
                    "group": gi, "collective": p.collective,
                    "algorithm": p.algorithm, "wire_dtype": p.wire_dtype,
                    "nbytes": int(p.nbytes),
                    **({"ag_algorithm": ag.algorithm} if ag else {}),
                },
            })
        return {
            "schema": 1, "rank": -1,
            "clock": {"offset_s": 0.0, "rtt_s": 0.0, "estimated": False},
            "plan": {}, "events": events, "steps": [],
        }


def simulate(
    model: InterconnectModel,
    program: SimProgram,
    config: Optional[SimConfig] = None,
    *,
    steps: int = 4,
    fault_plan: Optional[FaultPlan] = None,
    seed: int = 0,
) -> SimResult:
    """Run the discrete-event simulation. ``seed`` only labels the run
    when no fault plan is given (the fault plan carries its own seed);
    everything else is a pure function of the inputs."""
    config = config or SimConfig()
    steps = max(int(steps), 1)
    n = model.size
    plans = _group_plans(model, program, config)
    delays = _delay_matrix(fault_plan, n, steps)
    faulted = sorted(delays)
    # The representative unfaulted lane (SPMD compute is homogeneous, so
    # one lane stands in for every rank the fault plan never touches).
    base_rank = next(
        (r for r in range(n) if r not in delays), 0
    )

    hop_free: Dict[str, float] = {h.name: 0.0 for h in model.hops}
    by_hop = {h.name: h for h in model.hops}

    step_spans: Dict[int, List[Tuple[int, float, float]]] = {}
    compute_spans: Dict[int, List[Tuple[str, float, float]]] = {}
    fault_instants: Dict[int, List[Tuple[int, float, float]]] = {}
    for r in sorted({base_rank, *faulted}):
        step_spans.setdefault(r, [])
        compute_spans.setdefault(r, [])
    stage_spans: List[_StageSpan] = []

    def stage_cost(stage) -> float:
        if stage.hop == "-":
            return 0.0
        hop = by_hop[stage.hop]
        return (
            hop.latency_us * stage.rounds
            + stage.bytes_on_wire / (hop.bandwidth_gbps * 1e3)
        )

    # Per-tracked-rank current clock: the base lane plus every faulted
    # rank (all other ranks mirror the base lane exactly).
    tracked = sorted({base_rank, *faulted})
    clock = {r: 0.0 for r in tracked}

    for s in range(steps):
        t_begin = {r: clock[r] for r in tracked}
        # Forward (+ the composed program's fixed TP-psum term: ICI
        # time every rank spends synchronously, outside the staircase).
        for r in tracked:
            t0 = clock[r]
            clock[r] = t0 + program.forward_us
            compute_spans[r].append((f"sim_forward:{s}", t0, clock[r]))
        if program.fixed_comm_us > 0.0:
            for r in tracked:
                t0 = clock[r]
                clock[r] = t0 + program.fixed_comm_us
                compute_spans[r].append((f"sim_tp_comm:{s}", t0, clock[r]))
        # Backward segments; a step's injected delay stretches the
        # FIRST segment (the straggler model: the rank falls behind as
        # the backward starts).
        ready: Dict[int, Dict[int, float]] = {}  # group -> rank -> t
        for gi, g in enumerate(program.groups):
            ready[gi] = {}
            for r in tracked:
                extra = 0.0
                if gi == 0 and delays.get(r):
                    extra = delays[r][s]
                    if extra > 0.0:
                        fault_instants.setdefault(r, []).append(
                            (s, clock[r], extra)
                        )
                t0 = clock[r]
                clock[r] = t0 + g.compute_us + extra
                compute_spans[r].append(
                    (f"sim_backward:{s}:g{gi}", t0, clock[r])
                )
                ready[gi][r] = clock[r]
        backward_end = {r: clock[r] for r in tracked}
        # Post-hoc mode: nothing reduces until the whole backward ends.
        if not config.overlap:
            for gi in ready:
                ready[gi] = dict(backward_end)
        # Collectives in reduction order: start at the fleet-wide ready
        # point, stages claim their hops serially.
        comm_done = 0.0
        for gi, (plan, ag) in enumerate(plans):
            start = max(ready[gi].values())
            t = start
            for st in plan.stages:
                if st.hop == "-":
                    continue
                t0 = max(t, hop_free[st.hop])
                t1 = t0 + stage_cost(st)
                hop_free[st.hop] = t1
                stage_spans.append(_StageSpan(
                    group=gi, primitive=st.primitive, hop=st.hop,
                    axis=st.axis, nbytes=st.bytes_on_wire,
                    rounds=st.rounds, wire_dtype=st.wire_dtype,
                    t0=t0, t1=t1,
                ))
                t = t1
            comm_done = max(comm_done, t)
            # ZeRO-1: the parameter all-gather of this group's shard,
            # conservatively exposed after the RS (the tuner's pricing).
            if ag is not None:
                for st in ag.stages:
                    if st.hop == "-":
                        continue
                    t0 = max(t, hop_free[st.hop])
                    t1 = t0 + stage_cost(st)
                    hop_free[st.hop] = t1
                    stage_spans.append(_StageSpan(
                        group=gi, primitive=st.primitive + ":ag",
                        hop=st.hop, axis=st.axis,
                        nbytes=st.bytes_on_wire, rounds=st.rounds,
                        wire_dtype=st.wire_dtype, t0=t0, t1=t1,
                    ))
                    t = t1
                comm_done = max(comm_done, t)
        # Optimizer after the last reduction; the final collective
        # synchronizes, so every rank ends the step together.
        end = max(
            [comm_done] + [backward_end[r] for r in tracked]
        ) + program.optimizer_us
        for r in tracked:
            opt0 = max(comm_done, backward_end[r])
            compute_spans[r].append((f"sim_optimizer:{s}", opt0, end))
            step_spans[r].append((s, t_begin[r], end))
            clock[r] = end

    return SimResult(
        ranks=n, steps=steps, model=model, program=program,
        config=config, seed=int(seed), step_spans=step_spans,
        compute_spans=compute_spans, stage_spans=stage_spans,
        fault_instants=fault_instants, plans=plans,
        base_rank=base_rank,
    )


def straggler_sensitivity(
    model: InterconnectModel,
    program: SimProgram,
    config: Optional[SimConfig] = None,
    *,
    probe_delay_us: float = 1000.0,
    steps: int = 2,
) -> float:
    """How much of a one-rank delay the fleet eats: ``d(step time) /
    d(delay)`` for a probe delay on rank 0. 1.0 = fully synchronous
    (every delayed microsecond is paid by everyone); below 1.0 the
    stream pipeline hid part of the straggler behind wire time the
    fleet was paying anyway."""
    base = simulate(model, program, config, steps=steps)
    probe = FaultPlan.from_json(json.dumps({
        "seed": 0,
        "faults": [{
            "kind": "delay", "rank": 0, "site": "step",
            "seconds": probe_delay_us / 1e6, "after": 0,
        }],
    }))
    delayed = simulate(model, program, config, steps=steps,
                       fault_plan=probe)
    d = (delayed.mean_step_us - base.mean_step_us) / probe_delay_us
    return round(max(d, 0.0), 6)


# ------------------------------------------------------- serving twin
#
# The serving half of the fleet simulator (capacity planning): an open-loop Poisson arrival stream played through the
# EXACT shipping batching policy (serve/batcher.ContinuousBatcher under
# a virtual clock) against an affine batch-service-time model, with the
# request/replica chaos sites of the same seeded fault plans the live
# engine honors. Like the training twin: simulated microseconds from 0,
# no wall clock, every report float rounded — a fixed seed is
# byte-reproducible, which is what lets "what does p99 do at 2x qps?"
# be answered deterministically on a laptop.


@dataclass(frozen=True)
class ServeSimConfig:
    """Knobs of one serving simulation. ``qps`` drives the open-loop
    Poisson arrival process (inter-arrival ~ Exp(qps), independent of
    completions — the arrival stream does not slow down when the fleet
    falls behind, which is exactly what makes overload visible).
    Service time of a dispatched batch is affine:
    ``service_base_us + service_per_request_us * live_slots`` — the
    fixed cost of one compiled decode dispatch plus the marginal cost
    of each occupied slot."""

    qps: float = 50.0
    duration_s: float = 10.0
    replicas: int = 2
    max_batch_size: int = 8
    max_wait_us: int = 2000
    queue_bound: int = 1024
    slo_ms: float = 100.0
    service_base_us: float = 2000.0
    service_per_request_us: float = 500.0
    seed: int = 0

    def to_dict(self) -> dict:
        return {
            "qps": round(float(self.qps), 4),
            "duration_s": round(float(self.duration_s), 4),
            "replicas": int(self.replicas),
            "max_batch_size": int(self.max_batch_size),
            "max_wait_us": int(self.max_wait_us),
            "queue_bound": int(self.queue_bound),
            "slo_ms": round(float(self.slo_ms), 4),
            "service_base_us": round(float(self.service_base_us), 4),
            "service_per_request_us": round(
                float(self.service_per_request_us), 4
            ),
            "seed": int(self.seed),
        }


_SERVE_FAULT_KINDS = ("drop", "delay", "kill_replica")


def simulate_serve(
    config: ServeSimConfig,
    fault_plan: Optional[FaultPlan] = None,
) -> dict:
    """Simulate one serving run; returns the (rounded, sort-keyed
    deterministic) report dict.

    Mechanics mirror the live engine one-for-one: arrivals enter the
    real :class:`~horovod_tpu_torch.serve.batcher.ContinuousBatcher`; the
    earliest-free replica dispatches whenever the policy says a batch
    is ready (max-batch or head-deadline); ``request``-site faults
    resolve at admission in arrival order (``drop`` → answered as
    dropped, ``delay`` → the enqueue slides but the latency clock keeps
    counting from arrival); a ``replica``-site ``kill_replica`` on the
    K-th batch dispatch kills that replica and re-queues its batch at
    the FRONT with original timestamps (the exactly-once re-queue). A
    full queue refuses (outcome ``rejected``), never silently drops.
    """
    import random as _random

    from ..serve.batcher import ContinuousBatcher

    if fault_plan is not None:
        skipped = sorted({
            a.kind for a in fault_plan.actions
            if a.site not in ("request", "replica")
        })
        if skipped:
            logger.warning(
                "serve sim: fault plan carries non-serving action "
                "kind(s) %s — only request/replica-site faults shape "
                "this prediction", skipped,
            )

    # ---- open-loop Poisson arrivals (its own seeded stream).
    rng = _random.Random(config.seed)
    horizon_us = float(config.duration_s) * 1e6
    arrivals: List[Tuple[str, float]] = []
    t = 0.0
    i = 0
    while True:
        t += rng.expovariate(max(float(config.qps), 1e-9)) * 1e6
        if t >= horizon_us:
            break
        arrivals.append((f"req{i}", t))
        i += 1

    # ---- request-site faults resolve at admission, in arrival order
    # (the site's 1-based hit counter IS the arrival index).
    request_actions = [] if fault_plan is None else [
        a for a in fault_plan.actions if a.site == "request"
    ]
    replica_actions = [] if fault_plan is None else [
        a for a in fault_plan.actions if a.site == "replica"
    ]
    arrive_t: Dict[str, float] = {}
    enqueue_t: Dict[str, float] = {}
    outcomes: Dict[str, str] = {}
    admitted: List[Tuple[str, float]] = []
    for hit, (rid, t_arr) in enumerate(arrivals, start=1):
        arrive_t[rid] = t_arr
        t_enq = t_arr
        dropped = False
        for a in request_actions:
            if a.in_window(hit) and fault_plan.decide(a, None):
                if a.kind == "drop":
                    dropped = True
                else:  # delay: queueing latency before batching
                    t_enq += float(a.seconds) * 1e6
        if dropped:
            outcomes[rid] = "dropped"
        else:
            admitted.append((rid, t_enq))
            enqueue_t[rid] = t_enq
    # Delays can reorder the enqueue stream; admission is by ENQUEUE time.
    admitted.sort(key=lambda p: (p[1], p[0]))

    # ---- discrete-event loop: earliest-free live replica dispatches.
    batcher = ContinuousBatcher(
        max_batch_size=config.max_batch_size,
        max_wait_us=config.max_wait_us,
        queue_bound=config.queue_bound,
    )
    replica_free = [0.0] * max(int(config.replicas), 1)
    killed: set = set()
    finish_t: Dict[str, float] = {}
    batches = 0
    occupancy = 0
    requeued = 0
    dispatch_hits = 0
    idx = 0
    inf = float("inf")
    while True:
        live = [r for r in range(len(replica_free)) if r not in killed]
        if not live:
            break
        r = min(live, key=lambda j: (replica_free[j], j))
        t_r = replica_free[r]
        while idx < len(admitted) and admitted[idx][1] <= t_r:
            rid, t_enq = admitted[idx]
            idx += 1
            if not batcher.offer(rid, int(t_enq)):
                outcomes[rid] = "rejected"
        decision = batcher.poll(int(t_r))
        if not decision.ready:
            cand = []
            dl = batcher.next_deadline_us()
            if dl is not None:
                cand.append(float(dl))
            if idx < len(admitted):
                cand.append(admitted[idx][1])
            if not cand:
                break  # drained: no queue, no future arrivals
            replica_free[r] = max(t_r, min(cand))
            continue
        dispatch_hits += 1
        kill = any(
            a.in_window(dispatch_hits) and fault_plan.decide(a, None)
            for a in replica_actions
        )
        if kill:
            for rid in reversed(decision.request_ids):
                batcher.requeue(rid, int(enqueue_t[rid]))
            requeued += len(decision.request_ids)
            killed.add(r)
            continue
        n_live = len(decision.request_ids)
        service = (float(config.service_base_us)
                   + float(config.service_per_request_us) * n_live)
        done = t_r + service
        replica_free[r] = done
        batches += 1
        occupancy += n_live
        for rid in decision.request_ids:
            finish_t[rid] = done
            outcomes[rid] = "ok"

    # ---- report (rounded, canonical).
    lat_ms = sorted(
        (finish_t[rid] - arrive_t[rid]) / 1e3 for rid in finish_t
    )

    def pct(p: float) -> float:
        if not lat_ms:
            return 0.0
        return lat_ms[min(int(p * (len(lat_ms) - 1)), len(lat_ms) - 1)]

    served = sum(1 for o in outcomes.values() if o == "ok")
    slo_viol = sum(1 for v in lat_ms if v > float(config.slo_ms))
    unanswered = len(arrivals) - len(outcomes)
    return {
        "schema": SIM_SCHEMA,
        "config": config.to_dict(),
        "arrivals": len(arrivals),
        "served": served,
        "dropped": sum(1 for o in outcomes.values() if o == "dropped"),
        "rejected": sum(1 for o in outcomes.values() if o == "rejected"),
        "requeued": int(requeued),
        "replicas_killed": len(killed),
        "unanswered": int(unanswered),
        "batches": int(batches),
        "mean_batch_occupancy": round(occupancy / batches, 4) if batches
        else 0.0,
        "latency_ms": {
            "p50": round(pct(0.50), 4),
            "p90": round(pct(0.90), 4),
            "p99": round(pct(0.99), 4),
            "mean": round(sum(lat_ms) / len(lat_ms), 4) if lat_ms else 0.0,
            "max": round(lat_ms[-1], 4) if lat_ms else 0.0,
        },
        "slo_violation_frac": round(slo_viol / served, 4) if served
        else 0.0,
        "throughput_rps": round(
            served / float(config.duration_s), 4
        ) if config.duration_s else 0.0,
    }
