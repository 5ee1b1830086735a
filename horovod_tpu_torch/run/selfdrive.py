"""Self-driving fleet: the decision cores behind quarantine and autoscale.

The port of ``horovod_tpu/run/selfdrive.py``: the pure, unit-testable
policies the elastic driver (:mod:`.elastic_driver`) and the serving
engine act on, with no clock, no thread and no torch.

1. **Slowness quarantine** (:class:`StragglerPolicy`): consume the
   per-step straggler charges the driver's ``StepSkewTracker`` emits;
   when ONE rank is charged the last finisher above threshold for
   ``HOROVOD_QUARANTINE_STRIKES`` of the last ``HOROVOD_QUARANTINE_WINDOW``
   observed steps, propose quarantining its host. Never below the min
   world size, never two hosts in one beat. The driver reuses the
   blacklist cooldown, decay and relapse doubling with a distinct
   ``reason="slow"`` ledger.
2. **Serving autoscale** (:class:`ServeScalePolicy`): queue depth and SLO
   burn over a window of beats, one verdict a call.
3. **Drift scalars** (:func:`divergence_ratios`, :func:`max_divergence`,
   :func:`skew_trend`, :func:`replay_divergence`) and the resize's bytes
   (:func:`price_resize`).

4. **Live re-plan** (:func:`propose_replan`): when the calibrated per-hop
   constants drift from the generation defaults beyond
   ``HOROVOD_REPLAN_DIVERGENCE``, or the skew trend says the current plan
   is mispriced, re-price the tuner's free objectives
   (``tune/objective.py``) on the drifted model over a small grid
   (:func:`candidate_configs`) and propose the best configuration,
   published only when it is STRICTLY better than the current one and
   every plan it implies passes the symbolic verifier
   (:func:`verify_replan`). :func:`spec_from_windows` reconstructs the
   program from the fleet's trace windows (or ``HOROVOD_REPLAN_SPEC``),
   :func:`model_for_world` the interconnect model from the published world
   (``h100`` on an H100, as ``topo/model.py`` detects it).
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# --------------------------------------------------------------- knobs
QUARANTINE_STRIKES_ENV = "HOROVOD_QUARANTINE_STRIKES"
QUARANTINE_WINDOW_ENV = "HOROVOD_QUARANTINE_WINDOW"
QUARANTINE_COOLDOWN_ENV = "HOROVOD_QUARANTINE_COOLDOWN_S"
REPLAN_DIVERGENCE_ENV = "HOROVOD_REPLAN_DIVERGENCE"
REPLAN_SKEW_ENV = "HOROVOD_REPLAN_SKEW_S"
REPLAN_CHECK_ENV = "HOROVOD_REPLAN_CHECK_S"
REPLAN_SPEC_ENV = "HOROVOD_REPLAN_SPEC"
SPARES_ENV = "HOROVOD_SPARES"

DEFAULT_QUARANTINE_WINDOW_FACTOR = 2  # window = factor * strikes


def _env_int(env: Dict[str, str], name: str, default: int) -> int:
    try:
        return int(env.get(name, "") or default)
    except ValueError:
        return default


def _env_float(env: Dict[str, str], name: str, default: float) -> float:
    try:
        return float(env.get(name, "") or default)
    except ValueError:
        return default


# ------------------------------------------------- slowness quarantine
@dataclass(frozen=True)
class QuarantineDecision:
    """One policy verdict: quarantine ``host`` because ``rank`` was the
    charged straggler for ``charges`` of the last ``window`` steps."""

    host: str
    rank: int
    charges: int
    window: int


class StragglerPolicy:
    """Sliding-window strike accumulator over the driver's per-step
    straggler charges.

    ``observe()`` is fed every step the skew tracker emits (charged or
    not — the window is "the last N steps", not "the last N charges"),
    so a rank that stops lagging DECAYS out as healthy steps push its
    charges off the window. ``decide()`` returns at most ONE decision
    per call (one host per supervision beat) and applies the min-world
    veto itself, so the safety properties are unit-testable without a
    fleet. ``reset_generation()`` drops the ledger: ranks are renumbered
    across a resize, so charges must never survive one.
    """

    def __init__(self, strikes: int = 0, window: Optional[int] = None):
        self.strikes = max(int(strikes), 0)
        if window is None:
            window = DEFAULT_QUARANTINE_WINDOW_FACTOR * max(self.strikes, 1)
        self.window = max(int(window), max(self.strikes, 1))
        self._steps: "deque[Tuple[int, Optional[int]]]" = deque(
            maxlen=self.window
        )
        self.generation: Optional[int] = None
        self.vetoes = 0

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "StragglerPolicy":
        e = env if env is not None else os.environ
        strikes = _env_int(e, QUARANTINE_STRIKES_ENV, 0)
        window = _env_int(e, QUARANTINE_WINDOW_ENV, 0) or None
        return StragglerPolicy(strikes=strikes, window=window)

    @property
    def enabled(self) -> bool:
        return self.strikes > 0

    def reset_generation(self, gen: Optional[int] = None) -> None:
        self._steps.clear()
        self.generation = None if gen is None else int(gen)

    def observe(self, step: int, skew_s: float, worst_rank: int,
                charged: bool) -> None:
        """Record one emitted step: ``charged`` is the driver's existing
        straggler verdict (skew above threshold → the last finisher is
        charged one ``hvd_straggler_total``)."""
        self._steps.append((int(step), int(worst_rank) if charged else None))

    def charges(self) -> Dict[int, int]:
        """Charged-step count per rank inside the current window."""
        out: Dict[int, int] = {}
        for _, rank in self._steps:
            if rank is not None:
                out[rank] = out.get(rank, 0) + 1
        return out

    def decide(
        self,
        rank_to_host: Dict[int, str],
        slots_by_host: Dict[str, int],
        min_world: int,
    ) -> Optional[QuarantineDecision]:
        """At most one quarantine per beat: the most-charged rank at or
        above the strike threshold, vetoed when removing its host would
        drop the fleet below ``min_world`` (``slots_by_host`` is the
        AVAILABLE capacity per host — spare slots on healthy hosts are
        exactly what makes a quarantine affordable). A decision consumes
        the offender's charges so the same evidence is never spent
        twice."""
        if not self.enabled:
            return None
        charges = self.charges()
        ranked = sorted(
            ((n, r) for r, n in charges.items() if n >= self.strikes),
            key=lambda t: (-t[0], t[1]),
        )
        for n, rank in ranked:
            host = rank_to_host.get(rank)
            if host is None:
                continue  # departed rank: stale charge, nothing to act on
            remaining = sum(
                c for h, c in slots_by_host.items() if h != host
            )
            if remaining < min_world:
                self.vetoes += 1
                return None  # quarantining ANY offender would kill the job
            # Spend the evidence: drop this rank's charges from the
            # window (healthy peers keep theirs — but only one decision
            # leaves this call, so two hosts can never fall in one beat).
            self._steps = deque(
                ((s, None if r == rank else r) for s, r in self._steps),
                maxlen=self.window,
            )
            return QuarantineDecision(
                host=host, rank=rank, charges=n, window=self.window
            )
        return None


# ---------------------------------------------------- serving autoscale
@dataclass(frozen=True)
class ScaleDecision:
    """One serving-autoscale verdict (docs/serving.md "Autoscale"):
    ``action`` is ``"scale-out"`` (promote a spare into a new DP serving
    replica) or ``"scale-in"`` (quarantine-shrink one replica away);
    ``reason`` names the triggering signal."""

    action: str
    reason: str
    depth: float
    slo_burn: float


class ServeScalePolicy:
    """Queue-depth / SLO-burn autoscaler for ``serve()``: the same
    pure-policy discipline as :class:`StragglerPolicy`: no clock, no
    threads; the engine feeds one :meth:`observe` beat per autoscale
    tick (queue depth, SLO violations and completions since the last
    beat) and :meth:`decide` returns at most one verdict per call.

    Triggers over the sliding ``window`` of beats:

    - **scale-out** when mean queue depth >= ``scale_out_depth`` OR the
      SLO burn fraction (violations / completions) >= ``slo_burn`` —
      the serving analogue of spare promotion.
    - **scale-in** when mean depth <= ``scale_in_depth`` AND burn is
      under half the threshold — the quarantine-shrink verb.

    Vetoes are the policy's own: never below ``min_replicas``, never
    above ``max_replicas``, and a ``cooldown`` of beats after any
    decision so one burst cannot thrash the fleet both ways.
    """

    def __init__(self, scale_out_depth: float = 16.0,
                 scale_in_depth: float = 1.0, slo_burn: float = 0.1,
                 window: int = 8, cooldown: int = 4,
                 min_replicas: int = 1, max_replicas: int = 8):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        self.scale_out_depth = float(scale_out_depth)
        self.scale_in_depth = float(scale_in_depth)
        self.slo_burn = float(slo_burn)
        self.window = int(window)
        self.cooldown = max(int(cooldown), 0)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        # (queue_depth, slo_violations, completions) per beat.
        self._beats: "deque[Tuple[float, int, int]]" = deque(
            maxlen=self.window
        )
        self._beat = 0
        self._last_decision_beat: Optional[int] = None

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None,
                 *, min_replicas: int = 1,
                 max_replicas: int = 8) -> "ServeScalePolicy":
        from ..common import env as _env

        e = env if env is not None else os.environ
        return ServeScalePolicy(
            scale_out_depth=_env_float(
                e, _env.HOROVOD_SERVE_SCALE_OUT_DEPTH, 16.0
            ),
            scale_in_depth=_env_float(
                e, _env.HOROVOD_SERVE_SCALE_IN_DEPTH, 1.0
            ),
            slo_burn=_env_float(e, _env.HOROVOD_SERVE_SLO_BURN, 0.1),
            window=_env_int(e, _env.HOROVOD_SERVE_SCALE_WINDOW, 8),
            cooldown=_env_int(e, _env.HOROVOD_SERVE_SCALE_COOLDOWN, 4),
            min_replicas=min_replicas,
            max_replicas=max_replicas,
        )

    def observe(self, queue_depth: float, slo_violations: int,
                completions: int) -> None:
        """One autoscale beat: instantaneous queue depth plus the SLO
        violations and completed requests SINCE the previous beat."""
        self._beats.append(
            (float(queue_depth), int(slo_violations), int(completions))
        )
        self._beat += 1

    def burn(self) -> float:
        """SLO-violation fraction over the window (0 with no traffic —
        an idle fleet is not burning its SLO)."""
        viol = sum(v for _, v, _ in self._beats)
        done = sum(c for _, _, c in self._beats)
        return (viol / done) if done else 0.0

    def mean_depth(self) -> float:
        if not self._beats:
            return 0.0
        return sum(d for d, _, _ in self._beats) / len(self._beats)

    def decide(self, replicas: int) -> Optional[ScaleDecision]:
        """At most one verdict per call, None inside the cooldown or
        before the window has filled (no decisions on a cold start)."""
        if len(self._beats) < self.window:
            return None
        if (self._last_decision_beat is not None
                and self._beat - self._last_decision_beat <= self.cooldown):
            return None
        depth = self.mean_depth()
        burn = self.burn()
        if ((depth >= self.scale_out_depth or burn >= self.slo_burn)
                and replicas < self.max_replicas):
            self._last_decision_beat = self._beat
            reason = ("queue-depth" if depth >= self.scale_out_depth
                      else "slo-burn")
            return ScaleDecision("scale-out", reason, depth, burn)
        if (depth <= self.scale_in_depth and burn < self.slo_burn / 2
                and replicas > self.min_replicas):
            self._last_decision_beat = self._beat
            return ScaleDecision("scale-in", "idle", depth, burn)
        return None


# ------------------------------------------------------------- re-plan
def divergence_ratios(default_model, calibrated_model) -> Dict[str, float]:
    """Per-hop drift between the generation-default alpha-beta entries
    and the calibrated ones, as a symmetric ratio >= 1 (1.0 = no drift).
    The bandwidth and latency drifts are folded with ``max`` — either
    constant moving means the planner priced the link wrong."""
    out: Dict[str, float] = {}
    calibrated = {h.name: h for h in calibrated_model.hops}
    for h in default_model.hops:
        c = calibrated.get(h.name)
        if c is None:
            continue
        ratio = 1.0
        if c.bandwidth_gbps > 0 and h.bandwidth_gbps > 0:
            r = h.bandwidth_gbps / c.bandwidth_gbps
            ratio = max(ratio, r, 1.0 / r)
        if c.latency_us > 0 and h.latency_us > 0:
            r = c.latency_us / h.latency_us
            ratio = max(ratio, r, 1.0 / r)
        out[h.name] = round(ratio, 6)
    return out


def max_divergence(ratios: Dict[str, float]) -> float:
    """The drift scalar the ``HOROVOD_REPLAN_DIVERGENCE`` threshold
    gates on: the largest per-hop |ratio - 1|."""
    return round(
        max((abs(r - 1.0) for r in ratios.values()), default=0.0), 6
    )


def skew_trend(samples, min_n: int = 8) -> Optional[float]:
    """The ``StepSkewTracker``-trend trigger scalar: mean cross-rank
    step skew over the recent window, or None while the evidence is
    thinner than ``min_n`` steps (one noisy step must never re-plan a
    fleet). Sustained skew above ``HOROVOD_REPLAN_SKEW_S`` says the
    current plan is mispriced for the fleet as it actually behaves —
    the re-plan then re-prices on whatever calibrated constants are
    available (generation defaults when none are)."""
    xs = [float(s) for s in samples]
    if len(xs) < max(int(min_n), 1):
        return None
    return round(sum(xs) / len(xs), 6)


def replay_divergence(report: Dict) -> Dict[str, float]:
    """Per-hop modeled/measured ratios from a ``fleet_sim.py --replay``
    report (the ``hvd_sim_divergence_ratio`` block): the OTHER drift
    source the trigger accepts. ``null`` entries (hop never measured)
    are skipped — absence of evidence is not drift."""
    out: Dict[str, float] = {}
    block = report.get("divergence") or report.get(
        "hvd_sim_divergence_ratio") or {}
    for hop, ratio in block.items():
        if ratio is None:
            continue
        try:
            r = float(ratio)
        except (TypeError, ValueError):
            continue
        if r > 0:
            out[str(hop)] = round(max(r, 1.0 / r), 6)
    return out


_DEFAULT_CONFIG_KEYS = (
    "fusion_threshold_bytes", "first_bucket_bytes", "topo_algorithm",
    "wire_dtype",
)


def _normalize_config(config: Optional[Dict]) -> Dict:
    from ..common.env import Config

    cfg = dict(config or {})
    base = Config.from_env()
    cfg.setdefault("fusion_threshold_bytes",
                   int(base.fusion_threshold_bytes))
    cfg.setdefault("first_bucket_bytes",
                   int(base.fusion_first_bucket_bytes))
    cfg.setdefault("topo_algorithm", "auto")
    cfg.setdefault("wire_dtype", "f32")
    return {k: cfg[k] for k in _DEFAULT_CONFIG_KEYS}


def candidate_configs(model, current: Dict) -> List[Dict]:
    """The deterministic re-plan grid: every topo choice the compositor
    can realize on this model x both wire dtypes, over the current
    bucket knobs plus the tuner's canonical first-bucket alternatives.
    Small on purpose — a re-plan prices in one supervision beat; the
    full GP search stays offline (tools/autotune_compiled.py)."""
    topos = ["auto", "flat"]
    if model.levels > 1:
        topos += ["two-level", "split"]
    first_buckets = sorted({
        int(current["first_bucket_bytes"]), 1 << 20, 4 << 20,
    })
    out: List[Dict] = []
    for topo in topos:
        for wire in ("f32", "int8"):
            for fb in first_buckets:
                out.append({
                    "fusion_threshold_bytes":
                        int(current["fusion_threshold_bytes"]),
                    "first_bucket_bytes": fb,
                    "topo_algorithm": topo,
                    "wire_dtype": wire,
                })
    return out


@dataclass
class ReplanProposal:
    """A priced, not-yet-verified re-plan: the winning knob set, the
    incumbent it beats, and the modeled evidence (exposed-us on the
    drifted model) that justifies publishing it."""

    config: Dict
    current: Dict
    current_exposed_us: float
    replanned_exposed_us: float
    trigger: str
    drift: float
    per_hop: Dict[str, float] = field(default_factory=dict)

    def to_notice(self, notice_id: int, gen: int, epoch: int) -> Dict:
        """The KV document workers adopt at a commit boundary. Stable
        key order (the driver serializes it sort_keys) and no wall
        clock — the notice must journal/diff deterministically."""
        return {
            "id": int(notice_id),
            "gen": int(gen),
            "epoch": int(epoch),
            "trigger": self.trigger,
            "drift": round(self.drift, 6),
            "per_hop": {k: v for k, v in sorted(self.per_hop.items())},
            "config": dict(self.config),
            "current": dict(self.current),
            "modeled": {
                "current_exposed_us": round(self.current_exposed_us, 4),
                "replanned_exposed_us": round(self.replanned_exposed_us, 4),
            },
        }


def propose_replan(
    spec,
    model,
    current_config: Optional[Dict],
    calibration,
    trigger: str = "divergence",
    per_hop: Optional[Dict[str, float]] = None,
    drift: float = 0.0,
) -> Optional[ReplanProposal]:
    """Re-price the free objectives on the CALIBRATED (drifted) model
    and return the best configuration — or None when the incumbent is
    already the best (a re-plan that does not strictly win modeled step
    time is never published; the smoke gates on this)."""
    from ..tune.objective import free_objectives

    current = _normalize_config(current_config)
    cur_obj = free_objectives(spec, current, model, calibration=calibration)
    best_cfg, best_obj = current, cur_obj
    for cand in candidate_configs(model, current):
        if cand == current:
            continue
        obj = free_objectives(spec, cand, model, calibration=calibration)
        if obj["exposed_us"] < best_obj["exposed_us"] or (
            obj["exposed_us"] == best_obj["exposed_us"]
            and obj["wire_bytes"] < best_obj["wire_bytes"]
        ):
            best_cfg, best_obj = cand, obj
    if best_cfg == current:
        return None
    if not best_obj["exposed_us"] < cur_obj["exposed_us"]:
        return None
    return ReplanProposal(
        config=best_cfg,
        current=current,
        current_exposed_us=float(cur_obj["exposed_us"]),
        replanned_exposed_us=float(best_obj["exposed_us"]),
        trigger=trigger,
        drift=float(drift),
        per_hop=dict(per_hop or {}),
    )


def price_resize(param_bytes: int, n_old: int, n_new: int, model=None, *,
                 opt_slots: int = 2, quantized: bool = False,
                 itemsize: int = 4) -> Dict:
    """Price the sharded-state redistribution of a world resize
    (quarantine shrink, spare-promotion grow, scale-in/out) so the
    re-plan ladder can weigh "resize now" against its wire cost: the
    ZeRO-1 optimizer state (``opt_slots`` f32 vectors per parameter —
    Adam 2, momentum 1 — plus the EF residual on the int8 wire) is
    sharded 1/N and must re-partition when N changes
    (``parallel/reshard`` executes the move this prices).

    ``model`` (an ``InterconnectModel``) turns bytes into a modeled
    time over its OUTERMOST hop — a resize re-forms the world, so the
    redistribution crosses the slowest fabric; ranks move their slices
    in parallel, so the serialized bytes are ``moved / min(n)``."""
    from ..parallel.reshard import resize_redistribution

    elements = max(int(param_bytes) // 4, 0)  # f32 master elements
    copies = int(opt_slots) + (1 if quantized else 0)
    out = resize_redistribution(
        elements, itemsize, int(n_old), int(n_new),
        quantized=quantized, copies=copies,
    )
    out["param_bytes"] = int(param_bytes)
    out["opt_slots"] = int(opt_slots)
    out["quantized"] = bool(quantized)
    if model is not None:
        hop = model.hops[0]
        per_rank = out["moved_bytes"] / max(min(int(n_old), int(n_new)), 1)
        bytes_per_us = float(hop.bandwidth_gbps) * 1000.0
        out["modeled_time_us"] = round(
            float(hop.latency_us) + per_rank / bytes_per_us, 4
        )
        out["hop"] = hop.name
    return out


def verify_replan(spec, config: Dict, model, calibration) -> List:
    """Symbolically verify every stream-group plan ``config`` implies
    (the tuner's pre-pin gate, ``analysis/plan_verify``): a re-plan
    notice is published only when this returns no findings — the driver
    must never steer the fleet onto a plan the checker can refute."""
    from ..analysis.plan_verify import verify_plan
    from ..tune.objective import calibrated_model, group_plans

    if calibration is not None:
        model, _ = calibrated_model(model, calibration,
                                    where="replan-verify")
    findings: List = []
    for plan in group_plans(spec, config, model):
        findings.extend(verify_plan(plan, model))
    return findings


# --------------------------------------------- observed-program spec
def spec_from_windows(windows: Dict[int, dict]):
    """Reconstruct the fleet's observed program (layer name -> payload
    bytes) from collected trace windows: the per-collective spans the
    runtime records carry ``nbytes``, so the driver can price a re-plan
    against what the fleet ACTUALLY reduces without any side channel.
    ``HOROVOD_REPLAN_SPEC`` (inline JSON or a path;
    ``{"layers": [["name", bytes], ...]}``) overrides for operators who
    want the re-plan priced against a declared program. Returns None
    when neither source yields a byte."""
    from ..tune.objective import ProgramSpec

    raw = os.environ.get(REPLAN_SPEC_ENV, "").strip()
    if raw:
        import json as _json

        text = raw
        if not raw.lstrip().startswith("{"):
            with open(raw) as f:
                text = f.read()
        doc = _json.loads(text)
        layers = tuple(
            (str(n), int(b)) for n, b in doc.get("layers", []) if int(b) > 0
        )
        if layers:
            return ProgramSpec(
                name=str(doc.get("name", "replan-spec")), layers=layers
            )
    seen: Dict[str, int] = {}
    order: List[str] = []
    for _, doc in sorted(windows.items()):
        for ev in doc.get("events") or []:
            name = str(ev.get("name", ""))
            if not name.startswith(("hvd_response", "hvd_plan")):
                continue
            args = ev.get("args") or {}
            nbytes = args.get("nbytes", args.get("bytes"))
            if not nbytes:
                continue
            key = str(args.get("tensor", "")) or name
            if key not in seen:
                order.append(key)
            seen[key] = max(seen.get(key, 0), int(nbytes))
    layers = tuple((k, seen[k]) for k in order if seen[k] > 0)
    if not layers:
        return None
    return ProgramSpec(name="observed", layers=layers)


def model_for_world(world: Optional[Dict], generation: Optional[str] = None):
    """The interconnect model the driver prices re-plans on, derived
    from the published world doc's assignment structure (local/cross
    sizes) exactly as ``topo.model_from_topology`` derives it from a
    live process: a homogeneous local>1 x cross>1 grid gets the
    DCN x ICI ladder, anything else collapses to one flat ICI hop.
    ``HOROVOD_TOPOLOGY_MODEL`` overrides apply as everywhere else."""
    from ..topo import model as _tm

    size = len((world or {}).get("assignments") or {}) or 1
    locals_ = {
        int(a.get("local_size", 1))
        for a in (world or {}).get("assignments", {}).values()
    } or {1}
    crosses = {
        int(a.get("cross_size", 1))
        for a in (world or {}).get("assignments", {}).values()
    } or {1}
    gen = generation or _tm.detect_generation()
    local = locals_.pop() if len(locals_) == 1 else 0
    cross = crosses.pop() if len(crosses) == 1 else 0
    if local > 1 and cross > 1 and local * cross == size:
        model = _tm.synthetic_model(local, cross, generation=gen)
    else:
        model = _tm.synthetic_model(size, generation=gen)
    return _tm.apply_override(model)
