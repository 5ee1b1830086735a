"""The offline GP/EI tuner for the compiled path, and the ``tuned.json``
artifact it emits.

The port of ``horovod_tpu/tune/tuner.py``: for the same ``ProgramSpec`` and
model its output equals the JAX package's byte for byte (the signature
aside, which keys on the port's parameter names; ``tune/signature.py``).

The loop is the eager engine's (``cpp/src/autotune.cc``) transplanted to
trace-time knobs and free objectives: evaluate the untuned default
first (so "strictly better than default" is always measurable), seed a
few deterministic design points, then fit the GP and walk Expected
Improvement over the candidate grid until the sample budget is spent.
Scoring is the structural-overlap + compositor-cost objective
(``tune/objective.py``); a measured step time can be mixed in by
passing ``measure_fn`` when hardware is reachable.

Before a winner is pinned, every stream-group plan it implies is run
through the symbolic plan verifier (``analysis/plan_verify.py``) — a
tuner must never emit a ``tuned.json`` whose schedule cannot be proven
to realize the collective. Verification failures raise
:class:`TuneVerificationError` instead of writing output.

Everything is seeded and pure-python: two runs from the same inputs
produce byte-identical ``tuned.json`` files (asserted by
``tests/test_torch_tune.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common.types import ReduceOp
from . import gp as _gp
from .objective import (
    ProgramSpec,
    TPTerm,
    free_objectives,
    group_plans,
    tp_group_plans,
)
from .signature import signature_hash
from .space import SearchSpace, space_for_model

TUNED_VERSION = 1


class TuneVerificationError(RuntimeError):
    """The winning configuration's plan failed symbolic verification;
    no ``tuned.json`` may be emitted."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = "\n".join(f"  {f.render()}" for f in self.findings[:8])
        super().__init__(
            f"refusing to pin a tuned configuration: "
            f"{len(self.findings)} plan-verification finding(s)\n{lines}"
        )


@dataclass
class TunedConfig:
    """A pinned compiled-path tuning: the knob values, the step
    signature they are valid for, and the evidence (chosen vs baseline
    objectives, sample history) that justified them."""

    knobs: Dict
    signature: Dict
    objectives: Dict
    baseline: Dict
    program: str = ""
    model: Dict = field(default_factory=dict)
    search: Dict = field(default_factory=dict)
    history: List[Dict] = field(default_factory=list)
    version: int = TUNED_VERSION

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "program": self.program,
            "knobs": dict(self.knobs),
            "signature": dict(self.signature),
            "objectives": dict(self.objectives),
            "baseline": dict(self.baseline),
            "model": dict(self.model),
            "search": dict(self.search),
            "history": list(self.history),
        }

    def to_json(self) -> str:
        """Stable serialization — sorted keys, no timestamps — so the CI
        smoke can diff two tuner runs byte-for-byte."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=1) + "\n"

    @staticmethod
    def from_dict(d: Dict) -> "TunedConfig":
        return TunedConfig(
            knobs=dict(d.get("knobs", {})),
            signature=dict(d.get("signature", {})),
            objectives=dict(d.get("objectives", {})),
            baseline=dict(d.get("baseline", {})),
            program=str(d.get("program", "")),
            model=dict(d.get("model", {})),
            search=dict(d.get("search", {})),
            history=list(d.get("history", [])),
            version=int(d.get("version", TUNED_VERSION)),
        )

    @property
    def signature_hash(self) -> str:
        h = self.signature.get("hash")
        return str(h) if h else signature_hash(self.signature)


def save_tuned(cfg: TunedConfig, path: str) -> str:
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def load_tuned(path: str) -> TunedConfig:
    with open(path) as f:
        return TunedConfig.from_dict(json.load(f))


def _round_x(x: Sequence[float]) -> List[float]:
    return [round(float(v), 6) for v in x]


def tune(
    spec: ProgramSpec,
    model,
    *,
    samples: int = 16,
    seed: int = 0,
    space: Optional[SearchSpace] = None,
    allow_int8: bool = True,
    op: ReduceOp = ReduceOp.AVERAGE,
    measure_fn: Optional[Callable[[Dict], float]] = None,
    rounds_fn: Optional[Callable] = None,
    verify: bool = True,
    zero1: bool = False,
    calibration=None,
    fixed_comm_us: float = 0.0,
    tp: Optional[TPTerm] = None,
) -> TunedConfig:
    """Search the joint compiled-path space for ``spec`` on ``model``.

    ``measure_fn(config) -> step_seconds`` (optional) mixes a measured
    objective into the score as ``-1e6 * step_seconds`` (microseconds,
    same unit as the modeled cost) — the free objectives still run so
    the emitted evidence block is always populated. ``rounds_fn`` is
    forwarded to the plan verifier (tests inject corrupted schedules
    through it). ``verify=False`` is for unit tests only.

    ``zero1=True`` tunes the streamed-ZeRO-1 reduction shape: groups
    are priced as per-bucket reduce-scatter + parameter all-gather
    (``free_objectives(zero1=True)``), "split" is dropped from the
    admissible topology choices, and the emitted RS/AG plans are the
    ones symbolically verified before pinning — this is what lets
    ``tuned.json`` stop exempting ``--zero1``.

    ``calibration`` (a ``calibration.json`` path / ``Calibration`` /
    None = the ``HOROVOD_CALIBRATION_FILE`` knob) prices the whole
    search — objectives, emitted plans, and the model recorded in
    ``tuned.json`` — with measured per-hop constants
    (``sim/calibrate.py``); a stale hop-ladder signature warns loudly
    and the search runs on generation defaults, recorded as such in
    ``search.calibration``.

    ``fixed_comm_us`` prices a caller-computed constant per-step
    communication term into every objective — knob-invariant by
    construction, recorded verbatim in ``search.fixed_comm_us``.
    ``tp`` (a :class:`TPTerm`) supersedes it: the TP term is then
    priced PER CONFIG from the config's own ``tp_chunks`` choice
    (``objective.tp_term_us`` — the classic exposed psum at 0, the
    fused collective-matmul pair above), the chunk-count dim joins the
    search, the winner's fused plans are symbolically verified on the
    TP-axis model, and ``search.fixed_comm_us`` records the WINNER's
    computed term instead of a caller constant.
    """
    from .objective import calibrated_model

    if tp is not None and float(fixed_comm_us) > 0.0:
        raise ValueError(
            "pass either tp=TPTerm(...) (priced per config) or the "
            "legacy fixed_comm_us constant — not both"
        )
    calib_info = {"applied": False, "source": "generation-defaults"}
    if calibration is not None:
        model, calib_info = calibrated_model(
            model, calibration, where="tune"
        )
    tp_active = tp is not None and int(tp.degree) > 1
    space = space or space_for_model(model, allow_int8=allow_int8,
                                     zero1=zero1, tp=tp_active)
    grid = space.candidate_grid()
    rng = _gp.Lcg(seed)
    samples = max(int(samples), 1)

    def evaluate(config: Dict) -> Tuple[Dict, float]:
        obj = free_objectives(spec, config, model, op=op, zero1=zero1,
                              fixed_comm_us=fixed_comm_us, tp=tp)
        score = obj["score"]
        if measure_fn is not None:
            measured_s = float(measure_fn(config))
            obj["measured_step_s"] = round(measured_s, 6)
            score = round(-1e6 * measured_s, 6)
            obj["score"] = score
        return obj, score

    xs: List[Tuple[float, ...]] = []
    ys: List[float] = []
    configs: List[Dict] = []
    objs: List[Dict] = []
    seen = set()

    def try_point(x: Tuple[float, ...]) -> None:
        config = space.validate(space.decode(x))
        key = tuple(_round_x(space.encode(config)))
        if key in seen:
            return
        seen.add(key)
        obj, score = evaluate(config)
        xs.append(key)
        ys.append(score)
        configs.append(config)
        objs.append(obj)

    # Sample 0 is ALWAYS the untuned default — the baseline every
    # improvement claim is measured against.
    default = space.default_config()
    try_point(space.encode(default))
    baseline = dict(objs[0])

    # Informed corners before the random design: the small-bucket corner
    # (more stream groups → earlier wire starts) and, when admissible,
    # the int8 default — each teaches the GP one knob axis, so even an
    # ~8-sample smoke budget explores every direction instead of
    # betting the whole budget on random grid cells.
    corners: List[Dict] = [dict(default)]
    corners[-1].update(fusion_threshold_bytes=2 << 20,
                       first_bucket_bytes=256 << 10)
    if space.allow_int8:
        corners.append(dict(default, wire_dtype="int8"))
        corners.append(dict(corners[0], wire_dtype="int8"))
    if getattr(space, "tp", False):
        # The mid-chunk fused corner — teaches the GP the chunk axis
        # against the default's classic exposed psum (tp_chunks=0).
        corners.append(dict(default, tp_chunks=2))
    for c in corners:
        if len(xs) >= samples:
            break
        try_point(space.encode(c))

    # A few seeded random design points before the GP has anything to
    # say (deterministic LCG — byte-stable across runs).
    n_seed = min(3, max(samples - len(xs), 0))
    guard = 0
    while len(xs) < 1 + len(corners) + n_seed and guard < 64:
        if len(xs) >= samples:
            break
        guard += 1
        try_point(grid[rng.next_index(len(grid))])

    while len(xs) < samples:
        model_gp = _gp.fit(xs, ys)
        if model_gp is None:
            break
        # Best unseen EI candidate (strict >, iteration order breaks
        # ties) — the C++ grid scan with a dedupe, since re-sampling a
        # deterministic objective teaches the GP nothing.
        best_ei, best_x = -1.0, None
        for c in grid:
            key = tuple(_round_x(
                space.encode(space.validate(space.decode(c)))
            ))
            if key in seen:
                continue
            ei = _gp.expected_improvement(model_gp, c)
            if ei > best_ei:
                best_ei, best_x = ei, c
        if best_x is None:
            break  # grid exhausted
        try_point(best_x)

    best_i = 0
    for i in range(1, len(ys)):
        if ys[i] > ys[best_i]:
            best_i = i
    best_config = configs[best_i]
    best_obj = objs[best_i]

    tp_plans, tp_model = tp_group_plans(best_config, model, tp)
    findings: List = []
    if verify:
        from ..analysis.plan_verify import verify_plan

        for plan in group_plans(spec, best_config, model, op=op,
                                zero1=zero1):
            findings.extend(verify_plan(plan, model, rounds_fn=rounds_fn))
        for plan in tp_plans:
            findings.extend(
                verify_plan(plan, tp_model, rounds_fn=rounds_fn)
            )
        if findings:
            raise TuneVerificationError(findings)

    history = [
        {"x": _round_x(x), "config": configs[i],
         "score": round(ys[i], 6)}
        for i, x in enumerate(xs)
    ]
    return TunedConfig(
        knobs=dict(best_config),
        signature=dict(spec.signature),
        objectives=best_obj,
        baseline=baseline,
        program=spec.name,
        model=model.to_dict(),
        search={
            "samples": len(xs),
            "requested_samples": samples,
            "seed": int(seed),
            "objective": "measured" if measure_fn is not None else "free",
            "zero1": bool(zero1),
            "calibration": calib_info,
            # With a TP term, this is the WINNER's computed per-step TP
            # time (its tp_chunks choice priced by tp_term_us) — no
            # longer a caller-supplied constant.
            "fixed_comm_us": (
                round(float(best_obj.get("tp", {})
                            .get("fixed_comm_us", 0.0)), 4)
                if tp is not None
                else round(max(float(fixed_comm_us), 0.0), 4)
            ),
            **({"tp": {**tp.to_dict(),
                       "chunks": int(best_config.get("tp_chunks", 0))}}
               if tp is not None else {}),
            "space": {
                "topo_choices": list(space.topo_choices),
                "allow_int8": bool(space.allow_int8),
                **({"tp": True} if getattr(space, "tp", False) else {}),
            },
            "verified_plans": 0 if not verify else len(
                group_plans(spec, best_config, model, op=op, zero1=zero1)
            ) + len(tp_plans),
        },
        history=history,
    )
