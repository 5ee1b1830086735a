"""Finding model of the port's static checks.

The port's copy of ``horovod_tpu/analysis/findings.py``: a Finding is one
rule violation with a stable, machine-readable shape (JSON with a
deterministic key order; ``severity[rule] location: message`` for humans).
The rule ids are the JAX package's whole vocabulary, so a finding here and
there names the same rule; the port runs the eager checks
(:mod:`.ordering`, :mod:`.groups`, :mod:`.preflight`).
"""

from __future__ import annotations

import contextlib
import fnmatch
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

# --- rule ids (Pass 1: collective lint) ---
RULE_UNKNOWN_AXIS = "unknown-axis"
RULE_ORDER_MISMATCH = "cross-rank-order"
RULE_SIGNATURE_MISMATCH = "cross-rank-signature"
RULE_MISSING_COLLECTIVE = "cross-rank-missing"
RULE_PPERMUTE = "ppermute-non-bijective"
RULE_GROUP_DTYPE = "group-dtype-mismatch"
RULE_GROUP_BUDGET = "group-over-budget"
RULE_FUSION_BUDGET = "fusion-over-budget"
# DistributedOptimizer(overlap=True) around a model whose layers were never
# (or only partially) registered for streamed reduction — the silent
# fallback/unreduced-gradient hazard (docs/overlap.md).
RULE_OVERLAP_STREAMING = "overlap-no-streaming"
# Streamed-overlap step traced under HOROVOD_GUARD_NONFINITE=skip without
# the cross-rank skip-agreement collective (guard/nonfinite.agree_flag):
# ranks could disagree about skipping a step and silently diverge
# (docs/fault_tolerance.md "Data-plane integrity").
RULE_GUARD_SKIP_AGREEMENT = "guard-skip-no-agreement"

# --- rule ids (Pass 2: runtime thread-safety lint) ---
RULE_UNGUARDED = "unguarded-shared-state"

# --- rule ids (Pass 3: symbolic plan verifier) ---
# A compositor Plan stage that is malformed: unknown primitive, a hop/axis
# that does not exist on the model, an SPMD asymmetry (group members whose
# abstract buffers disagree where the schedule requires agreement), or a
# declared round count that does not match the stage's expanded schedule.
RULE_PLAN_STAGE = "plan-bad-stage"
# An expanded ppermute round of a ring/halving schedule is not a complete
# bijection over its hop (the silent-hang class jaxpr lint catches for
# traced ppermutes, applied to the *planned* schedule before any trace).
RULE_PLAN_BIJECTION = "plan-non-bijective-permute"
# A stage's declared bytes-on-wire deviates from the symbolically-derived
# traffic beyond integer-rounding slack.
RULE_PLAN_BYTES = "plan-bytes-mismatch"
# The final abstract state does not satisfy the collective's spec
# (allreduce: every rank holds the full reduction; allgather/
# reduce-scatter/broadcast/alltoall likewise).
RULE_PLAN_RESULT = "plan-wrong-result"

# --- rule ids (Pass 4: SPMD rank-divergence analyzer) ---
# A collective reached under control flow (cond/switch/while) whose
# predicate derives from axis_index over an axis the collective reduces
# over: ranks of one group can take different branches and deadlock
# (the Horovod coordination model's classic SPMD killer).
RULE_RANK_DIVERGENCE = "rank-divergent-collective"

# --- rule ids (Pass 5: mesh/sharding-rule validator) ---
RULE_SHARDING_UNKNOWN_AXIS = "sharding-unknown-axis"
RULE_SHARDING_DUP_AXIS = "sharding-duplicate-axis"
RULE_SHARDING_INDIVISIBLE = "sharding-non-divisible"
RULE_SHARDING_UNMATCHED = "sharding-unmatched-param"
RULE_SHARDING_SCALAR = "sharding-scalar-not-replicated"
RULE_SHARDING_BAD_RULE = "sharding-bad-rule"

ALL_RULES = (
    RULE_UNKNOWN_AXIS,
    RULE_ORDER_MISMATCH,
    RULE_SIGNATURE_MISMATCH,
    RULE_MISSING_COLLECTIVE,
    RULE_PPERMUTE,
    RULE_GROUP_DTYPE,
    RULE_GROUP_BUDGET,
    RULE_FUSION_BUDGET,
    RULE_OVERLAP_STREAMING,
    RULE_GUARD_SKIP_AGREEMENT,
    RULE_UNGUARDED,
    RULE_PLAN_STAGE,
    RULE_PLAN_BIJECTION,
    RULE_PLAN_BYTES,
    RULE_PLAN_RESULT,
    RULE_RANK_DIVERGENCE,
    RULE_SHARDING_UNKNOWN_AXIS,
    RULE_SHARDING_DUP_AXIS,
    RULE_SHARDING_INDIVISIBLE,
    RULE_SHARDING_UNMATCHED,
    RULE_SHARDING_SCALAR,
    RULE_SHARDING_BAD_RULE,
)


@dataclass
class Finding:
    rule: str
    severity: str
    message: str
    location: str = ""
    details: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        # Insertion order is the stable JSON key order.
        return {
            "rule": self.rule,
            "severity": self.severity,
            "location": self.location,
            "message": self.message,
            "details": {k: self.details[k] for k in sorted(self.details)},
        }

    def render(self) -> str:
        loc = f" {self.location}" if self.location else ""
        return f"{self.severity}[{self.rule}]{loc}: {self.message}"


class CollectiveSafetyError(RuntimeError):
    """Raised by the opt-in pre-flight (HOROVOD_TPU_STATIC_CHECKS=1) when a
    static check finds an error-severity problem before the collective is
    submitted/traced."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        super().__init__(
            "collective-safety pre-flight failed:\n"
            + "\n".join(f"  {f.render()}" for f in self.findings)
        )


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    """Deterministic order: errors first, then by rule, location, message."""
    sev_rank = {SEVERITY_ERROR: 0, SEVERITY_WARNING: 1}
    return sorted(
        findings,
        key=lambda f: (
            sev_rank.get(f.severity, 2), f.rule, f.location, f.message
        ),
    )


def findings_to_json(findings: Sequence[Finding], **extra: Any) -> str:
    ordered = sort_findings(findings)
    doc = {
        "findings": [f.to_dict() for f in ordered],
        "summary": {
            "total": len(ordered),
            "errors": sum(
                1 for f in ordered if f.severity == SEVERITY_ERROR
            ),
            "warnings": sum(
                1 for f in ordered if f.severity == SEVERITY_WARNING
            ),
        },
    }
    doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=False)


def errors(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEVERITY_ERROR]


# --- call-site suppressions -------------------------------------------------
#
# The AST pass suppresses with an in-source comment; jaxpr-level and
# divergence findings have no source line to hang a comment on — their
# "call site" is the lint/preflight call. A suppression spec is
# ``"rule-id"`` (everywhere) or ``"rule-id@location-glob"`` (only where
# the finding's location matches the fnmatch pattern), so one sanctioned
# false positive never forces a global rule disable. Specs come in via
# the ``suppress=`` kwarg on the analyzers or the :func:`suppressions`
# context manager (thread-local, nestable) around a lint/preflight call.

_suppress_local = threading.local()


def _parse_spec(spec: str) -> Tuple[str, str]:
    rule, _, loc = str(spec).partition("@")
    return rule.strip(), (loc.strip() or "*")


def _active_specs() -> List[Tuple[str, str]]:
    return list(getattr(_suppress_local, "stack", ()))


@contextlib.contextmanager
def suppressions(*specs: str):
    """Suppress matching findings from any analyzer run inside the block
    (the call-site analogue of ``# hvd-analysis: ignore[rule]``)."""
    parsed = [_parse_spec(s) for s in specs]
    stack = getattr(_suppress_local, "stack", [])
    _suppress_local.stack = stack + parsed
    try:
        yield
    finally:
        _suppress_local.stack = stack


def _suppressed(finding: Finding, specs: Iterable[Tuple[str, str]]) -> bool:
    for rule, loc in specs:
        if rule and rule != finding.rule:
            continue
        if fnmatch.fnmatchcase(finding.location or "", loc):
            return True
    return False


def apply_suppressions(
    findings: Sequence[Finding],
    suppress: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Filter ``findings`` through the explicit ``suppress`` specs plus
    any :func:`suppressions` context active on this thread."""
    specs = [_parse_spec(s) for s in (suppress or ())]
    specs.extend(_active_specs())
    if not specs:
        return list(findings)
    return [f for f in findings if not _suppressed(f, specs)]
