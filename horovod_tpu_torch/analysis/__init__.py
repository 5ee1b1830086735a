"""Collective-safety static checks: the port of ``horovod_tpu/analysis``.

Five passes over three layers of the port:

 - **Pass 1 (collective lint)** checks what a training step does on the
   wire: the step is recorded as it runs (:mod:`.graph_lint`: every
   collective the port issues, its axis, dtype and bytes) and its axes,
   ring permutations and fusion buckets are checked; eager ranks are
   simulated against the tensor-name registry and their submission orders
   diffed (:mod:`.ordering`); grouped collectives' dtype and budget are
   validated (:mod:`.groups`).
 - **Pass 2 (lock-discipline lint)** checks the port's threaded sources
   against their declared lock discipline (:mod:`.runtime_lint`).
 - **Pass 3 (symbolic plan verifier)** executes every compositor plan over
   an abstract per-rank chunk state (:mod:`.plan_verify`).
 - **Pass 4 (rank divergence)** compares the collectives the members of
   each group recorded, to find a collective some ranks issue and others
   do not (:mod:`.divergence`).
 - **Pass 5 (sharding rules)** rejects rule tables a mesh cannot satisfy
   before anything is placed (:mod:`.sharding_rules`).

``python -m horovod_tpu_torch.tools.collective_lint`` runs every pass as a
CLI; ``HOROVOD_TPU_STATIC_CHECKS=1`` wires the checks into the entry points
as a pre-flight (:mod:`.preflight`). Findings are suppressed in the source
(``# hvd-analysis: ignore[rule]``) or at the call site (:func:`suppressions`
or the ``suppress=`` keyword).
"""

from __future__ import annotations

from .findings import (
    CollectiveSafetyError,
    Finding,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    apply_suppressions,
    errors,
    findings_to_json,
    sort_findings,
    suppressions,
)
from .groups import check_fusion_plan, check_group
from .graph_lint import (
    CollectiveSite,
    collect_collectives,
    lint_sites,
    lint_step,
    record,
)
from .ordering import (
    CollectiveCall,
    check_cross_rank_order,
    record_rank_trace,
    simulate_ranks,
)
from .runtime_lint import (
    AttrRule,
    ClassRule,
    DEFAULT_DISCIPLINE,
    MODULE,
    lint_file,
    lint_runtime,
    lint_source,
)
from .divergence import analyze_divergence, analyze_step
from .plan_verify import verify_plan, verify_plan_grid
from .sharding_rules import normalize_spec, validate_sharding_rules

__all__ = [
    "AttrRule",
    "ClassRule",
    "CollectiveCall",
    "CollectiveSafetyError",
    "CollectiveSite",
    "DEFAULT_DISCIPLINE",
    "Finding",
    "MODULE",
    "SEVERITY_ERROR",
    "SEVERITY_WARNING",
    "analyze_divergence",
    "analyze_step",
    "apply_suppressions",
    "check_cross_rank_order",
    "check_fusion_plan",
    "check_group",
    "collect_collectives",
    "errors",
    "findings_to_json",
    "lint_file",
    "lint_runtime",
    "lint_sites",
    "lint_source",
    "lint_step",
    "normalize_spec",
    "record",
    "record_rank_trace",
    "simulate_ranks",
    "sort_findings",
    "suppressions",
    "validate_sharding_rules",
    "verify_plan",
    "verify_plan_grid",
]
