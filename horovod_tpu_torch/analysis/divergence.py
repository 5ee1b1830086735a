"""Pass 4: SPMD rank divergence over recorded steps.

The port's counterpart of ``horovod_tpu/analysis/divergence.py``. The
failure class is the one the Horovod coordinator exists for: ranks of one
group disagreeing about WHETHER to issue a collective. One member takes
the branch with the allreduce, its peers the other, and every rank hangs.
A JAX step's branch is a ``cond`` whose predicate the JAX pass taints from
``axis_index``; a torch step's branch is Python, with no predicate to
taint. So this pass compares what the ranks did instead: the sequences of
collectives each member of a group recorded on it
(:mod:`.graph_lint`'s recorder, every rank running the step). A collective
that some members issue and others do not, or issue in another order or
with another signature, is the finding (:data:`RULE_RANK_DIVERGENCE`),
reported over that group's axes and only those. Divergence over another
axis is fine: every member of the collective's group took the same branch.

The sanctioned seam lints clean by construction: the guard's
``agree_flag`` is an allreduce MAX over the group, after which every
member holds the same flag and takes the same branch. The ranks must really
reduce for that (a fake group would leave each rank its own flag and report
a false divergence), so the recorder agrees each call over its group
through the job's store before issuing it, and issues only the calls the
members agree on: a divergent program runs to its end on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .findings import Finding, RULE_RANK_DIVERGENCE, SEVERITY_ERROR, apply_suppressions
from .graph_lint import COLLECTIVE_PRIMITIVES, P2P, CollectiveSite


def _describe(site: Optional[CollectiveSite]) -> str:
    if site is None:
        return "nothing"
    return f"{COLLECTIVE_PRIMITIVES[site.primitive]} ({site.primitive}, {site.dtype}, " \
           f"{site.nbytes} bytes)"


def analyze_divergence(traces: Mapping[int, Sequence[CollectiveSite]], *,
                       suppress: Optional[Sequence[str]] = None) -> List[Finding]:
    """Compare the recorded sequences (``{rank: sites}``) of the members of
    every group; one finding per group axes and site where the members
    first part ([] when every group's members issued the same calls)."""
    by_group: Dict[Tuple[int, ...], Dict[int, List[CollectiveSite]]] = {}
    axes_of: Dict[Tuple[int, ...], Tuple[str, ...]] = {}
    for rank, sites in traces.items():
        for s in sites:
            if s.primitive in P2P:
                continue
            by_group.setdefault(s.members, {}).setdefault(rank, []).append(s)
            axes_of[s.members] = s.axes
    findings: List[Finding] = []
    seen = set()
    for members in sorted(by_group):
        seqs = {r: by_group[members].get(r, []) for r in members if r in traces}
        length = max(len(v) for v in seqs.values())
        for i in range(length):
            at = {r: (v[i] if i < len(v) else None) for r, v in seqs.items()}
            sigs = {r: (s.signature() if s is not None else None) for r, s in at.items()}
            if len(set(sigs.values())) == 1:
                continue
            first = next(s for s in at.values() if s is not None)
            issuing = sorted(r for r, s in at.items() if s is not None
                             and s.signature() == first.signature())
            others = sorted(set(at) - set(issuing))
            axes = list(axes_of[members])
            key = (tuple(axes), first.location)
            if key not in seen:
                seen.add(key)
                axis = axes if len(axes) > 1 else axes[0]
                findings.append(Finding(
                    rule=RULE_RANK_DIVERGENCE,
                    severity=SEVERITY_ERROR,
                    message=(
                        f"{first.kind} over axis {axis!r} (call {i} on the group of ranks "
                        f"{list(members)}) is issued by ranks {issuing} while ranks {others} "
                        f"issue {', '.join(sorted({_describe(at[r]) for r in others}))} — "
                        f"group members took different branches on a rank-dependent value "
                        f"and would deadlock every rank; agree the predicate first (an "
                        f"allreduce MAX over the axis, the guard skip-agreement pattern) or "
                        f"lift the collective out of the branch"),
                    location=first.location,
                    details={
                        "guard": "rank-dependent branch",
                        "tainted_axes": axes,
                        "collective_axes": axes,
                        "call_index": i,
                        "ranks_issuing": issuing,
                        "ranks_diverging": others,
                    },
                ))
            break
    return apply_suppressions(findings, suppress)


def analyze_step(fn, *args: Any, mesh: Any = None, suppress: Optional[Sequence[str]] = None,
                 timeout_s: float = 30.0, **kwargs: Any) -> List[Finding]:
    """Run ``fn(*args, **kwargs)`` once on every rank of the job under the
    recorder, each collective agreed over its group before it is issued,
    and compare the ranks' records (:func:`analyze_divergence`). Every rank
    calls it and every rank gets the findings."""
    from .graph_lint import gather_traces, record

    with record(mesh, agree=True, timeout_s=timeout_s) as rec:
        fn(*args, **kwargs)
    return analyze_divergence(gather_traces(rec.sites), suppress=suppress)
