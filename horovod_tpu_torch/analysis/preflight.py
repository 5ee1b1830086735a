"""Pre-flight checks (``HOROVOD_TPU_STATIC_CHECKS=1``).

The port of ``horovod_tpu/analysis/preflight.py``. With the knob set, the
entry points run the static checks before their first reduction:

 - ``allreduce_gradients``, ``DistributedOptimizer`` and
   ``make_train_step`` check the gradient tree's fusion-bucket plan and
   that the reduction's group is a group of the step's mesh
   (:func:`check_gradient_tree`), once a plan (the JAX package checks at
   trace time, once a compile);
 - ``DistributedOptimizer(overlap=True)`` checks at its first step that its
   parameters carry the streamed registrations of ONE build
   (:func:`check_overlap_streaming`; without the knob its findings are
   logged as warnings, as in the JAX package);
 - the eager ``grouped_*`` ops check the group's dtypes and size before
   any member is enqueued, and every eager named collective is recorded
   into a per-process submission ledger, which
   :func:`verify_cross_rank_order` diffs across ranks (call it at a
   known-quiet point, on every rank, like a barrier).

:func:`check_sharding_rules` (Pass 5) runs ALWAYS, knob or not, wherever a
rule table places a tree (the composed step, the tensor-parallel decode
step and cache, ``local_params_from_flax``), as the JAX package's composed
path does. :func:`check_guard_skip_agreement` is the guard's rule that
``graph_lint.lint_step`` applies to a recorded step.

Error-severity findings raise :class:`CollectiveSafetyError`; warnings are
logged. The knob is read once and cached: set it before the first
collective. :func:`report` returns the checks' findings and host time.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .findings import CollectiveSafetyError, Finding, SEVERITY_ERROR, errors
from .ordering import CollectiveCall, check_cross_rank_order

logger = logging.getLogger("horovod_tpu_torch")

ENV_KNOB = "HOROVOD_TPU_STATIC_CHECKS"

_enabled_cache: Optional[bool] = None
_ledger_lock = threading.Lock()
_ledger: List[CollectiveCall] = []


def enabled() -> bool:
    """True when HOROVOD_TPU_STATIC_CHECKS is set truthy (cached after the
    first read)."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = os.environ.get(ENV_KNOB, "").strip().lower() in (
            "1", "true", "yes", "on")
    return _enabled_cache


def refresh() -> bool:
    """Read the knob anew (for a process that sets it after its first
    collective); returns :func:`enabled`."""
    global _enabled_cache
    _enabled_cache = None
    return enabled()


def _reset_for_tests(value: Optional[bool] = None) -> None:
    global _enabled_cache
    _enabled_cache = value
    with _ledger_lock:
        _ledger.clear()
    reset_report()


def _raise_or_log(findings: Sequence[Finding]) -> None:
    with _ledger_lock:
        _found.extend(findings)
    errs = errors(findings)
    for f in findings:
        if f.severity != SEVERITY_ERROR:
            logger.warning("static check: %s", f.render())
    if errs:
        raise CollectiveSafetyError(errs)


# The compiled-mode checks run once a plan; what they found, and their host
# time, for :func:`report`.
_checked: set = set()
_found: List[Finding] = []
_host_s = [0.0]


def first_check(key: Tuple) -> bool:
    """True the first time a check sees ``key`` in this process."""
    with _ledger_lock:
        if key in _checked:
            return False
        _checked.add(key)
        return True


def reset_report() -> None:
    """Forget the compiled-mode checks' findings, host time and the plans
    they saw (the next reduction is checked anew)."""
    with _ledger_lock:
        _checked.clear()
        _found.clear()
        _host_s[0] = 0.0


def report() -> Tuple[List[Finding], float]:
    """The findings the pre-flight checks made so far and their host time
    in milliseconds."""
    with _ledger_lock:
        return list(_found), _host_s[0] * 1e3


def _timed(fn):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            with _ledger_lock:
                _host_s[0] += time.perf_counter() - t0
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


# --- compiled-mode checks ---
def _mesh_groups(mesh) -> Dict[int, Tuple[str, ...]]:
    """id(group) -> axes of every axis group of ``mesh`` and of the axis
    tuples flattened on it."""
    out = {id(mesh.get_group(d)): (d,) for d in mesh.mesh_dim_names}
    for axes, g in mesh.__dict__.get("_hvt_flat_groups", {}).items():
        out.setdefault(id(g), tuple(axes))
    return out


def _unbound_groups(group: Any, mesh: Any) -> List[str]:
    """The levels of ``group`` (None: every rank; a group; a tuple of
    groups) that are not groups of ``mesh``, described by their ranks."""
    import torch.distributed as dist

    if mesh is None or group is None:
        return []
    known = _mesh_groups(mesh)
    levels = list(group) if isinstance(group, tuple) else [group]
    flat = getattr(group, "flat", None)
    if flat is not None:
        levels.append(flat)
    return ["ranks " + ",".join(map(str, dist.get_process_group_ranks(g)))
            for g in levels if id(g) not in known and g is not dist.group.WORLD]


@_timed
def check_gradient_tree(grads: Sequence[Any], threshold_bytes: int, group: Any = None,
                        mesh: Any = None) -> None:
    """Pre-flight of a gradient reduction: the fusion bucket plan of
    ``grads`` must be well-formed (``groups.check_fusion_plan``) and, with
    ``mesh``, the reduction's group must be a group of the step's mesh (the
    JAX check that the reduction axis is bound)."""
    from .findings import RULE_UNKNOWN_AXIS
    from .groups import check_fusion_plan

    findings: List[Finding] = []
    for g in _unbound_groups(group, mesh):
        findings.append(Finding(
            rule=RULE_UNKNOWN_AXIS,
            severity=SEVERITY_ERROR,
            message=(f"allreduce_gradients over the group of {g}, which is no axis of the "
                     f"step's mesh (axes: {list(mesh.mesh_dim_names)}) — the reduction would "
                     "run over ranks the step does not shard its batch over"),
            location="preflight:allreduce_gradients",
            details={"group": g, "mesh_axes": list(mesh.mesh_dim_names)},
        ))
    leaves = [t for t in grads if t is not None]
    if leaves:
        findings.extend(check_fusion_plan(leaves, threshold_bytes))
    _raise_or_log(findings)


@_timed
def check_overlap_streaming(registrations: Dict[str, int], n_grad_leaves: int) -> List[Finding]:
    """Lint for ``DistributedOptimizer(overlap=True)``: its parameters must
    carry the streamed registrations of one build
    (``ops/fusion.stream_registrations``), every gradient leaf's. A rebuilt
    step counts once: the new build takes the old one's hooks off. Returns
    warning findings: nothing registered (the stream was closed), or a
    partial registration (leaves whose gradients the stream never
    reduces)."""
    from .findings import RULE_OVERLAP_STREAMING, SEVERITY_WARNING

    findings: List[Finding] = []
    calls = int(registrations.get("calls", 0))
    leaves = int(registrations.get("leaves", 0))
    if calls == 0:
        findings.append(Finding(
            rule=RULE_OVERLAP_STREAMING,
            severity=SEVERITY_WARNING,
            message=("DistributedOptimizer(overlap=True) but no parameter is registered for "
                     "streamed reduction — its stream was closed or never built; the "
                     "backward reduces nothing in flight"),
            location="preflight:DistributedOptimizer",
            details={"registered_calls": 0, "grad_leaves": int(n_grad_leaves)},
        ))
    elif leaves < int(n_grad_leaves):
        findings.append(Finding(
            rule=RULE_OVERLAP_STREAMING,
            severity=SEVERITY_WARNING,
            message=(f"overlap=True with a PARTIAL streaming registration: {leaves} of "
                     f"{n_grad_leaves} gradient leaves were registered — the unregistered "
                     "leaves' gradients are NOT reduced in the backward; register every layer "
                     "or drop overlap=True"),
            location="preflight:DistributedOptimizer",
            details={"registered_leaves": leaves, "grad_leaves": int(n_grad_leaves),
                     "registered_calls": calls},
        ))
    return findings


def check_guard_skip_agreement(stream_calls: int, seam_calls: int,
                               policy: Optional[str] = None) -> List[Finding]:
    """Lint for streamed reduction under the non-finite ``skip`` policy: a
    step that launched streamed groups but never ran the cross-rank
    skip-agreement collective (``guard/nonfinite.agree_flag``) lets ranks
    disagree about whether a step was skipped. ``make_train_step`` and
    ``DistributedOptimizer`` always run the seam; the rule catches
    hand-rolled steps. ``policy=None`` resolves HOROVOD_GUARD_NONFINITE."""
    from ..guard import resolve_policy
    from .findings import RULE_GUARD_SKIP_AGREEMENT

    if resolve_policy(policy) != "skip":
        return []
    if stream_calls <= 0 or seam_calls > 0:
        return []
    return [Finding(
        rule=RULE_GUARD_SKIP_AGREEMENT,
        severity=SEVERITY_ERROR,
        message=("HOROVOD_GUARD_NONFINITE=skip with streamed-overlap reduction but NO "
                 "cross-rank skip-agreement collective was issued — ranks can disagree about "
                 "skipping a step and silently diverge; route the update through "
                 "hvd.DistributedOptimizer / hvd.make_train_step (which run the agreement "
                 "seam), or call guard.nonfinite.agree_flag on your skip flag"),
        location="preflight:guard-skip",
        details={"stream_calls": int(stream_calls), "seam_calls": int(seam_calls)},
    )]


@_timed
def check_sharding_rules(rules: Any, mesh: Any, params: Optional[Dict[str, Sequence[int]]] = None,
                         *, suppress: Optional[Sequence[str]] = None) -> List[Finding]:
    """Pass 5 pre-flight, ALWAYS enforced (not gated on the knob): reject a
    rule table (or a shipped table's name) the mesh (a ``DeviceMesh`` or
    ``{name: size}``) cannot satisfy for the tree of global shapes
    ``params`` before any placement. Error findings raise
    :class:`CollectiveSafetyError` naming the rule and the parameter;
    warnings (a rule sharding a scalar) are logged and returned."""
    from ..parallel.rules import resolve_rules
    from .sharding_rules import validate_sharding_rules

    findings = validate_sharding_rules(resolve_rules(rules), mesh, params, suppress=suppress)
    _raise_or_log(findings)
    return findings


def check_grouped(tensors: Sequence[Any], threshold_bytes: Optional[int], name: str) -> None:
    from .groups import check_group

    _raise_or_log(check_group(tensors, threshold_bytes=threshold_bytes, name=name))


def record_submission(op: str, name: str, process_set_id: int, tensor: Any = None) -> None:
    """Append one eager submission to this process's ledger. A dtype is
    named as numpy names it (``float32``), as in the JAX package's ledger."""
    dtype, shape = "", ()
    if tensor is not None and hasattr(tensor, "dtype"):
        dtype = str(tensor.dtype).replace("torch.", "")
        shape = tuple(int(d) for d in getattr(tensor, "shape", ()))
    with _ledger_lock:
        _ledger.append(CollectiveCall(op=op, name=name, process_set_id=int(process_set_id),
                                      dtype=dtype, shape=shape))


def ledger() -> List[CollectiveCall]:
    with _ledger_lock:
        return list(_ledger)


def clear_ledger() -> None:
    with _ledger_lock:
        _ledger.clear()


def verify_cross_rank_order(allgather_object_fn=None) -> List[Finding]:
    """Gather every rank's ledger and diff the submission orders. Raises
    :class:`CollectiveSafetyError` on a divergence; returns the findings
    ([] when the orders agree)."""
    if allgather_object_fn is None:
        from ..eager import allgather_object as allgather_object_fn
    payload = [(c.op, c.name, c.process_set_id, c.dtype, tuple(c.shape)) for c in ledger()]
    all_payloads = allgather_object_fn(payload, name="hvd.analysis.order")
    traces = {
        r: [CollectiveCall(op=p[0], name=p[1], process_set_id=p[2], dtype=p[3],
                           shape=tuple(p[4])) for p in rank_payload]
        for r, rank_payload in enumerate(all_payloads)
    }
    findings = check_cross_rank_order(traces)
    if errors(findings):
        raise CollectiveSafetyError(errors(findings))
    return findings
