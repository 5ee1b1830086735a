"""Opt-in pre-flight of the eager API (``HOROVOD_TPU_STATIC_CHECKS=1``).

The eager half of ``horovod_tpu/analysis/preflight.py`` (``:40-63,
227-299``). With the knob set:

 - ``grouped_*`` checks the group's dtypes and size before any member is
   enqueued (a bad group would strand peers holding an incomplete group);
 - every eager named collective is recorded into a per-process submission
   ledger, which :func:`verify_cross_rank_order` diffs across ranks (call
   it at a known-quiet point, on every rank, like a barrier), or which the
   ordering lint reads offline.

Error-severity findings raise :class:`CollectiveSafetyError`; warnings are
logged. The knob is read once and cached: set it before the first
collective. The compiled-mode half (the gradient tree's bucket plan at
trace time, sharding rules) is ROADMAP A13.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, List, Optional, Sequence

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


def _reset_for_tests(value: Optional[bool] = None) -> None:
    global _enabled_cache
    _enabled_cache = value
    with _ledger_lock:
        _ledger.clear()


def _raise_or_log(findings: Sequence[Finding]) -> None:
    errs = errors(findings)
    for f in findings:
        if f.severity != SEVERITY_ERROR:
            logger.warning("static check: %s", f.render())
    if errs:
        raise CollectiveSafetyError(errs)


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
