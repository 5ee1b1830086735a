"""Grouped-allreduce / fusion-bucket static checks.

First-class groups (``hvd.grouped_allreduce``) are threshold-exempt: the
coordinator holds every member until the whole group is ready on every
rank, then fuses them into one plan per signature. Two latent hazards are
checkable before submission:

 - **mixed dtypes** split the group into one plan per signature, silently
   breaking the "one collective" expectation (and the fused-buffer
   bandwidth shape) — :data:`RULE_GROUP_DTYPE`;
 - **total size over the fusion-buffer budget** forces a carrier larger
   than the configured fusion buffer, the memory spike runtime fusion was
   designed to avoid — :data:`RULE_GROUP_BUDGET`.

The same check validates fusion bucket plans (``ops/fusion.plan_buckets``)
so a planner regression can never silently produce an over-budget or
mixed-dtype bucket. The port's copy of ``horovod_tpu/analysis/groups.py``;
it reads torch tensors, numpy arrays and ``(dtype, nbytes)`` specs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .findings import (
    Finding,
    RULE_GROUP_BUDGET,
    RULE_GROUP_DTYPE,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
)


def _spec(tensor: Any) -> Tuple[str, int]:
    """(dtype, nbytes) of an array-like or an already-made spec tuple. A
    torch dtype is named as numpy names it (``float32``), so findings read
    alike in both packages."""
    if isinstance(tensor, tuple) and len(tensor) == 2:
        return str(tensor[0]), int(tensor[1])
    import numpy as np
    import torch

    if isinstance(tensor, torch.Tensor):
        return str(tensor.dtype).replace("torch.", ""), tensor.numel() * tensor.element_size()

    dtype = getattr(tensor, "dtype", None)
    shape = getattr(tensor, "shape", None)
    if dtype is None or shape is None:
        arr = np.asarray(tensor)
        dtype, shape = arr.dtype, arr.shape
    size = 1
    for d in shape:
        size *= int(d)
    itemsize = getattr(dtype, "itemsize", None) or np.dtype(dtype).itemsize
    return str(dtype), size * itemsize


def check_group(
    tensors: Sequence[Any],
    *,
    threshold_bytes: Optional[int] = None,
    name: str = "group",
) -> List[Finding]:
    """Lint one declared collective group (tensors, arrays, or
    ``(dtype, nbytes)`` spec tuples)."""
    specs = [_spec(t) for t in tensors]
    findings: List[Finding] = []
    dtypes = sorted({d for d, _ in specs})
    loc = f"group:{name}"
    if len(dtypes) > 1:
        findings.append(
            Finding(
                rule=RULE_GROUP_DTYPE,
                severity=SEVERITY_ERROR,
                message=(
                    f"grouped collective '{name}' mixes dtypes {dtypes}: "
                    "the group will execute as one plan per dtype, not "
                    "one fused collective"
                ),
                location=loc,
                details={"dtypes": dtypes, "members": len(specs)},
            )
        )
    total = sum(nbytes for _, nbytes in specs)
    if threshold_bytes and total > threshold_bytes:
        findings.append(
            Finding(
                rule=RULE_GROUP_BUDGET,
                severity=SEVERITY_WARNING,
                message=(
                    f"grouped collective '{name}' totals {total} bytes, "
                    f"over the {threshold_bytes}-byte fusion-buffer "
                    "budget (groups are threshold-exempt, so the carrier "
                    "allocates the full size at once)"
                ),
                location=loc,
                details={
                    "total_bytes": total,
                    "threshold_bytes": threshold_bytes,
                    "members": len(specs),
                },
            )
        )
    return findings


def check_fusion_plan(
    leaves: Sequence[Any],
    threshold_bytes: int,
    *,
    name: str = "gradients",
) -> List[Finding]:
    """Validate what ``ops/fusion.plan_buckets`` would produce for a
    gradient pytree's leaves: every multi-leaf bucket must be single-dtype
    and within budget. (Single big leaves legally exceed the budget in a
    bucket of their own.)"""
    from ..ops.fusion import plan_buckets

    findings: List[Finding] = []
    buckets = plan_buckets(list(leaves), threshold_bytes)
    for bi, bucket in enumerate(buckets):
        if len(bucket) < 2:
            continue
        members = [leaves[i] for i in bucket]
        findings.extend(
            check_group(
                members,
                threshold_bytes=threshold_bytes,
                name=f"{name}.bucket{bi}",
            )
        )
    return findings
