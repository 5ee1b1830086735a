"""Tensor fusion: bucket planning and the fused allreduce.

The non-streamed half of ``horovod_tpu/ops/fusion.py``. Same-dtype tensors
are packed greedily, in the order given, into buckets of up to the fusion
threshold, and each bucket is reduced by one collective. ``plan_buckets``
is copied rule for rule, so a leaf list in the JAX package's order gives
the same bucket index lists.

The JAX package reduces its gradient pytree in ``jax.tree.leaves`` order,
which walks dicts by sorted key: ``block_0, block_1, block_10, ...,
embeddings, lm_head, ...``. ``tree_order`` gives that order for
``/``- or ``.``-joined parameter names, so the port's buckets match the
reference's and not ``named_parameters()`` order.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..common import env as _env
from ..common.types import ReduceOp
from . import collectives


def default_threshold_bytes(threshold_bytes: Optional[int] = None) -> int:
    """Resolve the fusion threshold: explicit value > HOROVOD_FUSION_THRESHOLD
    env knob > the reference's 64 MB default."""
    if threshold_bytes is not None:
        return int(threshold_bytes)
    return _env._get_int(_env.HOROVOD_FUSION_THRESHOLD, 64 * 1024 * 1024)


def tree_order(names: Sequence[str]) -> List[int]:
    """Indices of ``names`` in the order ``jax.tree.leaves`` visits the same
    paths in a nested dict: sorted level by level."""
    paths = [tuple(re.split(r"[./]", n)) for n in names]
    return sorted(range(len(names)), key=lambda i: paths[i])


def plan_buckets(
    leaves: Sequence[torch.Tensor], threshold_bytes: int
) -> List[List[int]]:
    """Group leaf indices into fusion buckets.

    Same-dtype tensors are packed greedily in submission order up to
    ``threshold_bytes`` per bucket. An oversized leaf (a bucket of its own)
    closes its dtype's active bucket: later same-dtype leaves keep fusing,
    but into a FRESH bucket, so bucket emission order stays monotone in
    submission order.
    """
    buckets: List[List[int]] = []
    # Active bucket per dtype: (bucket_index, bytes_used)
    active: Dict[str, Tuple[int, int]] = {}
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        key = str(leaf.dtype)
        if nbytes >= threshold_bytes:
            buckets.append([i])
            active.pop(key, None)
            continue
        if key in active:
            bidx, used = active[key]
            if used + nbytes <= threshold_bytes:
                buckets[bidx].append(i)
                active[key] = (bidx, used + nbytes)
                continue
        buckets.append([i])
        active[key] = (len(buckets) - 1, nbytes)
    return buckets


def pack_bucket(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten and concatenate a same-dtype bucket into one 1-D buffer."""
    return torch.cat([l.reshape(-1) for l in leaves])


def unpack_bucket(
    buf: torch.Tensor, shapes: Sequence[Tuple[int, ...]]
) -> List[torch.Tensor]:
    """Views of ``buf`` with the given shapes, in order."""
    sizes = [torch.Size(s).numel() for s in shapes]
    return [p.view(s) for p, s in zip(torch.split(buf, sizes), shapes)]


def fused_allreduce(
    leaves: Sequence[torch.Tensor],
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    threshold_bytes: Optional[int] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    group: collectives.Group = None,
) -> List[torch.Tensor]:
    """Allreduce every tensor of ``leaves`` with bucket fusion: one
    collective per bucket. Returns the reduced tensors in the input order;
    the inputs are left unchanged. ``threshold_bytes=None`` resolves the
    HOROVOD_FUSION_THRESHOLD knob. ``group`` is the process group to reduce
    over (a mesh axis's, as the JAX package's ``axis_name``; None: every
    rank); Average divides by its size."""
    threshold_bytes = default_threshold_bytes(threshold_bytes)
    results: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for bucket in plan_buckets(leaves, threshold_bytes):
        if len(bucket) == 1:
            i = bucket[0]
            results[i] = collectives.allreduce(
                leaves[i], op=op, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, group=group,
            )
            continue
        reduced = collectives.allreduce_(
            pack_bucket([leaves[i] for i in bucket]), op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, group=group,
        )
        unpacked = unpack_bucket(reduced, [leaves[i].shape for i in bucket])
        for i, r in zip(bucket, unpacked):
            results[i] = r
    return results
