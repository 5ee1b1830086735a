"""Non-finite sentinels around the gradient reduction.

The port's ``horovod_tpu/guard/nonfinite.py``. ``train.py`` applies the
policy (``guard/__init__.py``) around the fused reduction: ``zero``
sanitizes the local gradients before the wire; ``warn`` detects on the
reduced ones; ``skip`` and ``abort`` take a local flag, reach cross-rank
agreement on it with :func:`agree_flag` (one allreduce MAX), and the step
then applies no update on any rank (``abort`` also raises).

The functions take a tensor, or a dict, list or tuple of tensors.
"""

from __future__ import annotations

from typing import Any, List

import torch

from ..common.types import ReduceOp
from ..ops import collectives


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in _leaves(x)]
    return [] if tree is None else [tree]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return None if tree is None else fn(tree)


def local_flag(tree: Any) -> torch.Tensor:
    """1.0 when any float leaf of ``tree`` holds a non-finite value on THIS
    rank, else 0.0 (a float32 scalar, so it can ride an allreduce). The
    leaves share a device. One fused multi-tensor pass, the check of
    PyTorch's gradient scaler, instead of three launches a leaf: its
    unscale multiplies by 1.0, which leaves every value as it was."""
    leaves = [l for l in _leaves(tree) if l.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    found = torch.zeros(1, dtype=torch.float32, device=leaves[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(leaves, found, torch.ones_like(found))
    return found.reshape(())


def sanitize(tree: Any) -> Any:
    """Replace non-finite entries of every float leaf with 0 (policy
    ``zero``). Non-float leaves pass through untouched."""
    def fix(l):
        if not l.is_floating_point():
            return l
        return torch.where(torch.isfinite(l), l, torch.zeros_like(l))

    return _map(fix, tree)


def agree_flag(flag: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Cross-rank agreement on the skip/abort flag: an allreduce MAX over
    the group, so it is 1 on EVERY rank when ANY rank flagged, and no rank
    applies a step another rank skipped. A tuple of groups (an axis tuple,
    or the composed step's data and model groups) agrees over every rank of
    their grid, one MAX a group."""
    if collectives.RECORD is not None:
        collectives.RECORD.seam_calls += 1       # the static checks' skip-agreement rule
    flag = flag.reshape(1)
    for g in (group if isinstance(group, tuple) else (group,)):
        flag = collectives.allreduce(flag, op=ReduceOp.MAX, group=g)
    return flag.reshape(())


def select_on_flag(flag: torch.Tensor, when_set: Any, when_clear: Any) -> Any:
    """Leaf-wise select between two same-structure trees on a scalar flag:
    ``when_set``'s leaves where the flag is set, else ``when_clear``'s."""
    keep = flag > 0
    picked = iter([torch.where(keep, a, b)
                   for a, b in zip(_leaves(when_set), _leaves(when_clear))])
    return _rebuild(when_clear, picked)


def _rebuild(tree: Any, it) -> Any:
    """``tree``'s structure with its leaves taken from ``it`` in
    :func:`_leaves` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return None if tree is None else next(it)
