"""Shared plumbing for shard-stacked parameter layouts (PP's ``[n_stages,
...]`` leading dim over the ``stage`` axis).

The counterpart of ``horovod_tpu/parallel/_stacked.py``. There the whole
``[n, ...]``-stacked tree enters a ``shard_map`` and each device sees its
``[1, ...]`` row; the optimizer state is vmapped over the rows. Here each
rank holds only its row (``utils.convert.stacked_row`` cuts it from a stacked
tree): leaf tensors that require grad, trained in place by a torch optimizer
over those leaves, so the optimizer's state is this rank's row of the
stacked state.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from ..common.types import ReduceOp
from ..ops import collectives, fusion
from ..ops.collectives import Group


def init_stacked_state(make_optimizer: Callable[[Sequence[torch.Tensor]], Any], row: Any):
    """The optimizer of this rank's row: ``make_optimizer`` (a torch
    optimizer's constructor with its hyperparameters bound, e.g. ``lambda ps:
    torch.optim.AdamW(ps, lr=3e-4, weight_decay=1e-4)``) over the row's leaves
    in ``jax.tree.leaves`` order. Its state is the row's state, local to the
    rank, as the JAX package's vmapped ``optimizer.init`` places one state a
    row."""
    return make_optimizer(fusion.tree_leaves(row))


def summed_grads(leaves: Sequence[torch.Tensor], group: Group,
                 n_div: int) -> List[torch.Tensor]:
    """The leaves' gradients summed over ``group`` and divided by ``n_div``.
    A leaf with no gradient counts as zeros (a parameter whose owner is
    another rank's stage). A group of one rank sends nothing."""
    grads = [l.grad if l.grad is not None else torch.zeros_like(l) for l in leaves]
    if collectives.group_rank_size(group)[1] > 1:
        grads = fusion.fused_allreduce(grads, op=ReduceOp.SUM, group=group)
    return [g / n_div for g in grads] if n_div != 1 else grads


def apply_stacked_update(optimizer, row: Any, grads_local: Sequence[torch.Tensor]) -> None:
    """Step the row with ``grads_local`` (already normalized, in the row's
    leaf order): the port's unstack -> ``optimizer.update`` -> restack."""
    for leaf, g in zip(fusion.tree_leaves(row), grads_local):
        leaf.grad = g
    optimizer.step()


def stacked_train_update(optimizer, row: Any, value_and_grad_fn: Callable[[Any], torch.Tensor],
                         data_group: Group) -> torch.Tensor:
    """One update of this rank's row: ``value_and_grad_fn(row)`` returns the
    loss with the row's gradients in ``.grad``; the data-axis gradient sum is
    divided by the data-axis size (the average, as the JAX package divides its
    transpose's psum), then the optimizer steps. Returns the loss."""
    leaves = fusion.tree_leaves(row)
    for leaf in leaves:
        leaf.grad = None
    loss = value_and_grad_fn(row)
    nd = collectives.group_rank_size(data_group)[1]
    apply_stacked_update(optimizer, row, summed_grads(leaves, data_group, nd))
    return loss
