"""The data-parallel training API: the port's main path.

The counterpart of the main-path functions of ``horovod_tpu/jax/__init__.py``
(``DistributedOptimizer``, ``broadcast_variables``, ``_build_train_step``,
``make_train_step``, ``GradientAccumulator``) in the user-facing shape of
``horovod_tpu/torch/__init__.py``: a wrapper around a torch optimizer whose
``step()`` first averages the gradients across ranks.

The reduction is post hoc: after the backward pass the gradients are packed
into fusion buckets (64 MiB by default) in the JAX package's leaf order and
each bucket is allreduced once (``ops/fusion.py``). Streamed reduction with
per-parameter hooks, the int8 wire, ZeRO-1, the hierarchical allreduce and
the non-finite guard are not ported yet; asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch

from .common import basics
from .common.compression import Compression
from .common.types import ReduceOp
from .ops import collectives, fusion


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


class DistributedOptimizer:
    """Wrap a torch optimizer so that ``step()`` first allreduces the
    gradients of its parameters, then runs the inner step.

    The gradients go through ``fused_allreduce`` in the order the JAX
    package reduces the same tree: sorted by parameter path when
    ``named_parameters`` is given (``fusion.tree_order``), else in the
    optimizer's own parameter order. ``backward_passes_per_step`` is the
    number of ``backward()`` calls whose gradients ``p.grad`` has summed
    before ``step()``; the reduced gradients are divided by it, as the JAX
    package folds the divisor into its update."""

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
        compression=Compression.none,
        op: ReduceOp = ReduceOp.AVERAGE,
        fusion_threshold_bytes: Optional[int] = None,
        backward_passes_per_step: int = 1,
    ):
        if op == ReduceOp.ADASUM:
            raise NotImplementedError("Adasum is not ported yet")
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._threshold = fusion_threshold_bytes
        self.backward_passes_per_step = backward_passes_per_step
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if named_parameters is not None:
            named = list(named_parameters)
            names = [n for n, _ in named]
            if len(names) != len(set(names)):
                raise ValueError("named_parameters contains duplicate parameter names")
            named_ids = {id(p) for _, p in named}
            if any(id(p) not in named_ids for p in params):
                raise ValueError(
                    "named_parameters does not name every parameter of the optimizer"
                )
            wanted = {id(p) for p in params}
            params = [named[i][1] for i in fusion.tree_order(names)
                      if id(named[i][1]) in wanted]
        self._params: List[torch.Tensor] = params

    def __getattr__(self, item):
        # Everything else (param_groups, state_dict, ...) is the inner
        # optimizer's.
        return getattr(self._opt, item)

    def synchronize(self) -> None:
        """Allreduce every gradient in place, fused into buckets."""
        params = [p for p in self._params if p.grad is not None]
        compressed = [self._compression.compress(p.grad) for p in params]
        reduced = fusion.fused_allreduce(
            [c for c, _ in compressed], op=self._op,
            threshold_bytes=self._threshold,
        )
        with torch.no_grad():
            for p, r, (_, ctx) in zip(params, reduced, compressed):
                p.grad.copy_(self._compression.decompress(r, ctx))
                if self.backward_passes_per_step > 1:
                    p.grad.mul_(1.0 / self.backward_passes_per_step)

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite every rank's tensors in place with the root's: a
    ``state_dict`` or a ``named_parameters()`` iterable of ``(name, tensor)``.
    The counterpart of ``broadcast_variables``."""
    items = params.items() if hasattr(params, "items") else params
    for _, p in items:
        collectives.broadcast_(p.detach(), root_rank=root_rank)


def _broadcast_value(value, root_rank: int):
    """A tensor or a Python number, from the root, through the process
    group's device (NCCL takes CUDA tensors only; AdamW keeps its step count
    on the CPU)."""
    if torch.is_tensor(value):
        wire = value.detach().to(basics.device())
        collectives.broadcast_(wire, root_rank=root_rank)
        return wire.to(value.device)
    wire = torch.tensor([float(value)], dtype=torch.float64, device=basics.device())
    collectives.broadcast_(wire, root_rank=root_rank)
    return type(value)(wire.item())


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Overwrite every rank's optimizer state and numeric hyperparameters
    with the root's. A fresh optimizer has no state yet: then only its
    hyperparameters travel, and every rank creates the same zero state at
    its first step (no dummy step moves the parameters)."""
    if isinstance(optimizer, DistributedOptimizer):
        optimizer = optimizer._opt
    state_dict = optimizer.state_dict()
    for entries in [*state_dict["param_groups"], *state_dict["state"].values()]:
        for key, value in entries.items():
            if key != "params" and (torch.is_tensor(value) or isinstance(value, (int, float))):
                entries[key] = _broadcast_value(value, root_rank)
    optimizer.load_state_dict(state_dict)


def make_train_step(
    loss_fn: Callable,
    optimizer,
    *,
    op: Optional[ReduceOp] = None,
    compression=None,
    fusion_threshold_bytes: Optional[int] = None,
    has_aux: bool = False,
    nonfinite: str = "off",
    quantized: bool = False,
    zero1: bool = False,
    overlap: bool = False,
    hierarchical: Any = False,
):
    """Build ``step(params, batch)``: forward, backward, the fused
    allreduce of the gradients, the optimizer update. Returns the loss
    averaged over ranks (and the rank-averaged aux with ``has_aux``).

    ``loss_fn(params, batch)`` returns the loss on this rank's shard of the
    batch (or ``(loss, aux)``); ``params`` is passed through untouched (a
    module, or the tree ``tp_apply`` takes). ``optimizer`` is a plain torch
    optimizer over those parameters, wrapped here with ``op``,
    ``compression`` and ``fusion_threshold_bytes`` (defaults: Average, none,
    the HOROVOD_FUSION_THRESHOLD knob), or a :class:`DistributedOptimizer`
    that already carries them. Parameters are updated in place.

    ``nonfinite``, ``quantized``, ``zero1``, ``overlap`` and
    ``hierarchical`` keep the JAX signature; any setting but the default
    raises ``NotImplementedError``, as those paths are not ported yet."""
    asked = {"nonfinite": nonfinite != "off", "quantized": quantized, "zero1": zero1,
             "overlap": overlap, "hierarchical": hierarchical}
    unported = [name for name, on in asked.items() if on]
    if unported:
        raise NotImplementedError(
            f"make_train_step options not ported yet: {', '.join(unported)}"
        )
    if isinstance(optimizer, DistributedOptimizer):
        if op is not None or compression is not None or fusion_threshold_bytes is not None:
            raise ValueError(
                "op, compression and fusion_threshold_bytes are set on the "
                "DistributedOptimizer already; pass them there"
            )
        dist_opt = optimizer
    else:
        dist_opt = DistributedOptimizer(
            optimizer,
            compression=compression or Compression.none,
            op=ReduceOp.AVERAGE if op is None else op,
            fusion_threshold_bytes=fusion_threshold_bytes,
        )

    def average(t: torch.Tensor) -> torch.Tensor:
        return collectives.allreduce(t.detach(), op=ReduceOp.AVERAGE)

    def step(params, batch):
        dist_opt.zero_grad(set_to_none=True)
        out = loss_fn(params, batch)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        dist_opt.step()
        if has_aux:
            return average(loss), _tree_map(average, aux)
        return average(loss)

    return step


class GradientAccumulator:
    """Local gradient accumulation, parity with ``backward_passes_per_step``:
    accumulate ``n`` microbatch gradients locally, then allreduce once."""

    def __init__(self, n: int):
        self.n = n

    def init(self, grads: Any) -> Any:
        return _tree_map(torch.zeros_like, grads)

    def add(self, acc: Any, grads: Any) -> Any:
        return _tree_map(torch.add, acc, grads)

    def should_reduce(self, step_count: int) -> bool:
        return (step_count + 1) % self.n == 0
