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

``make_train_step(rules=..., mesh=...)`` builds the composed DP×TP step
(``_build_composed_train_step`` of the JAX package): the parameters are this
rank's tensor-parallel shards, the loss runs on them with the model axis
bound, and the gradients reduce over the data axis only.
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
    package folds the divisor into its update. ``group`` is the process
    group the gradients reduce over (None: every rank; the data axis's group
    in the composed DP×TP step), and Average divides by its size."""

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
        compression=Compression.none,
        op: ReduceOp = ReduceOp.AVERAGE,
        fusion_threshold_bytes: Optional[int] = None,
        backward_passes_per_step: int = 1,
        group: collectives.Group = None,
    ):
        if op == ReduceOp.ADASUM:
            raise NotImplementedError("Adasum is not ported yet")
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._threshold = fusion_threshold_bytes
        self._group = group
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
            threshold_bytes=self._threshold, group=self._group,
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
    mesh=None,
    rules: Any = None,
    model_axis: str = "model",
    data_axis: str = "data",
    tp_overlap: Optional[bool] = None,
):
    """Build ``step(params, batch)``: forward, backward, the fused
    allreduce of the gradients, the optimizer update. Returns the loss
    averaged over ranks (and the rank-averaged aux with ``has_aux``).

    ``loss_fn(params, batch)`` returns the loss on this rank's shard of the
    batch (or ``(loss, aux)``); ``params`` is passed through untouched (a
    module, or the tree ``tp_apply`` takes). When ``params`` is a module,
    its floating-point buffers (BatchNorm's running statistics, which its
    forward updated from this rank's shard) are averaged over ranks after
    the update, as the JAX step ``pmean``s the new ``batch_stats`` it
    returns as aux. ``optimizer`` is a plain torch
    optimizer over those parameters, wrapped here with ``op``,
    ``compression`` and ``fusion_threshold_bytes`` (defaults: Average, none,
    the HOROVOD_FUSION_THRESHOLD knob), or a :class:`DistributedOptimizer`
    that already carries them. Parameters are updated in place.

    ``nonfinite``, ``quantized``, ``zero1``, ``overlap`` and
    ``hierarchical`` keep the JAX signature; any setting but the default
    raises ``NotImplementedError``, as those paths are not ported yet.

    ``rules`` (a rule table or a shipped name, ``"gpt"``; see
    ``parallel/rules.py``) switches to the composed DP×TP step on ``mesh``
    (a ``DeviceMesh`` with ``data_axis`` and ``model_axis``), described in
    :func:`_build_composed_train_step`. ``tp_overlap`` (default: the
    ``HOROVOD_TP_OVERLAP`` knob) selects its fused collective-matmul path
    and needs ``rules``."""
    asked = {"nonfinite": nonfinite != "off", "quantized": quantized, "zero1": zero1,
             "overlap": overlap, "hierarchical": hierarchical}
    if rules is not None:
        asked["compression"] = compression is not None
    unported = [name for name, on in asked.items() if on]
    if unported:
        raise NotImplementedError(
            f"make_train_step options not ported yet: {', '.join(unported)}"
        )
    if rules is not None:
        return _build_composed_train_step(
            loss_fn, optimizer, mesh, rules=rules, model_axis=model_axis,
            data_axis=data_axis, op=ReduceOp.AVERAGE if op is None else op,
            fusion_threshold_bytes=fusion_threshold_bytes, has_aux=has_aux,
            tp_overlap=tp_overlap,
        )
    if tp_overlap is not None:
        raise ValueError(
            "tp_overlap selects the fused collective-matmul TP path of the "
            "composed builder — pass rules=... (and a model axis); without "
            "tensor parallelism there is no TP psum to fuse"
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
        if isinstance(params, torch.nn.Module):
            _average_buffers(params)
        if has_aux:
            return average(loss), _tree_map(average, aux)
        return average(loss)

    return step


def _average_buffers(module: torch.nn.Module) -> None:
    """Average a module's floating-point buffers over every rank, in place,
    fused into buckets in the JAX package's leaf order."""
    named = [(n, b) for n, b in module.named_buffers() if b.is_floating_point()]
    if not named:
        return
    buffers = [named[i][1] for i in fusion.tree_order([n for n, _ in named])]
    torch._foreach_copy_(buffers, fusion.fused_allreduce(buffers, op=ReduceOp.AVERAGE))


def _build_composed_train_step(
    loss_fn: Callable,
    optimizer,
    mesh,
    *,
    rules: Any,
    model_axis: str,
    data_axis: str,
    op: ReduceOp,
    fusion_threshold_bytes: Optional[int],
    has_aux: bool,
    tp_overlap: Optional[bool],
):
    """The composed DP×TP step, ``step(params, batch)``.

    ``params`` is this rank's tree of local shards, as
    ``utils.convert.local_params_from_flax`` cuts it by the same ``rules``
    (leaves that require grad; updated in place); ``optimizer`` is a plain
    torch optimizer over those leaves. ``batch`` is the global batch (a
    tensor or a tuple, list or dict of tensors with the batch first), the
    same on every rank; the step takes this rank's rows of it over the data
    axis, as the JAX step's ``P(data)`` in-spec does.

    Each step: at the first call the rules are preflighted against the live
    tree (its whole shapes); the loss runs on the local shards inside
    ``mesh_scope(mesh)`` and ``overlap_scope(tp_overlap)``, so
    ``model_axis="model"`` in the loss resolves to the mesh's model group;
    backward; the gradients are allreduced over the DATA group only, fused
    into buckets in the JAX package's leaf order (the TP conjugates already
    made the replicated leaves' gradients whole and the same on every model
    rank); the optimizer steps on the local shards. Returns the loss
    averaged over data, then model (and the aux so averaged with
    ``has_aux``)."""
    from .parallel import rules as _rules
    from .parallel import tp as _tp

    rules = _rules.resolve_rules(rules)
    if mesh is None:
        raise ValueError("composed mode (rules=...) needs mesh=, a DeviceMesh with "
                         f"axes ({data_axis!r}, {model_axis!r})")
    names = tuple(mesh.mesh_dim_names)
    if model_axis == data_axis:
        raise ValueError(f"model_axis {model_axis!r} cannot also be a data axis")
    for ax in (data_axis, model_axis):
        if ax not in names:
            raise ValueError(
                f"composed mode needs mesh axes ({data_axis!r}, {model_axis!r}); "
                f"mesh has {names}"
            )
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"composed mode reduces SUM/AVERAGE over the data axis; got {ReduceOp(op).name}"
        )
    if isinstance(optimizer, DistributedOptimizer):
        raise ValueError("composed mode wraps a plain torch optimizer itself: its "
                         "gradients reduce over the data axis only")
    data_group, model_group = mesh.get_group(data_axis), mesh.get_group(model_axis)
    n_data = mesh.size(names.index(data_axis))
    d_idx = mesh.get_local_rank(data_axis)
    built: dict = {}

    def rows(t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0]
        if b % n_data:
            raise ValueError(f"batch of {b} does not split over {n_data} data ranks")
        return t[d_idx * (b // n_data):(d_idx + 1) * (b // n_data)]

    def average(t: torch.Tensor) -> torch.Tensor:
        t = collectives.allreduce(t.detach(), op=ReduceOp.AVERAGE, group=data_group)
        return collectives.allreduce(t, op=ReduceOp.AVERAGE, group=model_group)

    def step(params, batch):
        if "opt" not in built:
            specs = _rules.match_partition_rules(rules, params)
            _rules.preflight_rules(rules, mesh, _rules.global_shapes(params, specs, mesh))
            built["opt"] = DistributedOptimizer(
                optimizer, named_parameters=_rules.named_tree_paths(params), op=op,
                fusion_threshold_bytes=fusion_threshold_bytes, group=data_group,
            )
            step.sharding_specs = specs
        dist_opt = built["opt"]
        dist_opt.zero_grad(set_to_none=True)
        with _tp.mesh_scope(mesh), _tp.overlap_scope(tp_overlap):
            out = loss_fn(params, _tree_map(rows, batch))
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        dist_opt.step()
        if has_aux:
            return average(loss), _tree_map(average, aux)
        return average(loss)

    step.sharding_specs = None
    return step


def init_composed_zero1_state(*args, **kwargs):
    """The composed ZeRO-1 optimizer state of the JAX package; not ported
    yet (ROADMAP A7)."""
    raise NotImplementedError("composed ZeRO-1 (init_composed_zero1_state) is not ported yet")


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
