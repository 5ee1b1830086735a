"""The data-parallel training API: the port's main path.

The counterpart of ``horovod_tpu/jax/__init__.py``'s training half
(``DistributedOptimizer``, ``allreduce_gradients``, ``broadcast_variables``,
``_build_train_step``, ``_build_zero1_train_step``, ``make_train_step``,
``GradientAccumulator``) in the user-facing shape of
``horovod_tpu/torch/__init__.py``: a wrapper around a torch optimizer whose
``step()`` first reduces the gradients across ranks.

The reduction, as the options select it:

- post hoc (the default): after the backward pass the gradients are packed
  into fusion buckets (64 MiB by default) in the JAX package's leaf order
  and each bucket is allreduced once (``ops/fusion.py``);
- ``overlap=True``: streamed, group by group from inside the backward
  (``ops/fusion.stream_param_groups``: post-accumulate-grad hooks, a side
  stream on the card), with a smaller first group (``first_bucket_bytes``);
- ``quantized=True``: every float bucket over the int8 ring
  (``ops/quantized.py``), with an error-feedback residual per parameter
  (``error_feedback``, on by default);
- ``zero1=True``: a per-bucket reduce-scatter, the optimizer stepping this
  rank's shards only, the new shards all-gathered (``parallel/zero.py``);
- ``op=Adasum``: the adaptive pairwise reduction per bucket
  (``ops/adasum.py``), post hoc only;
- ``nonfinite``: the guard around the reduction (``guard/``).

The hierarchical allreduce and the options of the composed DP×TP step are
not ported (ROADMAP A7b), nor pinned tunings (A13); asking for them raises
``NotImplementedError``.

``make_train_step(rules=..., mesh=...)`` builds the composed DP×TP step
(``_build_composed_train_step`` of the JAX package): the parameters are this
rank's tensor-parallel shards, the loss runs on them with the model axis
bound, and the gradients reduce over the data axis only.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .common import basics
from .common import env as _env
from .common.compression import Compression
from .common.types import ReduceOp
from .guard import nonfinite as _nf
from .guard import resolve_policy
from .ops import collectives, fusion
from .ops.quantized import EFState, ef_like

_logger = logging.getLogger("horovod_tpu_torch")


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _resolve_quantized(quantized: Optional[bool]) -> bool:
    """The int8-wire knob: explicit argument > ``HOROVOD_QUANTIZED_WIRE``
    (1/true/int8 = on) > off."""
    if quantized is not None:
        return bool(quantized)
    raw = os.environ.get(_env.HOROVOD_QUANTIZED_WIRE, "").strip().lower()
    return raw in ("1", "true", "yes", "on", "int8")


def _check_overlap_rejections(overlap: bool, quantized: bool, op: ReduceOp) -> None:
    if quantized and op not in fusion._QUANTIZABLE_OPS:
        raise ValueError(
            f"quantized=True supports {fusion._QUANTIZABLE_OPS}; got {op} "
            "(per-hop int8 requantization accumulates in f32, which is "
            "only sound for additive reductions)"
        )
    if overlap and op not in fusion._STREAMABLE_OPS:
        raise ValueError(
            f"overlap=True supports elementwise reduce ops {fusion._STREAMABLE_OPS}; "
            f"got {op}"
        )


def _resolve_error_feedback(error_feedback: Optional[bool], quantized: bool) -> bool:
    """Error feedback defaults ON for the flat int8 wire, where the residual
    compensates this rank's quantizer; asking for it without the wire is an
    error, not a silent no-op."""
    if not quantized:
        if error_feedback:
            raise ValueError("error_feedback=True requires quantized=True")
        return False
    return True if error_feedback is None else bool(error_feedback)


def _check_unported(hierarchical: Any = False, tuned: Any = None) -> None:
    """The flat data axis is ported; the hierarchical allreduce and pinned
    tunings are not."""
    if hierarchical in ("auto", "planned"):
        raise NotImplementedError(
            f"hierarchical={hierarchical!r} is not ported yet: the topology compositor's "
            "plan selection is ROADMAP A13, the two-level collectives A7b")
    if hierarchical:
        raise NotImplementedError(
            "hierarchical=True is not ported yet (ROADMAP A7b, the two-level collectives)")
    if tuned is None:
        tuned = os.environ.get(_env.HOROVOD_TUNED_FILE, "") or None
    if tuned not in (None, False):
        raise NotImplementedError("tuned= (pinned offline tunings) is not ported yet "
                                  "(ROADMAP A13)")


def error_feedback_state(opt_state: Any, params: Any) -> EFState:
    """Wrap an optimizer state with a zero error-feedback residual for
    ``params`` (a tensor or a tree of them): the structure the JAX step
    threads. ``DistributedOptimizer`` keeps its residual itself
    (:attr:`DistributedOptimizer.residual`)."""
    return EFState(inner=opt_state, residual=ef_like(params))


def allreduce_gradients(
    grads: List[torch.Tensor],
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    group: collectives.Group = None,
    fusion_threshold_bytes: Optional[int] = None,
    compression=Compression.none,
    hierarchical: Any = False,
    quantized: Optional[bool] = None,
    nonfinite: Optional[str] = None,
) -> List[torch.Tensor]:
    """Fusion-bucketed allreduce of a list of gradients (in the order that
    sets their buckets); returns the reduced list, the inputs unchanged.
    ``quantized`` (None reads ``HOROVOD_QUANTIZED_WIRE``) moves each float
    bucket over the int8 ring, SUM/AVERAGE only, integer buckets exact.
    ``nonfinite`` (None reads ``HOROVOD_GUARD_NONFINITE``): ``zero``
    sanitizes before the wire, ``warn`` logs a non-finite reduced value;
    ``skip`` and ``abort`` act at the step (``DistributedOptimizer``)."""
    _check_unported(hierarchical, False)
    quantized = _resolve_quantized(quantized)
    policy = resolve_policy(nonfinite)
    if quantized:
        if op not in fusion._QUANTIZABLE_OPS:
            raise ValueError("quantized=True supports SUM/AVERAGE reduction only")
        if compression is not Compression.none:
            raise ValueError(
                "quantized=True already compresses the wire to int8; stacking cast "
                "compression would add loss for no bandwidth win")
    if policy == "zero":
        grads = _nf.sanitize(list(grads))
    reduced = _fused(grads, op, group, fusion_threshold_bytes, compression, quantized)
    if policy == "warn":
        _warn_nonfinite(reduced, "reduce")
    return reduced


def _fused(grads, op, group, threshold, compression, quantized) -> List[torch.Tensor]:
    """One fused allreduce through the reduce_fn ``op`` and the wire need."""
    from .ops.adasum import adasum_reduce_fn
    from .ops.quantized import quantized_reduce_fn

    reduce_fn = (adasum_reduce_fn if op == ReduceOp.ADASUM
                 else quantized_reduce_fn("flat") if quantized else None)
    compressed = [compression.compress(g) for g in grads]
    reduced = fusion.fused_allreduce([c for c, _ in compressed], op=op, threshold_bytes=threshold,
                                     group=group, reduce_fn=reduce_fn)
    return [compression.decompress(r, ctx) for r, (_, ctx) in zip(reduced, compressed)]


def _warn_nonfinite(reduced, path: str) -> None:
    if float(_nf.local_flag(reduced)) > 0:
        _logger.warning("non-finite guard: non-finite gradients detected in the %s path "
                        "(policy warn); the update proceeds", path)


class DistributedOptimizer:
    """Wrap a torch optimizer so that ``step()`` first reduces the
    gradients of its parameters over the ranks, then runs the inner step.

    The gradients travel in the order the JAX package reduces the same
    tree: by parameter path when ``named_parameters`` is given
    (``fusion.tree_order``), else in the optimizer's own order.
    ``backward_passes_per_step`` is the number of ``backward()`` calls whose
    gradients ``p.grad`` has summed before ``step()``; the reduced gradients
    are divided by it, as the JAX package folds the divisor into its update.
    ``group`` is the process group the gradients reduce over (None: every
    rank; the data axis's group in the composed DP×TP step), and Average
    divides by its size.

    The options of the JAX ``DistributedOptimizer`` on one data axis:

    - ``overlap`` streams the reduction from inside the backward, group by
      group (``ops/fusion.stream_param_groups``; ``first_bucket_bytes``, or
      HOROVOD_FUSION_FIRST_BUCKET_BYTES, caps the first group). Numerically
      the post-hoc reduction: elementwise reductions commute with the split.
      The groups come from the parameter tree's top-level children, so pass
      ``named_parameters`` for the model's layers to be the children.
    - ``quantized`` (None reads HOROVOD_QUANTIZED_WIRE) moves the float
      buckets over the int8 ring; ``error_feedback`` (default on with it)
      keeps a float32 residual per parameter, rank-local
      (:attr:`residual`), and sends ``g + e``.
    - ``zero1`` shards the optimizer state per streamed bucket over the
      group (``parallel/zero.py``): the gradients reduce-scatter (inside the
      backward with ``overlap``, over the int8 ring with ``quantized``, the
      residual sharded with them), the inner optimizer, rebuilt over this
      rank's shards, steps them, and the new shards are all-gathered into
      the parameters. ``zero1_shards``, if given, must be the group's size.
      The state is :attr:`zero1_state`; the wrapped optimizer keeps none.
    - ``nonfinite`` (None reads HOROVOD_GUARD_NONFINITE): ``zero``
      sanitizes before the wire (per streamed group under ``overlap``),
      ``warn`` logs, ``skip`` agrees a flag across ranks and then leaves the
      parameters, the optimizer state and the residual unchanged on every
      rank (the inner ``step()`` is not called), ``abort`` does the same and
      raises ``HorovodInternalError``.
    - ``op=Adasum`` reduces each bucket adaptively (``ops/adasum.py``), post
      hoc only.

    The combinations the JAX builders refuse raise ``ValueError`` here too.
    Unlike the JAX optax wrapper, ``zero1`` takes error feedback and
    skip/abort: the step here owns the state the JAX wrapper could not
    reach. ``hierarchical`` and ``tuned`` raise ``NotImplementedError``."""

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
        compression=Compression.none,
        op: ReduceOp = ReduceOp.AVERAGE,
        fusion_threshold_bytes: Optional[int] = None,
        backward_passes_per_step: int = 1,
        group: collectives.Group = None,
        *,
        quantized: Optional[bool] = None,
        error_feedback: Optional[bool] = None,
        overlap: bool = False,
        first_bucket_bytes: Optional[int] = None,
        nonfinite: Optional[str] = None,
        zero1: bool = False,
        zero1_shards: Optional[int] = None,
        hierarchical: Any = False,
        tuned: Any = None,
    ):
        _check_unported(hierarchical, tuned)
        quantized = _resolve_quantized(quantized)
        _check_overlap_rejections(overlap, quantized, op)
        if quantized and compression is not Compression.none:
            raise ValueError(
                "quantized=True already compresses the wire to int8; stacking cast "
                "compression would add loss for no bandwidth win")
        if zero1:
            if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
                raise ValueError(
                    f"zero1=True shards the optimizer update over a summed gradient; op "
                    f"must be SUM/AVERAGE, got {ReduceOp(op).name}")
            if compression is not Compression.none:
                raise ValueError(
                    "zero1=True reduce-scatters raw buckets; cast compression has no "
                    "shard form — use quantized=True instead")
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._threshold = fusion_threshold_bytes
        self._first_bucket = first_bucket_bytes
        self._group = group
        self._quantized = quantized
        self._use_ef = _resolve_error_feedback(error_feedback, quantized)
        self._overlap = overlap
        self._policy = resolve_policy(nonfinite)
        if zero1:
            from .parallel import zero as _zero

            _zero._hyperparameters(optimizer)
        self._zero1 = zero1
        self._zero1_shards = zero1_shards
        self.backward_passes_per_step = backward_passes_per_step
        self._stream: Optional[fusion.StreamedReduction] = None
        self._named = named_parameters is not None
        self._bind(list(named_parameters) if named_parameters is not None else None)

    # --- the parameter tree ------------------------------------------------

    def _bind(self, named: Optional[List[Tuple[str, torch.Tensor]]]) -> None:
        """Take the tree the reduction walks: the named parameters nested
        by path, or the optimizer's parameters as a list."""
        params = [p for g in self._opt.param_groups for p in g["params"]]
        if named is not None:
            names = [n for n, _ in named]
            if len(names) != len(set(names)):
                raise ValueError("named_parameters contains duplicate parameter names")
            named_ids = {id(p) for _, p in named}
            if any(id(p) not in named_ids for p in params):
                raise ValueError(
                    "named_parameters does not name every parameter of the optimizer"
                )
            wanted = {id(p) for p in params}
            self._tree: Any = fusion.named_tree([(n, p) for n, p in named if id(p) in wanted])
        else:
            self._tree = params
        self._params: List[torch.Tensor] = fusion.tree_leaves(self._tree)
        self._residual: Dict[int, torch.Tensor] = {}
        self._zero1_state = None
        self._pending: Optional[dict] = None
        if self._stream is not None:
            self._stream.remove()
            self._stream = None
        if self._overlap:
            self._stream = fusion.stream_param_groups(
                self._tree, self._reduce_group, threshold_bytes=self._threshold,
                first_bucket_bytes=self._first_bucket,
                backward_passes=self.backward_passes_per_step, group=self._group)
            self._groups = self._stream.groups
        elif self._zero1:
            self._groups = fusion.stream_groups(self._tree, self._threshold, self._first_bucket)

    def bind_module(self, module: torch.nn.Module) -> None:
        """Walk ``module.named_parameters()`` as the tree, when the
        optimizer was built without names (``make_train_step`` calls this
        at its first step, so a module's layers are the streamed groups)."""
        if not self._named:
            self._named = True
            self._bind(list(module.named_parameters()))

    def __getattr__(self, item):
        # Everything else (param_groups, state_dict, ...) is the inner
        # optimizer's.
        return getattr(self._opt, item)

    @property
    def zero1_state(self):
        """This rank's ``parallel.zero.Zero1State`` (zero1 only), built
        from the parameters at first use."""
        if self._zero1 and self._zero1_state is None:
            from .parallel import zero as _zero

            self._zero1_state = _zero.init_zero1_stream_state(
                self._opt, self._tree, self._zero1_shards, group=self._group,
                threshold_bytes=self._threshold, first_bucket_bytes=self._first_bucket,
                quantized=self._quantized, error_feedback=self._use_ef)
        return self._zero1_state

    @property
    def residual(self) -> List[torch.Tensor]:
        """The error-feedback residual of each parameter, in the reduction
        order (zeros until the first quantized step)."""
        return [self._residual_of(p) for p in self._params]

    def _residual_of(self, p: torch.Tensor) -> torch.Tensor:
        if id(p) not in self._residual:
            self._residual[id(p)] = ef_like(p)
        return self._residual[id(p)]

    # --- the reduction -------------------------------------------------------

    @property
    def streamed_groups(self) -> Tuple[int, int, int]:
        """(groups the hooks launched inside the last step's backward, those
        of them launched while another group's gradients were still to come,
        groups in all), for ``overlap``; (0, 0, 0) post hoc."""
        if self._stream is None:
            return 0, 0, 0
        return (self._stream.last_launched_in_backward, self._stream.last_launched_early,
                len(self._stream.groups))

    def _reduce_group(self, gi: int, grads: List[torch.Tensor]):
        """Reduce group ``gi``'s gradients (the streamed groups' order;
        post hoc, ``gi`` is None and ``grads`` every gradient). Returns
        ``(reduced, new_residual)``: the gradients, or under zero1 this
        rank's ``{"b<i>": shard}``."""
        if self._policy == "zero":
            grads = _nf.sanitize(grads)
        if self._zero1:
            state = self.zero1_state
            ef = None if state.ef is None else state.ef[f"g{gi}"]
            if ef is not None and self._policy == "zero" and self._overlap:
                ef = _nf.sanitize(ef)
            return fusion.fused_reduce_scatter(
                grads, op=self._op, group=self._group, threshold_bytes=self._threshold,
                quantized=self._quantized, ef=ef)
        if self._use_ef:
            params = self._params if gi is None else self._groups[gi]
            ef = [self._residual_of(p) for p in params]
            if self._policy == "zero" and self._overlap:
                ef = _nf.sanitize(ef)
            return fusion.quantized_ef_allreduce(grads, ef, op=self._op, group=self._group,
                                                 threshold_bytes=self._threshold)
        return _fused(grads, self._op, self._group, self._threshold, self._compression,
                      self._quantized), None

    def synchronize(self) -> None:
        """Reduce every gradient: finish the streamed groups, or reduce post
        hoc. The replicated paths write the reduced gradients (divided by
        ``backward_passes_per_step``) into ``p.grad``; zero1 keeps this
        rank's reduced shards for ``step()``."""
        params = self._params
        pre = None
        if self._policy in ("skip", "abort") and not self._overlap and not self._zero1:
            # Pre-reduce local detection: catches a bad local gradient even
            # under MIN/MAX, where NaN may not propagate.
            pre = _nf.local_flag([p.grad for p in params if p.grad is not None])
        if self._stream is not None:
            parts = list(zip(self._groups, self._stream.finish()))
        elif self._zero1:
            parts = [(g, self._reduce_group(gi, [_grad(p) for p in g]))
                     for gi, g in enumerate(self._groups)]
        else:
            present = [p for p in params if p.grad is not None or self._use_ef]
            parts = [(present, self._reduce_group(None, [_grad(p) for p in present]))]
        scale = 1.0 / self.backward_passes_per_step
        self._pending = {"pre": pre, "parts": parts}
        if self._zero1:
            return
        with torch.no_grad():
            for group_params, (reduced, _) in parts:
                for p, r in zip(group_params, reduced):
                    if p.grad is None:
                        p.grad = r.clone()
                    else:
                        p.grad.copy_(r)
                    if scale != 1.0:
                        p.grad.mul_(scale)

    def _agreed_skip(self) -> bool:
        """Apply the guard to the pending reduction: log under ``warn``;
        under ``skip``/``abort`` agree across ranks whether to skip."""
        if self._policy not in ("warn", "skip", "abort"):
            return False
        reduced = [r for _, (red, _) in self._pending["parts"] for r in
                   (red.values() if isinstance(red, dict) else red)]
        if self._policy == "warn":
            _warn_nonfinite(reduced, "zero1" if self._zero1 else
                            "overlap" if self._overlap else "reduce")
            return False
        post = _nf.local_flag(reduced)
        pre = self._pending["pre"]
        flag = post if pre is None else torch.maximum(pre.to(post.device), post)
        return float(_nf.agree_flag(flag.to(basics.device()), self._group)) > 0

    def step(self, closure=None):
        if self._pending is None:
            self.synchronize()
        try:
            skip = self._agreed_skip()
            if skip:
                if self._policy == "abort":
                    raise basics.HorovodInternalError(
                        "non-finite gradient guard (policy abort): a rank produced NaN/Inf "
                        "gradients this step; the update was not applied on any rank "
                        "(cross-rank agreed)")
                _logger.warning("non-finite guard: skipping this optimizer step on every "
                                "rank (cross-rank agreed)")
                return None
            parts = self._pending["parts"]
            if self._zero1:
                return self._zero1_step(parts)
            out = self._opt.step(closure)
            if self._use_ef:
                for group_params, (_, new_ef) in parts:
                    for p, e in zip(group_params, new_ef):
                        self._residual[id(p)] = e
            return out
        finally:
            self._pending = None

    def _zero1_step(self, parts) -> None:
        from .parallel import zero as _zero

        state = self.zero1_state
        scale = 1.0 / self.backward_passes_per_step
        reduced = {}
        for gi, (_, (shards, new_ef)) in enumerate(parts):
            reduced[f"g{gi}"] = {k: v * scale if scale != 1.0 else v for k, v in shards.items()}
            if new_ef is not None:
                state.ef[f"g{gi}"] = new_ef
        _zero.zero1_stream_update(
            state, self._tree, reduced, group=self._group, n_shards=self._zero1_shards,
            threshold_bytes=self._threshold, first_bucket_bytes=self._first_bucket,
            quantized=self._quantized)


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


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
    nonfinite: Optional[str] = None,
    quantized: Optional[bool] = None,
    error_feedback: Optional[bool] = None,
    zero1: bool = False,
    overlap: bool = False,
    first_bucket_bytes: Optional[int] = None,
    hierarchical: Any = False,
    tuned: Any = None,
    mesh=None,
    rules: Any = None,
    model_axis: str = "model",
    data_axis: str = "data",
    tp_overlap: Optional[bool] = None,
):
    """Build ``step(params, batch)``: forward, backward, the reduction of
    the gradients, the optimizer update. Returns the loss averaged over
    ranks (and the rank-averaged aux with ``has_aux``).

    ``loss_fn(params, batch)`` returns the loss on this rank's shard of the
    batch (or ``(loss, aux)``); ``params`` is passed through untouched (a
    module, or the tree ``tp_apply`` takes). When ``params`` is a module,
    its floating-point buffers (BatchNorm's running statistics, which its
    forward updated from this rank's shard) are averaged over ranks after
    the update, as the JAX step ``pmean``s the new ``batch_stats`` it
    returns as aux. Parameters are updated in place.

    ``optimizer`` is a plain torch optimizer over those parameters, wrapped
    here in a :class:`DistributedOptimizer` with ``op``, ``compression``,
    ``fusion_threshold_bytes`` and the data-axis options (``overlap``,
    ``first_bucket_bytes``, ``quantized``, ``error_feedback``, ``zero1``,
    ``nonfinite``; see there), or a :class:`DistributedOptimizer` that
    already carries them. A plain optimizer's parameters are walked by the
    module's parameter names (the JAX package's leaf order and top-level
    children) when ``params`` is a module. With ``nonfinite="abort"`` the
    step raises ``HorovodInternalError`` when any rank's gradients were not
    finite; the update is applied on no rank.

    ``hierarchical`` and ``tuned`` keep the JAX signature and raise
    ``NotImplementedError`` (ROADMAP A7b and A13).

    ``rules`` (a rule table or a shipped name, ``"gpt"``; see
    ``parallel/rules.py``) switches to the composed DP×TP step on ``mesh``
    (a ``DeviceMesh`` with ``data_axis`` and ``model_axis``), described in
    :func:`_build_composed_train_step`; its data-axis options are not
    ported (ROADMAP A7b). ``tp_overlap`` (default: the
    ``HOROVOD_TP_OVERLAP`` knob) selects its fused collective-matmul path
    and needs ``rules``."""
    variants = {"nonfinite": nonfinite not in (None, "off"), "quantized": bool(quantized),
                "error_feedback": bool(error_feedback), "zero1": zero1, "overlap": overlap,
                "first_bucket_bytes": first_bucket_bytes is not None}
    if rules is not None:
        asked = [name for name, on in {**variants, "hierarchical": bool(hierarchical),
                                       "compression": compression is not None}.items() if on]
        if asked:
            raise NotImplementedError(
                f"make_train_step options of the composed step not ported yet: "
                f"{', '.join(asked)} (ROADMAP A7b)")
        _check_unported(False, tuned)
        return _build_composed_train_step(
            loss_fn, optimizer, mesh, rules=rules, model_axis=model_axis,
            data_axis=data_axis, op=ReduceOp.AVERAGE if op is None else op,
            fusion_threshold_bytes=fusion_threshold_bytes, has_aux=has_aux,
            tp_overlap=tp_overlap,
        )
    if hierarchical:
        raise NotImplementedError(
            f"make_train_step options not ported yet: hierarchical={hierarchical!r} "
            "(ROADMAP A7b; 'auto'/'planned' plan selection A13)")
    if tp_overlap is not None:
        raise ValueError(
            "tp_overlap selects the fused collective-matmul TP path of the "
            "composed builder — pass rules=... (and a model axis); without "
            "tensor parallelism there is no TP psum to fuse"
        )
    if isinstance(optimizer, DistributedOptimizer):
        _check_unported(False, tuned)
        if (op is not None or compression is not None or fusion_threshold_bytes is not None
                or any(variants.values()) or quantized is not None):
            raise ValueError(
                "op, compression, fusion_threshold_bytes and the data-axis options are "
                "set on the DistributedOptimizer already; pass them there"
            )
        dist_opt = optimizer
    else:
        dist_opt = DistributedOptimizer(
            optimizer,
            compression=compression or Compression.none,
            op=ReduceOp.AVERAGE if op is None else op,
            fusion_threshold_bytes=fusion_threshold_bytes,
            quantized=quantized, error_feedback=error_feedback, overlap=overlap,
            first_bucket_bytes=first_bucket_bytes, nonfinite=nonfinite, zero1=zero1,
            tuned=tuned,
        )

    def average(t: torch.Tensor) -> torch.Tensor:
        return collectives.allreduce(t.detach(), op=ReduceOp.AVERAGE)

    def step(params, batch):
        if isinstance(params, torch.nn.Module):
            dist_opt.bind_module(params)
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
    yet (ROADMAP A7b)."""
    raise NotImplementedError(
        "composed ZeRO-1 (init_composed_zero1_state) is not ported yet (ROADMAP A7b)")


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
