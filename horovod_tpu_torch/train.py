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
- ``nonfinite``: the guard around the reduction (``guard/``);
- ``hierarchical=True``: every bucket two-level over a ``(cross, local)``
  tuple of groups (``HOROVOD_HIERARCHICAL_ALLREDUCE``: reduce-scatter in
  the node, allreduce of the shard across nodes, all-gather in the node;
  ``topo/compositor.py``), with the options above: the int8 wire on the
  cross level only, ZeRO-1's reduce-scatter and all-gather two-level,
  Adasum between node sums. ``make_train_step(mesh=..., hierarchical=True)``
  takes the groups from a ``build_hierarchical_mesh`` mesh;
- ``hierarchical="auto"`` on a mesh with a (pod,) cross, local hierarchy,
  or ``"planned"``: plan selection, each bucket priced on the
  interconnect model of the groups it reduces over
  (``topo/compositor.auto_reduce_fn``) and lowered flat, two-level or
  split (with ``quantized``: int8 on every level or on the outermost
  only); ``topo_algorithm`` pins one lowering. ``"auto"`` on a flat mesh
  is flat.

``tuned`` (a ``tune.TunedConfig``, a ``tuned.json`` path, or None for the
``HOROVOD_TUNED_FILE`` knob) applies a pinned offline tuning
(``horovod_tpu_torch/tune``) when the live step's signature matches it:
the pin's fusion threshold, first bucket, wire and topology choice fill
every knob the caller left unset; a stale pin warns and runs untuned.

``make_train_step(rules=..., mesh=...)`` builds the composed DP×TP step
(``_build_composed_train_step`` of the JAX package): the parameters are this
rank's tensor-parallel shards, the loss runs on them with the model axis
bound, and the gradients reduce over the data axis only, with the data-axis
options above (a ``(cross, local)`` data scope too).

``make_decode_step`` is the serving half: the batched one-token greedy
decode over a paged KV cache (``models/transformer.tp_decode_apply``),
dense or tensor-parallel by the same rule tables.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from . import trace as _trace
from . import tune as _tune
from .analysis import preflight as _preflight
from .common import basics
from .common import env as _env
from .common.compression import Compression
from .common.types import ReduceOp
from .guard import nonfinite as _nf
from .guard import _count, record_guard_event, resolve_policy
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


def _resolve_error_feedback(error_feedback: Optional[bool], quantized: bool,
                            hierarchical: bool = False) -> bool:
    """Error feedback defaults ON for the flat int8 wire, where the residual
    compensates this rank's quantizer, and OFF for the hierarchical wire
    (int8 on the cross level only: the quantizer sees post-local-reduction
    shards no per-rank residual can attribute); forcing it where it cannot
    act is an error, not a silent no-op."""
    if not quantized:
        if error_feedback:
            raise ValueError("error_feedback=True requires quantized=True")
        return False
    if hierarchical:
        if error_feedback:
            raise ValueError(
                "error feedback compensates the flat int8 ring; the hierarchical DCN-only "
                "wire has no per-rank quantizer to compensate — leave error_feedback unset")
        return False
    return True if error_feedback is None else bool(error_feedback)


def _resolve_hierarchical(hierarchical: Any, mesh=None) -> Tuple[Any, Optional[Tuple[str, ...]]]:
    """The tri-state ``hierarchical`` knob, as the JAX package resolves it:
    ``(mode, axes)`` with mode False, True (the forced two-level lowering)
    or ``"planned"`` (per-bucket plan selection), and ``axes`` the mesh's
    hierarchy axis tuple in planned mode when it decided (else None).
    ``"auto"`` with a mesh: its (pod,) cross, local axes make it planned, a
    flat mesh keeps it flat; without a mesh, the detected process
    topology's homogeneity-gated model decides (``topo.resolve_model``)."""
    if hierarchical == "auto":
        if mesh is not None:
            from .parallel.mesh import hierarchy_axes

            axes = hierarchy_axes(mesh)
            return ("planned", axes) if axes else (False, None)
        from .parallel.mesh import CROSS_AXIS, LOCAL_AXIS
        from .topo import resolve_model

        if resolve_model().eligible:
            return "planned", (CROSS_AXIS, LOCAL_AXIS)
        return False, None
    if hierarchical == "planned":
        return "planned", None
    return bool(hierarchical), None


def _check_hierarchy_group(group: Any, hierarchical: Any = True) -> None:
    """``hierarchical=True`` reduces over a ``(cross, local)`` pair of
    groups, the JAX package's axis tuple; planned mode over a tuple of two
    or more levels, outermost first."""
    planned = hierarchical == "planned"
    if not (isinstance(group, tuple) and (len(group) >= 2 if planned else len(group) == 2)):
        raise ValueError(
            f"hierarchical={hierarchical!r} needs a (cross, local) axis tuple, got {group!r}: "
            "pass group=parallel.mesh.axis_groups(mesh, ('cross', 'local')), or "
            "make_train_step(..., mesh=build_hierarchical_mesh(local_size), "
            f"hierarchical={hierarchical!r})")


def _tuned_knobs(cfg, caller: Dict[str, Any]) -> Dict[str, Any]:
    """The step knobs a matched pin gives, under the caller's explicit
    ones: every knob the caller left at its default (None, or False for
    ``hierarchical``) takes the pin's value (``tune.tuned_step_kwargs``)."""
    tk = _tune.tuned_step_kwargs(cfg)
    out = dict(caller)
    for k in ("fusion_threshold_bytes", "first_bucket_bytes", "quantized", "topo_algorithm"):
        if k in out and out[k] is None:
            out[k] = tk[k]
    if out.get("hierarchical", None) is False:
        out["hierarchical"] = tk["hierarchical"]
    return out


def _select_reduce_fn(op: ReduceOp, hierarchical: Any, quantized: bool,
                      topo_algorithm: Optional[str] = None):
    """A bucket's reduction, post hoc and streamed alike: Adasum (between
    node sums over a (cross, local) pair), the compositor's per-bucket plan
    (planned mode; ``topo_algorithm`` pins one), the int8 wire (on the
    cross level only when hierarchical), the two-level allreduce, or None,
    the flat allreduce."""
    from .ops.adasum import adasum_reduce_fn
    from .ops.quantized import quantized_reduce_fn

    if op == ReduceOp.ADASUM:
        return adasum_reduce_fn
    if hierarchical == "planned":
        from .topo import compositor

        return compositor.auto_reduce_fn(quantized=quantized, algorithm=topo_algorithm)
    if quantized:
        return quantized_reduce_fn("two-level" if hierarchical else "flat")
    return fusion._hier_reduce_fn if hierarchical else None


def collective_plan(collective: str = "allreduce", nbytes: int = 4 * 1024 * 1024,
                    op: Optional[ReduceOp] = None, wire_dtype: str = "f32") -> dict:
    """The training API's alias of :func:`horovod_tpu_torch.collective_plan`:
    the compositor's selected plan for one collective at one payload size
    (``wire_dtype="int8"``: the int8 wire's price)."""
    from .eager import collective_plan as _collective_plan

    return _collective_plan(collective, nbytes, op, wire_dtype=wire_dtype)


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
    topo_algorithm: Optional[str] = None,
) -> List[torch.Tensor]:
    """Fusion-bucketed allreduce of a list of gradients (in the order that
    sets their buckets); returns the reduced list, the inputs unchanged.
    ``quantized`` (None reads ``HOROVOD_QUANTIZED_WIRE``) moves each float
    bucket over the int8 ring, SUM/AVERAGE only, integer buckets exact.
    ``nonfinite`` (None reads ``HOROVOD_GUARD_NONFINITE``): ``zero``
    sanitizes before the wire, ``warn`` logs a non-finite reduced value;
    ``skip`` and ``abort`` act at the step (``DistributedOptimizer``).
    ``hierarchical=True`` reduces two-level over ``group``, a ``(cross,
    local)`` pair of groups (with ``quantized``: int8 on the cross level
    only); ``"planned"`` (or ``"auto"`` on an eligible detected topology)
    selects a plan per bucket over ``group``, and ``topo_algorithm`` pins
    one."""
    hierarchical, _ = _resolve_hierarchical(hierarchical)
    if hierarchical:
        _check_hierarchy_group(group, hierarchical)
    quantized = _resolve_quantized(quantized)
    policy = resolve_policy(nonfinite)
    if _preflight.enabled():
        # The JAX package checks at trace time, once a compile: here once
        # a plan (the tree's shapes and dtypes, the threshold, the group).
        threshold = fusion.default_threshold_bytes(fusion_threshold_bytes)
        if _preflight.first_check(("allreduce_gradients", threshold, id(group),
                                   tuple((tuple(g.shape), g.dtype) for g in grads))):
            _preflight.check_gradient_tree(grads, threshold, group)
    if quantized:
        if op not in fusion._QUANTIZABLE_OPS:
            raise ValueError("quantized=True supports SUM/AVERAGE reduction only")
        if compression is not Compression.none:
            raise ValueError(
                "quantized=True already compresses the wire to int8; stacking cast "
                "compression would add loss for no bandwidth win")
    if policy == "zero":
        grads = _nf.sanitize(list(grads))
    reduced = _fused(grads, op, group, fusion_threshold_bytes, compression,
                     _select_reduce_fn(op, hierarchical, quantized, topo_algorithm), "posthoc",
                     _wire_label(quantized, hierarchical))
    if policy == "warn":
        _warn_nonfinite(reduced, "reduce")
    return reduced


def _wire_label(quantized: bool, hierarchical: Any) -> str:
    """The wire dtype the fusion layer prices a reduction at: a planned
    reduction records its own int8 wire, as the JAX package's does."""
    return "int8" if quantized and hierarchical != "planned" else "f32"


def _fused(grads, op, group, threshold, compression, reduce_fn, label: str,
           wire_dtype: str) -> List[torch.Tensor]:
    """One fused allreduce through ``reduce_fn`` (``_select_reduce_fn``'s);
    ``label`` names the fusion path in the taps, ``wire_dtype`` prices its
    bytes."""
    compressed = [compression.compress(g) for g in grads]
    reduced = fusion.fused_allreduce([c for c, _ in compressed], op=op, threshold_bytes=threshold,
                                     group=group, reduce_fn=reduce_fn, label=label,
                                     wire_dtype=wire_dtype)
    return [compression.decompress(r, ctx) for r, (_, ctx) in zip(reduced, compressed)]


def _warn_nonfinite(reduced, path: str) -> None:
    if float(_nf.local_flag(reduced)) > 0:
        _count("hvd_guard_nonfinite_total", policy="warn", path=path)
        record_guard_event("nonfinite-warn", path)
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
    divides by its size. A tuple of groups (``parallel.mesh.axis_groups``,
    outermost first) is the JAX package's axis tuple: the reduction runs
    flat over its flattened group, and ZeRO-1 two-level.

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
    - ``hierarchical=True`` (``group`` a ``(cross, local)`` pair) reduces
      every bucket two-level, post hoc or streamed; with ``quantized`` the
      int8 wire runs on the cross level only and error feedback is off; with
      Adasum the node sums combine across nodes.
    - ``hierarchical="planned"`` (``group`` a tuple of levels, outermost
      first; ``"auto"`` resolves to it where the detected topology is an
      eligible grid) selects each bucket's plan on the interconnect model
      of ``group`` (flat, two-level or split; with ``quantized`` the int8
      ring or int8 on the outermost level only, error feedback off);
      ``topo_algorithm`` pins one lowering where the planner offers it.
      :attr:`selected_plans` reads what was selected.

    The combinations the JAX builders refuse raise ``ValueError`` here too,
    ``zero1`` with ``hierarchical`` among them: a two-level ZeRO-1 is
    ``make_train_step(zero1=True, hierarchical=True, mesh=...)``, or a
    tuple ``group`` here. Unlike the JAX optax wrapper, ``zero1`` takes
    error feedback and skip/abort: the step here owns the state the JAX
    wrapper could not reach.

    ``tuned`` (a ``tune.TunedConfig``, a ``tuned.json`` path, None for
    ``HOROVOD_TUNED_FILE``, or False) is matched on the params half of its
    signature only (the optimizer sees no mesh), once: on the first named
    tree it binds (``named_parameters`` or ``bind_module``), or an unnamed
    parameter list it matches, else at the first ``step()``; a match fills
    the knobs left unset (threshold, first bucket, ``quantized``,
    ``hierarchical``, ``topo_algorithm``), a mismatch warns and keeps
    them. With ``zero1`` the pin is ignored with the JAX optax wrapper's
    warning: the sharded state is keyed by the knobs it was built with."""

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
        topo_algorithm: Optional[str] = None,
    ):
        self._caller_knobs = {
            "fusion_threshold_bytes": fusion_threshold_bytes,
            "first_bucket_bytes": first_bucket_bytes, "quantized": quantized,
            "hierarchical": hierarchical, "topo_algorithm": topo_algorithm,
            "error_feedback": error_feedback}
        if zero1:
            if tuned not in (None, False):
                _logger.warning(
                    "DistributedOptimizer(zero1=True) ignores tuned=: the sharded state "
                    "layout is keyed by the knobs the state was built with — apply "
                    "tunings via make_train_step(zero1=True, tuned=...)")
            self._tuned_cfg, self._tuned_source = None, "none"
        else:
            self._tuned_cfg, self._tuned_source = _tune.resolve_tuned(tuned)
        self._tuned_done = False
        hierarchical, _ = _resolve_hierarchical(hierarchical)
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
            if hierarchical:
                raise ValueError(
                    "DistributedOptimizer(zero1=True) runs over the flat data axis; "
                    "hierarchical zero1 lives in make_train_step(zero1=True, "
                    "hierarchical=True), which owns the mesh")
            if quantized and isinstance(group, tuple) and len(group) > 1:
                raise ValueError(
                    "quantized zero1 runs the flat int8 ring reduce-scatter over ONE axis; "
                    "hierarchical (DCN-only) compression is not defined for the RS+AG "
                    "decomposition — drop hierarchical or quantized")
        if hierarchical:
            _check_hierarchy_group(group, hierarchical)
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._group = group
        # The groups the skip/abort flag is agreed over (the composed step
        # adds the model group).
        self._flag_group = group
        self._set_knobs(fusion_threshold_bytes, first_bucket_bytes, quantized, hierarchical,
                        topo_algorithm, error_feedback)
        self._overlap = overlap
        self._policy = resolve_policy(nonfinite)
        if zero1:
            from .parallel import zero as _zero

            _zero._hyperparameters(optimizer)
        self._zero1 = zero1
        self._zero1_shards = zero1_shards
        self.backward_passes_per_step = backward_passes_per_step
        if _trace.ACTIVE:
            # Step-span correlation ids for every step this optimizer drives.
            _trace.TAP.note_plan(optimizer="DistributedOptimizer",
                                 wire_dtype="int8" if quantized else "f32",
                                 overlap=bool(overlap), **({"zero1": True} if zero1 else {}))
        self._stream: Optional[fusion.StreamedReduction] = None
        self._closed = False
        # The step's mesh, which make_train_step sets, for the pre-flight;
        # the pre-flight runs at the first reduction only.
        self._mesh = None
        self._preflighted = False
        self._named = named_parameters is not None
        self._bind(list(named_parameters) if named_parameters is not None else None)

    def close(self) -> None:
        """Take the streamed reduction's hooks off the parameters
        (``overlap``) and close the optimizer: a later ``synchronize`` or
        ``step`` raises. Idempotent. A new streamed build over the same
        parameters closes the old one's stream by itself."""
        if self._stream is not None:
            self._stream.remove()
        self._closed = True

    @property
    def closed(self) -> bool:
        """Closed by :meth:`close`, or its stream by a newer build over the
        same parameters."""
        return self._closed or (self._stream is not None and self._stream.closed)

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError(
                "this DistributedOptimizer is closed (close(), or a newer streamed build "
                "over the same parameters took its hooks off them); build the step anew "
                "and call that")

    def _set_knobs(self, threshold, first_bucket, quantized: bool, hierarchical: Any,
                   topo_algorithm: Optional[str], error_feedback: Optional[bool]) -> None:
        self._threshold = threshold
        self._first_bucket = first_bucket
        self._hierarchical = hierarchical
        self._quantized = quantized
        self._reduce_fn = _select_reduce_fn(self._op, hierarchical, quantized, topo_algorithm)
        self._use_ef = _resolve_error_feedback(error_feedback, quantized, bool(hierarchical))

    def _apply_tuned(self, final: bool) -> None:
        """Match the pin on the params half of the bound tree's signature
        and, on a match, take its knobs under the caller's explicit ones.
        An unnamed tree that does not match is decided later (``final``):
        a module's names may still bind, or the first ``step()`` decides."""
        cfg = self._tuned_cfg
        live = _tune.step_signature(self._tree)
        matched = _tune.signatures_match(cfg.signature, live, require_mesh=False)
        if not (matched or final):
            return
        if matched:
            kw = _tuned_knobs(cfg, self._caller_knobs)
            hierarchical, _ = _resolve_hierarchical(kw["hierarchical"])
            if hierarchical == "planned" and not isinstance(self._group, tuple):
                # A plan over levels needs a tuple of groups; a flat group
                # lowers flat whatever the pin's topology choice.
                hierarchical = False
            quantized = _resolve_quantized(kw["quantized"])
            _check_overlap_rejections(self._overlap, quantized, self._op)
            self._set_knobs(kw["fusion_threshold_bytes"], kw["first_bucket_bytes"], quantized,
                            hierarchical, kw["topo_algorithm"] if hierarchical == "planned"
                            else None, kw["error_feedback"])
        else:
            _tune.warn_signature_mismatch(cfg, live.get("hash", "?"), "DistributedOptimizer")
        _tune.note_applied(self._tuned_source, cfg.signature_hash, matched,
                           "DistributedOptimizer")
        self._tuned_done = True

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
        if self._tuned_cfg is not None and not self._tuned_done:
            self._apply_tuned(final=named is not None)
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
    def selected_plans(self) -> Dict[int, str]:
        """Planned mode: bucket bytes -> the allreduce algorithm the
        compositor selected for it, over the steps so far; {} otherwise."""
        return dict(getattr(self._reduce_fn, "selected", {}))

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
                quantized=self._quantized, ef=ef, label=f"zero1:g{gi}")
        if self._use_ef:
            params = self._params if gi is None else self._groups[gi]
            ef = [self._residual_of(p) for p in params]
            if self._policy == "zero" and self._overlap:
                ef = _nf.sanitize(ef)
            return fusion.quantized_ef_allreduce(
                grads, ef, op=self._op, group=self._group, threshold_bytes=self._threshold,
                label="posthoc-ef" if gi is None else f"stream:g{gi}")
        return _fused(grads, self._op, self._group, self._threshold, self._compression,
                      self._reduce_fn, "posthoc" if gi is None else f"stream:g{gi}",
                      _wire_label(self._quantized, self._hierarchical)), None

    def synchronize(self) -> None:
        """Reduce every gradient: finish the streamed groups, or reduce post
        hoc. The replicated paths write the reduced gradients (divided by
        ``backward_passes_per_step``) into ``p.grad``; zero1 keeps this
        rank's reduced shards for ``step()``."""
        self._check_open()
        if not self._preflighted:
            self._preflight()
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

    def _preflight(self) -> None:
        """The first reduction's static checks: with HOROVOD_TPU_STATIC_CHECKS
        the gradient tree's bucket plan and the group against the step's
        mesh; under ``overlap`` the streamed registrations (one build's,
        every leaf), raised or logged with the knob, logged without it."""
        self._preflighted = True
        if _preflight.enabled():
            _preflight.check_gradient_tree(
                self._params, fusion.default_threshold_bytes(self._threshold), self._group,
                self._mesh)
        if self._overlap:
            findings = _preflight.check_overlap_streaming(
                fusion.stream_registrations(self._params), len(self._params))
            if _preflight.enabled():
                _preflight._raise_or_log(findings)
            else:
                for f in findings:
                    _logger.warning("%s", f.render())

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
        skip = float(_nf.agree_flag(flag.to(basics.device()), self._flag_group)) > 0
        if skip:
            path = "zero1" if self._zero1 else "overlap" if self._overlap else "reduce"
            _count("hvd_guard_nonfinite_total", policy=self._policy, path=path)
            if self._policy == "skip":
                _count("hvd_guard_skipped_steps_total")
            record_guard_event(f"nonfinite-{self._policy}", path)
        return skip

    def step(self, closure=None):
        self._check_open()
        if self._tuned_cfg is not None and not self._tuned_done:
            self._apply_tuned(final=True)
        if self._pending is None:
            self.synchronize()
        try:
            skip = self._agreed_skip()
            if skip:
                if self._policy == "abort":
                    if _trace.ACTIVE:
                        # Persist the last moments before the abort unwinds.
                        _trace.TAP.flight_dump("guard-abort")
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
    topo_algorithm: Optional[str] = None,
    mesh=None,
    rules: Any = None,
    model_axis: str = "model",
    data_axis: Any = "data",
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
    ``nonfinite``, ``hierarchical``; see there), or a
    :class:`DistributedOptimizer` that already carries them. A plain
    optimizer's parameters are walked by the module's parameter names (the
    JAX package's leaf order and top-level children) when ``params`` is a
    module. With ``nonfinite="abort"`` the step raises
    ``HorovodInternalError`` when any rank's gradients were not finite; the
    update is applied on no rank. The returned step's ``optimizer`` is the
    :class:`DistributedOptimizer` it steps.

    ``hierarchical=True`` takes the ``(cross, local)`` groups from ``mesh``
    (``parallel.mesh.build_hierarchical_mesh``) and reduces every bucket
    two-level over them; with ``zero1`` the reduce-scatter and the
    all-gather run two-level. ``hierarchical="auto"`` on a mesh with a
    (pod,) cross, local hierarchy (``parallel.mesh.hierarchy_axes``), or
    ``"planned"`` (over (cross, local)), selects each bucket's plan on the
    interconnect model of those groups (:class:`DistributedOptimizer`);
    ``"auto"`` on a flat mesh is flat. With ``zero1`` the hierarchy is the
    reduce-scatter's and the all-gather's, two-level. ``topo_algorithm``
    pins a plan only under plan selection and is otherwise moot, as in the
    JAX package, except ``"split"`` with ``zero1`` (no reduce-scatter form),
    a ``ValueError``.

    ``tuned`` (a ``tune.TunedConfig``, a ``tuned.json`` path, None for the
    ``HOROVOD_TUNED_FILE`` knob, or False) defers the build to the first
    call, as the JAX package does: the live signature (``params``' names,
    shapes and dtypes, and ``mesh``'s axes, ``{"data": world size}``
    without one) is matched against the pin's; a match fills the threshold,
    the first bucket, ``quantized``, ``hierarchical`` and
    ``topo_algorithm`` wherever the caller left them unset (under
    ``zero1`` a ``split`` pin falls back to per-bucket selection), a
    mismatch warns loudly and builds untuned. ``tune.applied_tuned_info``
    and the ``hvd_tuned_info`` gauge record the verdict; ``step.optimizer``
    exists from the first call on. A tuned step is bitwise the step built
    with ``tune.tuned_step_kwargs(cfg)`` by hand. An explicit ``tuned``
    with a :class:`DistributedOptimizer` raises ``ValueError`` (pass it
    there); the env knob is then the optimizer's own to resolve.

    ``rules`` (a rule table or a shipped name, ``"gpt"``; see
    ``parallel/rules.py``) switches to the composed DP×TP step on ``mesh``
    (a ``DeviceMesh`` with ``data_axis`` and ``model_axis``), described in
    :func:`_build_composed_train_step`. ``tp_overlap`` (default: the
    ``HOROVOD_TP_OVERLAP`` knob) selects its fused collective-matmul path
    and needs ``rules``."""
    if isinstance(optimizer, DistributedOptimizer):
        if tuned not in (None, False):
            raise ValueError("tuned= is set on the DistributedOptimizer already; pass it there")
        tuned = False
    tuned_cfg, tuned_source = _tune.resolve_tuned(tuned)
    if rules is not None:
        return _build_composed_train_step(
            loss_fn, optimizer, mesh, rules=rules, model_axis=model_axis,
            data_axis=data_axis, op=ReduceOp.AVERAGE if op is None else op,
            fusion_threshold_bytes=fusion_threshold_bytes, has_aux=has_aux,
            tp_overlap=tp_overlap, compression=compression, hierarchical=hierarchical,
            quantized=quantized, error_feedback=error_feedback, overlap=overlap,
            first_bucket_bytes=first_bucket_bytes, nonfinite=nonfinite,
            topo_algorithm=topo_algorithm, zero1=zero1,
            tuned_cfg=tuned_cfg, tuned_source=tuned_source,
        )
    if tp_overlap is not None:
        raise ValueError(
            "tp_overlap selects the fused collective-matmul TP path of the "
            "composed builder — pass rules=... (and a model axis); without "
            "tensor parallelism there is no TP psum to fuse"
        )
    kwargs = dict(op=op, compression=compression, fusion_threshold_bytes=fusion_threshold_bytes,
                  has_aux=has_aux, nonfinite=nonfinite, quantized=quantized,
                  error_feedback=error_feedback, zero1=zero1, overlap=overlap,
                  first_bucket_bytes=first_bucket_bytes, hierarchical=hierarchical,
                  topo_algorithm=topo_algorithm, mesh=mesh)
    if tuned_cfg is None:
        return _build_train_step(loss_fn, optimizer, **kwargs)

    state: dict = {}

    def dispatch(params, batch):
        if state.get("closed"):
            raise RuntimeError("this train step is closed; build the step anew and call that")
        step = state.get("step")
        if step is None:
            live = _tune.step_signature(params, mesh=_signature_mesh(mesh))
            matched = _tune.signatures_match(tuned_cfg.signature, live)
            kw = dict(kwargs)
            if matched:
                kw = _tuned_knobs(tuned_cfg, kw)
                if kw["zero1"] and kw["topo_algorithm"] == "split":
                    # The split has no reduce-scatter form; zero1 lowers
                    # by the mesh's shape: back to per-bucket selection.
                    kw["topo_algorithm"] = None
            else:
                _tune.warn_signature_mismatch(tuned_cfg, live.get("hash", "?"),
                                              "make_train_step")
            _tune.note_applied(tuned_source, tuned_cfg.signature_hash, matched,
                               "make_train_step")
            step = state["step"] = _build_train_step(loss_fn, optimizer, **kw)
            dispatch.optimizer = step.optimizer
        return step(params, batch)

    def close() -> None:
        """Close the built step (its hooks off the parameters); a later call
        raises."""
        state["closed"] = True
        if state.get("step") is not None:
            state["step"].close()

    dispatch.optimizer = None
    dispatch.close = close
    return dispatch


def _signature_mesh(mesh) -> Any:
    """The mesh half of a live step's signature: the mesh's axes, or a flat
    DP step's ``{"data": world size}``."""
    from .parallel.mesh import DATA_AXIS

    return mesh if mesh is not None else {DATA_AXIS: collectives.group_rank_size(None)[1]}


def _build_train_step(
    loss_fn: Callable,
    optimizer,
    *,
    op: Optional[ReduceOp],
    compression,
    fusion_threshold_bytes: Optional[int],
    has_aux: bool,
    nonfinite: Optional[str],
    quantized: Optional[bool],
    error_feedback: Optional[bool],
    zero1: bool,
    overlap: bool,
    first_bucket_bytes: Optional[int],
    hierarchical: Any,
    topo_algorithm: Optional[str],
    mesh,
):
    """The DP step :func:`make_train_step` describes, for knobs resolved."""
    if zero1 and topo_algorithm == "split":
        raise ValueError(
            "topo_algorithm='split' has no reduce-scatter decomposition; zero1 lowers flat "
            "or two-level by the mesh shape")
    hierarchical, hier_axes = _resolve_hierarchical(hierarchical, mesh)
    # A pinned compositor algorithm reaches the lowering in planned mode
    # only; anywhere else it is moot.
    pin_algorithm = topo_algorithm if hierarchical == "planned" else None
    if isinstance(optimizer, DistributedOptimizer):
        if (op is not None or compression is not None or fusion_threshold_bytes is not None
                or nonfinite not in (None, "off") or quantized is not None or zero1 or overlap
                or error_feedback or first_bucket_bytes is not None or hierarchical):
            raise ValueError(
                "op, compression, fusion_threshold_bytes and the data-axis options are "
                "set on the DistributedOptimizer already; pass them there"
            )
        dist_opt = optimizer
    else:
        # Under zero1 the hierarchy is the group's: the reduce-scatter and
        # the all-gather run two-level over a tuple of groups.
        dist_opt = DistributedOptimizer(
            optimizer,
            compression=compression or Compression.none,
            op=ReduceOp.AVERAGE if op is None else op,
            fusion_threshold_bytes=fusion_threshold_bytes,
            group=_hierarchy_groups(mesh, hier_axes) if hierarchical else None,
            quantized=quantized, error_feedback=error_feedback, overlap=overlap,
            first_bucket_bytes=first_bucket_bytes, nonfinite=nonfinite, zero1=zero1,
            hierarchical=False if zero1 else hierarchical, topo_algorithm=pin_algorithm,
            tuned=False,
        )
    dist_opt._mesh = mesh
    # The loss is averaged over the reduction's ranks (every rank, unless
    # the optimizer reduces over the flattened group of an axis tuple).
    loss_group = getattr(dist_opt._group, "flat", None)

    def average(t: torch.Tensor) -> torch.Tensor:
        return collectives.allreduce(t.detach(), op=ReduceOp.AVERAGE, group=loss_group)

    def step(params, batch):
        dist_opt._check_open()
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

    # The step tap (the JAX step's ``_maybe_trace``): host-side step spans
    # stamped with the step's options and the noted plan ids; with tracing
    # off, ``step`` itself.
    step = _trace.wrap_step(
        step, overlap=dist_opt._overlap, quantized=dist_opt._quantized,
        hierarchical=str(dist_opt._hierarchical),
        wire_dtype="int8" if dist_opt._quantized else "f32")
    step.optimizer = dist_opt
    step.close = dist_opt.close
    return step


def _hierarchy_groups(mesh, axes: Optional[Tuple[str, ...]] = None):
    """The groups of a hierarchical mesh's ``axes`` (default ``(cross,
    local)``), with their flattened group: the axis tuple a hierarchical or
    planned reduction runs over."""
    from .parallel.mesh import CROSS_AXIS, LOCAL_AXIS, axis_groups

    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    if CROSS_AXIS not in names or LOCAL_AXIS not in names:
        raise ValueError(
            "hierarchical=True needs a (cross, local) axis tuple: pass "
            f"mesh=build_hierarchical_mesh(local_size) (mesh axes: {names or None})")
    return axis_groups(mesh, axes or (CROSS_AXIS, LOCAL_AXIS))


def _average_buffers(module: torch.nn.Module) -> None:
    """Average a module's floating-point buffers over every rank, in place,
    fused into buckets in the JAX package's leaf order."""
    named = [(n, b) for n, b in module.named_buffers() if b.is_floating_point()]
    if not named:
        return
    buffers = [named[i][1] for i in fusion.tree_order([n for n, _ in named])]
    torch._foreach_copy_(buffers, fusion.fused_allreduce(buffers, op=ReduceOp.AVERAGE,
                                                         label=None))


def _build_composed_train_step(
    loss_fn: Callable,
    optimizer,
    mesh,
    *,
    rules: Any,
    model_axis: str,
    data_axis: Any,
    op: ReduceOp,
    fusion_threshold_bytes: Optional[int],
    has_aux: bool,
    tp_overlap: Optional[bool],
    compression=None,
    hierarchical: Any = False,
    quantized: Optional[bool] = None,
    error_feedback: Optional[bool] = None,
    overlap: bool = False,
    first_bucket_bytes: Optional[int] = None,
    nonfinite: Optional[str] = None,
    topo_algorithm: Optional[str] = None,
    zero1: bool = False,
    tuned_cfg=None,
    tuned_source: str = "none",
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
    backward; the gradients are reduced over the DATA group only (the TP
    conjugates already made the replicated leaves' gradients whole and the
    same on every model rank), by a :class:`DistributedOptimizer` over the
    data group that the first call builds (``step.optimizer``) with the
    data-axis options; the optimizer steps on the local shards. Returns the
    loss averaged over data, then model (and the aux so averaged with
    ``has_aux``).

    The data-axis options, as the JAX builder has them: ``overlap`` and
    ``first_bucket_bytes`` stream the data-group reduction from the
    backward; ``quantized`` moves it over the flat int8 ring with error
    feedback off; ``zero1`` shards the optimizer state over the data group,
    as :func:`init_composed_zero1_state` builds it; ``nonfinite`` agrees its
    skip/abort flag over the data AND the model groups, so one model rank's
    NaN skips the step on every rank. ``data_axis`` may be an axis tuple,
    ``("cross", "local")``: the reduction then runs flat over the tuple's
    flattened group, and ZeRO-1's two-level. ``hierarchical=True``,
    ``compression``, ``topo_algorithm``, ``error_feedback`` and
    ``quantized`` with a data-axis tuple raise the JAX builder's
    ``ValueError``s. A pinned tuning (``tuned_cfg``, from
    ``make_train_step(tuned=...)``) is matched at the first call on the
    local tree and the mesh and gives the threshold and the first bucket
    only, where the caller left them unset."""
    from .parallel import rules as _rules
    from .parallel import tp as _tp

    rules = _rules.resolve_rules(rules)
    dp_axes = tuple(data_axis) if isinstance(data_axis, (tuple, list)) else (data_axis,)
    if mesh is None:
        raise ValueError("composed mode (rules=...) needs mesh=, a DeviceMesh with "
                         f"axes ({data_axis!r}, {model_axis!r})")
    names = tuple(mesh.mesh_dim_names)
    if model_axis in dp_axes:
        raise ValueError(f"model_axis {model_axis!r} cannot also be a data axis")
    for ax in dp_axes + (model_axis,):
        if ax not in names:
            raise ValueError(
                f"composed mode needs mesh axes ({data_axis!r}, {model_axis!r}); "
                f"mesh has {names}"
            )
    if hierarchical == "auto":
        hierarchical = False        # the explicit axis tuple is the hierarchy
    if hierarchical:
        raise ValueError(
            "composed rules= mode scopes hierarchy to the DP axes EXPLICITLY: pass "
            "data_axis=('cross', 'local') for a two-level DP scope instead of "
            "hierarchical=True — the TP psums must never be re-planned onto DCN, so the knob "
            "that re-plans the whole step is rejected")
    if topo_algorithm is not None:
        raise ValueError(
            "topo_algorithm pins a compositor plan; the composed DP axis lowers flat and TP "
            "psums are never re-planned — drop topo_algorithm")
    if compression not in (None, Compression.none):
        raise ValueError("composed mode rejects cast compression; use quantized=True for the "
                         "DP-axis int8 wire")
    if error_feedback:
        raise ValueError("error feedback rides the single-axis streamed side channel; "
                         "composed mode runs the int8 wire EF-off")
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"composed mode reduces SUM/AVERAGE over the data axis; got {ReduceOp(op).name}"
        )
    quantized = _resolve_quantized(quantized)
    _check_overlap_rejections(overlap, quantized, op)
    if quantized and len(dp_axes) > 1:
        raise ValueError(
            "quantized composed DP runs the flat int8 ring over ONE data axis; the two-level "
            "DP scope has no int8 RS+AG form — drop quantized or the axis tuple")
    if isinstance(optimizer, DistributedOptimizer):
        raise ValueError("composed mode wraps a plain torch optimizer itself: its "
                         "gradients reduce over the data axis only")
    data_group = _data_groups(mesh, dp_axes)
    model_group = mesh.get_group(model_axis)
    d_idx, n_data = collectives.group_rank_size(data_group)
    built: dict = {}

    def rows(t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0]
        if b % n_data:
            raise ValueError(f"batch of {b} does not split over {n_data} data ranks")
        return t[d_idx * (b // n_data):(d_idx + 1) * (b // n_data)]

    def average(t: torch.Tensor) -> torch.Tensor:
        t = collectives.allreduce(t.detach(), op=ReduceOp.AVERAGE,
                                  group=collectives.flat_group(data_group))
        return collectives.allreduce(t, op=ReduceOp.AVERAGE, group=model_group)

    def step(params, batch):
        if built.get("closed"):
            raise RuntimeError("this train step is closed; build the step anew and call that")
        if "opt" not in built:
            threshold, first = fusion_threshold_bytes, first_bucket_bytes
            if tuned_cfg is not None:
                where = "make_train_step(rules=...)"
                live = _tune.step_signature(params, mesh=mesh)
                matched = _tune.signatures_match(tuned_cfg.signature, live)
                if matched:
                    kw = _tuned_knobs(tuned_cfg, {"fusion_threshold_bytes": threshold,
                                                  "first_bucket_bytes": first})
                    threshold, first = kw["fusion_threshold_bytes"], kw["first_bucket_bytes"]
                else:
                    _tune.warn_signature_mismatch(tuned_cfg, live.get("hash", "?"), where)
                _tune.note_applied(tuned_source, tuned_cfg.signature_hash, matched, where)
            specs = _rules.match_partition_rules(rules, params)
            _preflight.check_sharding_rules(rules, mesh,
                                            _rules.global_shapes(params, specs, mesh))
            dist_opt = DistributedOptimizer(
                optimizer, named_parameters=_rules.named_tree_paths(params), op=op,
                fusion_threshold_bytes=threshold, group=data_group,
                quantized=quantized, error_feedback=False, overlap=overlap,
                first_bucket_bytes=first, nonfinite=nonfinite, zero1=zero1, tuned=False,
            )
            dist_opt._mesh = mesh
            # A model rank's NaN must skip the step on every rank of the mesh.
            levels = data_group if isinstance(data_group, tuple) else (data_group,)
            dist_opt._flag_group = (*levels, model_group)
            built["opt"] = traced.optimizer = dist_opt
            traced.sharding_specs = specs
        dist_opt = built["opt"]
        dist_opt._check_open()
        dist_opt.zero_grad(set_to_none=True)
        with _tp.mesh_scope(mesh), _tp.overlap_scope(tp_overlap):
            out = loss_fn(params, _tree_map(rows, batch))
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        dist_opt.step()
        if has_aux:
            return average(loss), _tree_map(average, aux)
        return average(loss)

    traced = _trace.wrap_step(step, overlap=overlap, quantized=bool(quantized),
                              hierarchical=str(hierarchical),
                              wire_dtype="int8" if quantized else "f32")
    def close() -> None:
        """Close the step's optimizer (its hooks off the parameters); a
        later call raises."""
        built["closed"] = True
        if "opt" in built:
            built["opt"].close()

    traced.sharding_specs = None
    traced.optimizer = None
    traced.close = close
    return traced


def _data_groups(mesh, dp_axes: Tuple[str, ...]):
    """The data scope's group, or for an axis tuple its groups with the
    flattened one (``parallel.mesh.axis_groups``)."""
    from .parallel.mesh import axis_groups

    return mesh.get_group(dp_axes[0]) if len(dp_axes) == 1 else axis_groups(mesh, dp_axes)


def init_composed_zero1_state(
    optimizer: torch.optim.Optimizer,
    params: Any,
    rules: Any,
    mesh,
    *,
    model_axis: str = "model",
    data_axis: Any = "data",
    threshold_bytes: Optional[int] = None,
    first_bucket_bytes: Optional[int] = None,
    quantized: bool = False,
):
    """This rank's ZeRO-1 state for ``make_train_step(rules=...,
    zero1=True)``: the whole tree ``params`` (tensors or numpy arrays,
    nested by path) is cut to this rank's model shard by the rules
    (``parallel/rules.local_shard_tree``), and the streamed per-bucket state
    of those local leaves is built over the data scope
    (``parallel/zero.init_zero1_stream_state``), sharded at this rank's data
    index (outer-major over an axis tuple). It is the state the composed
    zero1 step builds at its first call (``step.optimizer.zero1_state``).
    The bucket partition is over the model rank's LOCAL leaves, so it
    round-trips with the in-step update. No error-feedback residual: the
    composed int8 wire runs EF-off.

    The JAX package's function builds every rank's cell at once, stacked
    ``[n_data, n_model, ...]``, and its step indexes ``[0, 0]`` inside
    ``shard_map``; here each rank keeps only its own ``[d, m]`` cell."""
    import numpy as np

    from .parallel import rules as _rules
    from .parallel import zero as _zero
    from .parallel.mesh import axis_size

    rules = _rules.resolve_rules(rules)
    dp_axes = tuple(data_axis) if isinstance(data_axis, (tuple, list)) else (data_axis,)
    specs = _rules.match_partition_rules(rules, params)
    coords = {model_axis: (mesh.get_local_rank(model_axis), axis_size(mesh, model_axis))}
    local = _tree_map(lambda a: torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray)
                      else a, _rules.local_shard_tree(params, specs, coords))
    return _zero.init_zero1_stream_state(
        optimizer, local, group=_data_groups(mesh, dp_axes), threshold_bytes=threshold_bytes,
        first_bucket_bytes=first_bucket_bytes, quantized=quantized, error_feedback=False)


def decode_inputs(tokens, positions, page_table, device: torch.device, prefix=()):
    """The decode step's inputs as int64 tensors on ``device``: ``prefix``
    (a few ints), the [B] tokens, the [B] positions and the [B, max_pages]
    page table packed in that order into one flat tensor, and the three
    inputs as views of it. From the host they go up in ONE copy, from a
    pinned buffer without blocking (the caching host allocator keeps the
    buffer until the copy has run), so the step's only host
    synchronization stays the read-back of its output."""
    import numpy as np

    tok, pos = np.asarray(tokens).reshape(-1), np.asarray(positions).reshape(-1)
    table = np.asarray(page_table)
    packed = torch.from_numpy(np.concatenate(
        [np.asarray(prefix, np.int64), tok, pos, table.reshape(-1)]).astype(np.int64))
    if device.type == "cuda":
        packed = packed.pin_memory().to(device, non_blocking=True)
    return packed, split_decode_inputs(packed[len(prefix):], tok.shape[0])


def split_decode_inputs(flat: torch.Tensor, batch: int):
    """(tokens, positions, page_table) views of a packed [B, B, B x
    max_pages] tensor."""
    return flat[:batch], flat[batch:2 * batch], flat[2 * batch:].view(batch, -1)


def make_decode_step(
    *,
    n_heads: int,
    mesh=None,
    rules: Any = None,
    cache_rules: Any = None,
    model_axis: str = "model",
    dtype=torch.float32,
):
    """The batched one-token greedy decode step of serving, the counterpart
    of the JAX package's ``make_decode_step``::

        step(params, cache, tokens, positions, page_table)
            -> (next_tokens [B] int32 on the params' device, cache)

    ``cache`` is the paged decode state (``serve/kvcache.make_decode_state``),
    updated in place; ``page_table`` the [B, max_pages] slot-to-page map;
    ``tokens``, ``positions`` and ``page_table`` are host arrays (numpy) or
    tensors on the params' device. The forward is
    ``models/transformer.tp_decode_apply``.

    With ``mesh`` and ``rules`` the step is tensor-parallel over
    ``model_axis``: ``params`` are this rank's shards by the rule table (as
    ``utils.convert.local_params_from_flax`` cuts them) and the cache holds
    this rank's heads by ``cache_rules`` (default
    ``parallel/rules.GPT_CACHE_RULES``: the head dim over the model axis),
    both tables preflighted against the live trees' whole shapes at the
    first call. Every rank of the model group must call the step with the
    same inputs in the same order (``serve.serve`` runs a leader and
    followers for that). With ``mesh=None`` it is the dense single-card
    step. The build is deferred to the first call, where the live trees
    decide the specs."""
    from .models.transformer import tp_decode_apply
    from .parallel import rules as _rules
    from .serve.kvcache import preflight_decode_state

    if (mesh is None) != (rules is None):
        raise ValueError(
            "make_decode_step shards by TABLE: pass mesh= and rules= "
            "together (or neither for the dense reference)"
        )
    if mesh is not None and model_axis not in mesh.mesh_dim_names:
        raise ValueError(
            f"decode mesh needs axis {model_axis!r}; mesh has "
            f"{tuple(mesh.mesh_dim_names)}"
        )
    built: dict = {}

    def _build(params, cache):
        if mesh is None:
            return None
        crules = (_rules.GPT_CACHE_RULES if cache_rules is None
                  else _rules.resolve_rules(cache_rules))
        resolved = _rules.resolve_rules(rules)
        specs = _rules.match_partition_rules(resolved, params)
        # Both tables checked against the whole shapes before any step.
        _preflight.check_sharding_rules(resolved, mesh, _rules.global_shapes(params, specs, mesh))
        preflight_decode_state(crules, mesh, cache)
        return mesh.get_group(model_axis)

    def step(params, cache, tokens, positions, page_table):
        if "group" not in built:
            built["group"] = _build(params, cache)
        device = params["embeddings"]["embedding"].device
        inputs = (tokens, positions, page_table)
        if all(isinstance(t, torch.Tensor) for t in inputs):
            tokens, positions, page_table = (t.to(device) for t in inputs)
        else:
            _, (tokens, positions, page_table) = decode_inputs(*inputs, device)
        logits, cache = tp_decode_apply(
            params, tokens.long(), positions.long(), cache, page_table.long(),
            n_heads=n_heads, model_axis=built["group"], dtype=dtype)
        return logits.argmax(dim=-1).to(torch.int32), cache

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
