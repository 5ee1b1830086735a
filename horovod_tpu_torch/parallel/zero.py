"""ZeRO-1: the optimizer state sharded over the data group.

The port of ``horovod_tpu/parallel/zero.py``. Each rank keeps the optimizer
state of one 1/N shard of the parameters; the gradient allreduce becomes a
reduce-scatter, each rank updates only its shard, and the updated shards are
all-gathered back into every rank's parameters:

    packed grads --reducescatter--> g_shard        (1/N of the bytes out)
    inner.step() on (p_shard, g_shard)             (1/N of the state)
    packed params <--allgather-- p_shard'

The data group may be a tuple of groups (an axis tuple such as ``(cross,
local)``): the reduce-scatter and the all-gather then run two-level
(``topo/compositor.py``) and a rank's shard is the one of its outer-major
index.

In torch each rank holds one flat shard tensor per (group, bucket) of the
streamed layout (``ops/fusion.zero1_group_layout``), in the bucket's dtype,
and the inner optimizer is rebuilt over those shards as
``type(opt)(shards, **hyperparameters)``. An optax transformation applies to
the whole tree alike, so an optimizer whose parameter groups differ in their
hyperparameters is refused. Elementwise optimizers (SGD, momentum, Adam,
AdamW) track the replicated step to float rounding.

``init_zero1_state``/``zero1_update``/``make_zero1_train_step`` are the
older whole-vector form: one shard of the flat parameter vector.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..common.types import ReduceOp
from ..ops import collectives
from ..ops import fusion as F

__all__ = [
    "Zero1State",
    "init_zero1_state",
    "init_zero1_stream_state",
    "init_zero1_stream_states",
    "make_zero1_train_step",
    "zero1_posthoc_reduce",
    "zero1_stream_update",
    "zero1_update",
]


class Zero1State(NamedTuple):
    """This rank's ZeRO-1 state: ``shards["g<gi>"]["b<bi>"]`` its flat
    parameter shard of bucket bi of streamed group gi, ``opt`` the inner
    optimizer over those shards, and ``ef`` the SHARDED error-feedback
    residuals of the int8 wire (the same keys, f32 ``[k]``), or None. All of
    it is rank-local: each rank holds and updates only its own rows."""

    opt: torch.optim.Optimizer
    shards: Dict[str, Dict[str, torch.Tensor]]
    ef: Optional[Dict[str, Dict[str, torch.Tensor]]]


def _hyperparameters(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The one set of hyperparameters every parameter group shares, as the
    optimizer's constructor takes them."""
    hyper = [{k: g[k] for k in optimizer.defaults} for g in optimizer.param_groups]
    if any(h != hyper[0] for h in hyper[1:]):
        raise ValueError(
            "zero1 rebuilds the optimizer over flat shards of every parameter, so its "
            "parameter groups must share one set of hyperparameters; got "
            f"{len(hyper)} groups that differ"
        )
    takes = inspect.signature(type(optimizer).__init__).parameters
    return {k: v for k, v in hyper[0].items() if k in takes}


def _shards_of(group, n_shards: Optional[int]):
    """(n, rank) of the data group, or of a tuple of groups (outer-major,
    the shard index the two-level reduce-scatter emits); a stated shard
    count must be its size, or every shard offset would silently
    misalign."""
    rank, n = collectives.group_rank_size(group)
    if n_shards is not None and int(n_shards) != n:
        raise ValueError(
            f"zero1: the state is sharded {n_shards} ways but the group has {n} ranks; "
            f"the shard offsets would silently misalign"
        )
    return n, rank


def _shard(buf: torch.Tensor, rank: int, k: int) -> torch.Tensor:
    return F._pad_to(buf, (rank + 1) * k)[rank * k:(rank + 1) * k]


def init_zero1_stream_state(
    optimizer: torch.optim.Optimizer,
    params: Any,
    n_shards: Optional[int] = None,
    *,
    group: collectives.Group = None,
    threshold_bytes: Optional[int] = None,
    first_bucket_bytes: Optional[int] = None,
    quantized: bool = False,
    error_feedback: Optional[bool] = None,
) -> Zero1State:
    """Build this rank's :class:`Zero1State` over the parameter tree
    ``params``: for every streamed group and fusion bucket, this rank's
    shard of the packed parameters, and the inner optimizer over the shards
    (a fresh ``type(optimizer)`` with ``optimizer``'s hyperparameters, so
    stateful optimizers start exactly as they would on the whole vector).
    Non-float and empty buckets carry no state. ``error_feedback`` (default:
    on for the int8 wire) adds zero sharded residuals."""
    if error_feedback and not quantized:
        raise ValueError("error_feedback=True requires quantized=True")
    _hyperparameters(optimizer)
    n, rank = _shards_of(group, n_shards)
    return _stream_state(optimizer, params, n, rank, threshold_bytes, first_bucket_bytes,
                         quantized, error_feedback)


def init_zero1_stream_states(optimizer: torch.optim.Optimizer, params: Any, n_shards: int, *,
                             threshold_bytes: Optional[int] = None,
                             first_bucket_bytes: Optional[int] = None,
                             quantized: bool = False,
                             error_feedback: Optional[bool] = None) -> List[Zero1State]:
    """Every rank's :class:`Zero1State` at ``n_shards`` ranks, built in one
    process with no process group (what :func:`init_zero1_stream_state`
    gives each rank): a checkpoint's restore target, a reshard's test."""
    return [_stream_state(optimizer, params, int(n_shards), r, threshold_bytes,
                          first_bucket_bytes, quantized, error_feedback)
            for r in range(int(n_shards))]


def _stream_state(optimizer, params, n: int, rank: int, threshold_bytes, first_bucket_bytes,
                  quantized: bool, error_feedback) -> Zero1State:
    use_ef = bool(quantized) if error_feedback is None else bool(error_feedback)
    if use_ef and not quantized:
        raise ValueError("error_feedback=True requires quantized=True")
    hyper = _hyperparameters(optimizer)
    shards: Dict[str, Dict[str, torch.Tensor]] = {}
    ef: Dict[str, Dict[str, torch.Tensor]] = {}
    for label, leaves, buckets in F.zero1_group_layout(params, threshold_bytes,
                                                       first_bucket_bytes):
        shards[label], ef[label] = {}, {}
        for bi, bucket in enumerate(buckets):
            packed = F.pack_bucket([leaves[i].detach() for i in bucket])
            if packed.numel() == 0 or not packed.is_floating_point():
                continue
            k = F.zero1_shard_len(packed.numel(), n, quantized)
            shards[label][f"b{bi}"] = torch.nn.Parameter(_shard(packed, rank, k).clone())
            if use_ef:
                ef[label][f"b{bi}"] = torch.zeros(k, dtype=torch.float32, device=packed.device)
    opt = type(optimizer)([s for g in shards.values() for s in g.values()], **hyper)
    return Zero1State(opt=opt, shards=shards, ef=ef if use_ef else None)


def zero1_posthoc_reduce(
    grads: Any,
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    group: collectives.Group = None,
    threshold_bytes: Optional[int] = None,
    first_bucket_bytes: Optional[int] = None,
    quantized: bool = False,
    ef: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
):
    """The streamed ZeRO-1 reduction applied after the backward: the same
    group partition and per-bucket reduce-scatter the streamed path runs
    (``ops/fusion.fused_reduce_scatter``), over a gradient tree shaped as
    the parameters. Returns ``({"g<gi>": {"b<bi>": shard}}, new_ef)``."""
    reduced: Dict[str, Dict[str, torch.Tensor]] = {}
    new_ef: Dict[str, Dict[str, torch.Tensor]] = {}
    for label, leaves, _ in F.zero1_group_layout(grads, threshold_bytes, first_bucket_bytes):
        if ef is not None and label not in ef:
            raise ValueError(f"sharded EF residual is missing group {label!r}: build it "
                             f"with init_zero1_stream_state")
        reduced[label], group_ef = F.fused_reduce_scatter(
            leaves, op=op, group=group, threshold_bytes=threshold_bytes,
            quantized=quantized, ef=None if ef is None else ef[label])
        if group_ef is not None:
            new_ef[label] = group_ef
    return reduced, (new_ef if ef is not None else None)


def zero1_stream_update(
    state: Zero1State,
    params: Any,
    reduced: Dict[str, Dict[str, torch.Tensor]],
    *,
    group: collectives.Group = None,
    n_shards: Optional[int] = None,
    threshold_bytes: Optional[int] = None,
    first_bucket_bytes: Optional[int] = None,
    quantized: bool = False,
) -> None:
    """The shard-local update, in place: per bucket, this rank's shard of
    the current parameters, the reduced gradient shard (``reduced``, from
    the streamed backward or :func:`zero1_posthoc_reduce`), one step of the
    inner optimizer over every shard, then each updated shard all-gathered
    back into the parameters. The padded tail never leaves the gather: the
    gathered bucket is cut to its true length before it is unpacked."""
    n, rank = _shards_of(group, n_shards)
    layout = F.zero1_group_layout(params, threshold_bytes, first_bucket_bytes)
    with torch.no_grad():
        live = []
        for label, leaves, buckets in layout:
            shards = state.shards.get(label, {})
            for bi, bucket in enumerate(buckets):
                key = f"b{bi}"
                packed = F.pack_bucket([leaves[i].detach() for i in bucket])
                if packed.numel() == 0 or not packed.is_floating_point():
                    continue            # no shard state: the parameters pass through
                if key not in shards:
                    raise ValueError(
                        f"zero1 optimizer state is missing bucket {label}/{key}: it was "
                        f"built for a different partition (the threshold, first-bucket "
                        f"and quantized knobs must match init_zero1_stream_state)")
                shard = shards[key]
                k = F.zero1_shard_len(packed.numel(), n, quantized)
                if shard.numel() != k:
                    raise ValueError(f"zero1 shard {label}/{key} holds {shard.numel()} "
                                     f"elements; the live layout needs {k}")
                shard.copy_(_shard(packed, rank, k))
                shard.grad = reduced[label][key].to(shard.dtype)
                live.append((shard, [leaves[i] for i in bucket], packed.numel()))
            stale = set(shards) - {f"b{bi}" for bi in range(len(buckets))}
            if stale:
                raise ValueError(f"zero1 optimizer state carries buckets {sorted(stale)} the "
                                 f"live partition of group {label!r} does not")
        state.opt.step()
        for shard, leaves, total in live:
            full = _allgather(shard.detach(), group)[:total]
            for leaf, new in zip(leaves, F.unpack_bucket(full, [l.shape for l in leaves])):
                leaf.copy_(new)
            shard.grad = None
        if live:
            # The parameter all-gather, always full precision, charged in a
            # step's first call as the JAX package charges it at trace time
            # (horovod_tpu/parallel/zero.py:448).
            F.charge(sum(n * s.numel() * s.element_size() for s, _, _ in live), group,
                     "all_gather")


def _allgather(shard: torch.Tensor, group) -> torch.Tensor:
    """The new shards gathered over the group; over a tuple of groups, the
    two-level all-gather (only the 1/L shard crosses the outer levels)."""
    if isinstance(group, tuple):
        from ..topo.compositor import lower_allgather

        return lower_allgather(shard, group)
    return collectives.allgather(shard, group=group)


# --- the whole-vector form ------------------------------------------------------


def init_zero1_state(optimizer: torch.optim.Optimizer, params: Any,
                     n_shards: Optional[int] = None, *, group: collectives.Group = None,
                     quantized: bool = False) -> Zero1State:
    """The whole-vector ZeRO-1 state: this rank's shard of every parameter
    flattened into one vector (in tree order; the leaves share a dtype),
    padded to whole (BLOCK-aligned with ``quantized``) shards, and the inner
    optimizer over it. No error feedback, as in the reference."""
    leaves = F.tree_leaves(params)
    if len({l.dtype for l in leaves}) > 1:
        raise ValueError("the whole-vector zero1 state flattens one dtype; the parameters "
                         f"have {sorted({str(l.dtype) for l in leaves})}")
    n, rank = _shards_of(group, n_shards)
    flat = F.pack_bucket([l.detach() for l in leaves])
    k = F.zero1_shard_len(flat.numel(), n, quantized)
    shard = torch.nn.Parameter(_shard(flat, rank, k).clone())
    opt = type(optimizer)([shard], **_hyperparameters(optimizer))
    return Zero1State(opt=opt, shards={"g0": {"b0": shard}}, ef=None)


def zero1_update(state: Zero1State, params: Any, grads: Any, *,
                 group: collectives.Group = None, n_shards: Optional[int] = None,
                 quantized: bool = False) -> None:
    """The whole-vector ZeRO-1 update, in place: reduce-scatter the flat
    gradients (averaged over the group; the int8 ring with ``quantized``),
    step this rank's shard, all-gather the new parameters."""
    from ..ops.quantized import quantized_ring_reduce_scatter

    n, rank = _shards_of(group, n_shards)
    leaves = F.tree_leaves(params)
    shard = state.shards["g0"]["b0"]
    k = shard.numel()
    with torch.no_grad():
        flat_p = F.pack_bucket([l.detach() for l in leaves])
        flat_g = F._pad_to(F.pack_bucket(F.tree_leaves(grads)), n * k)
        if quantized:
            g_shard = quantized_ring_reduce_scatter(flat_g, group=group, average=True)
        else:
            g_shard = collectives.reducescatter(flat_g, op=ReduceOp.AVERAGE, group=group)
        shard.copy_(_shard(flat_p, rank, k))
        shard.grad = g_shard.to(shard.dtype)
        state.opt.step()
        full = collectives.allgather(shard.detach(), group=group)[:flat_p.numel()]
        for leaf, new in zip(leaves, F.unpack_bucket(full, [l.shape for l in leaves])):
            leaf.copy_(new)
        shard.grad = None


def make_zero1_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, *,
                          group: collectives.Group = None, quantized: bool = False):
    """``step(params, batch) -> loss``: the loss on this rank's shard of the
    batch, backward, :func:`zero1_update` (the state is built from
    ``optimizer``'s hyperparameters at the first call), and the loss
    averaged over the group. ``params`` is a module or a tree of leaves that
    require grad; it is updated in place."""
    built: Dict[str, Zero1State] = {}

    def step(params, batch):
        tree = (F.named_tree(list(params.named_parameters()))
                if isinstance(params, torch.nn.Module) else params)
        if "state" not in built:
            built["state"] = init_zero1_state(optimizer, tree, group=group,
                                              quantized=quantized)
        leaves = F.tree_leaves(tree)
        for leaf in leaves:
            leaf.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        grads = [l.grad if l.grad is not None else torch.zeros_like(l) for l in leaves]
        zero1_update(built["state"], tree, grads, group=group, quantized=quantized)
        return collectives.allreduce(loss.detach(), op=ReduceOp.AVERAGE, group=group)

    return step
