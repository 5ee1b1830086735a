"""Expert parallelism (Mixture-of-Experts) over an ``expert`` mesh axis.

The counterpart of ``horovod_tpu/parallel/ep.py``: tokens are routed top-1
(Switch style) with a static capacity, sent to the experts' owners with an
all-to-all over the expert group, transformed by the local expert FFNs in
one batched product, and sent back and combined.

The routing is the JAX package's, exactly: an f32 softmax of ``x @
w_router``, the expert by argmax (the first index on ties, as ``jnp.argmax``
and ``torch.argmax`` both take), each token's position in its expert's
buffer by a cumsum in token order, ``capacity = max(1, int(capacity_factor *
S / E_total))`` in Python floats, overflow tokens giving exactly zero, and
the load-balancing loss ``E * sum(mean(onehot) * mean(gates))``.

The JAX function moves rows with dense one-hot ``[S, E, C]`` dispatch and
combine tensors and two einsums. At the bench's widths (S 32768, E 16,
C 2560) each of those tensors is 5.4 GB in f32 and each contraction ~1.4
TFLOP that only moves rows. :func:`moe_ffn` computes the same function with
index ops: a gather of each slot's token into the ``[E, C, D]`` buffers
(its backward a scatter-add), and the combine as ``gate[s] * out[e(s),
pos(s)]``. Every slot holds at most one token, so both forms give the same
f32 values; :func:`_moe_ffn_dense` keeps the dense form as the plain version
the tests hold the index form to.

The expert axis is given as a process group, as an axis name that
``parallel.tp.mesh_scope`` resolves (``make_ep_train_step`` opens one), as
None (no expert axis: one rank holds every expert), or as anything with
``n`` and ``all_to_all`` (a ``Hop``; ``chip_smoke.py`` plays four expert
ranks on one card through threads with one).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ..common.basics import resolve_device
from ..common.types import ReduceOp
from ..ops import collectives, fusion
from .mesh import DATA_AXIS, EXPERT_AXIS, flatten_group


class MoEParams(NamedTuple):
    """Parameters of one MoE FFN layer. ``w_router`` is replicated;
    ``w_in``/``w_out`` hold this rank's experts (globally sharded over the
    expert axis on dim 0)."""

    w_router: torch.Tensor  # [D, E_total]
    w_in: torch.Tensor      # [E_local, D, H]
    w_out: torch.Tensor     # [E_local, H, D]


def init_moe_params(generator: torch.Generator, *, d_model: int, d_hidden: int,
                    num_experts: int, num_expert_shards: int, dtype=torch.float32,
                    device=None) -> MoEParams:
    """The GLOBAL parameters of one layer (dim 0 of ``w_in``/``w_out`` is the
    global expert count; ``utils.convert.moe_params_from_numpy`` cuts a
    rank's rows), drawn from ``generator`` with the JAX package's scales:
    normal times 1/sqrt(d_model) for the router and ``w_in``, 1/sqrt(d_hidden)
    for ``w_out``. ``device=None`` means the card."""
    if num_experts % num_expert_shards:
        raise ValueError(f"num_experts={num_experts} not divisible by "
                         f"expert shards={num_expert_shards}")
    device = resolve_device(device)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device) * scale
        return t.to(device=device, dtype=dtype)

    return MoEParams(
        w_router=normal((d_model, num_experts), d_model ** -0.5),
        w_in=normal((num_experts, d_model, d_hidden), d_model ** -0.5),
        w_out=normal((num_experts, d_hidden, d_model), d_hidden ** -0.5),
    )


class _HopAllToAll(torch.autograd.Function):
    """The all-to-all of a hop on dim 0 (chunk j to rank j); its transpose
    is itself."""

    @staticmethod
    def forward(ctx, x, hop):
        ctx.hop = hop
        return hop.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.hop.all_to_all(grad.contiguous()), None


def _expert_exchange(expert_axis) -> Tuple[int, Callable[[torch.Tensor], torch.Tensor]]:
    """(the expert axis's size, its differentiable all-to-all on dim 0)."""
    if expert_axis is None:
        return 1, lambda t: t
    if hasattr(expert_axis, "all_to_all"):
        return expert_axis.n, lambda t: _HopAllToAll.apply(t, expert_axis)
    from .tp import resolve_group

    group = resolve_group(expert_axis)
    n = dist.get_world_size(group)
    return n, lambda t: collectives.alltoall(t, group=group) if n > 1 else t


def _route(params: MoEParams, x: torch.Tensor, e_total: int, capacity_factor: float):
    """The Switch routing: gates [S, E] (f32), each token's expert and its
    gate, the one-hot [S, E] (f32), the capacity and the aux loss."""
    s_tokens = x.shape[0]
    capacity = max(1, int(capacity_factor * s_tokens / e_total))
    logits = x @ params.w_router
    gates = torch.softmax(logits.float(), dim=-1)
    expert_index = gates.argmax(dim=-1)
    gate = gates.gather(-1, expert_index[:, None])[:, 0]
    onehot = F.one_hot(expert_index, e_total).float()
    aux = e_total * (onehot.mean(0) * gates.mean(0)).sum()
    return gates, expert_index, gate, onehot, capacity, aux


def _experts(params: MoEParams, expert_in: torch.Tensor, n_exp: int, capacity: int,
             dtype, exchange, activation) -> torch.Tensor:
    """``[E_total * C, D]`` f32 capacity buffers -> the experts' f32 outputs
    in the same layout: the all-to-all to the owners, one batched product a
    matrix over (source, capacity) rows, the all-to-all back."""
    e_local, d_model, _ = params.w_in.shape
    x = exchange(expert_in.reshape(n_exp, e_local, capacity, d_model))
    with record_function("moe_experts"):
        x = x.to(dtype).permute(1, 0, 2, 3).reshape(e_local, n_exp * capacity, d_model)
        h = activation(torch.bmm(x, params.w_in))
        out = torch.bmm(h, params.w_out)
        out = out.reshape(e_local, n_exp, capacity, d_model).permute(1, 0, 2, 3).float()
    return exchange(out.contiguous()).reshape(n_exp * e_local * capacity, d_model)


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")


def moe_ffn(params: MoEParams, x: torch.Tensor, *, expert_axis=EXPERT_AXIS,
            capacity_factor: float = 1.25,
            activation: Callable = _gelu) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE FFN on this rank's tokens ``x`` ``[S, D]``.
    Returns ``(y [S, D] in x's dtype, aux_loss)``. Every rank routes its own
    S tokens over ALL experts; the capacity is per (expert, source rank).
    ``activation`` defaults to ``jax.nn.gelu``'s tanh form."""
    n_exp, exchange = _expert_exchange(expert_axis)
    e_total = params.w_in.shape[0] * n_exp
    s_tokens, d_model = x.shape
    with record_function("moe_dispatch"):
        _, expert_index, gate, onehot, capacity, aux = _route(params, x, e_total,
                                                              capacity_factor)
        position = onehot.cumsum(0).gather(-1, expert_index[:, None])[:, 0].long() - 1
        keep = position < capacity
        slot = torch.where(keep, expert_index * capacity + position, 0)
        # token_of_slot[k]: the token in slot k, or S (a zero row) for an empty slot.
        token_of_slot = torch.full((e_total * capacity,), s_tokens, dtype=torch.long,
                                   device=x.device)
        token_of_slot[slot[keep]] = torch.arange(s_tokens, device=x.device)[keep]
        rows = torch.cat([x.float(), x.new_zeros((1, d_model), dtype=torch.float32)])
        expert_in = rows[token_of_slot]
    out = _experts(params, expert_in, n_exp, capacity, x.dtype, exchange, activation)
    with record_function("moe_combine"):
        y = torch.where(keep[:, None], gate[:, None] * out[slot], 0.0)
    return y.to(x.dtype), aux


def _moe_ffn_dense(params: MoEParams, x: torch.Tensor, *, expert_axis=EXPERT_AXIS,
                   capacity_factor: float = 1.25,
                   activation: Callable = _gelu) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`moe_ffn`: the JAX function's dense
    one-hot ``[S, E, C]`` dispatch and combine tensors and their einsums,
    around the same expert products."""
    n_exp, exchange = _expert_exchange(expert_axis)
    e_total = params.w_in.shape[0] * n_exp
    _, _, gate, onehot, capacity, aux = _route(params, x, e_total, capacity_factor)
    position = (onehot.cumsum(0) - 1.0) * onehot
    keep = (position < capacity) & (onehot > 0)
    pos = torch.where(keep, position, 0.0).long()
    dispatch = F.one_hot(pos, capacity).float() * keep.float()[..., None]
    combine = dispatch * gate[:, None, None]
    expert_in = torch.einsum("sec,sd->ecd", dispatch, x.float())
    out = _experts(params, expert_in.reshape(e_total * capacity, -1), n_exp, capacity,
                   x.dtype, exchange, activation)
    y = torch.einsum("sec,ecd->sd", combine, out.reshape(e_total, capacity, -1))
    return y.to(x.dtype), aux


def _named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``[(/-joined path, leaf)]`` in ``jax.tree.leaves`` order: dict keys
    sorted, a ``MoEParams`` by its field names, other sequences by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, MoEParams):
        return [kv for k, v in zip(tree._fields, tree) for kv in _named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _is_expert_leaf(path: str) -> bool:
    return any(part in ("w_in", "w_out") for part in path.split("/"))


def expert_sharding_specs(tree: Any, expert_axis: str = EXPERT_AXIS) -> dict:
    """``{path: spec}`` over a tree's leaves (paths as :func:`_named_leaves`
    joins them): ``(expert_axis,)`` for ``MoEParams.w_in``/``w_out`` (dim 0
    sharded over the expert axis), ``()`` for everything else (replicated)."""
    return {path: ((expert_axis,) if _is_expert_leaf(path) else ())
            for path, _ in _named_leaves(tree)}


def make_ep_train_step(loss_fn: Callable, optimizer, mesh, *, data_axis: str = DATA_AXIS,
                       expert_axis: str = EXPERT_AXIS, aux_loss_weight: float = 0.01):
    """The DP×EP step, ``step(params, batch) -> task loss``.

    ``loss_fn(params, batch) -> (task_loss, aux_loss)`` runs on this rank's
    rows of the batch and calls :func:`moe_ffn` (its ``expert_axis="expert"``
    resolves in ``mesh``). ``params`` is this rank's tree: ``MoEParams`` with
    this rank's expert rows, everything else replicated; leaves that require
    grad, updated in place by ``optimizer`` (a torch optimizer over them, so
    the expert state is local to the rank). ``batch`` is the global batch (a
    tensor or a tuple of tensors, batch first), the same on every rank; it
    shards over ``(data, expert)`` row-major, so every rank trains on
    distinct tokens.

    The loss is ``task + aux_loss_weight * aux``. Every gradient is averaged
    over data; then replicated parameters average over expert too, and
    expert-sharded ones divide by the expert size (the all-to-all's
    transpose already summed the expert group's cotangents into the owner's
    rows). Returns the task loss averaged over both axes."""
    from .tp import mesh_scope

    names = tuple(mesh.mesh_dim_names)
    for axis in (data_axis, expert_axis):
        if axis not in names:
            raise ValueError(f"the expert-parallel step needs mesh axes ({data_axis!r}, "
                             f"{expert_axis!r}); mesh has {names}")
    data_group, expert_group = mesh.get_group(data_axis), mesh.get_group(expert_axis)
    both = flatten_group(mesh, tuple(a for a in names if a in (data_axis, expert_axis)))
    d, nd = collectives.group_rank_size(data_group)
    e, ne = collectives.group_rank_size(expert_group)
    shard = d * ne + e

    def rows(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % (nd * ne):
            raise ValueError(f"batch of {t.shape[0]} does not split over {nd} x {ne} ranks")
        per = t.shape[0] // (nd * ne)
        return t[shard * per:(shard + 1) * per]

    def average(leaves: List[torch.Tensor], group, n: int) -> List[torch.Tensor]:
        return fusion.fused_allreduce(leaves, op=ReduceOp.AVERAGE, group=group) if n > 1 \
            else leaves

    def step(params, batch):
        named = _named_leaves(params)
        for _, leaf in named:
            leaf.grad = None
        local = tuple(rows(t) for t in batch) if isinstance(batch, (tuple, list)) else rows(batch)
        with mesh_scope(mesh):
            task, aux = loss_fn(params, local)
        (task + aux_loss_weight * aux).backward()
        grads = average([l.grad if l.grad is not None else torch.zeros_like(l)
                         for _, l in named], data_group, nd)
        sharded = [_is_expert_leaf(path) for path, _ in named]
        replicated = iter(average([g for g, ex in zip(grads, sharded) if not ex],
                                  expert_group, ne))
        for (_, leaf), g, ex in zip(named, grads, sharded):
            leaf.grad = g / ne if ex else next(replicated)
        optimizer.step()
        return collectives.allreduce(task.detach().float(), op=ReduceOp.AVERAGE, group=both)

    return step
