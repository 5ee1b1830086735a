"""Tensor (model) parallelism: Megatron column/row-parallel layers.

The counterpart of ``horovod_tpu/parallel/tp.py``. Weight matrices shard
over the ``model`` axis and activations stay sharded between the column- and
row-parallel halves of each block, so the classic schedule has ONE
all-reduce per half-block, on the row-parallel output:

  - column-parallel: W1 [D, F/n]; y = x @ W1, output feature-sharded, no
    communication (q/k/v and the MLP up-projection);
  - row-parallel: W2 [F/n, D]; z = allreduce(y @ W2), the block output
    replicated again (attention out, MLP down).

The fused form (``*_fused``, ``tp_scatter_tokens``, ``tp_gather_tokens``)
keeps the residual stream token-sharded between blocks and replaces each
all-reduce by the collective-matmul primitives of
``ops/collective_matmul.py`` (kernels B3 and B4 on the card).

The model axis is given as a process group, or as an axis name that
:func:`resolve_group` looks up in the mesh of the innermost
:func:`mesh_scope` (the composed step opens one around the loss, as
``shard_map`` binds axis names in the JAX package). None means no model
axis.

PyTorch has no replication tracking, so every conjugate is explicit, the
branch the JAX package takes where ``needs_explicit_grad_reduce()`` is
true: Megatron's ``f`` (identity forward, all-reduce backward) before each
column-parallel consumer of a replicated input, and an all-reduce whose
backward is the identity after each row-parallel producer, because the loss
downstream is replicated over the model axis.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..common import env as _env
from ..ops import collectives, fusion
from ..ops.collectives import Group

MODEL_AXIS = "model"

_MESH_SCOPE: List[Any] = []
_OVERLAP_SCOPE: List[Optional[bool]] = []


@contextlib.contextmanager
def mesh_scope(mesh):
    """Bind axis names to ``mesh`` (a ``DeviceMesh``) inside the block, so
    ``model_axis="model"`` resolves to ``mesh.get_group("model")``."""
    _MESH_SCOPE.append(mesh)
    try:
        yield
    finally:
        _MESH_SCOPE.pop()


def resolve_group(axis) -> Group:
    """A process group from a group, or from an axis name of the innermost
    :func:`mesh_scope`'s mesh."""
    if not isinstance(axis, str):
        return axis
    if not _MESH_SCOPE:
        raise ValueError(
            f"model axis {axis!r} is a name, but no mesh is in scope: pass the "
            f"axis's process group, or call inside mesh_scope(mesh) (the "
            f"composed make_train_step opens one)"
        )
    mesh = _MESH_SCOPE[-1]
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r}; axes {mesh.mesh_dim_names}")
    return mesh.get_group(axis)


def axis_size(group: Group) -> int:
    return dist.get_world_size(group)


def axis_index(group: Group) -> int:
    return dist.get_rank(group)


def axis_name_of(group: Group) -> str:
    """The mesh axis a group is, by the innermost :func:`mesh_scope`'s mesh
    (``model`` outside one): the ``axis`` label of its wire bytes."""
    if _MESH_SCOPE:
        mesh = _MESH_SCOPE[-1]
        for d in mesh.mesh_dim_names:
            if mesh.get_group(d) is group:
                return d
    return MODEL_AXIS


def _charge_psum(t: torch.Tensor, group: Group) -> None:
    """Charge one model-axis psum of ``t`` in a step's first call
    (``fusion.charge``), as the JAX package does at trace time
    (``horovod_tpu/parallel/tp.py:52``, ``:127``, ``:238``)."""
    fusion.charge(t.numel() * t.element_size(), group, "psum", axis=axis_name_of(group))


# --- the conjugate pairs ------------------------------------------------------


class _BlockInput(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _charge_psum(grad, ctx.group)
        return collectives.allreduce(grad.contiguous(), group=ctx.group), None


class _ReplicatedSum(torch.autograd.Function):
    """All-reduce forward whose backward is the identity
    (``psum_replicated_grad``): the cotangent of the sum is already the
    same on every rank of the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        _charge_psum(x, group)
        return collectives.allreduce(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterTokens(torch.autograd.Function):
    """Forward: this rank's token chunk (dim -2). Backward: the cotangent
    zero-padded back to all tokens, then all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        n, i = axis_size(group), axis_index(group)
        tc = x.shape[-2] // n
        ctx.group, ctx.n, ctx.i = group, n, i
        return x[..., i * tc:(i + 1) * tc, :].contiguous()

    @staticmethod
    def backward(ctx, grad):
        tc = grad.shape[-2]
        full = grad.new_zeros(*grad.shape[:-2], tc * ctx.n, grad.shape[-1])
        full[..., ctx.i * tc:(ctx.i + 1) * tc, :] = grad
        _charge_psum(full, ctx.group)
        return collectives.allreduce_(full, group=ctx.group), None


class _GatherTokens(torch.autograd.Function):
    """Forward: all-gather the token chunks (dim -2). Backward: this rank's
    slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collectives._allgather(x.contiguous(), group, x.dim() - 2)

    @staticmethod
    def backward(ctx, grad):
        n, i = axis_size(ctx.group), axis_index(ctx.group)
        tc = grad.shape[-2] // n
        return grad[..., i * tc:(i + 1) * tc, :], None


def tp_block_input(x: torch.Tensor, *, axis_name=MODEL_AXIS) -> torch.Tensor:
    """Megatron's ``f``: identity forward, the cotangent all-reduced over
    the model axis. Apply to a REPLICATED input right before it feeds
    column-parallel shards; without it each rank's cotangent carries only
    its own shard's part."""
    group = resolve_group(axis_name)
    if axis_size(group) == 1:
        return x
    return _BlockInput.apply(x, group)


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W[:, shard] (+ b[shard]): feature-sharded output, no
    communication."""
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def _check_row_bias(b_shard, w_shard, n: int, what: str) -> None:
    f = b_shard.shape[-1]
    if f * n != w_shard.shape[-1]:
        # A full-size bias would be added n times; refuse it.
        raise ValueError(
            f"{what} bias must be the [D/n] shard: got {f} features for "
            f"D={w_shard.shape[-1]} over n={n} shards"
        )


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 b_shard: Optional[torch.Tensor] = None, *,
                 axis_name=MODEL_AXIS) -> torch.Tensor:
    """z = allreduce_i(x_i @ W[shard_i, :] + scatter_i(b_i)): the one
    collective of the Megatron half-block. The bias is the [D/n] shard,
    placed at this rank's offset inside the reduction. The all-reduce's
    backward is the identity: the loss downstream is replicated over the
    model axis."""
    group = resolve_group(axis_name)
    n = axis_size(group)
    y = x_shard @ w_shard
    if b_shard is not None:
        _check_row_bias(b_shard, w_shard, n, "row_parallel")
        f = b_shard.shape[-1]
        i = axis_index(group)
        y = y + F.pad(b_shard, (i * f, (n - 1 - i) * f))
    if n == 1:
        return y
    return _ReplicatedSum.apply(y, group)


# --- the fused (collective-matmul) path ---------------------------------------


def overlap_scope(enabled: Optional[bool]):
    """Context manager pinning the fused-path selection (the composed
    builder wraps the loss in one, so ``make_train_step(rules=...,
    tp_overlap=...)`` reaches every ``tp_apply`` call). ``None`` defers to
    the environment knob."""

    @contextlib.contextmanager
    def scope():
        _OVERLAP_SCOPE.append(None if enabled is None else bool(enabled))
        try:
            yield
        finally:
            _OVERLAP_SCOPE.pop()

    return scope()


def tp_overlap_enabled(explicit: Optional[bool] = None) -> bool:
    """The fused-path switch: an explicit argument wins, then the innermost
    :func:`overlap_scope`, then ``HOROVOD_TP_OVERLAP``."""
    if explicit is not None:
        return bool(explicit)
    for v in reversed(_OVERLAP_SCOPE):
        if v is not None:
            return v
    return _env._get_bool(_env.HOROVOD_TP_OVERLAP, False)


def tp_overlap_chunks() -> int:
    """The configured sub-chunk count (0 = auto: one chunk per rank)."""
    return _env._get_int(_env.HOROVOD_TP_OVERLAP_CHUNKS, 0)


def tp_scatter_tokens(x: torch.Tensor, *, axis_name=MODEL_AXIS) -> torch.Tensor:
    """Enter the fused path: this rank's token chunk (dim -2) of a
    REPLICATED activation, free of communication forward; the backward
    reassembles the cotangent and all-reduces it over the model axis."""
    group = resolve_group(axis_name)
    n = axis_size(group)
    if x.shape[-2] % n:
        raise ValueError(
            f"tp_scatter_tokens needs tokens ({x.shape[-2]}) divisible by the "
            f"model-axis size ({n})"
        )
    return _ScatterTokens.apply(x, group)


def tp_gather_tokens(x_shard: torch.Tensor, *, axis_name=MODEL_AXIS) -> torch.Tensor:
    """Leave the fused path: all-gather the token chunks (dim -2) back to a
    replicated activation. The backward takes this rank's slice of the
    cotangent, which is the same on every rank (the loss is replicated), so
    the all-gather's reduce-scatter transpose would count it n times."""
    return _GatherTokens.apply(x_shard, resolve_group(axis_name))


def tp_replicated_params(tree: Any, *, axis_name=MODEL_AXIS) -> Any:
    """Mark a REPLICATED parameter subtree used by token-sharded compute on
    the fused path (the block layer norms): each rank's gradient covers its
    token chunk only, so the cotangents all-reduce over the model axis
    (:func:`tp_block_input` per leaf)."""
    if isinstance(tree, dict):
        return {k: tp_replicated_params(v, axis_name=axis_name) for k, v in tree.items()}
    return tp_block_input(tree, axis_name=axis_name)


def column_parallel_fused(x_shard: torch.Tensor, w_shard: torch.Tensor,
                          b_shard: Optional[torch.Tensor] = None, *,
                          axis_name=MODEL_AXIS, chunks: int = 0) -> torch.Tensor:
    """Fused column consume: ``all_gather(x_shard over tokens) @
    W[:, shard]``, the chunks riding the bidirectional ring while the
    chunk product runs (kernel B3). Token-sharded input; full-token,
    feature-sharded output."""
    from ..ops.collective_matmul import all_gather_matmul

    group = resolve_group(axis_name)
    y = all_gather_matmul(x_shard, w_shard, group=group, chunks=chunks,
                          axis=axis_name_of(group))
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel_fused(x_shard: torch.Tensor, w_shard: torch.Tensor,
                       b_shard: Optional[torch.Tensor] = None, *,
                       axis_name=MODEL_AXIS, chunks: int = 0) -> torch.Tensor:
    """Fused row produce: ``reduce_scatter(x @ W[shard, :] over tokens)``,
    per-destination partial products reduced along the ring (kernel B4).
    Output is the token-sharded residual stream. The [D/n] bias is
    all-gathered to [D] and added to every token; the gather's transpose is
    the reduce-scatter, so each bias shard's gradient sums every rank's
    token chunk."""
    from ..ops.collective_matmul import matmul_reduce_scatter

    group = resolve_group(axis_name)
    z = matmul_reduce_scatter(x_shard, w_shard, group=group, chunks=chunks,
                              axis=axis_name_of(group))
    if b_shard is not None:
        _check_row_bias(b_shard, w_shard, axis_size(group), "row_parallel_fused")
        z = z + collectives.allgather(b_shard, group=group, dim=0)
    return z


def tp_mlp(params: dict, x: torch.Tensor, *, axis_name=MODEL_AXIS,
           activation: Callable = lambda y: F.gelu(y, approximate="tanh")) -> torch.Tensor:
    """One Megatron MLP block on sharded weights: ``params = {"w1": [D,
    F/n], "b1": [F/n], "w2": [F/n, D], "b2": [D/n]}``."""
    h = activation(column_parallel(x, params["w1"], params.get("b1")))
    return row_parallel(h, params["w2"], params.get("b2"), axis_name=axis_name)


def tp_attention(params: dict, x: torch.Tensor, *, head_dim: int,
                 axis_name=MODEL_AXIS, causal: bool = True) -> torch.Tensor:
    """Megatron head-sharded self-attention: the QKV projection is
    column-parallel over heads (H/n local heads), flash attention runs on
    the local heads, and the output projection is row-parallel.
    ``params = {"wqkv": [D, 3*(H/n)*Dh], "wo": [(H/n)*Dh, D], "bo": [D/n]}``."""
    from ..ops.flash_attention import flash_attention_bthd

    B, T, _ = x.shape
    qkv = column_parallel(x, params["wqkv"])
    if qkv.shape[-1] % (3 * head_dim):
        raise ValueError(
            f"qkv width {qkv.shape[-1]} is not divisible by 3*head_dim "
            f"({3 * head_dim}); head_dim does not match the sharded weights"
        )
    hl = qkv.shape[-1] // (3 * head_dim)
    q, k, v = (t.reshape(B, T, hl, head_dim) for t in qkv.chunk(3, dim=-1))
    a = flash_attention_bthd(q, k, v, causal=causal).reshape(B, T, hl * head_dim)
    return row_parallel(a, params["wo"], params.get("bo"), axis_name=axis_name)
