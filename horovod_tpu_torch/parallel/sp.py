"""Sequence-parallel (long-context) training step builder.

The counterpart of ``horovod_tpu/parallel/sp.py``. Data parallelism and
sequence/context parallelism share one mesh: the batch shards over
``data`` and the sequence over ``seq``, and the gradients average over both
axes, i.e. over every rank (parameters are replicated). The model's
attention must be ring or Ulysses attention bound to the ``seq`` axis's
group (``TransformerLM(attn_fn=...)``), for a context too long for one
card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..common.types import ReduceOp
from ..ops import collectives
from ..train import DistributedOptimizer
from .mesh import DATA_AXIS, SEQ_AXIS, axis_size


def make_sp_train_step(
    loss_fn: Callable,
    optimizer,
    mesh: DeviceMesh,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    fusion_threshold_bytes: Optional[int] = None,
):
    """Build ``step(model, tokens, labels)`` for a DP×SP mesh.

    ``tokens`` and ``labels`` are the global ``[B, T]`` batch, the same on
    every rank; the step takes this rank's ``[B/nd, T/ns]`` shard, as the
    JAX step's ``P(data, seq)`` sharding gives it, and calls
    ``loss_fn(model, tokens, labels, positions)`` with the shard's global
    positions. The gradients are averaged over every rank in the JAX
    package's leaf order (``DistributedOptimizer``, fused into buckets of
    ``fusion_threshold_bytes``); ``optimizer`` is a torch optimizer over the
    model's parameters, or a ``DistributedOptimizer`` that wraps one. The
    parameters are updated in place; returns the loss averaged over every
    rank."""
    nd, ns = axis_size(mesh, data_axis), axis_size(mesh, seq_axis)
    d_idx, s_idx = mesh.get_local_rank(data_axis), mesh.get_local_rank(seq_axis)
    if mesh.size() != nd * ns:
        raise ValueError(
            f"the mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} has axes besides "
            f"{data_axis!r} and {seq_axis!r}; the gradients average over every rank"
        )
    dist_opt = optimizer if isinstance(optimizer, DistributedOptimizer) else None

    def step(model, tokens, labels):
        nonlocal dist_opt
        if dist_opt is None:
            dist_opt = DistributedOptimizer(
                optimizer, named_parameters=model.named_parameters(),
                fusion_threshold_bytes=fusion_threshold_bytes,
            )
        B, T = tokens.shape
        if B % nd or T % ns:
            raise ValueError(f"batch {tuple(tokens.shape)} does not shard over "
                             f"data {nd} x seq {ns}")
        b, t = B // nd, T // ns
        rows = slice(d_idx * b, (d_idx + 1) * b)
        cols = slice(s_idx * t, (s_idx + 1) * t)
        positions = (s_idx * t + torch.arange(t, device=tokens.device)).expand(b, t)
        dist_opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens[rows, cols], labels[rows, cols], positions)
        loss.backward()
        dist_opt.step()
        return collectives.allreduce(loss.detach(), op=ReduceOp.AVERAGE)

    return step
