"""Adasum, the adaptive allreduce, as a recursive pairwise exchange.

The port of ``horovod_tpu/ops/adasum.py``. At level ``l``
every rank exchanges its current vector with partner ``rank XOR 2^l`` and
both combine it locally,

    a' = (1 - a.b / (2 ||a||^2)) a  +  (1 - a.b / (2 ||b||^2)) b

(the reference's ``adasum.h:378-388``), so orthogonal gradients add and
parallel ones average. The combine is symmetric, so both members of a pair
compute the same vector and after log2(n) levels every rank holds
Adasum(a_0 .. a_{n-1}), paired in the order of the JAX recursion. Needs a
power-of-2 number of ranks, as the reference does.

The hierarchical variant (:func:`hierarchical_adasum_allreduce`, the
reference's ``adasum_cuda_operations.cc``) reduce-scatters each node's sum
over the local group, runs the exchange over the cross group on the shards
and all-gathers them back: the combine runs between node SUMS, not node
averages, as in the JAX package. The exchanges go through a hop
(``ops/collectives.Hop``: ``rank``, ``n``, ``exchange``), so ``chip_smoke.py``
plays a grid of ranks on one card through the same code.
"""

from __future__ import annotations

from typing import Any, List

import torch

from . import collectives


def _pairwise_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The adaptive pairwise combine, in f32 for half-precision inputs; a
    zero vector keeps coefficient 1 (a plain sum with it)."""
    compute = torch.float32 if a.dtype in (torch.bfloat16, torch.float16) else a.dtype
    af = a.to(compute).reshape(-1)
    bf = b.to(compute).reshape(-1)
    ab, aa, bb = torch.dot(af, bf), torch.dot(af, af), torch.dot(bf, bf)
    one = torch.ones((), dtype=compute, device=a.device)
    coeff_a = torch.where(aa > 0, 1.0 - ab / (2.0 * torch.where(aa > 0, aa, one)), one)
    coeff_b = torch.where(bb > 0, 1.0 - ab / (2.0 * torch.where(bb > 0, bb, one)), one)
    return (coeff_a * af + coeff_b * bf).reshape(a.shape).to(a.dtype)


def adasum_allreduce(x: torch.Tensor, *, group: Any = None) -> torch.Tensor:
    """Adasum of every rank's ``x`` over the group (a power-of-2 size), or
    over a hop."""
    hop = collectives.as_hop(group)
    n, r = hop.n, hop.rank
    if n & (n - 1) != 0:
        raise ValueError(
            f"Adasum requires a power-of-2 number of ranks, got {n} "
            "(the reference enforces the same, horovod/torch/mpi_ops.py:104-120)"
        )
    x = x.contiguous()
    level = 1
    while level < n:
        x = _pairwise_combine(x, hop.exchange(x, r ^ level))
        level <<= 1
    return x


def adasum_allreduce_reference(vectors: List[Any]) -> Any:
    """NumPy reference (recursive halving over a list, in float64), for the
    numeric tests."""
    import numpy as np

    def combine(a, b):
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        ab = float(np.vdot(a.ravel(), b.ravel()))
        aa = float(np.vdot(a.ravel(), a.ravel()))
        bb = float(np.vdot(b.ravel(), b.ravel()))
        ca = 1.0 - ab / (2.0 * aa) if aa > 0 else 1.0
        cb = 1.0 - ab / (2.0 * bb) if bb > 0 else 1.0
        return ca * a + cb * b

    vecs = list(vectors)
    while len(vecs) > 1:
        vecs = [combine(vecs[i], vecs[i + 1]) for i in range(0, len(vecs), 2)]
    return vecs[0]


def hierarchical_adasum_reference(vectors: List[Any], local_size: int) -> Any:
    """NumPy reference of the hierarchical variant: node sums are
    reduce-scattered into ``local_size`` contiguous chunks, the exchange
    combines each chunk across nodes on its own (per-chunk dot products,
    what each local rank computes on its shard), and the chunks
    concatenate back. Rank order is rank = cross * local_size + local."""
    import numpy as np

    vecs = [np.asarray(v, dtype=np.float64).reshape(-1) for v in vectors]
    if len(vecs) % local_size:
        raise ValueError(f"{len(vecs)} vectors do not split into nodes of {local_size}")
    cross = len(vecs) // local_size
    node_sums = [np.sum(vecs[c * local_size:(c + 1) * local_size], axis=0) for c in range(cross)]
    n = node_sums[0].size
    pad = (-n) % local_size
    if pad:
        node_sums = [np.concatenate([v, np.zeros(pad)]) for v in node_sums]
    chunk = (n + pad) // local_size
    out = [adasum_allreduce_reference([v[s * chunk:(s + 1) * chunk] for v in node_sums])
           for s in range(local_size)]
    return np.concatenate(out)[:n].reshape(np.asarray(vectors[0]).shape)


def hierarchical_adasum_allreduce(x: torch.Tensor, *, local_group: Any,
                                  cross_group: Any) -> torch.Tensor:
    """Hierarchical Adasum on a (cross, local) grid: reduce-scatter within
    the node (the local group) -> the pairwise exchange across nodes on the
    shards (the cross group, a power-of-2 size) -> all-gather within the
    node. Each node contributes the SUM of its local ranks' vectors;
    turning it into a node average is the caller's to do, as in the
    reference and the JAX package. The groups may be hops."""
    local = collectives.as_hop(local_group)
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % local.n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shard = adasum_allreduce(local.reduce_scatter(flat), group=cross_group)
    full = local.all_gather(shard)
    return (full[:n] if pad else full).reshape(x.shape)


def adasum_reduce_fn(x: torch.Tensor, *, op=None, group: Any = None,
                     prescale_factor: float = 1.0, postscale_factor: float = 1.0
                     ) -> torch.Tensor:
    """A ``reduce_fn`` for ``ops/fusion.fused_allreduce``: op=Adasum
    buckets reduce here (``op`` is ignored, as in the reference). ``group``
    is one group (the flat exchange) or a ``(cross, local)`` pair (the
    hierarchical variant)."""
    if prescale_factor != 1.0:
        x = x * prescale_factor
    if isinstance(group, tuple):
        if len(group) != 2:
            raise ValueError(
                f"Adasum group must be one group or a (cross, local) pair; got {len(group)} "
                "levels")
        out = hierarchical_adasum_allreduce(x, local_group=group[1], cross_group=group[0])
    else:
        out = adasum_allreduce(x, group=group)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out
