"""Adasum, the adaptive allreduce, as a recursive pairwise exchange.

The port of the flat half of ``horovod_tpu/ops/adasum.py``. At level ``l``
every rank exchanges its current vector with partner ``rank XOR 2^l`` and
both combine it locally,

    a' = (1 - a.b / (2 ||a||^2)) a  +  (1 - a.b / (2 ||b||^2)) b

(the reference's ``adasum.h:378-388``), so orthogonal gradients add and
parallel ones average. The combine is symmetric, so both members of a pair
compute the same vector and after log2(n) levels every rank holds
Adasum(a_0 .. a_{n-1}), paired in the order of the JAX recursion. Needs a
power-of-2 number of ranks, as the reference does. The hierarchical
variant is not ported (ROADMAP A7b).
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist

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


def _exchange(x: torch.Tensor, partner: int, group: collectives.Group) -> torch.Tensor:
    """Send ``x`` to group rank ``partner`` and receive its tensor."""
    group = group or dist.group.WORLD
    peer = dist.get_global_rank(group, partner)
    buf = torch.empty_like(x)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer, group),
                                        dist.P2POp(dist.irecv, buf, peer, group)]):
        work.wait()
    return buf


def adasum_allreduce(x: torch.Tensor, *, group: collectives.Group = None) -> torch.Tensor:
    """Adasum of every rank's ``x`` over the group (a power-of-2 size)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n & (n - 1) != 0:
        raise ValueError(
            f"Adasum requires a power-of-2 number of ranks, got {n} "
            "(the reference enforces the same, horovod/torch/mpi_ops.py:104-120)"
        )
    x = x.contiguous()
    level = 1
    while level < n:
        x = _pairwise_combine(x, _exchange(x, r ^ level, group))
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


def adasum_reduce_fn(x: torch.Tensor, *, op=None, group: collectives.Group = None,
                     prescale_factor: float = 1.0, postscale_factor: float = 1.0
                     ) -> torch.Tensor:
    """A ``reduce_fn`` for ``ops/fusion.fused_allreduce``: op=Adasum
    buckets reduce here (``op`` is ignored, as in the reference)."""
    if prescale_factor != 1.0:
        x = x * prescale_factor
    out = adasum_allreduce(x, group=group)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out
