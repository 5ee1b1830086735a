"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

The counterpart of ``horovod_tpu/parallel/ring_attention.py``. Each rank of
the sequence group holds a ``[B, T_local, H, D]`` shard of q, k and v, in
sequence order (rank s holds positions ``s*T_local`` onwards).

- **Ring attention** (:func:`ring_attention`): each rank keeps its Q shard
  while the K/V shards travel the ring (``ops.collectives.ring_shift``, the
  counterpart of ``lax.ppermute``); every step runs one ring block
  (``ops.flash_attention.flash_attention_block``, kernel B2 on the card) and
  merges its ``(o, m, l)`` triple into the running one with the
  online-softmax rule. Causality follows global positions through the
  block's ``delta``.
- **Ulysses** (:func:`ulysses_attention`): ``alltoall`` re-shards from
  sequence-sharded to head-sharded, flash attention (kernel B1) runs over
  the whole sequence on the local heads, and a second ``alltoall`` shards
  back.

Both are differentiable end to end: the collectives' backward is the
transposed exchange.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.collectives import Group, alltoall, ring_shift
from ..ops.flash_attention import _NEG_INF, flash_attention_block, flash_attention_bthd


def _block_attn(q, k, v, bias, m_prev, l_prev, o_prev, scale):
    """One online-softmax accumulation step of the dense path.

    q: [B, Tq, H, D]; k/v: [B, Tk, H, D]; bias: [Tq, Tk] additive mask
    (0 or -inf). Carries m (row max), l (denominator) and o (unnormalised
    numerator), [B, H, Tq(, D)] in f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores + bias[None, None]
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))
    # Guard fully masked rows (m == -inf): keep them at zero contribution.
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    corr = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - safe_m), 0.0)
    l_new = l_prev * corr + p.sum(dim=-1)
    o_new = o_prev * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l_new, o_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Group = None,
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Blockwise ring attention over the ranks of ``group`` (None: every
    rank). q/k/v: ``[B, T_local, H, D]``, this rank's sequence shard.
    Returns ``[B, T_local, H, D]`` in q's dtype.

    After s steps this rank holds the K/V shard of rank ``(rank - s) % n``,
    whose keys sit ``(src - rank) * T_local`` positions from this rank's
    queries. ``use_flash=False`` runs the dense block instead of the ring
    block kernel (kept for A/B numerics, as in the reference)."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    if use_flash:
        # Fold heads into the kernel's batch axis once; K and V travel
        # stacked, so each ring step is one paired exchange.
        fold = lambda x: x.transpose(1, 2).reshape(B * H, T, D)
        qf = fold(q)
        kv = torch.stack([fold(k), fold(v)])
        m = torch.full((B * H, T), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(B * H, T, dtype=torch.float32, device=q.device)
        o = torch.zeros(B * H, T, D, dtype=torch.float32, device=q.device)
        for s in range(n):
            src = (rank - s) % n
            o_s, m_s, l_s = flash_attention_block(
                qf, kv[0], kv[1], (src - rank) * T, sm_scale=scale, causal=causal,
            )
            # Online-softmax merge (finite -1e30 sentinel: a fully masked
            # block contributes exp(-huge) = 0).
            m_new = torch.maximum(m, m_s)
            c, c_s = torch.exp(m - m_new), torch.exp(m_s - m_new)
            o = o * c[..., None] + o_s * c_s[..., None]
            l = l * c + l_s * c_s
            m = m_new
            if s < n - 1:
                kv = ring_shift(kv, group=group)
        l = torch.where(l == 0.0, 1.0, l)
        out = (o / l[..., None]).to(q.dtype)
        return out.reshape(B, H, T, D).transpose(1, 2)

    q_pos = rank * T + torch.arange(T, device=q.device)
    m = torch.full((B, H, T), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, T, dtype=torch.float32, device=q.device)
    o = torch.zeros(B, H, T, D, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n):
        src = (rank - s) % n
        if causal:
            k_pos = src * T + torch.arange(T, device=q.device)
            bias = torch.where(k_pos[None, :] > q_pos[:, None], -math.inf, 0.0)
        else:
            bias = torch.zeros(T, T, device=q.device)
        m, l, o = _block_attn(q, kv[0], kv[1], bias, m, l, o, scale)
        if s < n - 1:
            kv = ring_shift(kv, group=group)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).to(q.dtype).transpose(1, 2)


def _dense_attention(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """Dense softmax attention over ``[B, T, H, D]`` in f32, -inf masks."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        scores = torch.where(pos[None, :] > pos[:, None], -math.inf, scores)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Group = None,
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Ulysses all-to-all sequence parallelism: re-shard
    ``[B, T/n, H, D] -> [B, T, H/n, D]``, attention over the whole sequence
    on the local heads (the flash kernel by default), then re-shard back.
    Requires heads % n == 0."""
    n = dist.get_world_size(group)
    B, T, H, D = q.shape
    if H % n != 0:
        raise ValueError(f"ulysses needs heads ({H}) divisible by axis ({n})")
    seq_to_heads = lambda x: alltoall(x, group=group, split_axis=2, concat_axis=1)
    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if use_flash:
        out = flash_attention_bthd(qg, kg, vg, causal=causal, sm_scale=scale)
    else:
        out = _dense_attention(qg, kg, vg, causal, scale)
    return alltoall(out, group=group, split_axis=1, concat_axis=2)


def reference_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense single-process reference over ``[B, T, H, D]`` (for tests)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _dense_attention(q, k, v, causal, scale)
