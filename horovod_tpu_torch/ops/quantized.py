"""Int8-quantized ring allreduce and reduce-scatter over a process group.

The port of the flat half of ``horovod_tpu/ops/quantized.py`` (the EQuARX
idea, arXiv 2506.17615): the ring's two phases move blockwise int8 instead
of full-precision values. Each hop of the reduce-scatter phase dequantizes
the incoming partial into float32, adds the local chunk and requantizes
before forwarding, so the accumulation is never done in int8; the
all-gather phase forwards each completed chunk as its owner quantized it.

Quantization is symmetric and blockwise (``common/quant.py``): one float32
scale per ``BLOCK`` = 256 elements, ``s = max|block| / 127`` (1 for an
all-zero block) and ``q = round(v / s)`` clipped to [-127, 127], rounding
half to even as ``jnp.round`` does. The arithmetic is float32 whatever the
input dtype. One hop moves one payload: the int8 values followed by the
scales' raw bytes (``_pack``).

Hops go through a ring transport (``collectives.Ring``: ``rank``, ``n``,
``post`` and ``wait``, one ``batch_isend_irecv`` a hop); any object with
those members can stand in for it, so ``chip_smoke.py`` plays 4 ranks on
one card through the same code.

The hierarchical lowering (:func:`quantized_hierarchical_allreduce`) moves
int8 on the outermost level only: the inner levels reduce-scatter and
all-gather in full precision, and the 1/L shard crosses the outer level
(across nodes) through the int8 ring over that level's ``ring``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from ..common.quant import BLOCK
from ..common.types import ReduceOp
from . import collectives

__all__ = [
    "BLOCK",
    "EFState",
    "ef_like",
    "quantize_roundtrip",
    "quantized_reduce_fn",
    "quantized_hierarchical_allreduce",
    "quantized_ring_allreduce",
    "quantized_ring_reduce_scatter",
]


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as XLA and the CPU divide. On the card
    PyTorch multiplies by the reciprocal of a Python-number divisor, which
    can land one ulp away; a tensor divisor is divided."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _quantize(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric blockwise int8: (q int8 [m], scales f32 [m / BLOCK]).
    ``m`` must be a multiple of BLOCK (callers pad). The arithmetic runs in
    float32 whatever the input dtype: a bf16 ``v / scale`` would re-round
    the quantization grid itself."""
    vb = v.to(torch.float32).reshape(-1, BLOCK)
    amax = vb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, _true_div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(vb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale.reshape(-1)


def _dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.float32).reshape(-1, BLOCK) * scales[:, None]).reshape(-1)


def _pack(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One wire payload a hop: the int8 values, then the scales' raw bytes
    (a second transfer for the scales would double the hops' launches)."""
    return torch.cat([q, scales.contiguous().view(torch.int8)])


def _unpack(buf: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    nb = k // BLOCK
    return buf[:k], buf[k:k + 4 * nb].view(torch.float32)


def _ring_of(ring, group):
    return ring if ring is not None else collectives.Ring(group)


def _ring_rs_phase(chunks: torch.Tensor, k: int, ring, shift: int) -> torch.Tensor:
    """The shared int8-wire ring reduce-scatter pass: after n-1 hops rank r
    holds the complete float32 sum of chunk (r + 1 + shift) mod n. The
    allreduce uses shift=0 (then all-gathers); the reduce-scatter uses
    shift=-1 so that rank r finishes holding its own chunk r."""
    n, r = ring.n, ring.rank
    partial = chunks[(r + shift) % n]
    for step in range(n - 1):
        (wire,) = ring.wait(ring.post([(_pack(*_quantize(partial)), 1)]))
        q, s = _unpack(wire, k)
        partial = _dequantize(q, s) + chunks[(r - step - 1 + shift) % n]
    return partial


def quantized_ring_reduce_scatter(
    x: torch.Tensor,
    *,
    group: collectives.Group = None,
    average: bool = False,
    ring=None,
) -> torch.Tensor:
    """Reduce-scatter with int8 on the wire: rank r returns the complete sum
    (or average) of chunk r, in ``reducescatter``'s tiled layout.

    ``x`` is flat, of length n * k with k a multiple of BLOCK (callers pad;
    ``ops/fusion.zero1_shard_len`` aligns the shard). This is the
    reduce-scatter phase of :func:`quantized_ring_allreduce` with the chunk
    labels shifted by one, so rank r finishes holding chunk r, the shard
    ZeRO-1 needs, at no extra hop."""
    ring = _ring_of(ring, group)
    n = ring.n
    orig_dtype = x.dtype
    flat = x.to(torch.float32).reshape(-1)
    total = flat.shape[0]
    # Checked before the n == 1 shortcut, so misuse fails on a one-rank run
    # too and not only at scale.
    if total % n != 0 or (total // n) % BLOCK != 0:
        raise ValueError(
            f"quantized reduce-scatter needs len(x) divisible by n*BLOCK "
            f"(= {n * BLOCK}); got {total}"
        )
    if n == 1 or total == 0:
        return flat.to(orig_dtype)
    k = total // n
    partial = _ring_rs_phase(flat.reshape(n, k), k, ring, shift=-1)
    if average:
        partial = _true_div(partial, n)
    return partial.to(orig_dtype)


def quantized_ring_allreduce(
    x: torch.Tensor,
    *,
    group: collectives.Group = None,
    average: bool = False,
    ring=None,
) -> torch.Tensor:
    """Sum (or average) ``x`` over the group, moving int8 on the wire. The
    result has ``x``'s shape and dtype; the accumulation is float32. Every
    rank returns the same values, its own chunk included."""
    ring = _ring_of(ring, group)
    n, r = ring.n, ring.rank
    if n == 1:
        return x
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    total = flat.shape[0]
    if total == 0:
        # An empty leaf is an identity, not a degenerate ring of empty hops.
        return x
    k = -(-total // n)
    k = -(-k // BLOCK) * BLOCK       # the chunk a multiple of the scale block
    chunks = torch.nn.functional.pad(flat, (0, n * k - total)).reshape(n, k)

    # Reduce-scatter: after n-1 hops rank r holds the sum of chunk r + 1.
    partial = _ring_rs_phase(chunks, k, ring, shift=0)

    # All-gather: each chunk is quantized once by its owner and forwarded
    # verbatim, so the hops add no error. The owner writes the DEQUANTIZED
    # value for its own chunk too: every rank must produce the same result
    # (keeping the exact partial only locally would let replicas drift).
    q0, s0 = _quantize(partial)
    out = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    out[(r + 1) % n] = _dequantize(q0, s0)
    wire = _pack(q0, s0)
    for step in range(n - 1):
        (wire,) = ring.wait(ring.post([(wire, 1)]))
        out[(r - step) % n] = _dequantize(*_unpack(wire, k))
    result = out.reshape(-1)[:total].reshape(orig_shape)
    if average:
        result = _true_div(result, n)
    return result.to(orig_dtype)


# --- hierarchical (int8 on the outermost level only) -------------------------


def _q2l(flat: torch.Tensor, levels) -> torch.Tensor:
    """k-level allreduce of a flat f32 vector with int8 ONLY on the
    outermost level: RS(inner, full precision) -> recurse on the 1/L shard
    -> AG(inner). The base case, the outermost level alone, is the int8
    ring."""
    if len(levels) == 1:
        return quantized_ring_allreduce(flat, ring=levels[0].ring)
    inner = levels[-1]
    n = flat.shape[0]
    pad = (-n) % inner.n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    full = inner.all_gather(_q2l(inner.reduce_scatter(flat), levels[:-1]))
    return full[:n] if pad else full


def quantized_hierarchical_allreduce(x: torch.Tensor, axes, *, average: bool = False
                                     ) -> torch.Tensor:
    """Sum (or average) ``x`` over the hierarchy ``axes`` (groups or hops,
    outermost first) with int8 on the outermost level only: the inner
    levels run full-precision reduce-scatter and all-gather, the remaining
    1/L shard crosses the outer level through the int8 ring. The result
    has ``x``'s shape and dtype."""
    from ..topo.compositor import hops

    levels = hops(axes)
    if len(levels) == 1:
        return quantized_ring_allreduce(x, average=average, ring=levels[0].ring)
    flat = x.to(torch.float32).reshape(-1)
    if flat.shape[0] == 0:
        return x
    out = _q2l(flat, levels)
    if average:
        out = _true_div(out, math.prod(h.n for h in levels))
    return out.reshape(x.shape).to(x.dtype)


# --- wire round-trip (error feedback) ----------------------------------------


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``dequant(quant(x))`` with the padding and block layout the ring
    applies to a local payload: the compression operator EF-SGD compensates.
    Returns float32 of ``x``'s shape. The ring pads with zeros to whole
    blocks, and all-zero tail blocks quantize to zero with scale 1, so
    padding here to the next BLOCK boundary reproduces its scales bit for
    bit."""
    flat = x.to(torch.float32).reshape(-1)
    total = flat.shape[0]
    if total == 0:
        return flat.reshape(x.shape)
    pad = (-total) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return _dequantize(*_quantize(flat))[:total].reshape(x.shape)


class EFState(NamedTuple):
    """An optimizer state beside the error-feedback residual. ``residual``
    is RANK-LOCAL by design: each rank compensates its own quantization
    error."""

    inner: Any
    residual: Any


def ef_like(params: Any) -> Any:
    """Zero error-feedback residuals for a tensor or a dict, list or tuple
    of them: float32 per leaf whatever the leaf's dtype (a bf16 residual
    would re-round the very error it carries)."""
    if isinstance(params, dict):
        return {k: ef_like(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(ef_like(v) for v in params)
    return torch.zeros(params.shape, dtype=torch.float32, device=params.device)


# --- fusion-bucket reduce_fn -------------------------------------------------


def quantized_reduce_fn(mode: str = "flat"):
    """A ``reduce_fn`` for ``ops/fusion.fused_allreduce``: float buckets
    ride the int8 wire, integer buckets reduce exactly (buckets are one
    dtype, so dispatching per bucket loses nothing). ``mode``: ``"flat"``,
    the int8 ring over the group (over the flattened group of a tuple);
    ``"two-level"``, int8 on the outermost level only
    (:func:`quantized_hierarchical_allreduce`; ``group`` is the hierarchy's
    tuple of groups, outermost first)."""
    if mode not in ("flat", "two-level"):
        raise ValueError(f"unknown quantized reduce mode {mode!r}")

    def fn(x, *, op, group=None, prescale_factor=1.0, postscale_factor=1.0, ring=None):
        if not x.is_floating_point():
            return collectives.allreduce(
                x, op=op, group=collectives.flat_group(group), prescale_factor=prescale_factor,
                postscale_factor=postscale_factor,
            ).to(x.dtype)
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"quantized reduction supports SUM/AVERAGE; got {op}")
        if prescale_factor != 1.0:
            x = x * prescale_factor
        average = op == ReduceOp.AVERAGE
        if mode == "two-level":
            out = quantized_hierarchical_allreduce(x, group, average=average)
        else:
            out = quantized_ring_allreduce(x, group=collectives.flat_group(group),
                                           average=average, ring=ring)
        if postscale_factor != 1.0:
            out = out * postscale_factor
        return out

    return fn
