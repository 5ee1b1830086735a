"""Collective matmul: the all-gather and the reduce-scatter fused into the matmul.

The counterpart of ``horovod_tpu/ops/collective_matmul.py``, the primitives
of the fused DP×TP path:

- :func:`all_gather_matmul`: ``all_gather(x_shard over tokens) @ w``. The
  local chunk is multiplied first; then at each hop of a bidirectional ring
  the resident chunks move on while the chunks that just arrived are
  multiplied into their rows (kernel B3, ``_ag_matmul_tpu`` on the TPU).
- :func:`matmul_reduce_scatter`: ``reduce_scatter(y @ w over tokens)``. In
  each direction an f32 accumulator starts as the partial product of the
  farthest destination and rides the ring, each hop adding the next
  destination's partial; the output is this rank's own partial plus both
  arrivals (kernel B4, ``_mrs_tpu``).

``psum(y @ w) == all_gather(matmul_reduce_scatter(y, w))`` over tokens, which
makes the fused Megatron block equal to the classic one.

The schedule is Python, one function per primitive, shared by the kernel
path and the plain path: ``ring_hops(n)`` hops right and left, each of
``resolve_chunks`` sub-chunks making the whole traversal. At each hop both
directions' transfers are posted in ONE ``batch_isend_irecv``, in the same
order on every rank. On the card it runs on the process group's own NCCL
stream, ordered after the compute stream's queued work by a CUDA event;
the chunk product of what arrived at the previous hop is queued next on
the compute stream, so it overlaps the transfer, and the compute stream
waits for the transfer (another event) only when it needs what arrived. (A
side stream of the port's own between the two measured slower on 4 H100s,
0.39 against 0.22 ms a hop; PERF.md.) On Hopper the TPU kernel's in-kernel
remote copies become these NCCL transfers outside the kernel; the
kernels (``csrc/collective_matmul.cu``) do each hop's product.

Beside each kernel is its plain PyTorch version (``_chunk_product_plain``,
``_partial_product_plain``, ``_epilogue_plain``); a wrapper takes the plain
version only for tensors on the CPU, and for any other tensor launches the
kernel or raises. ``AGMM_LAUNCHES`` counts B3's chunk-product launches and
``MRS_LAUNCHES`` B4's partial-product launches.

bf16 products run on the TMA + wgmma kernel at the tile ``tile_for(K, N,
dtype)`` picks; the choice depends on nothing else, so a chunk's rows are
bitwise the rows of the same product over the gathered input. Operands TMA
cannot take (``_tma_ok``: K or N not a multiple of 8, a base address off 16
bytes) take the earlier WMMA kernel, and f32 the FMA kernel, chosen by shape
before the launch.

Both primitives are differentiable, with the DUAL primitive as backward
(``_agmm_bwd``/``_mrs_bwd``): d(all_gather_matmul)/dx is a
matmul_reduce_scatter of the cotangent and d(matmul_reduce_scatter)/dy an
all_gather_matmul; the weight gradient (``_ring_grad_w``) circulates one
operand around the same ring and contracts it with ``torch.matmul``, as the
JAX package computes it outside Pallas.

The accumulator rides the ring in f32, as in the TPU kernel; the JAX
reference ring ``_mrs_ref`` adds the hops in y's dtype, so in bf16 the port
is the more exact of the two.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, List, Optional, Tuple

import torch

from . import _build
from .collectives import Group, Ring

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

AGMM_LAUNCHES = 0
MRS_LAUNCHES = 0

__all__ = [
    "all_gather_matmul",
    "matmul_reduce_scatter",
    "resolve_chunks",
    "ring_hops",
    "fusable",
    "expected_ppermutes",
]


# --- ring shape ---------------------------------------------------------------


def ring_hops(n: int) -> Tuple[int, int]:
    """(forward, backward) hop counts of the bidirectional ring: the n-1
    transfers split so both directions carry half the payload."""
    n = int(n)
    if n <= 1:
        return 0, 0
    return n // 2, (n - 1) // 2


def resolve_chunks(tokens_per_rank: int, chunks: int = 0) -> int:
    """The sub-chunk count: ``chunks`` (or ``HOROVOD_TP_OVERLAP_CHUNKS``
    when 0) clamped to the largest divisor of the per-rank token chunk."""
    c = int(chunks)
    if c <= 0:
        try:
            c = int(os.environ.get("HOROVOD_TP_OVERLAP_CHUNKS", "0"))
        except ValueError:
            c = 0
    if c <= 0:
        c = 1
    t = max(int(tokens_per_rank), 1)
    c = min(c, t)
    while t % c:
        c -= 1
    return max(c, 1)


def expected_ppermutes(n: int, chunks: int = 1) -> int:
    """Ring transfers of ONE primitive's forward: every sub-chunk makes the
    full bidirectional traversal."""
    return (int(n) - 1) * max(int(chunks), 1) if n > 1 else 0


def fusable(tokens: int, n: int) -> bool:
    """Whether the token dim splits evenly over the axis (the fused
    schedule needs equal chunks)."""
    n = int(n)
    return n > 1 and int(tokens) % n == 0


# --- plain versions -----------------------------------------------------------


def _chunk_product_plain(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """B3's hop: ``out = a @ w`` summed in f32, written into the view
    ``out`` in its dtype."""
    out.copy_((a.float() @ w.float()).to(out.dtype))


def _partial_product_plain(a: torch.Tensor, w: torch.Tensor,
                           acc_in: Optional[torch.Tensor]) -> torch.Tensor:
    """B4's hop: the f32 accumulator ``acc_in + a @ w`` (``a @ w`` alone
    when ``acc_in`` is None)."""
    p = a.float() @ w.float()
    return p if acc_in is None else acc_in + p


def _epilogue_plain(own, fwd, bwd, dtype) -> torch.Tensor:
    """B4's output: (own + forward arrival) + backward arrival, cast."""
    acc = own if fwd is None else own + fwd
    acc = acc if bwd is None else acc + bwd
    return acc.to(dtype)


# --- the tile -----------------------------------------------------------------

# The TMA + wgmma kernel's tile (BM, BN, STAGES) by (K, N), for bf16: the
# committed choice of tools/cm_tile_sweep.py at the shapes the fused GPT step
# gives it (PERF.md); other shapes take DEFAULT_TILE. A tile must be one the
# library was built with (HVT_CM_CONFIGS in csrc/collective_matmul.cu); the C
# entries refuse any other.
TILES = {(768, 576): (64, 192, 4), (768, 768): (64, 192, 4), (192, 768): (64, 192, 4),
         (576, 768): (64, 192, 4), (768, 192): (64, 128, 4)}
DEFAULT_TILE = (64, 128, 4)
SIMT_TILE = (0, 0, 0)   # the earlier kernels: WMMA (bf16), FMA (f32)


def tile_for(k: int, n: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The tile of the product [rows, k] @ [k, n] in ``dtype``: a function
    of (k, n, dtype) alone, never of the rows or the batch, so every output
    element is summed in one order. f32 takes the FMA kernel
    (``SIMT_TILE``)."""
    if dtype != torch.bfloat16:
        return SIMT_TILE
    return TILES.get((int(k), int(n)), DEFAULT_TILE)


def _tma_ok(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *more) -> bool:
    """Whether the TMA kernel can take these operands: bf16, K and N
    multiples of 8 and the batch strides multiples of 8 elements (TMA's
    16-byte strides), and every base address 16-byte aligned (a chunk is a
    view at a row offset). ``more``: further tensors the kernel reads or
    writes (B4's accumulators), None allowed."""
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return False
    k, n = w.shape
    if k % 8 or n % 8 or a.stride(0) % 8 or out.stride(0) % 8:
        return False
    return all(t.data_ptr() % 16 == 0 for t in (a, w, out, *more) if t is not None)


# --- the kernels --------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ENTRIES: dict = {}
_MAP_REFUSED = 10000    # kMapRefused in csrc/collective_matmul.cu, plus the CUresult


def _lib() -> ctypes.CDLL:
    return bind(_build.load("collective_matmul"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a loaded collective-matmul
    library (the package's own, or a variant built with other tiles)."""
    if not getattr(lib, "_hvt_bound", False):
        lib.hvt_chunk_product.argtypes = [_P] * 3 + [_I] * 4 + [_L] * 2 + [_I] * 4 + [_P]
        lib.hvt_partial_product.argtypes = [_P] * 4 + [_I] * 4 + [_L] + [_I] * 4 + [_P]
        lib.hvt_mrs_epilogue.argtypes = [_P] * 4 + [_L, _I, _P]
        for fn in (lib.hvt_chunk_product, lib.hvt_partial_product, lib.hvt_mrs_epilogue):
            fn.restype = ctypes.c_int
        lib._hvt_bound = True
    return lib


def _entry(name: str):
    """The bound C entry, looked up once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(_lib(), name)
    return fn


def _run(entry: str, device: torch.device, *args) -> None:
    """Call a C entry on ``device``'s current stream (its raw handle, as
    Triton's launcher takes it: the cheapest lookup); raise on its error."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = _entry(entry)(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = _entry(entry)(*args, stream)
    if rc >= _MAP_REFUSED:
        raise RuntimeError(f"{entry}: the CUDA driver refused a TMA tensor map "
                           f"(CUresult {rc - _MAP_REFUSED})")
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")


def _check_operands(a: torch.Tensor, w: torch.Tensor, *others: torch.Tensor) -> None:
    """a: [batch, rows, K] with contiguous rows; w: [K, N] contiguous; every
    tensor on one CUDA device; a and w of one dtype, f32 or bf16."""
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev for t in (w, *others)):
        raise ValueError(
            f"collective matmul kernels need every tensor on one CUDA device; got "
            f"{[str(t.device) for t in (a, w, *others)]}"
        )
    if a.dtype not in _DTYPE_CODES or w.dtype != a.dtype:
        raise ValueError(
            f"collective matmul kernels take float32 or bfloat16 operands of one "
            f"dtype; got {a.dtype} and {w.dtype}"
        )
    if a.dim() != 3 or w.dim() != 2 or a.shape[2] != w.shape[0]:
        raise ValueError(f"expected a [batch, rows, K] and w [K, N]; got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if not w.is_contiguous() or a.stride(2) != 1 or (a.shape[1] > 1 and a.stride(1) != a.shape[2]):
        raise ValueError("collective matmul kernels need contiguous rows of a and a contiguous w")


def _tile(a, w, out, more, legacy: bool) -> Tuple[int, int, int]:
    """The tile a launch runs: ``tile_for`` where ``_tma_ok``, else the
    earlier kernels. ``legacy`` runs the earlier kernels on any operands, so
    chip_smoke.py can time the two designs in turns; the rings never set it."""
    if legacy or not _tma_ok(a, w, out, *more):
        return SIMT_TILE
    return tile_for(w.shape[0], w.shape[1], a.dtype)


def _launch_chunk_product(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                          legacy: bool = False) -> None:
    """B3 on the card: ``out`` is a [batch, rows, N] view of the gathered
    output (contiguous rows, any batch stride)."""
    global AGMM_LAUNCHES
    _check_operands(a, w, out)
    batch, rows, k = a.shape
    n = w.shape[1]
    if out.dtype != a.dtype or out.shape != (batch, rows, n) or out.stride(2) != 1 or (
            rows > 1 and out.stride(1) != n):
        raise ValueError(f"output view {tuple(out.shape)} {out.dtype} does not fit "
                         f"{tuple(a.shape)} @ {tuple(w.shape)}")
    _run("hvt_chunk_product", a.device, a.data_ptr(), w.data_ptr(), out.data_ptr(),
         batch, rows, k, n, a.stride(0), out.stride(0), _DTYPE_CODES[a.dtype],
         *_tile(a, w, out, (), legacy))
    AGMM_LAUNCHES += 1


def _launch_partial_product(a: torch.Tensor, w: torch.Tensor, acc_in: Optional[torch.Tensor],
                            legacy: bool = False) -> torch.Tensor:
    """B4 on the card: returns the f32 ``acc_in + a @ w``."""
    global MRS_LAUNCHES
    _check_operands(a, w, *(() if acc_in is None else (acc_in,)))
    batch, rows, k = a.shape
    n = w.shape[1]
    if acc_in is not None and (acc_in.dtype != torch.float32 or not acc_in.is_contiguous()
                               or acc_in.shape != (batch, rows, n)):
        raise ValueError(f"the accumulator must be contiguous float32 {(batch, rows, n)}")
    acc_out = torch.empty(batch, rows, n, dtype=torch.float32, device=a.device)
    _run("hvt_partial_product", a.device, a.data_ptr(), w.data_ptr(),
         None if acc_in is None else acc_in.data_ptr(), acc_out.data_ptr(),
         batch, rows, k, n, a.stride(0), _DTYPE_CODES[a.dtype],
         *_tile(a, w, acc_out, (acc_in,), legacy))
    MRS_LAUNCHES += 1
    return acc_out


def _launch_epilogue(own, fwd, bwd, dtype) -> torch.Tensor:
    for t in (own, fwd, bwd):
        if t is not None and (t.device.type != "cuda" or t.dtype != torch.float32
                              or not t.is_contiguous() or t.shape != own.shape):
            raise ValueError("the epilogue takes contiguous float32 CUDA accumulators "
                             "of one shape")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the epilogue writes float32 or bfloat16, not {dtype}")
    out = torch.empty(own.shape, dtype=dtype, device=own.device)
    _run("hvt_mrs_epilogue", own.device, own.data_ptr(),
         None if fwd is None else fwd.data_ptr(), None if bwd is None else bwd.data_ptr(),
         out.data_ptr(), own.numel(), _DTYPE_CODES[dtype])
    return out


def _chunk_product(a, w, out) -> None:
    if a.device.type == "cpu":
        _chunk_product_plain(a, w, out)
    else:
        _launch_chunk_product(a, w, out)


def _partial_product(a, w, acc_in=None) -> torch.Tensor:
    if a.device.type == "cpu":
        return _partial_product_plain(a, w, acc_in)
    return _launch_partial_product(a, w, acc_in)


def _epilogue(own, fwd, bwd, dtype) -> torch.Tensor:
    if own.device.type == "cpu":
        return _epilogue_plain(own, fwd, bwd, dtype)
    return _launch_epilogue(own, fwd, bwd, dtype)


# --- the ring -----------------------------------------------------------------

# The ring transport is ``collectives.Ring``: one ``batch_isend_irecv`` a hop.
_Ring = Ring


def _circulate(ring: _Ring, chunk: torch.Tensor,
               consume: Callable[[torch.Tensor, int, bool], None]) -> None:
    """Send ``chunk`` around both directions of the ring, ``ring_hops``
    hops each; ``consume(arrived, source_rank, forward)`` runs on each
    arrival while the next hop is in flight."""
    n, r = ring.n, ring.rank
    h_fwd, h_bwd = ring_hops(n)
    fwd = bwd = chunk
    pending: List[Tuple[torch.Tensor, int, bool]] = []
    for k in range(1, h_fwd + 1):
        handle = ring.post([(fwd, 1)] + ([(bwd, -1)] if k <= h_bwd else []))
        for arrived in pending:
            consume(*arrived)
        recvs = ring.wait(handle)
        fwd = recvs[0]
        pending = [(fwd, (r - k) % n, True)]
        if k <= h_bwd:
            bwd = recvs[1]
            pending.append((bwd, (r + k) % n, False))
    for arrived in pending:
        consume(*arrived)


def _ag_matmul(x: torch.Tensor, w: torch.Tensor, ring: _Ring, chunks: int) -> torch.Tensor:
    """The all-gather-matmul ring: ``x`` [..., Tc, D] (this rank's token
    chunk), ``w`` [D, F]; returns [..., n*Tc, F] with source rank j's rows
    at offset j*Tc of every batch row (``lax.all_gather(tiled=True)``
    order), in x's dtype."""
    n, r = ring.n, ring.rank
    tc, d = x.shape[-2], x.shape[-1]
    x3 = x.reshape(-1, tc, d)
    out = x.new_empty(x3.shape[0], n * tc, w.shape[-1])
    _chunk_product(x3, w, out[:, r * tc:(r + 1) * tc])
    if n > 1:
        c = resolve_chunks(tc, chunks)
        sc = tc // c
        for s in range(c):
            def write(arrived, src, _forward, s=s):
                row = src * tc + s * sc
                _chunk_product(arrived, w, out[:, row:row + sc])

            _circulate(ring, x3[:, s * sc:(s + 1) * sc].contiguous(), write)
    return out.view(*x.shape[:-2], n * tc, w.shape[-1])


def _mrs(y: torch.Tensor, w: torch.Tensor, ring: _Ring, chunks: int) -> torch.Tensor:
    """The matmul-reduce-scatter ring: ``y`` [..., T, Fl] (all tokens, local
    features), ``w`` [Fl, D]; returns this rank's [..., T/n, D] chunk of
    ``reduce_scatter(y @ w)`` (token-tiled, SUM), in y's dtype. The
    accumulators are f32."""
    n, r = ring.n, ring.rank
    t, fl = y.shape[-2], y.shape[-1]
    if t % n:
        raise ValueError(
            f"matmul_reduce_scatter needs tokens ({t}) divisible by the axis size ({n})"
        )
    tc = t // n
    y3 = y.reshape(-1, t, fl)
    h_fwd, h_bwd = ring_hops(n)
    c = resolve_chunks(tc, chunks)
    sc = tc // c
    outs = []
    for s in range(c):
        def part(dest, acc_in=None, s=s):
            row = dest * tc + s * sc
            return _partial_product(y3[:, row:row + sc], w, acc_in)

        fwd = part((r + h_fwd) % n) if h_fwd else None
        bwd = part((r - h_bwd) % n) if h_bwd else None
        own = None
        for j in range(1, h_fwd + 1):
            handle = ring.post([(fwd, 1)] + ([(bwd, -1)] if j <= h_bwd else []))
            if own is None:
                own = part(r)   # runs while the first hop is in flight
            recvs = ring.wait(handle)
            fwd = recvs[0] if j == h_fwd else part((r + h_fwd - j) % n, recvs[0])
            if j <= h_bwd:
                bwd = recvs[1] if j == h_bwd else part((r - h_bwd + j) % n, recvs[1])
        if own is None:
            own = part(r)
        outs.append(_epilogue(own, fwd, bwd, y.dtype))
    out = outs[0] if c == 1 else torch.cat(outs, dim=1)
    return out.view(*y.shape[:-2], tc, w.shape[-1])


def _ring_grad_w(circ: torch.Tensor, full: torch.Tensor, ring: _Ring,
                 circ_is_lhs: bool) -> torch.Tensor:
    """The weight-gradient ring of both backwards: ``sum_j A_j^T @ B_j``
    over source ranks j, where one operand's chunk circulates (``circ``,
    this rank's [..., Tc, *]) and the other is the local token slice of
    ``full`` [..., n*Tc, *]; ``circ_is_lhs`` puts the circulating chunk on
    the transposed side. Summed in the reference's order: own, then the
    forward arrivals, then the backward ones."""
    tc = circ.shape[-2]

    def one(chunk, src):
        seg = full[..., src * tc:(src + 1) * tc, :]
        a, b = (chunk, seg) if circ_is_lhs else (seg, chunk)
        return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])

    dw = one(circ, ring.rank)
    terms = {True: [], False: []}
    _circulate(ring, circ.contiguous(),
               lambda arrived, src, forward: terms[forward].append(one(arrived, src)))
    for term in terms[True] + terms[False]:
        dw = dw + term
    return dw


def _agmm_bwd(x, w, ct, ring: _Ring, chunks: int):
    """The all-gather-matmul's gradients: dx = reduce_scatter(ct @ w^T),
    the dual primitive; dw = all_gather(x)^T @ ct as the x chunks ride the
    ring. Every rank runs both rings, in this order."""
    ct = ct.contiguous()
    dx = _mrs(ct, w.t().contiguous(), ring, chunks).to(x.dtype)
    dw = _ring_grad_w(x, ct, ring, circ_is_lhs=True).to(w.dtype)
    return dx, dw


def _mrs_bwd(y, w, ct, ring: _Ring, chunks: int):
    """The matmul-reduce-scatter's gradients: dy = all_gather(ct) @ w^T,
    the dual primitive; dw = y^T @ all_gather(ct) as the ct chunks ride
    the ring."""
    ct = ct.contiguous()
    dy = _ag_matmul(ct, w.t().contiguous(), ring, chunks).to(y.dtype)
    dw = _ring_grad_w(ct, y, ring, circ_is_lhs=False).to(w.dtype)
    return dy, dw


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ring, chunks):
        ctx.save_for_backward(x, w)
        ctx.ring, ctx.chunks = ring, chunks
        return _ag_matmul(x, w, ring, chunks)

    @staticmethod
    def backward(ctx, ct):
        return (*_agmm_bwd(*ctx.saved_tensors, ct, ctx.ring, ctx.chunks), None, None)


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w, ring, chunks):
        ctx.save_for_backward(y, w)
        ctx.ring, ctx.chunks = ring, chunks
        return _mrs(y, w, ring, chunks)

    @staticmethod
    def backward(ctx, ct):
        return (*_mrs_bwd(*ctx.saved_tensors, ct, ctx.ring, ctx.chunks), None, None)


def all_gather_matmul(x_shard: torch.Tensor, w: torch.Tensor, *, group: Group = None,
                      chunks: int = 0) -> torch.Tensor:
    """``all_gather(x_shard, tiled over tokens) @ w`` with the gather fused
    into the matmul. ``x_shard`` [..., T/n, D] (token dim -2), ``w`` [D,
    F]; returns [..., T, F] in x's dtype. ``chunks`` sub-splits each rank's
    chunk (0: ``HOROVOD_TP_OVERLAP_CHUNKS``, else 1). Every rank of
    ``group`` must call it, in the same order. Differentiable."""
    return _AllGatherMatmul.apply(x_shard.contiguous(), w.contiguous(), _Ring(group),
                                  int(chunks))


def matmul_reduce_scatter(y: torch.Tensor, w: torch.Tensor, *, group: Group = None,
                          chunks: int = 0) -> torch.Tensor:
    """``reduce_scatter(y @ w, tiled over tokens)`` with the reduction fused
    into the matmul. ``y`` [..., T, Fl], ``w`` [Fl, D]; returns this rank's
    [..., T/n, D] chunk in y's dtype. Every rank of ``group`` must call it,
    in the same order. Differentiable."""
    return _MatmulReduceScatter.apply(y.contiguous(), w.contiguous(), _Ring(group),
                                      int(chunks))
