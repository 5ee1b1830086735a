"""Flash attention: the hand-written CUDA kernels and their plain versions.

The counterpart of ``horovod_tpu/ops/pallas_attention.py``. The kernels
(``csrc/flash_attention.cu``) replace the TPU kernel ``_fwd_kernel`` and
the ``lax.scan`` backward ``_flash_vjp_bwd``: a forward that writes O and
the row logsumexp, and two backward kernels, dQ and then dK/dV.

Beside each kernel is its plain PyTorch version, ``_flash_fwd_plain`` and
``_flash_bwd_plain``, which repeat the reference's arithmetic block by
block. A wrapper takes the plain version only for tensors on the CPU (that
is how the tests run); for CUDA tensors it launches the kernel or raises.
In f32 the kernels run on the CUDA cores with the plain versions'
arithmetic; in bf16 they run on the tensor cores, which take P (and, in
the backward, dS) in bf16. ``p_dtype=torch.bfloat16`` makes a plain version
round them where the kernels do, and ``kernel_tiles`` gives the forward's
K tile, the block over which its online softmax rounds P.

``FWD_LAUNCHES`` counts launches of the forward kernel. ``BWD_LAUNCHES``
counts backward launches, each of which launches the dQ kernel and then
the dK/dV kernel once. A batch x heads axis longer than a grid holds
(65535) launches in pieces, each counted.

The ring-attention block (``flash_attention_block``, the reference's
``normalize=False`` mode of the same TPU kernel) runs the forward in its
block mode, counted by ``BLOCK_LAUNCHES``, with the plain version
``_flash_block_plain``. Its backward, the VJP of the reference's dense
recompute (``_dense_block``) through all three cotangents, runs the two
backward kernels in their block mode, counted by ``BLOCK_BWD_LAUNCHES``,
with the plain version ``_flash_block_bwd_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BLOCK_LAUNCHES = 0
BLOCK_BWD_LAUNCHES = 0


def _pick_block(t: int, pref: int) -> int:
    """Largest block <= pref that divides t. A length whose best divisor
    is below 8 is refused, as the reference kernel refuses it."""
    cap = min(pref, t)
    b = cap
    while t % b:
        b -= 1
    if b < 8 and b < cap:
        raise ValueError(
            f"sequence length {t} has no block divisor >= 8 under "
            f"{pref}; pad the sequence or pass explicit block sizes"
        )
    return b


def flashable(t_q: int, t_k: int, block_q: int = 128,
              block_k: int = 128) -> bool:
    """Whether the flash path accepts these sequence lengths (callers with
    arbitrary shapes use this to take the dense path instead)."""
    try:
        _pick_block(t_q, block_q)
        _pick_block(t_k, block_k)
        return True
    except ValueError:
        return False


def flash_shape_ok(t_q: int, t_k: int, d: int) -> bool:
    """Whether attention of these lengths and head dim takes the flash
    path: lengths ``flashable`` accepts and a head dim of at most 128 (one
    that is not 32, 64 or 128 is zero-padded to the next of them, which is
    exact). Other shapes take the dense path. The same choice on the CPU and
    on the card."""
    return d <= _HEAD_DIMS[-1] and flashable(t_q, t_k)


def _padded(d: int) -> int:
    """The kernels' head dim for ``d`` <= 128: the next of 32, 64, 128."""
    return next(h for h in _HEAD_DIMS if h >= d)


def _pad_head(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` zero-padded on its last axis to ``dp``. Zero columns add
    nothing to Q K^T and give zero columns of O, dQ, dK and dV, so the
    padded attention is the attention, and its gradient flows back through
    the pad's slice."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def _dense_full(q, k, v, causal, sm_scale):
    """Dense [BH, T, D] attention, for lengths the flash path refuses."""
    s = q.float() @ k.float().transpose(1, 2) * sm_scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


# --------------------------------------------------------------------------
# Plain versions: the reference's arithmetic, one K block at a time.
# --------------------------------------------------------------------------

def _rounded(x: torch.Tensor, p_dtype) -> torch.Tensor:
    """``x`` rounded to ``p_dtype`` and widened back (``x`` itself for None):
    where the bf16 kernels round an operand of their second product."""
    return x if p_dtype is None else x.to(p_dtype).float()


def _online_softmax_plain(q, k, v, causal: bool, sm_scale: float, delta: int,
                          block_k: int = 128, p_dtype=None):
    """The loop of ``_fwd_kernel``: the online softmax over K blocks in f32,
    with key ``j`` visible to query ``i`` under the causal mask when
    ``i >= j + delta``. Returns the unnormalised sum P V [BH, T_q, D] and the
    row max m and row sum l, [BH, T_q, 1] each.

    With ``p_dtype`` (``torch.bfloat16``) the loop is the bf16 kernel's: K
    blocks of exactly ``block_k`` keys (the kernel's tile) with a ragged last
    one, and P rounded to ``p_dtype`` before P V; l sums the unrounded P."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    bk = _pick_block(t_k, block_k) if p_dtype is None else block_k
    qf = q.float()
    acc = torch.zeros(bh, t_q, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, t_q, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, t_q, 1, dtype=torch.float32, device=q.device)
    q_pos = torch.arange(t_q, device=q.device)[:, None]
    for k0 in range(0, t_k, bk):
        s = qf @ k[:, k0:k0 + bk].float().transpose(1, 2) * sm_scale
        if causal:
            keys = torch.arange(k0, k0 + s.shape[-1], device=q.device)
            mask = q_pos >= keys[None, :] + delta
            s = torch.where(mask, s, _NEG_INF)
        m_curr = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_curr)
        p = torch.exp(s - m_curr)
        if causal:
            # A fully masked row has m_curr == -1e30: re-mask p.
            p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _rounded(p, p_dtype) @ v[:, k0:k0 + bk].float()
        m = m_curr
    return acc, m, l


def _flash_fwd_plain(q, k, v, causal: bool, sm_scale: float, block_k: int = 128,
                     p_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fwd_kernel`` with ``normalize=True``: returns O in the input dtype
    and lse = m + log l (f32). ``p_dtype``: see ``_online_softmax_plain``."""
    acc, m, l = _online_softmax_plain(q, k, v, causal, sm_scale, 0, block_k, p_dtype)
    l = torch.where(l == 0.0, 1.0, l)   # fully masked rows -> 0 out
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _flash_block_plain(q, k, v, delta: int, causal: bool, sm_scale: float,
                       block_k: int = 128, p_dtype=None):
    """``_fwd_kernel`` with ``normalize=False``, the ring-attention block:
    the f32 triple (unnormalised O, m, l) with the causal mask shifted by
    ``delta``. A row that sees no key keeps m = -1e30, l = 0, O = 0.
    ``p_dtype``: see ``_online_softmax_plain``."""
    acc, m, l = _online_softmax_plain(q, k, v, causal, sm_scale, delta, block_k, p_dtype)
    return acc, m[..., 0], l[..., 0]


def _dense_block(q, k, v, delta: int, sm_scale: float, causal: bool):
    """The block's (O, m, l) computed densely in f32: the recompute target
    of the block's backward (``pallas_attention.py:_dense_block``). m is
    ``amax`` and ``maximum``, whose gradients ties share, as they share
    ``jnp.max``'s and ``jnp.maximum``'s."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf @ kf.transpose(1, 2) * sm_scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :] + delta)
        s = torch.where(mask, s, _NEG_INF)
    m = torch.maximum(torch.amax(s, dim=-1), s.new_tensor(_NEG_INF))
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    return p @ vf, m, p.sum(dim=-1)


def _bwd_sweep_plain(q, k, v, do, shift, dsum, causal: bool, sm_scale: float, delta: int,
                     bk: int, p_dtype=None, tie_coef=None):
    """The K-block loop of the two backward kernels, one block of ``bk``
    keys at a time (the last one ragged): P = exp(s - shift) under the
    causal mask shifted by ``delta``, dS = P (dO V^T - Dsum) scale, dQ = dS K,
    dK = dS^T Q, dV = P^T dO. With ``tie_coef`` (the ring block), dS gains
    ``tie_coef`` scale where a visible score equals ``shift``. With
    ``p_dtype`` P, dS and dO are rounded to it before the products that take
    them, as the bf16 kernels round them; dS is formed from the unrounded P,
    and its tie term, which carries a row's whole dm - D, is added after the
    rounding, as the kernels add it in f32."""
    t_q, t_k = q.shape[1], k.shape[1]
    qf = q.float()
    dor = _rounded(do.float(), p_dtype)
    q_pos = torch.arange(t_q, device=q.device)[:, None]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, t_k, bk):
        kb = k[:, k0:k0 + bk].float()
        vb = v[:, k0:k0 + bk].float()
        s = qf @ kb.transpose(1, 2) * sm_scale
        if causal:
            mask = q_pos >= torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :] + delta
            s = torch.where(mask, s, _NEG_INF)
        p = torch.exp(s - shift[:, :, None])
        if causal:
            p = torch.where(mask, p, 0.0)
        dp = dor @ vb.transpose(1, 2)
        ds = p * (dp - dsum[:, :, None]) * sm_scale
        ds_r = _rounded(ds, p_dtype)
        if tie_coef is not None:
            tie = s == shift[:, :, None]
            if causal:
                tie = tie & mask
            ds_r = ds_r + torch.where(tie, (tie_coef * sm_scale)[:, :, None], 0.0)
        dq = dq + ds_r @ kb
        dks.append(ds_r.transpose(1, 2) @ qf)
        dvs.append(_rounded(p, p_dtype).transpose(1, 2) @ dor)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool, sm_scale: float,
                     block_k: int = 128, p_dtype=None):
    """``_flash_vjp_bwd``: recompute P per K block from lse, with
    D = rowsum(dO * O) and dS = P (dP - D) * scale. With ``p_dtype``
    (``torch.bfloat16``) P and dS are rounded to it before the products
    that take them (dV = P^T dO, dQ = dS K, dK = dS^T Q), as the bf16
    kernels round them; dS is formed from the unrounded P."""
    dsum = (do.float() * o.float()).sum(dim=-1)
    return _bwd_sweep_plain(q, k, v, do, lse, dsum, causal, sm_scale, 0,
                            _pick_block(k.shape[1], block_k), p_dtype)


def _block_row_max(q, k, delta: int, causal: bool, sm_scale: float, bk: int):
    """The first sweep of the block backward: each row's max m over its
    visible scores (at least -1e30) and the count c of visible scores equal
    to it, one K block at a time."""
    bh, t_q = q.shape[:2]
    qf = q.float()
    q_pos = torch.arange(t_q, device=q.device)[:, None]
    m = torch.full((bh, t_q), _NEG_INF, dtype=torch.float32, device=q.device)
    c = torch.zeros(bh, t_q, dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], bk):
        s = qf @ k[:, k0:k0 + bk].float().transpose(1, 2) * sm_scale
        mask = torch.ones_like(s, dtype=torch.bool)
        if causal:
            mask = q_pos >= torch.arange(k0, k0 + s.shape[-1], device=q.device)[None, :] + delta
            s = torch.where(mask, s, _NEG_INF)
        bm = s.amax(dim=-1)
        bc = ((s == bm[..., None]) & mask).sum(dim=-1).float()
        c = torch.where(bm > m, bc, torch.where(bm == m, c + bc, c))
        m = torch.maximum(m, bm)
    return m, c


def _flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, delta: int, causal: bool,
                           sm_scale: float, block_k: int = 128, p_dtype=None):
    """The VJP of the ring block's (O, m, l) (``_dense_block``'s, which the
    reference's ``_flash_block_vjp_bwd`` takes) against the cotangents
    (dO, dm, dl), one K block of ``block_k`` keys at a time. Per row i over
    its visible keys j, with m and the tie count c from a first sweep of
    the scores (``_block_row_max``) and P = exp(s - m):

        dS_ij = P_ij (dO_i . v_j + dl_i) + [s_ij == m_i] (dm_i - D_i) / c_i,
        D_i = dO_i . O_i + dl_i l_i,

    dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO: B1's backward with lse
    -> m, Dsum -> -dl, the mask shifted by ``delta`` and the tie term (amax
    shares its gradient evenly among ties). D takes the forward's f32 O and
    l. ``p_dtype`` rounds P, dS and dO as the bf16 kernels do."""
    m, c = _block_row_max(q, k, delta, causal, sm_scale, block_k)
    d_row = (do.float() * o.float()).sum(dim=-1) + dl * l
    tie_coef = torch.where(c > 0, (dm - d_row) / torch.clamp(c, min=1.0), 0.0)
    return _bwd_sweep_plain(q, k, v, do, m, -dl, causal, sm_scale, delta, block_k, p_dtype,
                            tie_coef)


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a loaded flash library (the
    package's own, or a variant built with other tile sizes)."""
    if not getattr(lib, "_hvt_bound", False):
        lib.hvt_flash_fwd.argtypes = [_P] * 5 + [_I] * 5 + [_F, _I, _P]
        lib.hvt_flash_block_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_F, _I, _I, _I, _P]
        lib.hvt_flash_bwd_dq.argtypes = [_P] * 8 + [_I] * 5 + [_F, _I, _P]
        lib.hvt_flash_bwd_dkdv.argtypes = [_P] * 8 + [_I] * 5 + [_F, _I, _P]
        lib.hvt_flash_block_bwd_dq.argtypes = [_P] * 13 + [_I] * 5 + [_F, _I, _I, _P]
        lib.hvt_flash_block_bwd_dkdv.argtypes = [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P]
        lib.hvt_flash_tiles.argtypes = [_I, ctypes.POINTER(_I)]
        for fn in (lib.hvt_flash_fwd, lib.hvt_flash_block_fwd, lib.hvt_flash_bwd_dq,
                   lib.hvt_flash_bwd_dkdv, lib.hvt_flash_block_bwd_dq,
                   lib.hvt_flash_block_bwd_dkdv, lib.hvt_flash_tiles):
            fn.restype = ctypes.c_int
        lib._hvt_bound = True
    return lib


def kernel_tiles(d: int, lib: Optional[ctypes.CDLL] = None) -> dict:
    """The bf16 kernels' tile rows at head dim ``d`` (builds the library):
    ``fwd`` (Q, K), ``dq`` (Q, K) and ``dkdv`` (K, Q). A plain version
    given ``block_k=tiles["fwd"][1]`` and ``p_dtype=torch.bfloat16`` rounds
    P where the forward kernel does."""
    out = (_I * 6)()
    rc = (bind(lib) if lib is not None else _lib()).hvt_flash_tiles(d, out)
    if rc != 0:
        raise ValueError(f"head dim {d} is not one of {_HEAD_DIMS}")
    return {"fwd": (out[0], out[1]), "dq": (out[2], out[3]), "dkdv": (out[4], out[5])}


def _check_cuda(q, k, v, *like_q: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate the kernels' inputs: q (and ``like_q``: o, dO) [BH, T_q, D],
    k and v [BH, T_k, D], contiguous, one CUDA device, one dtype (f32 or
    bf16), D in 32/64/128 (``flash_attention_bthd`` pads other head dims up
    to 128). Returns (bh, t_q, t_k, d)."""
    tensors = (q, k, v, *like_q)
    for t in tensors:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(
                f"flash attention kernels need every tensor on one CUDA "
                f"device; got {t.device} beside {q.device}"
            )
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous tensors")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"flash attention kernels take float32 or bfloat16 q/k/v/o of "
            f"one dtype; got {[t.dtype for t in tensors]}"
        )
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"expected [BH, T, D] tensors, got {tuple(q.shape)}")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {_HEAD_DIMS}")
    if k.shape != (bh, t_k, d) or v.shape != k.shape or any(
            t.shape != q.shape for t in like_q):
        raise ValueError(
            f"shapes {[tuple(t.shape) for t in tensors]} do not fit q {tuple(q.shape)}"
        )
    return bh, t_q, t_k, d


def _check_rows(q: torch.Tensor, *stats: torch.Tensor, shape=None) -> None:
    """lse and Dsum (and the ring block's l, dm, dl): contiguous f32
    [BH, T_q] beside q; with ``shape``, f32 tensors of that shape (the ring
    block's O and dO)."""
    shape = q.shape[:2] if shape is None else shape
    for t in stats:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device or t.shape != shape):
            raise ValueError(
                f"expected contiguous float32 {tuple(shape)} tensors on {q.device}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


# The kernels' grids put batch x heads on y, which holds at most 65535 blocks.
_GRID_Y = 65535


def _run(entry: str, device: torch.device, *args) -> None:
    """Call a C entry on ``device``'s current stream; raise on its error."""
    with torch.cuda.device(device):
        rc = getattr(_lib(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")


def _bh_pieces(bh: int):
    """The launches of a batch x heads axis: (start, count) pieces of at
    most ``_GRID_Y``, each one grid."""
    return [(s, min(_GRID_Y, bh - s)) for s in range(0, bh, _GRID_Y)]


def _launch_fwd(q, k, v, causal: bool, sm_scale: float):
    global FWD_LAUNCHES
    bh, t_q, t_k, d = _check_cuda(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, t_q, dtype=torch.float32, device=q.device)
    for s, n in _bh_pieces(bh):
        _run("hvt_flash_fwd", q.device,
             q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(), o[s].data_ptr(),
             lse[s].data_ptr(), n, t_q, t_k, d, _DTYPE_CODES[q.dtype], sm_scale, int(causal))
        FWD_LAUNCHES += 1
    return o, lse


def _launch_block_fwd(q, k, v, delta: int, causal: bool, sm_scale: float,
                      legacy: bool = False):
    """The ring block kernel: (O f32, m, l) with the causal mask shifted by
    ``delta``. bf16 runs on the tensor cores; ``legacy=True`` times the
    CUDA-core kernel instead (chip_smoke's A/B; never on the path)."""
    global BLOCK_LAUNCHES
    bh, t_q, t_k, d = _check_cuda(q, k, v)
    o = torch.empty(bh, t_q, d, dtype=torch.float32, device=q.device)
    m = torch.empty(bh, t_q, dtype=torch.float32, device=q.device)
    l = torch.empty(bh, t_q, dtype=torch.float32, device=q.device)
    for s, n in _bh_pieces(bh):
        _run("hvt_flash_block_fwd", q.device,
             q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(), o[s].data_ptr(),
             m[s].data_ptr(), l[s].data_ptr(), n, t_q, t_k, d, _DTYPE_CODES[q.dtype],
             sm_scale, int(causal), int(delta), int(legacy))
        BLOCK_LAUNCHES += 1
    return o, m, l


def _launch_block_bwd_dq(q, k, v, o, l, do, dm, dl, delta: int, causal: bool,
                         sm_scale: float):
    """The block backward's dQ kernel (with its stats sweep). o and do are
    the f32 O and its cotangent, l, dm and dl f32 rows. Returns dq and the
    row terms the dK/dV kernel reads: m, Dsum (= -dl) and the tie
    coefficient (dm - D) / c. The tensor cores take dO as a bf16 copy."""
    bh, t_q, t_k, d = _check_cuda(q, k, v)
    _check_rows(q, o, do, shape=q.shape)
    _check_rows(q, l, dm, dl)
    do_k = do if q.dtype == torch.float32 else do.to(q.dtype)
    dq = torch.empty_like(q)
    m, dsum, tcoef = (torch.empty(bh, t_q, dtype=torch.float32, device=q.device)
                      for _ in range(3))
    for s, n in _bh_pieces(bh):
        _run("hvt_flash_block_bwd_dq", q.device,
             q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(), o[s].data_ptr(),
             do_k[s].data_ptr(), do[s].data_ptr(), l[s].data_ptr(), dm[s].data_ptr(),
             dl[s].data_ptr(), dq[s].data_ptr(), m[s].data_ptr(), dsum[s].data_ptr(),
             tcoef[s].data_ptr(), n, t_q, t_k, d, _DTYPE_CODES[q.dtype], sm_scale,
             int(causal), int(delta))
    return dq, do_k, (m, dsum, tcoef)


def _launch_block_bwd_dkdv(q, k, v, do_k, rows, delta: int, causal: bool, sm_scale: float):
    """The block backward's dK/dV kernel, after the dQ kernel: ``do_k`` is
    dO in the input dtype, ``rows`` the dQ kernel's (m, Dsum, tie coef)."""
    bh, t_q, t_k, d = _check_cuda(q, k, v, do_k)
    _check_rows(q, *rows)
    m, dsum, tcoef = rows
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for s, n in _bh_pieces(bh):
        _run("hvt_flash_block_bwd_dkdv", q.device,
             q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(), do_k[s].data_ptr(),
             m[s].data_ptr(), dsum[s].data_ptr(), tcoef[s].data_ptr(), dk[s].data_ptr(),
             dv[s].data_ptr(), n, t_q, t_k, d, _DTYPE_CODES[q.dtype], sm_scale,
             int(causal), int(delta))
    return dk, dv


def _launch_block_bwd(q, k, v, o, l, do, dm, dl, delta: int, causal: bool, sm_scale: float):
    """The ring block's backward on the card: the dQ kernel, then the dK/dV
    kernel, one pair a batch x heads piece, counted by
    ``BLOCK_BWD_LAUNCHES``."""
    global BLOCK_BWD_LAUNCHES
    dq, do_k, rows = _launch_block_bwd_dq(q, k, v, o, l, do, dm, dl, delta, causal, sm_scale)
    dk, dv = _launch_block_bwd_dkdv(q, k, v, do_k, rows, delta, causal, sm_scale)
    BLOCK_BWD_LAUNCHES += len(_bh_pieces(q.shape[0]))
    return dq, dk, dv


def _launch_bwd_dq(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """The dQ kernel; also returns Dsum = rowsum(dO * O), f32 [BH, T]."""
    bh, t_q, t_k, d = _check_cuda(q, k, v, o, do)
    _check_rows(q, lse)
    dq = torch.empty_like(q)
    dsum = torch.empty(bh, t_q, dtype=torch.float32, device=q.device)
    for s, n in _bh_pieces(bh):
        _run("hvt_flash_bwd_dq", q.device,
             q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(), o[s].data_ptr(),
             do[s].data_ptr(), lse[s].data_ptr(), dq[s].data_ptr(), dsum[s].data_ptr(),
             n, t_q, t_k, d, _DTYPE_CODES[q.dtype], sm_scale, int(causal))
    return dq, dsum


def _launch_bwd_dkdv(q, k, v, do, lse, dsum, causal: bool, sm_scale: float):
    bh, t_q, t_k, d = _check_cuda(q, k, v, do)
    _check_rows(q, lse, dsum)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for s, n in _bh_pieces(bh):
        _run("hvt_flash_bwd_dkdv", q.device,
             q[s].data_ptr(), k[s].data_ptr(), v[s].data_ptr(), do[s].data_ptr(),
             lse[s].data_ptr(), dsum[s].data_ptr(), dk[s].data_ptr(), dv[s].data_ptr(),
             n, t_q, t_k, d, _DTYPE_CODES[q.dtype], sm_scale, int(causal))
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    global BWD_LAUNCHES
    dq, dsum = _launch_bwd_dq(q, k, v, o, lse, do, causal, sm_scale)
    dk, dv = _launch_bwd_dkdv(q, k, v, do, lse, dsum, causal, sm_scale)
    BWD_LAUNCHES += len(_bh_pieces(q.shape[0]))
    return dq, dk, dv


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"flash attention runs on cpu or cuda tensors, not {t.device}")


def _flash_fwd(q, k, v, causal, sm_scale):
    if _on_cpu(q):
        return _flash_fwd_plain(q, k, v, causal, sm_scale)
    return _launch_fwd(q, k, v, causal, sm_scale)


def _flash_bwd(q, k, v, o, lse, do, causal, sm_scale):
    if _on_cpu(q):
        return _flash_bwd_plain(q, k, v, o, lse, do, causal, sm_scale)
    return _launch_bwd(q, k, v, o, lse, do, causal, sm_scale)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``jax.custom_vjp`` ``_flash``:
    the forward saves (q, k, v, o, lse) and the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = _flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(
            q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.sm_scale
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention over ``[..., T, D]`` (leading dims fold into one
    batch x heads axis). Differentiable; the backward recomputes P.
    ``sm_scale`` defaults to ``D ** -0.5``."""
    if q.dim() < 3:
        raise ValueError("expected [..., T, D] with at least one batch dim")
    lead = q.shape[:-2]
    t_q, d = q.shape[-2:]
    t_k = k.shape[-2]
    # The same lengths as the reference kernel's grid accepts.
    _pick_block(t_q, 128)
    _pick_block(t_k, 128)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = _FlashAttention.apply(
        q.reshape(-1, t_q, d).contiguous(), k.reshape(-1, t_k, d).contiguous(),
        v.reshape(-1, t_k, d).contiguous(), causal, scale,
    )
    return out.reshape(*lead, t_q, d)


def flash_attention_bthd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Layout adapter for the transformer's ``[B, T, H, D]`` attention:
    fold heads into the batch axis, run the flash path, unfold. Shapes
    ``flash_shape_ok`` refuses (lengths with no block divisor of 8 or more,
    as the reference chooses; head dims above 128) take the dense path; a
    head dim under 128 that the kernels are not built for is zero-padded to
    the next one they are, with the scale of the true head dim."""
    B, T, H, D = q.shape
    scale = sm_scale if sm_scale is not None else D ** -0.5
    if flash_shape_ok(T, k.shape[1], D):
        dp = _padded(D)
        fold = lambda x: _pad_head(x, dp).transpose(1, 2).reshape(B * H, x.shape[1], dp)
        out = flash_attention(fold(q), fold(k), fold(v), causal=causal, sm_scale=scale)
        out = out[..., :D]
    else:
        fold = lambda x: x.transpose(1, 2).reshape(B * H, x.shape[1], D)
        out = _dense_full(fold(q), fold(k), fold(v), causal, scale)
    return out.reshape(B, H, T, D).transpose(1, 2)


def _flash_block_bwd(q, k, v, o, l, do, dm, dl, delta, causal, sm_scale):
    if _on_cpu(q):
        return _flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, delta, causal, sm_scale)
    return _launch_block_bwd(q, k, v, o, l, do, dm, dl, delta, causal, sm_scale)


class _FlashBlock(torch.autograd.Function):
    """The counterpart of the reference's ``_flash_block`` custom VJP: the
    forward runs the block kernel and keeps its f32 O and l; the backward
    runs the block backward kernels (on the CPU their plain version), the
    VJP of the reference's dense recompute through all three cotangents."""

    @staticmethod
    def forward(ctx, q, k, v, delta: int, causal: bool, sm_scale: float):
        if _on_cpu(q):
            o, m, l = _flash_block_plain(q, k, v, delta, causal, sm_scale)
        else:
            o, m, l = _launch_block_fwd(q, k, v, delta, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, l)
        ctx.delta, ctx.causal, ctx.sm_scale = delta, causal, sm_scale
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        q, k, v, o, l = ctx.saved_tensors
        with torch.profiler.record_function("flash_block_backward"):
            dq, dk, dv = _flash_block_bwd(
                q, k, v, o, l, do.contiguous(), dm.contiguous(), dl.contiguous(),
                ctx.delta, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    delta: int,
    *,
    sm_scale: float,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring-attention block over q ``[BH, T_q, D]`` and k, v
    ``[BH, T_k, D]``. ``delta`` is the K block's global sequence origin
    minus Q's (key j sits at position j + delta). Returns the f32 triple
    ``(o_unnormalised, m, l)`` for the caller's online-softmax merge
    (``parallel/ring_attention.py``). Differentiable in q, k and v. Lengths
    the reference kernel's grid refuses are refused here too. A head dim
    under 128 that the kernel is not built for is zero-padded to the next
    one it is (exact: O's padded columns are zero, m and l do not change);
    above 128 the block is computed densely (``_dense_block``)."""
    _pick_block(q.shape[1], 128)
    _pick_block(k.shape[1], 128)
    d = q.shape[-1]
    if d > _HEAD_DIMS[-1]:
        return _dense_block(q, k, v, int(delta), sm_scale, causal)
    dp = _padded(d)
    o, m, l = _FlashBlock.apply(*(_pad_head(x, dp).contiguous() for x in (q, k, v)),
                                int(delta), causal, sm_scale)
    return (o if dp == d else o[..., :d]), m, l
