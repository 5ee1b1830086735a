"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrappers run the plain versions of the kernels
(``_flash_fwd_plain``, ``_flash_bwd_plain``) through the same autograd
Function the card uses; the Pallas kernel runs in interpret mode, as
tests/test_flash_attention.py runs it. The tolerances are that file's: f32
forward rtol 2e-4 / atol 2e-5, gradients 1e-3 / 1e-4, bf16 5e-2. (The
CUDA kernels are held to the plain versions by chip_smoke.py on the card.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_attention as ref
from horovod_tpu_torch.ops import flash_attention as port


def _qkv(bh=4, t=32, d=16, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, t, d).astype(np.float32) * 0.5 for _ in range(n)]


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 32, 16), (2, 256, 32), (3, 24, 64)])
def test_forward_matches_pallas(causal, shape):
    """Mirrors test_forward_matches_dense: O and lse of the plain version,
    and O through ``flash_attention``, against the Pallas kernel."""
    q, k, v = _qkv(*shape)
    scale = shape[2] ** -0.5
    o_ref, m, l = ref._flash_call(
        *map(jnp.asarray, (q, k, v)), 0, sm_scale=scale, causal=causal,
        block_q=128, block_k=128, normalize=True, interpret=True,
        out_dtype=jnp.float32,
    )
    lse_ref = m + jnp.log(jnp.where(l == 0.0, 1.0, l))
    o, lse = port._flash_fwd_plain(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-4, atol=2e-5)
    out = port.flash_attention(*_t(q, k, v), causal=causal)
    expected = ref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 8), (2, 256, 32)])
def test_grad_matches_jax(causal, shape):
    """Mirrors test_grad_matches_dense: the autograd Function's backward
    (``_flash_bwd_plain``) against ``jax.grad`` through the custom VJP."""
    q, k, v, w = _qkv(*shape, seed=1, n=4)

    def loss(q, k, v):
        return jnp.sum(ref.flash_attention(q, k, v, causal=causal) * w)

    expected = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    (port.flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_bf16_dtype_preserved():
    """Mirrors test_bf16_dtype_preserved: bf16 in, bf16 out, within 5e-2."""
    q, k, v = _qkv()
    out = port.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=True)
    assert out.dtype == torch.bfloat16
    expected = ref.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expected, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_bf16_grads_within_tolerance():
    q, k, v, w = _qkv(2, 64, 32, seed=2, n=4)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v, dtype=torch.bfloat16))
    (port.flash_attention(tq, tk, tv, causal=True).float() * torch.from_numpy(w)).sum().backward()
    expected = jax.grad(
        lambda a, b, c: jnp.sum(ref.flash_attention(a, b, c, causal=True)
                                .astype(jnp.float32) * w),
        argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), expected):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("t", [16, 131])
def test_bthd_adapter_matches_reference(t):
    """Mirrors test_bthd_adapter_matches_reference and
    test_odd_length_falls_back_to_dense (131 is prime: the dense path)."""
    rng = np.random.RandomState(3)
    B, H, D = 1, 2, 8
    q, k, v = (rng.randn(B, t, H, D).astype(np.float32) * 0.5 for _ in range(3))
    out = port.flash_attention_bthd(*_t(q, k, v), causal=True)
    expected = ref.flash_attention_bthd(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)
    assert port.flashable(t, t) == ref.flashable(t, t)


def test_flash_shape_ok_picks_the_padded_head_dim():
    """The one shape predicate of the adapter: lengths as ``flashable``, a
    head dim of at most 128, padded up to the next of 32, 64 and 128."""
    for d in (1, 8, 16, 32, 48, 64, 80, 96, 128):
        assert port.flash_shape_ok(16, 16, d)
        assert port._padded(d) == min(h for h in (32, 64, 128) if h >= d)
    assert not port.flash_shape_ok(16, 16, 129)
    assert not port.flash_shape_ok(131, 131, 64)
    assert port.flash_shape_ok(16, 1024, 64)


def test_bh_pieces_split_the_grid_limit():
    """Batch x heads beyond the grid's 65535 launches in pieces that cover
    the axis once, in order."""
    assert port._bh_pieces(96) == [(0, 96)]
    for bh in (65535, 65536, 2 * 65535 + 3):
        pieces = port._bh_pieces(bh)
        assert all(n <= 65535 for _, n in pieces)
        assert [s for s, _ in pieces] == list(range(0, bh, 65535))
        assert sum(n for _, n in pieces) == bh


def _record_head_dims(monkeypatch):
    """The head dims the flash forward and backward receive."""
    seen = []
    fwd, bwd = port._flash_fwd, port._flash_bwd
    monkeypatch.setattr(port, "_flash_fwd",
                        lambda q, *a: seen.append(("fwd", q.shape[-1])) or fwd(q, *a))
    monkeypatch.setattr(port, "_flash_bwd",
                        lambda q, *a: seen.append(("bwd", q.shape[-1])) or bwd(q, *a))
    return seen


@pytest.mark.parametrize("d", [8, 16, 80, 96])
def test_bthd_adapter_pads_head_dims_and_matches_jax(d, monkeypatch):
    """Head dims the kernels are not built for take the flash path
    zero-padded to the next built one (32, 32, 128, 128 here): O against
    JAX's adapter at 2e-4 / 2e-5, the gradients of q, k and v against
    jax.grad at 1e-3 / 1e-4."""
    seen = _record_head_dims(monkeypatch)
    rng = np.random.RandomState(d)
    B, T, H = 2, 48, 3
    q, k, v, w = (rng.randn(B, T, H, d).astype(np.float32) * 0.5 for _ in range(4))
    expected = ref.flash_attention_bthd(*map(jnp.asarray, (q, k, v)), causal=True)

    def loss(q, k, v):
        return jnp.sum(ref.flash_attention_bthd(q, k, v, causal=True) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = port.flash_attention_bthd(tq, tk, tv, causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert seen == [("fwd", port._padded(d)), ("bwd", port._padded(d))]


def test_bthd_adapter_head_dim_above_128_is_dense(monkeypatch):
    """A head dim above 128 takes the dense path, as the shape predicate
    says, and matches the reference."""
    seen = _record_head_dims(monkeypatch)
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(1, 16, 2, 160).astype(np.float32) * 0.5 for _ in range(3))
    out = port.flash_attention_bthd(*_t(q, k, v), causal=True)
    expected = ref.flash_attention_bthd(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)
    assert seen == []


@pytest.mark.parametrize("d", [16, 80, 160])
def test_flash_block_pads_head_dims_and_matches_jax(d):
    """The ring block at head dims the kernel is not built for: padded (16,
    80) or dense (160), its (O, m, l) against the reference's block."""
    q, k, v = _qkv(2, 32, d, seed=d)
    for delta in (0, -32, 16):
        got = port.flash_attention_block(*_t(q, k, v), delta, sm_scale=d ** -0.5)
        want = ref.flash_attention_block(*map(jnp.asarray, (q, k, v)), delta,
                                         sm_scale=d ** -0.5, causal=True)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=2e-4, atol=2e-5)


def test_dense_full_matches_reference():
    q, k, v = _qkv(2, 13, 8)
    for causal in (False, True):
        out = port._dense_full(*_t(q, k, v), causal, 0.3)
        expected = ref._dense_full(*map(jnp.asarray, (q, k, v)), causal, 0.3)
        np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("pref", [8, 128])
def test_pick_block_and_flashable_agree_with_reference(pref):
    for t in list(range(1, 300)) + [1024, 2048, 4093]:
        try:
            want = ref._pick_block(t, pref)
        except ValueError:
            with pytest.raises(ValueError):
                port._pick_block(t, pref)
        else:
            assert port._pick_block(t, pref) == want
        assert port.flashable(t, t, pref, pref) == ref.flashable(t, t, pref, pref)


def test_flash_attention_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 131, 8)
    with pytest.raises(ValueError, match="no block divisor"):
        port.flash_attention(q, q, q)


# The plain versions with ``p_dtype``: the bf16 kernels run their second
# products on the tensor cores, which take P (and dS) in bf16. The plain
# versions round them at the same places when given p_dtype=torch.bfloat16,
# and must still agree with the reference at its bf16 tolerance; with
# p_dtype=None they keep their arithmetic bit for bit.

def _plain_fwd_before_p_dtype(q, k, v, causal, sm_scale, block_k):
    """The plain forward as it was before ``p_dtype`` existed."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    bk = port._pick_block(t_k, block_k)
    qf = q.float()
    acc = torch.zeros(bh, t_q, d)
    m = torch.full((bh, t_q, 1), -1e30)
    l = torch.zeros(bh, t_q, 1)
    q_pos = torch.arange(t_q)[:, None]
    for k0 in range(0, t_k, bk):
        s = qf @ k[:, k0:k0 + bk].float().transpose(1, 2) * sm_scale
        if causal:
            mask = q_pos >= torch.arange(k0, k0 + bk)[None, :]
            s = torch.where(mask, s, -1e30)
        m_curr = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_curr)
        p = torch.exp(s - m_curr)
        if causal:
            p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[:, k0:k0 + bk].float()
        m = m_curr
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _plain_bwd_before_p_dtype(q, k, v, o, lse, do, causal, sm_scale, block_k):
    """The plain backward as it was before ``p_dtype`` existed."""
    t_q, t_k = q.shape[1], k.shape[1]
    bk = port._pick_block(t_k, block_k)
    qf, dof = q.float(), do.float()
    dsum = (dof * o.float()).sum(dim=-1)
    q_pos = torch.arange(t_q)[:, None]
    dq = torch.zeros(q.shape)
    dks, dvs = [], []
    for k0 in range(0, t_k, bk):
        kb, vb = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = qf @ kb.transpose(1, 2) * sm_scale
        if causal:
            mask = q_pos >= torch.arange(k0, k0 + bk)[None, :]
            s = torch.where(mask, s, -1e30)
        p = torch.exp(s - lse[:, :, None])
        if causal:
            p = torch.where(mask, p, 0.0)
        ds = p * ((dof @ vb.transpose(1, 2)) - dsum[:, :, None]) * sm_scale
        dq = dq + ds @ kb
        dks.append(ds.transpose(1, 2) @ qf)
        dvs.append(p.transpose(1, 2) @ dof)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_p_dtype_none_is_bitwise_unchanged(causal, dtype):
    """T 40 in K blocks of 10 (the divisor under 16): forward and backward
    with p_dtype=None give exactly what the code before it gave."""
    q, k, v, do = _t(*_qkv(2, 40, 32, seed=6, n=4), dtype=dtype)
    scale = 32 ** -0.5
    o, lse = port._flash_fwd_plain(q, k, v, causal, scale, block_k=16, p_dtype=None)
    o0, lse0 = _plain_fwd_before_p_dtype(q, k, v, causal, scale, 16)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    grads = port._flash_bwd_plain(q, k, v, o, lse, do, causal, scale, block_k=16, p_dtype=None)
    for got, want in zip(grads, _plain_bwd_before_p_dtype(q, k, v, o, lse, do, causal, scale, 16)):
        assert torch.equal(got, want)


_ROUNDED_SHAPES = [(2, 40, 32), (2, 64, 64)]   # T 40: K blocks of 16 with a ragged 8


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _ROUNDED_SHAPES)
def test_bf16_rounded_plain_forward_matches_pallas(causal, shape):
    q, k, v = _qkv(*shape, seed=7)
    o, lse = port._flash_fwd_plain(*_t(q, k, v, dtype=torch.bfloat16), causal,
                                   shape[2] ** -0.5, block_k=16, p_dtype=torch.bfloat16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    expected = ref.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(expected, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _ROUNDED_SHAPES)
def test_bf16_rounded_plain_grads_match_jax(causal, shape):
    """The gradients of sum(O * w) from the rounding plain versions against
    jax.grad through the reference, as test_bf16_grads_within_tolerance."""
    q, k, v, w = _qkv(*shape, seed=8, n=4)
    scale = shape[2] ** -0.5
    tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
    o, lse = port._flash_fwd_plain(tq, tk, tv, causal, scale, block_k=16,
                                   p_dtype=torch.bfloat16)
    grads = port._flash_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(w).to(torch.bfloat16),
                                  causal, scale, block_k=16, p_dtype=torch.bfloat16)
    expected = jax.grad(
        lambda a, b, c: jnp.sum(ref.flash_attention(a, b, c, causal=causal)
                                .astype(jnp.float32) * w),
        argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    for got, want in zip(grads, expected):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_rounded_p_is_softmax_in_bf16(causal):
    """BH 1, T 4, D 8: with dO = [I | 0] and V = 0, dV's first 4 columns
    are P^T, and the rounded P is softmax(s) rounded to bf16 by hand."""
    rng = np.random.RandomState(9)
    q, k = (torch.from_numpy(rng.randn(1, 4, 8).astype(np.float32)) for _ in range(2))
    v = torch.zeros(1, 4, 8)
    do = torch.zeros(1, 4, 8)
    do[0, :, :4] = torch.eye(4)
    scale = 8 ** -0.5
    o, lse = port._flash_fwd_plain(q, k, v, causal, scale)
    _, _, dv = port._flash_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                     p_dtype=torch.bfloat16)
    s = q[0] @ k[0].T * scale
    if causal:
        s = torch.where(torch.tril(torch.ones(4, 4, dtype=torch.bool)), s, -1e30)
    want = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    assert not torch.equal(want, torch.softmax(s, dim=-1))   # the rounding shows
    assert torch.equal(dv[0, :, :4].T, want)


_PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN47_INTERNAL_f4d45_18_flash_attention_cu_c28a3c6f20flash_fwd_mma_kernelILi64ELi2ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_INTERNAL_f4d45_18_flash_attention_cu_c28a3c6f20flash_fwd_mma_kernelILi64ELi2ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi
    0 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Function properties for _ZN47_INTERNAL_f4d45_18_flash_attention_cu_c28a3c6f21flash_bwd_dkdv_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 97 registers, used 1 barriers
ptxas info    : Function properties for _Z19mrs_epilogue_kernelPKfS0_S0_Pvii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers
"""


def test_ptxas_report_names_kernels_with_registers_and_spills():
    """The spill gate of chip_smoke.py reads nvcc's report through this."""
    from horovod_tpu_torch.ops import _build

    got = [(k["name"], k["registers"], k["spill_stores"], k["spill_loads"])
           for k in _build.ptxas_kernels(_PTXAS_REPORT)]
    assert got == [("flash_fwd_mma_kernel<64,2,64>", 254, 8, 16),
                   ("flash_bwd_dkdv_kernel<64>", 97, 0, 0),
                   ("mrs_epilogue_kernel", 20, 0, 0)]


def test_tensor_core_kernels_are_named_for_the_checks():
    """chip_smoke.py's spill gate names B1's tensor-core kernels, and its
    profile counts a kernel in the flash family by the substring flash_."""
    import os
    import chip_smoke

    src = open(os.path.join(os.path.dirname(port.__file__), "..", "csrc",
                            "flash_attention.cu")).read()
    for name in chip_smoke.MMA_KERNELS:
        assert "flash_" in name and f"\n{name}(" in src


def test_tile_sweep_refuses_without_a_card(tmp_path):
    from horovod_tpu_torch.tools import flash_tile_sweep

    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep would run")
    assert flash_tile_sweep.main(["--out", str(tmp_path / "sweep.jsonl")]) == 2


@pytest.mark.parametrize("causal", [True, False])
def test_flop_counter_counts_the_flash_ops_analytically(causal):
    """``FlopCounterMode`` counts one flash call by B1's formulas, on the
    CPU as on the card (where the kernels run outside the dispatcher): the
    analytic 4·BH·T_q·T_k·D forward, halved when causal, and 2.5 times that
    backward (five products against two). Not what the plain version's
    blockwise products would count: the op hides them."""
    from torch.utils.flop_counter import FlopCounterMode

    bh, t, d = 6, 64, 32
    q, k, v = (torch.randn(bh, t, d, requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        o = port.flash_attention(q, k, v, causal=causal)
    with FlopCounterMode(display=False) as bwd:
        o.backward(torch.ones_like(o))
    want = 4 * bh * t * t * d // (2 if causal else 1)
    assert fwd.get_total_flops() == want == port.flash_fwd_flops((bh, t, d), (bh, t, d), causal)
    assert bwd.get_total_flops() == want * 5 // 2
