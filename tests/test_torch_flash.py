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
