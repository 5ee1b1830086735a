"""The ring block's backward: its blockwise plain version against the JAX package.

On the CPU ``flash_attention_block``'s autograd Function runs the plain
version of the block backward kernels, ``_flash_block_bwd_plain``: the VJP
of the block's (O, m, l) through all three cotangents, one K block at a
time. It is held here against ``jax.grad`` of the reference's
``flash_attention_block`` (the Pallas block in interpret mode, whose VJP is
the dense recompute ``_dense_block``) at the reference's gradient tolerance,
rtol 1e-3 / atol 1e-4: causal and not, delta -T, 0, +T/2 and >= T, a ragged
last K block, random cotangents, and exact ties at the row max (duplicated
keys on a dyadic grid, where every order of summation gives the same score).
The same file holds the block mode's reduction to B1's backward, the block
forward's ``p_dtype``, and the route and profiler span of the backward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_attention as ref_fa
from horovod_tpu_torch.ops import flash_attention as port_fa


def _arrays(bh, t, d, seed, n=3, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bh, t, d) * scale).astype(np.float32) for _ in range(n)]


def _cotangents(bh, t, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, t, d).astype(np.float32), rng.randn(bh, t).astype(np.float32),
            rng.randn(bh, t).astype(np.float32))


def _jax_grads(q, k, v, delta, scale, causal, cts, block):
    wo, wm, wl = cts

    def loss(q, k, v):
        o, m, l = ref_fa.flash_attention_block(q, k, v, float(delta), sm_scale=scale,
                                               causal=causal, block_q=block, block_k=block)
        return jnp.sum(o * wo) + jnp.sum(m * wm) + jnp.sum(l * wl)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, delta, scale, causal, cts):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, m, l = port_fa.flash_attention_block(tq, tk, tv, delta, sm_scale=scale, causal=causal)
    wo, wm, wl = (torch.from_numpy(x) for x in cts)
    ((o * wo).sum() + (m * wm).sum() + (l * wl).sum()).backward()
    return tq.grad, tk.grad, tv.grad


# (bh, t, d, the reference's block): T 200 runs the plain backward in K blocks
# of 128 and a ragged 72.
_SHAPES = [(2, 24, 8, 8), (2, 200, 16, 100)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta_of_t", [-1.0, 0.0, 0.5, 1.0, 1.5])
@pytest.mark.parametrize("shape", _SHAPES)
def test_block_bwd_plain_matches_jax(shape, delta_of_t, causal):
    """dQ, dK and dV through the port's autograd against ``jax.grad`` of the
    reference block, with random dO, dm and dl."""
    bh, t, d, block = shape
    delta = int(delta_of_t * t)
    scale = d ** -0.5
    q, k, v = _arrays(bh, t, d, seed=t + d)
    cts = _cotangents(bh, t, d, seed=t + d + 1)
    want = _jax_grads(q, k, v, delta, scale, causal, cts, block)
    got = _port_grads(q, k, v, delta, scale, causal, cts)
    for name, a, b in zip(("dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=name)
    if causal and delta >= t:
        assert all(bool((g == 0).all()) for g in got)


def _tied_inputs(bh, t, d, seed):
    """q and k on a grid of quarters, with keys 2, 5 and 9 equal to one key
    that every query leans towards, so that the rows that see two or three
    of them have their max at a tie; exact in f32 whatever the order of
    summation."""
    rng = np.random.RandomState(seed)
    k = rng.randint(-2, 3, (bh, t, d)).astype(np.float32) / 4
    lead = np.sign(rng.randn(bh, 1, d)).astype(np.float32)
    k[:, [2, 5, 9]] = lead
    q = (2 * lead + rng.randint(-1, 2, (bh, t, d))).astype(np.float32) / 4
    v = rng.randn(bh, t, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta", [0, -16, 4])
def test_block_bwd_plain_shares_ties_as_jax(delta, causal):
    """Rows whose max is tied between two or three duplicated keys, with a
    nonzero dm: the tie term must go evenly to the tied keys, as jnp.max's
    gradient does."""
    bh, t, d = 2, 16, 8
    scale = d ** -0.5
    q, k, v = _tied_inputs(bh, t, d, seed=3)
    cts = _cotangents(bh, t, d, seed=4)
    m, c = port_fa._block_row_max(torch.from_numpy(q), torch.from_numpy(k), delta, causal,
                                  scale, 128)
    assert int((c >= 2).sum()) >= 8, c
    want = _jax_grads(q, k, v, delta, scale, causal, cts, 8)
    got = _port_grads(q, k, v, delta, scale, causal, cts)
    for name, a, b in zip(("dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("p_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_block_mode_reduces_to_b1(causal, p_dtype):
    """The block backward is B1's with lse -> m, Dsum -> -dl, the mask
    shifted by delta and the tie term. At delta 0, with B1 given lse := m
    and O := the block's O, the cotangents dl = -Dsum and dm = Dsum (1 - l)
    make -dl B1's Dsum and zero the tie term (dm - D) exactly; the two plain
    backwards then agree bit for bit. (Zero dm and dl do not reduce it:
    the tie term -D / c remains at every row's max.)"""
    bh, t, d = 2, 32, 16
    scale = d ** -0.5
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(bh, t, d, seed=11, n=4))
    o, m, l = port_fa._flash_block_plain(q, k, v, 0, causal, scale)
    dsum = (do * o).sum(dim=-1)
    dl = -dsum
    dm = dsum + dl * l
    got = port_fa._flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, 0, causal, scale,
                                         block_k=8, p_dtype=p_dtype)
    m_bwd, _ = port_fa._block_row_max(q, k, 0, causal, scale, 8)
    assert torch.equal(m_bwd, m)
    want = port_fa._flash_bwd_plain(q, k, v, o, m_bwd, do, causal, scale, block_k=8,
                                    p_dtype=p_dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _block_plain_before_p_dtype(q, k, v, delta, causal, sm_scale, block_k):
    """The block forward's plain version as it was before ``p_dtype``."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    bk = port_fa._pick_block(t_k, block_k)
    qf = q.float()
    acc = torch.zeros(bh, t_q, d)
    m = torch.full((bh, t_q, 1), -1e30)
    l = torch.zeros(bh, t_q, 1)
    q_pos = torch.arange(t_q)[:, None]
    for k0 in range(0, t_k, bk):
        s = qf @ k[:, k0:k0 + bk].float().transpose(1, 2) * sm_scale
        if causal:
            mask = q_pos >= torch.arange(k0, k0 + s.shape[-1])[None, :] + delta
            s = torch.where(mask, s, -1e30)
        m_curr = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_curr)
        p = torch.exp(s - m_curr)
        if causal:
            p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[:, k0:k0 + bk].float()
        m = m_curr
    return acc, m[..., 0], l[..., 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta", [-40, 0, 20, 40])
def test_block_plain_p_dtype_none_is_bitwise_unchanged(delta, causal, dtype):
    """T 40 in K blocks of 10: the block forward with p_dtype=None gives
    exactly what the code before it gave."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _arrays(2, 40, 32, seed=12))
    scale = 32 ** -0.5
    got = port_fa._flash_block_plain(q, k, v, delta, causal, scale, block_k=16, p_dtype=None)
    want = _block_plain_before_p_dtype(q, k, v, delta, causal, scale, 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta_of_t", [-1.0, 0.0, 0.5])
def test_bf16_rounded_block_plain_matches_jax(delta_of_t, causal):
    """T 40 with K tiles of 16 (a ragged 8): the plain versions that round P
    (forward) and P, dS and dO (backward) to bf16, as the tensor-core kernels
    do, against the reference block in bf16 at its bf16 tolerance, 5e-2."""
    bh, t, d = 2, 40, 32
    delta = int(delta_of_t * t)
    scale = d ** -0.5
    q, k, v = _arrays(bh, t, d, seed=13)
    cts = _cotangents(bh, t, d, seed=14)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    bf = torch.bfloat16
    o, m, l = port_fa._flash_block_plain(tq, tk, tv, delta, causal, scale, block_k=16, p_dtype=bf)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = ref_fa.flash_attention_block(jq, jk, jv, float(delta), sm_scale=scale, causal=causal,
                                        block_q=8, block_k=8)
    for name, a, b in zip(("O", "m", "l"), (o, m, l), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=5e-2, atol=5e-2,
                                   err_msg=name)
    do, dm, dl = (torch.from_numpy(x) for x in cts)
    grads = port_fa._flash_block_bwd_plain(tq, tk, tv, o, l, do, dm, dl, delta, causal, scale,
                                           block_k=16, p_dtype=bf)

    def loss(a, b, c):
        o_, m_, l_ = ref_fa.flash_attention_block(a, b, c, float(delta), sm_scale=scale,
                                                  causal=causal, block_q=8, block_k=8)
        return jnp.sum(o_ * cts[0]) + jnp.sum(m_ * cts[1]) + jnp.sum(l_ * cts[2])

    expected = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for name, a, b in zip(("dQ", "dK", "dV"), grads, expected):
        assert a.dtype == bf
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=5e-2,
                                   atol=5e-2, err_msg=name)


def test_block_backward_runs_the_plain_version_inside_its_span(monkeypatch):
    """On CPU tensors the block's backward is ``_flash_block_bwd_plain``
    (no dense recompute), inside the profiler span ``flash_block_backward``
    that chip_smoke.py's profile reads, with contiguous cotangents."""
    calls = []
    plain = port_fa._flash_block_bwd_plain

    def spy(q, k, v, o, l, do, dm, dl, *args):
        calls.append(all(t.is_contiguous() for t in (do, dm, dl)))
        return plain(q, k, v, o, l, do, dm, dl, *args)

    def dense(*_):
        raise AssertionError("the dense recompute was reached")

    monkeypatch.setattr(port_fa, "_flash_block_bwd_plain", spy)
    monkeypatch.setattr(port_fa, "_dense_block", dense)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays(2, 16, 8, seed=15))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        o, m, l = port_fa.flash_attention_block(q, k, v, 0, sm_scale=0.5)
        # Cotangents that arrive non-contiguous: O's through a transpose.
        (o.transpose(0, 1).sum(0).sum() + m.sum() + l.sum()).backward()
    assert calls == [True]
    assert any(e.name == "flash_block_backward" for e in prof.events())


def test_block_backward_wrappers_refuse_cpu_tensors():
    """The block backward's launch wrapper never falls back to the plain
    version: CPU tensors are refused before anything is built."""
    q = torch.zeros(2, 16, 32)
    rows = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port_fa._launch_block_bwd(q, q, q, q, rows, q, rows, rows, 0, True, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        port_fa._launch_block_fwd(q, q, q, 0, True, 1.0, legacy=True)
