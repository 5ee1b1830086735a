"""The port's int8 wire against the JAX package's ``ops/quantized.py``.

- ``_quantize``, ``_dequantize``, ``_pack``, ``_unpack`` and
  ``quantize_roundtrip`` BITWISE against JAX's, at f32 and bf16 inputs,
  with an all-zero block and values on the .5 ties (both round half to
  even).
- The int8 ring allreduce and reduce-scatter at 2 and 4 ranks, played by
  threads through the port's ring transport on the CPU, against JAX's on a
  2- and 4-device mesh. XLA on the CPU contracts each hop's ``q*s + c``
  into one FMA (checked here: an FMA done in float64 matches it bitwise),
  which PyTorch does not, so the partials differ by an f32 rounding a hop
  and a requantization may then pick the neighbouring int8: the bound is
  one quantization step of the block a hop, ``(n - 1) * amax(sum |x_r|) /
  127``; the largest difference seen is 7.5e-9 on sums of order 1e-2 (a
  few f32 ulps; no int8 landed elsewhere). Both against the
  exact f32 sum within JAX's own bound (tests/test_quantized.py: < 3%
  relative L2), and every rank's result the same.
- The DP step with ``quantized=True`` (error feedback on) against JAX's at 2
  gloo ranks: losses at rtol 1e-5, the parameters by the plain step's
  tolerance, the residual within one quantization step of its block; and
  streamed quantized equal to post-hoc quantized BITWISE when the bucket
  plans coincide (one bucket a leaf), as JAX's
  ``test_streamed_quantized_equals_posthoc_quantized_bitwise`` defines it.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from horovod_tpu.jax import _shard_map
from horovod_tpu.ops import quantized as jq
from horovod_tpu.parallel.mesh import build_mesh

from horovod_tpu_torch.ops import quantized as tq

from torch_port_harness import (GPT_THRESHOLD, assert_params_close, gpt_setup,
                                run_jax_variant, run_port_variants)


def _payload(seed=0, blocks=16):
    """Blocks of very different magnitudes, one all zero, one whose values
    sit on the .5 ties of its quantization grid."""
    rng = np.random.RandomState(seed)
    mags = np.repeat(rng.rand(blocks) * 10, 256).astype(np.float32)
    x = rng.randn(blocks * 256).astype(np.float32) * mags
    x[:256] = 0
    tie = np.round(rng.randn(256) * 40).astype(np.float32) + 0.5
    tie[0] = 127.0
    x[256:512] = tie * np.float32(0.25) / np.float32(127.0)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_and_wire_format_bitwise(dtype):
    x = _payload()
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jq._quantize(xj)
    qt, st = tq._quantize(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0]) == 1.0 and not qt[:256].any()        # the all-zero block
    assert (qt[256:512].abs() % 2 == 0).any()                # ties went to even
    np.testing.assert_array_equal(tq._dequantize(qt, st).numpy(),
                                  np.asarray(jq._dequantize(qj, sj)))
    packed = tq._pack(qt, st)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq._pack(qj, sj)))
    q2, s2 = tq._unpack(packed, qt.numel())
    assert torch.equal(q2, qt) and torch.equal(s2, st)
    np.testing.assert_array_equal(tq.quantize_roundtrip(xt[:1000]).numpy(),
                                  np.asarray(jq.quantize_roundtrip(xj[:1000])))


class ThreadRing:
    """One rank of a ring played by threads on the CPU: ``post`` leaves the
    sends in a shared mailbox and takes the neighbour's."""

    def __init__(self, rank, n, mailbox, barrier):
        self.rank, self.n, self.mailbox, self.barrier = rank, n, mailbox, barrier

    def post(self, sends):
        self.mailbox[self.rank] = sends
        self.barrier.wait()
        recvs = [self.mailbox[(self.rank - step) % self.n][i][0].clone()
                 for i, (_, step) in enumerate(sends)]
        self.barrier.wait()
        return recvs

    @staticmethod
    def wait(handle):
        return handle


def play(n, fn):
    barrier, mailbox = threading.Barrier(n, timeout=60), [None] * n
    out, errors = [None] * n, []

    def body(r):
        try:
            out[r] = fn(ThreadRing(r, n, mailbox, barrier))
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def test_xla_contracts_the_dequantize_add_into_an_fma():
    """Why the rings are held to a bound and not bitwise: one hop's
    ``dequant(q, s) + c`` under XLA equals the FMA (exact in float64: q has
    8 bits and s 24), not PyTorch's rounded product plus c."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 1024) * 0.01).astype(np.float32)
    q, s = tq._quantize(torch.from_numpy(x[0]))
    c = torch.from_numpy(x[1])
    want = np.asarray(jax.jit(lambda q, s, c: jq._dequantize(q, s) + c)(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), jnp.asarray(c.numpy())))
    fma = ((q.double().reshape(-1, 256) * s.double()[:, None]).reshape(-1) + c.double()).float()
    np.testing.assert_array_equal(fma.numpy(), want)
    assert not np.array_equal((tq._dequantize(q, s) + c).numpy(), want)


def _within_a_step_a_hop(got, want, x, n, rows=None):
    """|got - want| <= (n - 1) quantization steps of the block: no partial
    of the ring exceeds sum_r |x_r|, so none has a larger scale."""
    bound = np.abs(x).sum(axis=0)
    pad = (-bound.size) % 256
    blocks = np.pad(bound, (0, pad)).reshape(-1, 256).max(axis=1) / 127.0
    step = np.repeat(blocks, 256)[:bound.size]
    if rows is not None:
        step = step.reshape(n, -1)[rows]
    assert np.all(np.abs(got - want) <= (n - 1) * step + 1e-9)


def _jax_ring(fn, n, x, **kw):
    mesh = build_mesh({"data": n}, devices=jax.devices()[:n])
    body = lambda v: fn(v[0], axis_name="data", **kw)[None]
    run = jax.jit(_shard_map(body, mesh, in_specs=(P("data"),), out_specs=P("data")))
    return np.asarray(run(jnp.asarray(x)))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_allreduce_matches_jax_and_the_exact_sum(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n, 1003) * 0.01).astype(np.float32)   # odd length: padding
    want = _jax_ring(jq.quantized_ring_allreduce, n, x)
    got = play(n, lambda ring: tq.quantized_ring_allreduce(torch.from_numpy(x[ring.rank]),
                                                           ring=ring))
    exact = x.sum(axis=0)
    for r in range(n):
        _within_a_step_a_hop(got[r].numpy(), want[r], x, n)
        np.testing.assert_array_equal(got[r].numpy(), got[0].numpy())
        assert np.linalg.norm(got[r].numpy() - exact) / np.linalg.norm(exact) < 3e-2
    avg = play(n, lambda ring: tq.quantized_ring_allreduce(
        torch.from_numpy(x[ring.rank]).to(torch.bfloat16), ring=ring, average=True))
    assert avg[0].dtype == torch.bfloat16
    assert np.linalg.norm(avg[0].float().numpy() - exact / n) / np.linalg.norm(exact / n) < 3e-2


@pytest.mark.parametrize("n", [2, 4])
def test_ring_reduce_scatter_matches_jax_and_the_exact_sum(n):
    rng = np.random.RandomState(10 + n)
    k = 512
    x = (rng.randn(n, n * k) * 0.01).astype(np.float32)
    want = _jax_ring(jq.quantized_ring_reduce_scatter, n, x, average=True)
    got = play(n, lambda ring: tq.quantized_ring_reduce_scatter(
        torch.from_numpy(x[ring.rank]), ring=ring, average=True))
    exact = x.mean(axis=0).reshape(n, k)
    for r in range(n):
        _within_a_step_a_hop(got[r].numpy() * n, want[r] * n, x, n, rows=r)
        assert np.linalg.norm(got[r].numpy() - exact[r]) / np.linalg.norm(exact[r]) < 3e-2


def test_ring_edge_cases():
    # The reduce-scatter checks its length before the one-rank shortcut.
    with pytest.raises(ValueError, match="divisible by n\\*BLOCK"):
        play(1, lambda ring: tq.quantized_ring_reduce_scatter(torch.zeros(300), ring=ring))
    # An empty leaf is an identity, at any rank count.
    empty = play(2, lambda ring: tq.quantized_ring_allreduce(torch.zeros(0, 3), ring=ring))
    assert all(e.shape == (0, 3) for e in empty)
    ef = tq.ef_like({"a": torch.zeros(2, dtype=torch.bfloat16), "b": [torch.ones(3)]})
    assert ef["a"].dtype == torch.float32 and ef["b"][0].shape == (3,)
    # Both lowerings exist (the two-level one is held in
    # tests/test_torch_hierarchical.py); another mode is refused.
    assert callable(tq.quantized_reduce_fn("two-level"))
    with pytest.raises(ValueError, match="unknown quantized reduce mode"):
        tq.quantized_reduce_fn("ring")


N = 2
ONE_BUCKET_A_LEAF = dict(fusion_threshold_bytes=1, first_bucket_bytes=1)


@pytest.fixture(scope="module")
def setup():
    return gpt_setup()


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    variants = {
        "quantized": {"kwargs": dict(fusion_threshold_bytes=GPT_THRESHOLD, quantized=True)},
        "leaf_posthoc": {"kwargs": dict(ONE_BUCKET_A_LEAF, quantized=True)},
        "leaf_streamed": {"kwargs": dict(ONE_BUCKET_A_LEAF, quantized=True, overlap=True)},
    }
    return run_port_variants(tmp_path_factory.mktemp("quantized"), variants, N, setup)


def test_quantized_ef_step_matches_jax(runs, setup):
    """Losses at rtol 1e-5 and the parameters by the plain step's rule, but
    for the share of elements past a hundredth of a step: at each hop an
    element within an f32 rounding of a quantization edge (the FMA above)
    takes the neighbouring int8, which moves its Adam update by up to a
    whole step; three steps moved 0.04% of the elements so, and 0.1% is
    allowed. The residual after the first step (equal parameters, so
    gradients equal but for f32 rounding): every element within one
    quantization step of JAX's (a residual is at most half a step of its
    block, and 256 of them reach close to it, so a leaf's step is under
    2.2 times its largest residual), all but 0.1% within a thousandth of
    the leaf's largest."""
    from horovod_tpu.jax import EFState
    from horovod_tpu.parallel.rules import named_tree_paths

    losses, final, states = run_jax_variant(setup, N, quantized=True)
    assert all(isinstance(s, EFState) for s in states)
    port = runs["quantized"]
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert_params_close(port[0]["arrays"], final, share=1e-3)
    moved, off = 0.0, []
    for name, want in named_tree_paths(states[0].residual):
        want = np.asarray(want).ravel()
        got = port[0]["arrays"][f"e1:{name}"].ravel()
        largest = max(np.abs(want).max(), np.abs(got).max())
        assert np.abs(got - want).max() <= 2.2 * largest, name
        off.append(np.abs(got - want) > 1e-3 * largest)
        moved += float(np.abs(port[0]["arrays"][f"e:{name}"]).sum())
    assert np.mean(np.concatenate(off)) <= 1e-3
    assert moved > 0


def test_streamed_quantized_equals_posthoc_quantized_bitwise(runs):
    for r in range(N):
        s, p = runs["leaf_streamed"][r], runs["leaf_posthoc"][r]
        assert s["losses"] == p["losses"]
        assert all(launched == total for launched, _, total in s["groups"])
        for key, a in p["arrays"].items():
            np.testing.assert_array_equal(s["arrays"][key], a, err_msg=key)
    # Every rank holds the same parameters; the residuals are rank-local.
    for key, a in runs["leaf_streamed"][0]["arrays"].items():
        if key.startswith("p:"):
            np.testing.assert_array_equal(runs["leaf_streamed"][1]["arrays"][key], a)


@pytest.mark.parametrize("nbytes,dtype_bytes", [(0, 4), (1, 4), (1024, 4), (4 * 1003, 4),
                                                (2 * 777, 2), (-5, 4)])
def test_wire_byte_accounting_is_jax_packages(nbytes, dtype_bytes):
    from horovod_tpu.common import quant as jquant
    from horovod_tpu_torch.common import quant

    for name in ("int8_wire_bytes", "bf16_wire_bytes", "int8_saved_bytes"):
        assert getattr(quant, name)(nbytes, dtype_bytes) == \
            getattr(jquant, name)(nbytes, dtype_bytes), name
    assert (quant.BLOCK, quant.SCALE_BYTES, quant.WIRE_DTYPES) == \
        (jquant.BLOCK, jquant.SCALE_BYTES, jquant.WIRE_DTYPES)


def test_allreduce_gradients_and_ef_state_at_one_rank(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        g = [torch.tensor([1.0, float("nan")]), torch.arange(3)]
        out = hvd.allreduce_gradients(g, quantized=True, nonfinite="zero")
        assert torch.equal(out[0], torch.tensor([1.0, 0.0])) and torch.equal(out[1], g[1])
        with pytest.raises(ValueError, match="SUM/AVERAGE"):
            hvd.allreduce_gradients(g, quantized=True, op=hvd.Max)
        state = hvd.error_feedback_state({"lr": 0.1}, {"w": torch.ones(2, dtype=torch.bfloat16)})
        assert isinstance(state, hvd.EFState) and state.residual["w"].dtype == torch.float32
    finally:
        hvd.shutdown()
