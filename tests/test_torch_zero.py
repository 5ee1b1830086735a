"""The port's ZeRO-1 against the JAX package's ``parallel/zero.py``.

- The shard layout (groups, buckets, shard lengths, the EF residual's
  keys) equal to JAX's ``init_zero1_stream_state`` on the GPT tree.
- At 2 gloo ranks: ZeRO-1 equal to the replicated step within f32 rounding
  (AdamW is elementwise, so the shard's update is the whole vector's), and
  the streamed ZeRO-1 equal to the post-hoc one BITWISE (one reduction, two
  call sites, as JAX's ``test_streamed_equals_posthoc_zero1_bitwise``).
- Three steps against JAX's ``make_train_step(zero1=True)`` at the plain
  step's tolerances (losses rtol 1e-5, ``assert_params_close``), and of
  ``zero1`` with ``overlap`` and ``quantized`` at the int8 wire's share
  (tests/test_torch_quantized.py), its sharded residual after the first
  step within one quantization step of JAX's row for this rank.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel import zero

from torch_port_harness import (GPT_DIMS, GPT_FIRST_BUCKET, GPT_THRESHOLD, assert_params_close, gpt_setup,
                                run_jax_variant, run_port_variants)

N = 2
KW = dict(fusion_threshold_bytes=GPT_THRESHOLD, first_bucket_bytes=GPT_FIRST_BUCKET)


@pytest.fixture(scope="module")
def setup():
    return gpt_setup()


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    variants = {
        "replicated": {"kwargs": {"fusion_threshold_bytes": GPT_THRESHOLD}},
        "zero1": {"kwargs": dict(KW, zero1=True)},
        "zero1_overlap": {"kwargs": dict(KW, zero1=True, overlap=True)},
        "zero1_overlap_quantized": {"kwargs": dict(KW, zero1=True, overlap=True,
                                                   quantized=True)},
    }
    return run_port_variants(tmp_path_factory.mktemp("zero"), variants, N, setup)


@pytest.fixture
def one_rank(tmp_path):
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _params(arrays):
    return {k: v for k, v in arrays.items() if k.startswith("p:")}


def test_zero1_equals_replicated_within_f32_rounding(runs):
    for r in range(N):
        np.testing.assert_allclose(runs["zero1"][r]["losses"], runs["replicated"][r]["losses"],
                                   rtol=1e-6)
        for key, a in _params(runs["replicated"][r]["arrays"]).items():
            np.testing.assert_allclose(runs["zero1"][r]["arrays"][key], a, rtol=0, atol=1e-6,
                                       err_msg=key)


def test_streamed_zero1_equals_posthoc_zero1_bitwise(runs):
    for r in range(N):
        s, p = runs["zero1_overlap"][r], runs["zero1"][r]
        assert s["losses"] == p["losses"]
        assert all(launched == total > 1 for launched, _, total in s["groups"])
        for key, a in p["arrays"].items():
            np.testing.assert_array_equal(s["arrays"][key], a, err_msg=key)
    for name in ("zero1", "zero1_overlap_quantized"):
        for key, a in _params(runs[name][0]["arrays"]).items():
            np.testing.assert_array_equal(runs[name][1]["arrays"][key], a, err_msg=key)


def test_zero1_matches_jax_zero1_step(runs, setup):
    losses, final, states = run_jax_variant(setup, N, zero1=True, **KW)
    assert states[-1].ef is None
    for r in range(N):
        np.testing.assert_allclose(runs["zero1"][r]["losses"], losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert_params_close(runs["zero1"][0]["arrays"], final)


def test_zero1_overlap_quantized_matches_jax(runs, setup):
    losses, final, states = run_jax_variant(setup, N, zero1=True, overlap=True, quantized=True,
                                            **KW)
    port = runs["zero1_overlap_quantized"]
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=1e-5)
    assert_params_close(port[0]["arrays"], final, share=1e-3)
    ef = states[0].ef
    for r in range(N):
        keys = {k for k in port[r]["arrays"] if k.startswith("z1:")}
        assert keys == {f"z1:{g}/{b}" for g, bs in ef.items() for b in bs}
        for g, bs in ef.items():
            for b, rows in bs.items():
                want = np.asarray(rows)[r]
                got = port[r]["arrays"][f"z1:{g}/{b}"]
                assert got.shape == want.shape
                largest = max(np.abs(want).max(), np.abs(got).max())
                assert np.abs(got - want).max() <= 2.2 * largest
                assert np.mean(np.abs(got - want) > 1e-3 * largest) <= 1e-3


@pytest.mark.parametrize("quantized", [False, True])
def test_shard_layout_matches_jax(one_rank, setup, quantized):
    import optax

    from horovod_tpu.parallel.zero import init_zero1_stream_state
    from horovod_tpu_torch.models.transformer import TransformerLM

    _, params, _, _ = setup
    n = 4
    want = init_zero1_stream_state(optax.adamw(1e-3), params, n, threshold_bytes=GPT_THRESHOLD,
                                   first_bucket_bytes=GPT_FIRST_BUCKET, quantized=quantized)
    model = TransformerLM(**GPT_DIMS, dtype=torch.float32, device="cpu")
    tree = fusion.named_tree(list(model.named_parameters()))
    layout = fusion.zero1_group_layout(tree, GPT_THRESHOLD, GPT_FIRST_BUCKET)
    got = {label: {f"b{bi}": fusion.zero1_shard_len(
        sum(leaves[i].numel() for i in bucket), n, quantized)
        for bi, bucket in enumerate(buckets)} for label, leaves, buckets in layout}
    import jax

    # Each bucket's optax state stacks [n, k] moments (and [n] counts).
    ref = {g: {b: max(l.shape[1] for l in jax.tree.leaves(s) if l.ndim == 2)
               for b, s in bs.items()} for g, bs in want.opt.items()}
    assert got == ref and len(got) > 1
    state = zero.init_zero1_stream_state(torch.optim.AdamW(model.parameters()), tree,
                                         threshold_bytes=GPT_THRESHOLD,
                                         first_bucket_bytes=GPT_FIRST_BUCKET,
                                         quantized=quantized)
    assert (state.ef is not None) == quantized
    assert {g: set(bs) for g, bs in state.shards.items()} == {g: set(bs) for g, bs in ref.items()}


def test_refusals(one_rank):
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    two_lrs = torch.optim.SGD([{"params": [a]}, {"params": [b], "lr": 0.5}], lr=0.1)
    with pytest.raises(ValueError, match="share one set of hyperparameters"):
        hvd.DistributedOptimizer(two_lrs, zero1=True)
    with pytest.raises(ValueError, match="misalign"):
        zero.init_zero1_stream_state(torch.optim.SGD([a], lr=0.1), [a], n_shards=2)
    with pytest.raises(ValueError, match="requires quantized"):
        zero.init_zero1_stream_state(torch.optim.SGD([a], lr=0.1), [a], error_feedback=True)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([a, b], lr=0.1), zero1=True)
    stale = zero.init_zero1_stream_state(torch.optim.SGD([a], lr=0.1), [a])
    a.grad, b.grad = torch.ones(3), torch.ones(2)
    opt._zero1_state = stale
    with pytest.raises(ValueError, match="the live layout needs 5"):
        opt.step()


def test_whole_vector_zero1_step_is_the_plain_step(one_rank):
    """``make_zero1_train_step`` at one rank: the shard is the whole vector,
    so three AdamW steps equal torch's own, bitwise."""
    torch.manual_seed(0)
    w = {"a": torch.nn.Parameter(torch.randn(5, 3)), "b": torch.nn.Parameter(torch.randn(3))}
    ref = {k: torch.nn.Parameter(v.detach().clone()) for k, v in w.items()}
    x = torch.randn(4, 5)
    loss = lambda p, xb: ((xb @ p["a"]) + p["b"]).pow(2).mean()
    step = zero.make_zero1_train_step(loss, torch.optim.AdamW(list(w.values()), lr=0.1),
                                      quantized=False)
    ref_opt = torch.optim.AdamW([ref["a"], ref["b"]], lr=0.1)
    for _ in range(3):
        got = step(w, x)
        ref_opt.zero_grad()
        want = loss(ref, x)
        want.backward()
        ref_opt.step()
        assert float(got) == want.item()
    for k in w:
        torch.testing.assert_close(w[k].detach(), ref[k].detach(), rtol=0, atol=0)
