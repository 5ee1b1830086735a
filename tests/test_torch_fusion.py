"""The port's fusion planner and collectives against the JAX package.

Bucket plans are compared on the GPT ``TransformerLM`` leaf list, where the
leaf order is the trap: ``jax.tree.leaves`` sorts dict keys, so
``block_10`` comes before ``block_2``. The collectives run at 2 gloo ranks
on the CPU and mirror the cases of tests/test_collectives.py, with the
expected values computed locally as that file computes them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models.transformer import TransformerLM as RefLM
from horovod_tpu.ops import fusion as ref_fusion
from horovod_tpu.parallel.rules import named_tree_paths
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops import fusion

from torch_port_harness import run_ranks

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
SMOKE = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=128)


def _ref_leaves(dims):
    model = RefLM(**dims, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    return named_tree_paths(shapes)


@pytest.mark.parametrize("dims,threshold", [
    (GPT2_SMALL, None), (GPT2_SMALL, 8 << 20), (SMOKE, None), (SMOKE, 64 << 10),
], ids=["gpt2-default", "gpt2-8MiB", "smoke-default", "smoke-64KiB"])
def test_plan_buckets_matches_reference_on_transformer(dims, threshold):
    ref = _ref_leaves(dims)
    named = list(TransformerLM(**dims, dtype=torch.float32, device="meta").named_parameters())
    ordered = [named[i] for i in fusion.tree_order([n for n, _ in named])]
    assert [n.replace(".", "/") for n, _ in ordered] == [n for n, _ in ref]
    assert [tuple(p.shape) for _, p in ordered] == [tuple(l.shape) for _, l in ref]
    want = ref_fusion.plan_buckets([l for _, l in ref],
                                   ref_fusion.default_threshold_bytes(threshold))
    got = fusion.plan_buckets([p for _, p in ordered], fusion.default_threshold_bytes(threshold))
    assert got == want
    if threshold is None and dims is GPT2_SMALL:
        assert len(got) > 2   # ~500 MB of f32 leaves: the order shows


def test_bucket_planning():
    """Mirrors test_bucket_planning."""
    a = torch.zeros(100)
    b = torch.zeros(100)
    c = torch.zeros(100, dtype=torch.int32)
    d = torch.zeros(1000)
    buckets = fusion.plan_buckets([a, b, c, d], threshold_bytes=1000)
    assert buckets == ref_fusion.plan_buckets(
        [np.zeros(100, np.float32), np.zeros(100, np.float32),
         np.zeros(100, np.int32), np.zeros(1000, np.float32)], 1000)
    assert [0, 1] in buckets and [2] in buckets and [3] in buckets


def test_pack_unpack_roundtrip():
    """Mirrors test_pack_unpack_roundtrip."""
    rng = np.random.RandomState(3)
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((3, 4), (7,), (2, 2, 2))]
    buf = fusion.pack_bucket(leaves)
    assert buf.shape == (12 + 7 + 8,)
    for o, l in zip(fusion.unpack_bucket(buf, [l.shape for l in leaves]), leaves):
        assert torch.equal(o, l)


def test_default_threshold_reads_knob(monkeypatch):
    assert fusion.default_threshold_bytes() == 64 * 1024 * 1024
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "4096")
    assert fusion.default_threshold_bytes() == ref_fusion.default_threshold_bytes() == 4096
    assert fusion.default_threshold_bytes(7) == 7


N = 2
# Rank r holds row r of each global input below; results are saved per rank.
WORKER = r'''
import os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import ReduceOp
from horovod_tpu_torch.ops import fusion

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
rng = np.random.RandomState(0)
X = {
    "f32": np.arange(n * 4, dtype=np.float32).reshape(n, 4),
    "i32": np.arange(n * 4, dtype=np.int32).reshape(n, 4),
    "rand": rng.randn(n, 5).astype(np.float32),
    "ones": np.ones((n, 3), np.float32),
    "prod": (rng.rand(n, 6) + 0.5).astype(np.float32),
    "a": rng.randn(n, 4).astype(np.float32),
    "b": rng.randn(n, 2, 3).astype(np.float32),
    "c": rng.randn(n, 5).astype(np.float32),
}
x = {k: torch.from_numpy(v[r]) for k, v in X.items()}
bf16 = x["f32"].to(torch.bfloat16)
out = {
    "sum_f32": hvd.allreduce(x["f32"], op=ReduceOp.SUM),
    "sum_bf16": hvd.allreduce(bf16, op=ReduceOp.SUM).float(),
    "sum_i32": hvd.allreduce(x["i32"], op=ReduceOp.SUM),
    "average": hvd.allreduce(x["f32"], op=ReduceOp.AVERAGE),
    "min": hvd.allreduce(x["rand"], op=ReduceOp.MIN),
    "max": hvd.allreduce(x["rand"], op=ReduceOp.MAX),
    "product": hvd.allreduce(x["prod"], op=ReduceOp.PRODUCT),
    "scaled": hvd.allreduce(x["ones"], op=ReduceOp.SUM, prescale_factor=0.5,
                            postscale_factor=2.0),
    "allgather": hvd.allgather(x["f32"].reshape(1, 4)),
    "broadcast": hvd.broadcast(torch.full((4,), float(r)), root_rank=n - 1),
}
assert torch.equal(x["f32"], torch.from_numpy(X["f32"][r]))  # inputs untouched
leaves = [x["a"], x["b"], x["c"]]
for tag, thr in (("fused", 1 << 20), ("fused_split", 40)):
    red = fusion.fused_allreduce(leaves, op=ReduceOp.AVERAGE, threshold_bytes=thr)
    for name, t in zip("abc", red):
        out[f"{tag}_{name}"] = t
try:
    hvd.broadcast(x["f32"], root_rank=n)
except ValueError:
    out["bad_root_raised"] = torch.ones(1)
np.savez(f"{d}/rank{r}.npz", **{k: v.numpy() for k, v in out.items()},
         **{f"in_{k}": v for k, v in X.items()})
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_collectives")
    run_ranks(WORKER, N, d)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]


def _expect(res, key, expected, rtol=1e-6):
    for r in range(N):
        np.testing.assert_allclose(res[r][key], expected, rtol=rtol)


@pytest.mark.parametrize("key,rtol", [("sum_f32", 1e-6), ("sum_bf16", 1e-2), ("sum_i32", 0)])
def test_allreduce_sum(gloo_results, key, rtol):
    """Mirrors test_allreduce_sum over f32, bf16 and int32."""
    x = gloo_results[0]["in_f32"]
    _expect(gloo_results, key, x.astype(np.float64).sum(0), rtol=rtol)


def test_allreduce_average(gloo_results):
    _expect(gloo_results, "average", gloo_results[0]["in_f32"].mean(0))


@pytest.mark.parametrize("op", ["min", "max"])
def test_allreduce_min_max(gloo_results, op):
    x = gloo_results[0]["in_rand"]
    _expect(gloo_results, op, getattr(x, op)(0), rtol=0)


def test_allreduce_product(gloo_results):
    _expect(gloo_results, "product", gloo_results[0]["in_prod"].prod(0))


def test_allreduce_prescale_postscale(gloo_results):
    _expect(gloo_results, "scaled", np.full(3, N, np.float32))


def test_allgather(gloo_results):
    _expect(gloo_results, "allgather", gloo_results[0]["in_f32"])


def test_broadcast(gloo_results):
    _expect(gloo_results, "broadcast", np.full(4, N - 1, np.float32))
    for r in range(N):
        assert "bad_root_raised" in gloo_results[r]


@pytest.mark.parametrize("tag", ["fused", "fused_split"])
def test_fused_allreduce_matches_unfused(gloo_results, tag):
    """Mirrors test_fused_allreduce_matches_unfused, with one bucket and
    with a threshold that splits the leaves."""
    for name in "abc":
        _expect(gloo_results, f"{tag}_{name}", gloo_results[0][f"in_{name}"].mean(0),
                rtol=1e-5)
