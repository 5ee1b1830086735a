"""The port's flat Adasum against the JAX package's ``ops/adasum.py``.

- ``_pairwise_combine`` against JAX's (f32, bf16, a zero vector) to f32
  rounding (the dot products sum in another order).
- ``adasum_allreduce`` at 4 gloo ranks and on 2-rank subgroups, against
  ``adasum_allreduce_reference`` (float64) and against JAX's on a 2- and
  4-device mesh, which pairs ranks in the same order (rank XOR 2^level):
  rtol 1e-5 (each level rounds three dot products in f32); every rank of a
  group holds the same vector; a 3-rank group is refused.
- The DP step with ``op=Adasum`` against JAX's at 2 gloo ranks: losses at
  rtol 1e-5, the parameters at the plain step's tolerance.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from horovod_tpu.jax import _shard_map
from horovod_tpu.ops import adasum as jada
from horovod_tpu.parallel.mesh import build_mesh

from horovod_tpu_torch.ops import adasum as tada

from torch_port_harness import (GPT_THRESHOLD, assert_params_close, gpt_setup, run_jax_variant,
                                run_port_variants, run_ranks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_combine_matches_jax(dtype):
    rng = np.random.RandomState(0)
    a, b = rng.randn(2, 300).astype(np.float32)
    for x, y in ((a, b), (a, np.zeros_like(b)), (a, a)):
        want = np.asarray(jada._pairwise_combine(jnp.asarray(x).astype(dtype),
                                                 jnp.asarray(y).astype(dtype))).astype(np.float32)
        got = tada._pairwise_combine(torch.from_numpy(x).to(getattr(torch, dtype)),
                                     torch.from_numpy(y).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        tol = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * 1e-2)
    # Parallel vectors average; orthogonal ones add.
    np.testing.assert_allclose(tada._pairwise_combine(torch.from_numpy(a), torch.from_numpy(a)),
                               a, rtol=1e-6)


WORKER = r'''
import json, os
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.adasum import adasum_allreduce

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r = hvd.rank()
x = torch.from_numpy(np.load(f"{d}/x.npy")[r])
out = {"world": adasum_allreduce(x).tolist()}
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
out["pair"] = adasum_allreduce(x, group=pairs[r // 2]).tolist()
three = dist.new_group([0, 1, 2])
if r < 3:
    try:
        adasum_allreduce(x, group=three)
    except ValueError as e:
        out["three"] = str(e)
json.dump(out, open(f"{d}/out{r}.json", "w"))
hvd.shutdown()
'''


def _jax_adasum(x, n):
    mesh = build_mesh({"data": n}, devices=jax.devices()[:n])
    body = lambda v: jada.adasum_allreduce(v[0], axis_name="data")[None]
    return np.asarray(jax.jit(_shard_map(body, mesh, in_specs=(P("data"),),
                                         out_specs=P("data")))(jnp.asarray(x)))


def test_adasum_allreduce_at_4_ranks_and_on_pairs(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 333).astype(np.float32)
    x[3] = 0.5 * x[2]                       # a parallel pair
    np.save(tmp_path / "x.npy", x)
    run_ranks(WORKER, 4, tmp_path)
    outs = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(4)]
    world, want4 = _jax_adasum(x, 4), jada.adasum_allreduce_reference(list(x))
    for r in range(4):
        got = np.asarray(outs[r]["world"], np.float32)
        np.testing.assert_array_equal(got, np.asarray(outs[0]["world"], np.float32))
        np.testing.assert_allclose(got, world[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want4, rtol=1e-5, atol=1e-6)
        pair = x[2 * (r // 2):2 * (r // 2) + 2]
        np.testing.assert_allclose(outs[r]["pair"], _jax_adasum(pair, 2)[r % 2], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(outs[r]["pair"], jada.adasum_allreduce_reference(list(pair)),
                                   rtol=1e-5, atol=1e-6)
    for r in range(3):
        assert "power-of-2" in outs[r]["three"]


@pytest.fixture(scope="module")
def setup():
    return gpt_setup()


def test_adasum_step_matches_jax(setup, tmp_path_factory):
    port = run_port_variants(tmp_path_factory.mktemp("adasum"), {
        "adasum": {"kwargs": {"fusion_threshold_bytes": GPT_THRESHOLD, "op": "Adasum"}}},
        2, setup)["adasum"]
    from horovod_tpu.common.types import ReduceOp

    losses, final, _ = run_jax_variant(setup, 2, op=ReduceOp.ADASUM)
    for r in range(2):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=1e-5)
    assert_params_close(port[0]["arrays"], final)
    for key, a in port[0]["arrays"].items():
        np.testing.assert_array_equal(port[1]["arrays"][key], a, err_msg=key)
