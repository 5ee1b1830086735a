"""The port's expert parallelism (``horovod_tpu_torch.parallel.ep``) against
the JAX package's (``horovod_tpu.parallel.ep``).

One spawn of 4 gloo ranks runs the multi-rank port cases; the JAX side runs
on the conftest's virtual CPU devices with the same weights (JAX's
``init_moe_params``, carried across by ``utils.convert.moe_params_from_numpy``)
and tokens:

- ``moe_ffn`` at expert 4 (``test_ep.py``'s first case, tanh experts,
  capacity factor 4): y and each rank's aux at rtol / atol 1e-5;
- the capacity drop (every token routed to expert 0, capacity factor 0.3):
  exactly ``64 - 4 * capacity`` zero rows (``test_ep.py:99``);
- one SGD step of ``make_ep_train_step`` at data 1 x expert 4 against JAX's
  and against one process holding every expert (``test_ep.py:167``: SGD
  shows a wrong expert-gradient scale that Adam hides): loss rtol 1e-5,
  parameters rtol 1e-4 / atol 1e-5;
- one Adam step at data 2 x expert 2 against JAX's, the aux loss weighted
  0.01 (the same tolerances).

In one process: the index dispatch against the dense form
(``_moe_ffn_dense``) bitwise in f32, forward, and its gradients.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from horovod_tpu.jax import _shard_map
from horovod_tpu.parallel import ep as jep
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu_torch.parallel import ep
from horovod_tpu_torch.utils.convert import moe_params_from_numpy

from torch_port_harness import run_ranks

N = 4

WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import ep
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.utils.convert import moe_params_from_numpy

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r = hvd.rank()
data = np.load(f"{d}/inputs.npz")
out = {}
meshes = {(1, 4): build_mesh({"data": 1, "expert": 4}), (2, 2): build_mesh({"data": 2, "expert": 2})}


def moe(prefix, n_shards, index):
    return moe_params_from_numpy([data[f"{prefix}/{k}"] for k in ("w_router", "w_in", "w_out")],
                                 n_shards=n_shards, index=index, device="cpu")


def t(name):
    return torch.from_numpy(data[name])


# moe_ffn at expert 4, and the capacity drop.
group = meshes[(1, 4)].get_group("expert")
with torch.no_grad():
    x = t("A/x")[r * 12:(r + 1) * 12]
    y, aux = ep.moe_ffn(moe("A", 4, r), x, expert_axis=group, capacity_factor=4.0,
                        activation=torch.tanh)
    out["A/y"], out["A/aux"] = y, aux
    y, _ = ep.moe_ffn(moe("B", 4, r), t("B/x")[r * 16:(r + 1) * 16], expert_axis=group,
                      capacity_factor=0.3)
    out["B/zero_rows"] = (y == 0).all(-1).sum()


def loss_fn(cf):
    def fn(p, batch, expert_axis="expert"):
        xb, yb = batch
        h, aux = ep.moe_ffn(p["moe"], xb, expert_axis=expert_axis, capacity_factor=cf)
        return (((xb + h) @ p["head"] - yb) ** 2).mean(), aux
    return fn


def leaves(p):
    return [p["head"], *p["moe"]]


# One SGD step at data 1 x expert 4, aux weight 0.
p = {"moe": moe("D", 4, r), "head": t("D/head").clone().requires_grad_()}
step = ep.make_ep_train_step(loss_fn(16.0), torch.optim.SGD(leaves(p), lr=0.5), meshes[(1, 4)],
                             aux_loss_weight=0.0)
out["D/loss"] = step(p, (t("D/x"), t("D/y")))
out.update({"D/head": p["head"], "D/w_in": p["moe"].w_in, "D/w_out": p["moe"].w_out,
            "D/w_router": p["moe"].w_router})
# The same step in one process: every expert, no all-to-all.
p = {"moe": moe("D", 1, 0), "head": t("D/head").clone().requires_grad_()}
task, _ = loss_fn(16.0)(p, (t("D/x"), t("D/y")), expert_axis=None)
task.backward()
torch.optim.SGD(leaves(p), lr=0.5).step()
out.update({"D1/loss": task, "D1/head": p["head"], "D1/w_in": p["moe"].w_in,
            "D1/w_out": p["moe"].w_out, "D1/w_router": p["moe"].w_router})

# One Adam step at data 2 x expert 2, aux weight 0.01.
mesh = meshes[(2, 2)]
p = {"moe": moe("E", 2, mesh.get_local_rank("expert")),
     "head": t("E/head").clone().requires_grad_()}
step = ep.make_ep_train_step(loss_fn(2.0), torch.optim.Adam(leaves(p), lr=1e-2), mesh)
out["E/loss"] = step(p, (t("E/x"), t("E/y")))
out.update({"E/head": p["head"], "E/w_in": p["moe"].w_in, "E/w_out": p["moe"].w_out,
            "E/w_router": p["moe"].w_router})
np.savez(f"{d}/rank{r}.npz", **{k: v.detach().numpy() for k, v in out.items()})
hvd.shutdown()
'''


def _moe_arrays(prefix, params):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in params._asdict().items()}


def _jax_loss(cf):
    def fn(p, batch):
        xb, yb = batch
        h, aux = jep.moe_ffn(p["moe"], xb, expert_axis="expert", capacity_factor=cf)
        return jnp.mean(((xb + h) @ p["head"] - yb) ** 2), aux
    return fn


def _jax_step(params, batch, tx, axes, devices, **kw):
    mesh = build_mesh(axes, devices=devices[:axes["data"] * axes["expert"]])
    state = tx.init(params)
    step = jep.make_ep_train_step(_jax_loss(kw.pop("cf")), tx, mesh, params, state,
                                  donate=False, **kw)
    new, _, loss = step(params, state, batch)
    return jax.device_get(new), float(loss)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices):
    arrays, want = {}, {}
    mesh4 = build_mesh({"expert": 4}, devices=devices[:4])

    # A: moe_ffn at expert 4.
    pa = jep.init_moe_params(jax.random.PRNGKey(0), d_model=16, d_hidden=32, num_experts=8,
                             num_expert_shards=4)
    xa = np.random.RandomState(0).randn(48, 16).astype(np.float32)
    arrays.update({"A/x": xa, **_moe_arrays("A", pa)})

    def fa(p, xs):
        y, aux = jep.moe_ffn(p, xs, expert_axis="expert", capacity_factor=4.0,
                             activation=jnp.tanh)
        return y, aux[None]

    spec = jep.MoEParams(P(), P("expert"), P("expert"))
    y, aux = jax.jit(_shard_map(fa, mesh4, in_specs=(spec, P("expert")),
                                out_specs=(P("expert"), P("expert"))))(pa, jnp.asarray(xa))
    want["A/y"], want["A/aux"] = np.asarray(y), np.asarray(aux)

    # B: every token to expert 0.
    pb = jep.init_moe_params(jax.random.PRNGKey(1), d_model=8, d_hidden=8, num_experts=4,
                             num_expert_shards=4)
    pb = pb._replace(w_router=jnp.zeros((8, 4)).at[:, 0].set(5.0))
    xb = np.abs(np.random.RandomState(1).randn(64, 8)).astype(np.float32)
    arrays.update({"B/x": xb, **_moe_arrays("B", pb)})
    yb = jax.jit(_shard_map(lambda p, xs: jep.moe_ffn(p, xs, expert_axis="expert",
                                                      capacity_factor=0.3)[0],
                            mesh4, in_specs=(spec, P("expert")), out_specs=P("expert")))(
        pb, jnp.asarray(xb))
    want["B/zero_rows"] = int(np.sum(np.all(np.asarray(yb) == 0.0, axis=-1)))
    want["B/capacity"] = max(1, int(0.3 * 16 / 4))

    # D: one SGD step at data 1 x expert 4 and at one device.
    pd = {"moe": jep.init_moe_params(jax.random.PRNGKey(5), d_model=8, d_hidden=16,
                                     num_experts=4, num_expert_shards=4),
          "head": jnp.ones((8, 1)) * 0.1}
    batch = (np.random.RandomState(5).randn(32, 8).astype(np.float32),
             np.random.RandomState(6).randn(32, 1).astype(np.float32))
    arrays.update({"D/x": batch[0], "D/y": batch[1], "D/head": np.asarray(pd["head"]),
                   **_moe_arrays("D", pd["moe"])})
    jb = tuple(jnp.asarray(b) for b in batch)
    for tag, axes in (("D", {"data": 1, "expert": 4}), ("D1", {"data": 1, "expert": 1})):
        new, loss = _jax_step(pd, jb, optax.sgd(0.5), axes, devices, cf=16.0,
                              aux_loss_weight=0.0)
        want[f"{tag}/loss"] = loss
        want.update({f"{tag}/head": np.asarray(new["head"]),
                     **_moe_arrays(tag, new["moe"])})

    # E: one Adam step at data 2 x expert 2.
    pe = {"moe": jep.init_moe_params(jax.random.PRNGKey(2), d_model=8, d_hidden=16,
                                     num_experts=4, num_expert_shards=2),
          "head": jnp.ones((8, 1)) * 0.1}
    xe = np.random.RandomState(3).randn(64, 8).astype(np.float32)
    ye = xe @ np.random.RandomState(4).randn(8, 1).astype(np.float32)
    arrays.update({"E/x": xe, "E/y": ye, "E/head": np.asarray(pe["head"]),
                   **_moe_arrays("E", pe["moe"])})
    new, loss = _jax_step(pe, (jnp.asarray(xe), jnp.asarray(ye)), optax.adam(1e-2),
                          {"data": 2, "expert": 2}, devices, cf=2.0)
    want["E/loss"] = loss
    want.update({"E/head": np.asarray(new["head"]), **_moe_arrays("E", new["moe"])})
    want["E/init"] = _moe_arrays("E", pe["moe"])

    d = tmp_path_factory.mktemp("torch_ep")
    np.savez(d / "inputs.npz", **arrays)
    run_ranks(WORKER, N, d, timeout=240)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(N)], want


def test_moe_ffn_matches_jax_at_expert_4(runs):
    ported, want = runs
    y = np.concatenate([ported[r]["A/y"] for r in range(N)])
    np.testing.assert_allclose(y, want["A/y"], rtol=1e-5, atol=1e-5)
    aux = np.array([ported[r]["A/aux"] for r in range(N)])
    np.testing.assert_allclose(aux, want["A/aux"], rtol=1e-5, atol=1e-5)
    assert (aux > 0).all()


def test_moe_capacity_drops_tokens(runs):
    ported, want = runs
    zero_rows = sum(int(ported[r]["B/zero_rows"]) for r in range(N))
    assert zero_rows == want["B/zero_rows"] == 64 - 4 * want["B/capacity"]


def _expert_rows(a, e, n_shards):
    per = a.shape[0] // n_shards
    return a[e * per:(e + 1) * per]


@pytest.mark.parametrize("ref", ["D", "D1"])
def test_ep_sgd_step_matches_jax_and_one_process(runs, ref):
    """``D``: JAX's step at data 1 x expert 4; ``D1``: JAX's step on one
    device. The port's 4-rank step must match both, and so must the port's
    own one-process step."""
    ported, want = runs
    for r in range(N):
        for tag in ("D", "D1"):
            got = ported[r]
            if tag == "D1" and r:
                continue
            np.testing.assert_allclose(got[f"{tag}/loss"], want[f"{ref}/loss"], rtol=1e-5)
            for k in ("head", "w_router"):
                np.testing.assert_allclose(got[f"{tag}/{k}"], want[f"{ref}/{k}"], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{tag} {k}")
            for k in ("w_in", "w_out"):
                full = want[f"{ref}/{k}"]
                expect = full if tag == "D1" else _expert_rows(full, r, N)
                np.testing.assert_allclose(got[f"{tag}/{k}"], expect, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{tag} {k}")


def test_ep_adam_step_matches_jax_at_data_2_expert_2(runs):
    ported, want = runs
    for r in range(N):
        got, e = ported[r], r % 2
        np.testing.assert_allclose(got["E/loss"], want["E/loss"], rtol=1e-5)
        for k in ("head", "w_router"):
            np.testing.assert_allclose(got[f"E/{k}"], want[f"E/{k}"], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        for k in ("w_in", "w_out"):
            expect = _expert_rows(want[f"E/{k}"], e, 2)
            np.testing.assert_allclose(got[f"E/{k}"], expect, rtol=1e-4, atol=1e-5, err_msg=k)
            assert not np.array_equal(got[f"E/{k}"], _expert_rows(want["E/init"][f"E/{k}"], e, 2))


def _moe(seed, d, h, e):
    g = torch.Generator().manual_seed(seed)
    p = ep.init_moe_params(g, d_model=d, d_hidden=h, num_experts=e, num_expert_shards=1,
                           device="cpu")
    return ep.MoEParams(*(t.requires_grad_() for t in p)), g


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_index_dispatch_matches_dense_bitwise(capacity_factor):
    """The index dispatch and combine give the dense one-hot form's values
    bit for bit in f32 (each slot holds at most one token), dropped tokens
    included; the gradients agree to f32 rounding (the router's and x's sum
    their terms in another order)."""
    p, g = _moe(0, 16, 32, 8)
    x = torch.randn(96, 16, generator=g, requires_grad=True)
    y, aux = ep.moe_ffn(p, x, expert_axis=None, capacity_factor=capacity_factor)
    y_ref, aux_ref = ep._moe_ffn_dense(p, x, expert_axis=None, capacity_factor=capacity_factor)
    assert torch.equal(y, y_ref) and torch.equal(aux, aux_ref)
    dropped = int((y == 0).all(-1).sum())
    assert (dropped > 0) == (capacity_factor < 4.0)    # these tokens overflow below 4
    cot = torch.randn(y.shape, generator=g)
    grads = torch.autograd.grad((y * cot).sum() + aux, [x, *p])
    grads_ref = torch.autograd.grad((y_ref * cot).sum() + aux_ref, [x, *p])
    for got, want in zip(grads, grads_ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_moe_params_from_numpy_cuts_expert_rows():
    p = jep.init_moe_params(jax.random.PRNGKey(3), d_model=4, d_hidden=6, num_experts=8,
                            num_expert_shards=4)
    local = moe_params_from_numpy(jax.device_get(p), n_shards=4, index=2, device="cpu")
    np.testing.assert_array_equal(local.w_router.detach().numpy(), np.asarray(p.w_router))
    np.testing.assert_array_equal(local.w_in.detach().numpy(), np.asarray(p.w_in)[4:6])
    np.testing.assert_array_equal(local.w_out.detach().numpy(), np.asarray(p.w_out)[4:6])
    assert all(t.requires_grad for t in local)
    with pytest.raises(ValueError):
        moe_params_from_numpy(jax.device_get(p), n_shards=3, device="cpu")


def test_expert_sharding_specs():
    p, _ = _moe(0, 4, 4, 4)
    specs = ep.expert_sharding_specs({"moe": p, "other": torch.ones(3)})
    assert specs == {"moe/w_router": (), "moe/w_in": ("expert",), "moe/w_out": ("expert",),
                     "other": ()}


def test_init_moe_params_validates_divisibility():
    with pytest.raises(ValueError):
        ep.init_moe_params(torch.Generator(), d_model=4, d_hidden=4, num_experts=6,
                           num_expert_shards=4, device="cpu")


def test_bench_moe_smoke_prints_the_reference_line(tmp_path):
    """``python -m horovod_tpu_torch.bench --model moe --smoke --device cpu``
    prints bench.py's MoE JSON line."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "2", "TMPDIR": str(tmp_path),
           "PYTHONPATH": repo}
    out = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.bench", "--model", "moe",
                          "--smoke", "--device", "cpu"], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "moe_synthetic_tokens_per_sec_per_chip" and line["value"] > 0
    assert line["detail"]["mesh"] == {"data": 1, "expert": 1}
    assert np.isfinite(line["detail"]["loss"]) and line["detail"]["platform"] == "cpu"
