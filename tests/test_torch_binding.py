"""The port's torch binding (``horovod_tpu_torch.torch``) against the JAX
package's (``horovod_tpu.torch``).

Both bindings take torch tensors, so each case feeds the same seeded
inputs and the same seeded model weights to both.

- Size 1, in this process (the two eager cores side by side): the 18 cases
  of tests/test_torch.py. Data movement bitwise; trained weights and losses
  at rtol 1e-6 / atol 1e-7 (at one rank both bindings run the same torch
  arithmetic, so they are bitwise in practice). The JAX-only DLPack case
  becomes the port's "no host round trip" case: outputs keep the input's
  device and the in-place forms keep its storage.
- 2 and 4 gloo ranks (tests/torch_port_harness.py): the torch jobs of
  tests/test_multiprocess.py in one spawned run a rank count. The
  DistributedOptimizer, sparse_as_dense and SyncBatchNorm against the JAX
  binding at size 1 on the concatenated batch (equal shards make the
  averaged gradient the whole-batch gradient): weights at rtol 1e-6 / atol
  1e-7; SyncBatchNorm's output, dx, dweight, dbias and running statistics
  at rtol 1e-5 / atol 1e-6 in f32 (the statistics are summed in another
  order) and at two bf16 ulps (rtol 1.6e-2, atol 1e-2) in bf16. The Adasum
  optimizer against the JAX package's Adasum of the same per-rank deltas
  (``ops.adasum``, on a mesh of CPU devices) at rtol 1e-5 / atol 1e-6, as
  tests/test_torch_eager.py holds the eager Adasum. allgather_object and
  the grouped allgather/reducescatter exactly.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.torch as jt
from horovod_tpu.jax import _shard_map
from horovod_tpu.ops import adasum as jada

import horovod_tpu_torch.torch as pt

from torch_port_harness import run_ranks

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def both():
    """The JAX binding and the port's, both initialized in this process."""
    jt.shutdown()
    pt.shutdown()
    jt.init()
    pt.init(device="cpu")
    yield (jt, pt)
    pt.shutdown()
    jt.shutdown()


def _each(both, fn):
    """fn(binding) through the JAX binding, then the port's."""
    return [fn(b) for b in both]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a, b)


# --- size 1: tests/test_torch.py's cases through both bindings ---------------


def test_allreduce_ops(both):
    x = torch.arange(6, dtype=torch.float32)
    for kw in ({"op": "Sum"}, {"average": True}):
        j, p = _each(both, lambda b: b.allreduce(
            x, **({"op": b.Sum} if "op" in kw else kw)))
        _same(p, j)
        _same(p, x)


def test_allreduce_inplace(both):
    for b in both:
        x = torch.ones(4)
        ptr = x.data_ptr()
        y = b.allreduce_(x, op=b.Sum)
        assert y is x and x.data_ptr() == ptr
        _same(x, torch.ones(4))


def test_allreduce_async_poll(both):
    outs = []
    for b in both:
        h = b.allreduce_async(torch.ones(3), name="t_async")
        outs.append(b.synchronize(h))
        assert b.poll(h)
    _same(outs[1], outs[0])


def test_allgather_broadcast(both):
    x = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    for fn in (lambda b: b.allgather(x), lambda b: b.broadcast(x, root_rank=0)):
        j, p = _each(both, fn)
        _same(p, j)
        _same(p, x)
    for b in both:
        y = torch.zeros(2, 2, dtype=torch.int32)
        b.broadcast_(y, root_rank=0)
        _same(y, torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("comp", ["fp16", "bf16"])
def test_compression(both, comp):
    x = torch.linspace(0, 1, 10)
    j, p = _each(both, lambda b: b.allreduce(x, compression=getattr(b.Compression, comp)))
    assert p.dtype == torch.float32
    _same(p, j)


def test_bf16_tensor_allreduce(both):
    x = torch.linspace(0, 1, 8, dtype=torch.bfloat16)
    j, p = _each(both, lambda b: b.allreduce(x, op=b.Sum))
    _same(p, j)
    _same(p, x)


def _make_model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 1))


def _train(b, steps, **kw):
    model = _make_model()
    opt = b.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(), **kw)
    rng = np.random.RandomState(1)
    X = torch.from_numpy(rng.randn(32, 4).astype(np.float32))
    y = X @ torch.from_numpy(rng.randn(4, 1).astype(np.float32))
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(X), y)
        loss.backward()
        if kw.get("backward_passes_per_step", 1) == 2:
            torch.nn.functional.mse_loss(model(X[:16]), y[:16]).backward()
        opt.step()
        losses.append(loss.item())
    return losses, [p.detach().clone() for p in model.parameters()]


def _close(got, want, rtol=RTOL, atol=ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)


def test_distributed_optimizer_trains(both):
    (lj, wj), (lp, wp) = _each(both, lambda b: _train(b, 30))
    assert lp[-1] < lp[0] * 0.3, lp
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    _close(wp, wj)


def test_distributed_optimizer_backward_passes_per_step(both):
    (lj, wj), (lp, wp) = _each(both, lambda b: _train(b, 3, backward_passes_per_step=2))
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    _close(wp, wj)


def test_distributed_optimizer_duplicate_names_rejected(both):
    model = _make_model()
    for b in both:
        with pytest.raises(ValueError, match="duplicate"):
            b.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                   named_parameters=[("p", p) for p in model.parameters()])


def test_zero_grad_with_pending_handles_raises(both):
    for b in both:
        model = _make_model()
        opt = b.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                     named_parameters=model.named_parameters())
        torch.nn.functional.mse_loss(model(torch.randn(4, 4)), torch.randn(4, 1)).backward()
        with pytest.raises(AssertionError):
            opt.zero_grad()
        opt.synchronize()
        opt.zero_grad()


def test_broadcast_parameters(both):
    for b in both:
        model = _make_model()
        want = {k: v.clone() for k, v in model.state_dict().items()}
        b.broadcast_parameters(model.state_dict(), root_rank=0)
        b.broadcast_parameters(list(model.named_parameters()), root_rank=0)
        for k, v in model.state_dict().items():
            _same(v, want[k])


def test_broadcast_optimizer_state(both):
    for b in both:
        model = _make_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.25, momentum=0.9)
        model(torch.randn(4, 4)).sum().backward()
        opt.step()
        b.broadcast_optimizer_state(opt, root_rank=0)
        assert opt.param_groups[0]["lr"] == pytest.approx(0.25)
        assert opt.param_groups[0]["momentum"] == pytest.approx(0.9)


def test_broadcast_optimizer_state_dummy_step_matches_jax(both):
    """A fresh AdamW with a weight decay: the dummy step on zero gradients
    that materializes the state moves the parameters, in both bindings
    alike; AdamW's step count stays a CPU tensor."""
    out = []
    for b in both:
        model = _make_model()
        opt = b.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.1, weight_decay=0.5),
            named_parameters=model.named_parameters())
        b.broadcast_optimizer_state(opt, root_rank=0)
        state = opt.state_dict()["state"]
        assert all(s["step"].device.type == "cpu" and float(s["step"]) == 1.0
                   for s in state.values())
        out.append([p.detach().clone() for p in model.parameters()])
    moved = [not torch.equal(p, q) for p, q in zip(out[1], _make_model().parameters())]
    assert any(moved)
    for a, c in zip(out[1], out[0]):
        _same(a, c)


def test_broadcast_object(both):
    obj = {"epoch": 7, "best": 0.123}
    assert [b.broadcast_object(obj, root_rank=0) for b in both] == [obj, obj]


def test_join(both):
    for b in both:
        b.join()


def test_no_host_round_trip(both):
    """What the JAX binding's DLPack case asked of its bridge: tensors of
    every dtype (bf16 included) keep their device, and the in-place forms
    their storage."""
    b = both[1]
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        t = torch.arange(8).to(dt)
        for out in (b.allreduce(t, op=b.Sum), b.allgather(t), b.broadcast(t, 0),
                    b.synchronize(b.allreduce_async(t, op=b.Sum))):
            assert out.device == t.device and out.dtype == dt
            _same(out, t)
        for inplace in (lambda y: b.allreduce_(y, op=b.Sum), lambda y: b.broadcast_(y, 0),
                        lambda y: b.synchronize(b.allreduce_async_(y, op=b.Sum)),
                        lambda y: b.synchronize(b.broadcast_async_(y, 0))):
            y = t.clone()
            ptr = y.data_ptr()
            assert inplace(y) is y and y.data_ptr() == ptr
            _same(y, t)


def test_adasum_optimizer_delta_space_single_rank(both):
    """op=Adasum gives the delta-space optimizer; at size 1 Adasum is the
    identity, so the step equals the plain Adam step, in both bindings."""
    X = torch.randn(16, 4, generator=torch.Generator().manual_seed(3))
    y = torch.randn(16, 1, generator=torch.Generator().manual_seed(4))

    def run(b):
        model = _make_model()
        if b is None:
            opt = torch.optim.Adam(model.parameters(), lr=0.05)
        else:
            opt = b.DistributedOptimizer(torch.optim.Adam(model.parameters(), lr=0.05),
                                         named_parameters=model.named_parameters(), op=b.Adasum)
            assert type(opt).__name__ == "_DistributedAdasumOptimizer"
        for _ in range(5):
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(X), y).backward()
            opt.step()
        return [p.detach().clone() for p in model.parameters()]

    plain = run(None)
    j, p = _each(both, run)
    _close(p, j)
    _close(p, plain, rtol=0, atol=1e-6)


def test_allgather_object_single_rank(both):
    obj = {"rank": 0, "blob": "x" * 10}
    assert [b.allgather_object(obj) for b in both] == [[obj], [obj]]


def test_grouped_allreduce(both):
    tensors = [torch.full((4,), float(i + 1)) for i in range(5)]
    j, p = _each(both, lambda b: b.grouped_allreduce(tensors, op=b.Sum, name="tg"))
    for a, c, t in zip(p, j, tensors):
        _same(a, c)
        _same(a, t)
    for b in both:
        with pytest.raises(ValueError, match="Adasum"):
            b.grouped_allreduce_async(tensors, op=b.Adasum)


# --- 2 and 4 gloo ranks: tests/test_multiprocess.py's torch jobs -------------

ROWS = 8          # rows of the optimizer's batch a rank


def _job_inputs(n: int) -> dict:
    rng = np.random.RandomState(7)
    return {"X": rng.randn(n * ROWS, 4).astype(np.float32),
            "y": rng.randn(n * ROWS, 1).astype(np.float32),
            "bn_x": rng.randn(n * 2, 3, 2, 2).astype(np.float32),
            "bn_dy": rng.randn(n * 2, 3, 2, 2).astype(np.float32)}


JOB_WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
rows = slice(r * 8, (r + 1) * 8)
out, info = {}, {}

def model_linear(bias=True):
    torch.manual_seed(0)
    return torch.nn.Linear(4, 1, bias=bias)

# test_multiprocess.py:227, the hook-driven DistributedOptimizer.
m = model_linear()
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                               named_parameters=m.named_parameters())
hvd.broadcast_parameters(m.state_dict(), root_rank=0)
X, y = torch.from_numpy(data["X"][rows]), torch.from_numpy(data["y"][rows])
for _ in range(5):
    opt.zero_grad()
    torch.nn.functional.mse_loss(m(X), y).backward()
    opt.step()
out["opt_w"], out["opt_b"] = m.weight.detach().numpy(), m.bias.detach().numpy()

# :908, the Adasum optimizer: each rank's local SGD delta, and the result.
m = model_linear(bias=False)
hvd.broadcast_parameters(m.state_dict(), root_rank=0)
w0 = m.weight.detach().clone()
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                               named_parameters=m.named_parameters(), op=hvd.Adasum)
opt.zero_grad()
torch.nn.functional.mse_loss(m(X), y).backward()
out["ada_delta"] = (-0.1 * m.weight.grad).numpy().ravel().copy()
opt.step()
out["ada_w0"], out["ada_w"] = w0.numpy().ravel(), m.weight.detach().numpy().ravel()

# :1002, allgather_object of objects of different sizes.
info["objs"] = hvd.allgather_object({"rank": r, "pad": "z" * (10 + 100 * r)})

# :1444, SyncBatchNorm: f32 with momentum 0.1, two training steps, then eval;
# bf16; momentum=None with and without running statistics.
bx = torch.from_numpy(data["bn_x"][2 * r:2 * r + 2])
bdy = torch.from_numpy(data["bn_dy"][2 * r:2 * r + 2])
sbn = hvd.SyncBatchNorm(3, eps=1e-5, momentum=0.1)
with torch.no_grad():
    sbn.weight.copy_(torch.tensor([1.5, 0.5, 2.0]))
    sbn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
for step in range(2):
    x = bx.clone().requires_grad_(True)
    yb = sbn(x)
    yb.backward(bdy)
out["bn_y"], out["bn_dx"] = yb.detach().numpy(), x.grad.numpy()
out["bn_dw"], out["bn_db"] = sbn.weight.grad.numpy(), sbn.bias.grad.numpy()
out["bn_rm"], out["bn_rv"] = sbn.running_mean.numpy(), sbn.running_var.numpy()
sbn.eval()
out["bn_eval"] = sbn(bx).detach().numpy()
sbn_b = hvd.SyncBatchNorm(3).bfloat16()
xb = bx.bfloat16().clone().requires_grad_(True)
ybb = sbn_b(xb)
ybb.backward(bdy.bfloat16())
out["bnb_y"], out["bnb_dx"] = ybb.detach().float().numpy(), xb.grad.float().numpy()
info["bnb_dtypes"] = [str(ybb.dtype), str(xb.grad.dtype)]
sbn_n = hvd.SyncBatchNorm(3, momentum=None)
for _ in range(2):
    sbn_n(bx)
out["bnn_rm"], out["bnn_rv"] = sbn_n.running_mean.numpy(), sbn_n.running_var.numpy()
info["bnn_tracked"] = int(sbn_n.num_batches_tracked)
out["bnn_free"] = hvd.SyncBatchNorm(3, momentum=None,
                                    track_running_stats=False)(bx).detach().numpy()

# :1566, sparse_as_dense: rank r touches rows {r, 4} of an embedding.
torch.manual_seed(0)
emb = torch.nn.Embedding(8, 4, sparse=True)
opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                               named_parameters=emb.named_parameters(), sparse_as_dense=True)
emb(torch.tensor([r, 4])).sum().backward()
opt.step()
out["sparse_w"] = emb.weight.detach().numpy()
emb2 = torch.nn.Embedding(4, 2, sparse=True)
opt2 = hvd.DistributedOptimizer(torch.optim.SGD(emb2.parameters(), lr=0.1),
                                named_parameters=emb2.named_parameters())
try:
    emb2(torch.tensor([0])).sum().backward()
    opt2.step()
    info["sparse_err"] = ""
except ValueError as exc:
    info["sparse_err"] = str(exc)

# :1612, the grouped allgather / reducescatter through the binding.
gag = hvd.grouped_allgather([torch.full((1, 2), float(r)), torch.full((3,), float(10 + r))])
grs = hvd.grouped_reducescatter((t for t in [torch.ones(2 * n) * (r + 1),
                                             torch.arange(2.0 * n)]), op=hvd.Average)
for i, g in enumerate(gag):
    out[f"gag{i}"] = g.numpy()
for i, g in enumerate(grs):
    out[f"grs{i}"] = g.numpy()

np.savez(f"{d}/rank{r}.npz", **out)
json.dump(info, open(f"{d}/info{r}.json", "w"))
hvd.shutdown()
'''


def _run_jobs(tmp_path_factory, n: int):
    d = tmp_path_factory.mktemp(f"binding{n}")
    inputs = _job_inputs(n)
    np.savez(d / "inputs.npz", **inputs)
    run_ranks(JOB_WORKER, n, d, timeout=240)
    return SimpleNamespace(
        n=n, inputs=inputs,
        port=[dict(np.load(d / f"rank{r}.npz")) for r in range(n)],
        info=[json.loads((d / f"info{r}.json").read_text()) for r in range(n)])


@pytest.fixture(scope="module")
def jobs2(tmp_path_factory):
    return _run_jobs(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def jobs4(tmp_path_factory):
    return _run_jobs(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def jax_binding():
    jt.shutdown()
    jt.init()
    yield jt
    jt.shutdown()


def _jobs(request, n):
    return request.getfixturevalue(f"jobs{n}")


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_optimizer_ranks_match_whole_batch(request, jax_binding, n):
    job = _jobs(request, n)
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 1)
    opt = jax_binding.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                           named_parameters=m.named_parameters())
    X, y = torch.from_numpy(job.inputs["X"]), torch.from_numpy(job.inputs["y"])
    for _ in range(5):
        opt.zero_grad()
        torch.nn.functional.mse_loss(m(X), y).backward()
        opt.step()
    for r in range(n):
        np.testing.assert_array_equal(job.port[r]["opt_w"], job.port[0]["opt_w"])
        np.testing.assert_allclose(job.port[r]["opt_w"], m.weight.detach().numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(job.port[r]["opt_b"], m.bias.detach().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_optimizer_matches_jax_adasum(request, n):
    job = _jobs(request, n)
    deltas = np.stack([job.port[r]["ada_delta"] for r in range(n)])
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    body = _shard_map(lambda v: jada.adasum_allreduce(v[0], axis_name="data")[None], mesh,
                      in_specs=(P("data"),), out_specs=P("data"))
    combined = np.asarray(jax.jit(body)(jnp.asarray(deltas)))
    for r in range(n):
        np.testing.assert_array_equal(job.port[r]["ada_w0"], job.port[0]["ada_w0"])
        np.testing.assert_allclose(job.port[r]["ada_w"], job.port[r]["ada_w0"] + combined[r],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(job.port[r]["ada_w"], job.port[r]["ada_w0"]
                                   + jada.adasum_allreduce_reference(list(deltas)),
                                   rtol=1e-5, atol=1e-6)


def test_allgather_object_two_ranks(jobs2):
    want = [{"rank": r, "pad": "z" * (10 + 100 * r)} for r in range(2)]
    assert [i["objs"] for i in jobs2.info] == [want, want]


def _bn_reference(jb, job, dtype=torch.float32, momentum=0.1, steps=2, affine_init=True):
    """The JAX binding's SyncBatchNorm at size 1 on the concatenated batch."""
    m = jb.SyncBatchNorm(3, eps=1e-5, momentum=momentum)
    if affine_init:
        with torch.no_grad():
            m.weight.copy_(torch.tensor([1.5, 0.5, 2.0]))
            m.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    m = m.to(dtype)
    xg = torch.from_numpy(job.inputs["bn_x"]).to(dtype)
    dyg = torch.from_numpy(job.inputs["bn_dy"]).to(dtype)
    for _ in range(steps):
        x = xg.clone().requires_grad_(True)
        y = m(x)
        y.backward(dyg)
    return m, x, y


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_ranks_match_whole_batch(request, jax_binding, n):
    job = _jobs(request, n)
    m, x, y = _bn_reference(jax_binding, job)
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in range(n):
        rows = slice(2 * r, 2 * r + 2)
        p = job.port[r]
        np.testing.assert_allclose(p["bn_y"], y.detach().numpy()[rows], **tol)
        np.testing.assert_allclose(p["bn_dx"], x.grad.numpy()[rows], **tol)
        # Each rank's weight and bias gradients are its own shard's: their
        # sum over ranks is the whole batch's.
        np.testing.assert_allclose(p["bn_rm"], m.running_mean.numpy(), **tol)
        np.testing.assert_allclose(p["bn_rv"], m.running_var.numpy(), **tol)
    np.testing.assert_allclose(sum(job.port[r]["bn_dw"] for r in range(n)),
                               m.weight.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(job.port[r]["bn_db"] for r in range(n)),
                               m.bias.grad.numpy(), **tol)
    m.eval()
    for r in range(n):
        xr = torch.from_numpy(job.inputs["bn_x"][2 * r:2 * r + 2])
        np.testing.assert_allclose(job.port[r]["bn_eval"], m(xr).detach().numpy(), **tol)


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_bf16_and_momentum_none(request, jax_binding, n):
    job = _jobs(request, n)
    mb, xb, yb = _bn_reference(jax_binding, job, torch.bfloat16, momentum=0.1, steps=1,
                               affine_init=False)
    mn, _, _ = _bn_reference(jax_binding, job, momentum=None, steps=2, affine_init=False)
    free = jax_binding.SyncBatchNorm(3, momentum=None, track_running_stats=False)(
        torch.from_numpy(job.inputs["bn_x"])).detach().numpy()
    bf16 = dict(rtol=1.6e-2, atol=1e-2)
    for r in range(n):
        rows = slice(2 * r, 2 * r + 2)
        p = job.port[r]
        assert job.info[r]["bnb_dtypes"] == ["torch.bfloat16", "torch.bfloat16"]
        np.testing.assert_allclose(p["bnb_y"], yb.detach().float().numpy()[rows], **bf16)
        np.testing.assert_allclose(p["bnb_dx"], xb.grad.float().numpy()[rows], **bf16)
        assert job.info[r]["bnn_tracked"] == 2 == int(mn.num_batches_tracked)
        np.testing.assert_allclose(p["bnn_rm"], mn.running_mean.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p["bnn_rv"], mn.running_var.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p["bnn_free"], free[rows], rtol=1e-5, atol=1e-6)


def test_sparse_as_dense_two_ranks(jobs2, jax_binding):
    """Every rank's rows {r, 4}: the averaged dense gradient is the whole
    batch's sum over the ranks' lookups, divided by 2."""
    torch.manual_seed(0)
    emb = torch.nn.Embedding(8, 4, sparse=True)
    opt = jax_binding.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                                           named_parameters=emb.named_parameters(),
                                           sparse_as_dense=True)
    (emb(torch.tensor([0, 4, 1, 4])).sum() / 2).backward()
    opt.step()
    for r in range(2):
        np.testing.assert_array_equal(jobs2.port[r]["sparse_w"], jobs2.port[0]["sparse_w"])
        np.testing.assert_allclose(jobs2.port[r]["sparse_w"], emb.weight.detach().numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert "sparse_as_dense" in jobs2.info[r]["sparse_err"]


@pytest.mark.parametrize("n", [2, 4])
def test_grouped_allgather_reducescatter_ranks(request, n):
    job = _jobs(request, n)
    for r in range(n):
        p = job.port[r]
        np.testing.assert_array_equal(p["gag0"], np.repeat(np.arange(n, dtype=np.float32),
                                                           2).reshape(n, 2))
        np.testing.assert_array_equal(p["gag1"], np.repeat(10 + np.arange(n, dtype=np.float32),
                                                           3))
        np.testing.assert_array_equal(p["grs0"], np.full(2, (n + 1) / 2, np.float32))
        np.testing.assert_array_equal(p["grs1"], np.arange(2.0 * r, 2.0 * r + 2,
                                                           dtype=np.float32))
