"""The port's SyncBatchNorm (``horovod_tpu_torch.torch.SyncBatchNorm``)
against the JAX binding's, at one rank in this process.

- The sync path's autograd function, called directly in both bindings on
  the same seeded input (the JAX one reduces its statistics through numpy,
  the port's through the eager allreduce on tensors): outputs, dx,
  dweight and dbias at rtol 1e-6 / atol 1e-7 in f32 and bf16 (both do the
  same f32 arithmetic on the same statistics).
- The module forced onto its sync path (``_use_sync``) against
  ``nn.BatchNorm2d`` over the same batch, as chip_smoke.py runs it on the
  card: output, dx, dweight, dbias and the running statistics over three
  steps (momentum 0.1 and momentum None) at rtol 1e-5 / atol 1e-6 (the
  one-pass E[x^2] - E[x]^2 sums in another order).
- At one rank, and in eval mode, the module is ``nn.BatchNorm`` and
  communicates nothing. The two-rank and four-rank cases are in
  tests/test_torch_binding.py.
"""

import numpy as np
import pytest
import torch

import horovod_tpu.torch as jt
from horovod_tpu.torch.sync_batch_norm import _SyncBatchNormFunction as JaxFn

import horovod_tpu_torch.torch as pt
from horovod_tpu_torch import eager
from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFunction as PortFn

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module", autouse=True)
def both():
    jt.shutdown()
    pt.shutdown()
    jt.init()
    pt.init(device="cpu")
    yield
    pt.shutdown()
    jt.shutdown()


def _inputs(dtype, c=5, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(6, c, 4, 3) * 2 + 0.5).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.randn(6, c, 4, 3).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(c).astype(np.float32))
    return x, dy, w, b


def _grads(fn, x, dy, w, b, tag):
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    y, mean, var, count = fn.apply(x, w, b, 1e-5, tag)
    y.backward(dy)
    return [t.detach() for t in (y, x.grad, w.grad, b.grad, mean, var, count)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sync_function_matches_jax(dtype):
    args = _inputs(dtype)
    got = _grads(PortFn, *args, tag="t.port")
    want = _grads(JaxFn.get(), *args, tag="t.jax")
    assert got[0].dtype == got[1].dtype == dtype
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=RTOL, atol=ATOL)


class Forced(pt.SyncBatchNorm):
    def _use_sync(self):
        return self.training


@pytest.mark.parametrize("momentum", [0.1, None])
def test_forced_sync_path_matches_batch_norm(momentum):
    x, dy, w, b = _inputs(torch.float32, seed=1)
    sbn = Forced(5, eps=1e-5, momentum=momentum)
    ref = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=momentum)
    for m in (sbn, ref):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    tol = dict(rtol=1e-5, atol=1e-6)
    for step in range(3):
        outs = []
        for m in (sbn, ref):
            m.zero_grad()
            xi = (x * (step + 1)).clone().requires_grad_(True)
            y = m(xi)
            y.backward(dy)
            outs.append([y.detach(), xi.grad, m.weight.grad, m.bias.grad,
                         m.running_mean.clone(), m.running_var.clone()])
        for g, r in zip(*outs):
            np.testing.assert_allclose(g.numpy(), r.numpy(), **tol)
        assert int(sbn.num_batches_tracked) == int(ref.num_batches_tracked) == step + 1


def test_one_rank_and_eval_mode_do_not_communicate(monkeypatch):
    calls = []
    monkeypatch.setattr(eager, "allreduce", lambda *a, **k: calls.append(k) or None)
    x, _, w, b = _inputs(torch.float32, seed=2)
    sbn = pt.SyncBatchNorm(5)
    ref = torch.nn.BatchNorm2d(5)
    for m in (sbn, ref):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    assert torch.equal(sbn(x), ref(x))                 # size 1: nn.BatchNorm's path
    forced = Forced(5)
    forced.load_state_dict(ref.state_dict())
    forced.eval()
    ref.eval()
    assert torch.equal(forced(x), ref(x))              # eval: the running statistics
    assert calls == []


def test_rejects_1d_input():
    with pytest.raises(ValueError, match="at least 2D"):
        pt.SyncBatchNorm(3)(torch.ones(3))
