"""The port's ring block, ring attention and Ulysses against the JAX package.

The block (``flash_attention_block``) runs its plain version on the CPU,
through the same autograd Function the card uses; the Pallas block runs in
interpret mode, as tests/test_flash_attention.py runs it. Ring and Ulysses
attention run at 4 gloo ranks (one spawned run of ``WORKER`` serves every
multi-rank case) against the JAX functions on a 4-device ``seq`` mesh of
the virtual CPU mesh, as tests/test_ring_attention.py runs them. The same
run checks the collectives they stand on: ``alltoall``, the ring shift and
``group=`` on a ``data 2 x seq 2`` mesh.

Tolerances are those of the mirrored reference tests: f32 forward rtol 2e-4
/ atol 2e-5, gradients 1e-3 / 1e-4, bf16 5e-2.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from horovod_tpu.jax import _shard_map
from horovod_tpu.ops import pallas_attention as ref_fa
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from horovod_tpu_torch.ops import flash_attention as port_fa

from torch_port_harness import run_ranks

N = 4


def _qkv_bhtd(bh=2, t=32, d=16, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, t, d).astype(np.float32) * 0.5 for _ in range(n)]


# --- the ring block ----------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta_of_t", [-1.0, 0.0, 0.5, 1.0])
def test_block_matches_pallas(causal, delta_of_t):
    """The block's (O, m, l) against the Pallas block at delta -T, 0, +T/2
    (through a tile) and +T (no key visible)."""
    q, k, v = _qkv_bhtd(t=32)
    delta = int(delta_of_t * 32)
    scale = 16 ** -0.5
    want = ref_fa.flash_attention_block(*map(jnp.asarray, (q, k, v)), float(delta),
                                        sm_scale=scale, causal=causal, block_q=8, block_k=8)
    got = port_fa.flash_attention_block(*map(torch.from_numpy, (q, k, v)), delta,
                                        sm_scale=scale, causal=causal)
    for name, a, b in zip(("O", "m", "l"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    if causal and delta >= 32:
        assert (got[1] == -1e30).all() and (got[2] == 0).all() and (got[0] == 0).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta", [-16, 0, 8])
def test_block_grads_match_jax(causal, delta):
    """Mirrors test_block_grad_flows, through all three cotangents: the
    dense-recompute backward against ``jax.grad`` of the Pallas block."""
    q, k, v, wo = _qkv_bhtd(t=16, d=8, seed=1, n=4)
    rng = np.random.RandomState(2)
    wm, wl = rng.randn(2, 16).astype(np.float32), rng.randn(2, 16).astype(np.float32)
    scale = 8 ** -0.5

    def loss(q, k, v):
        o, m, l = ref_fa.flash_attention_block(q, k, v, float(delta), sm_scale=scale,
                                               causal=causal, block_q=8, block_k=8)
        return jnp.sum(o * wo) + jnp.sum(m * wm) + jnp.sum(l * wl)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, m, l = port_fa.flash_attention_block(tq, tk, tv, delta, sm_scale=scale, causal=causal)
    ((o * torch.from_numpy(wo)).sum() + (m * torch.from_numpy(wm)).sum()
     + (l * torch.from_numpy(wl)).sum()).backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_block_merge_equals_full():
    """Mirrors test_block_merge_equals_full: two blocks merged with the
    online-softmax rule give full causal attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv_bhtd(bh=2, t=16, d=8))
    scale = 8 ** -0.5
    o1, m1, l1 = port_fa.flash_attention_block(q, k[:, :8], v[:, :8], 0, sm_scale=scale)
    o2, m2, l2 = port_fa.flash_attention_block(q, k[:, 8:], v[:, 8:], 8, sm_scale=scale)
    m = torch.maximum(m1, m2)
    c1, c2 = torch.exp(m1 - m), torch.exp(m2 - m)
    l = l1 * c1 + l2 * c2
    merged = (o1 * c1[..., None] + o2 * c2[..., None]) / torch.where(l == 0, 1.0, l)[..., None]
    expected = ref_fa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                      causal=True)
    np.testing.assert_allclose(merged.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)


def test_block_refuses_lengths_the_reference_refuses():
    q = torch.zeros(1, 131, 8)
    with pytest.raises(ValueError, match="no block divisor"):
        port_fa.flash_attention_block(q, q, q, 0, sm_scale=1.0)


# --- ring and Ulysses at 4 gloo ranks ----------------------------------------

WORKER = r'''
import json, os
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel.mesh import axis_size, build_mesh, data_axis_size
from horovod_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
mesh = build_mesh({"seq": n})
g = mesh.get_group("seq")
out = {}

def shard(name, dtype=torch.float32, grad=False):
    x = data[name]
    t = x.shape[1] // n
    s = torch.from_numpy(x[:, r * t:(r + 1) * t].copy()).to(dtype)
    return s.requires_grad_() if grad else s

for causal in (False, True):
    q, k, v = (shard(x) for x in "qkv")
    out[f"ring_c{int(causal)}"] = ring_attention(q, k, v, group=g, causal=causal)
    out[f"ring_dense_c{int(causal)}"] = ring_attention(q, k, v, group=g, causal=causal,
                                                       use_flash=False)
    out[f"uly_c{int(causal)}"] = ulysses_attention(q, k, v, group=g, causal=causal)
    out[f"uly_dense_c{int(causal)}"] = ulysses_attention(q, k, v, group=g, causal=causal,
                                                         use_flash=False)
q, k, v = (shard(x, torch.bfloat16) for x in "qkv")
bf = ring_attention(q, k, v, group=g, causal=True)
assert bf.dtype == torch.bfloat16
out["ring_bf16"] = bf.float()
for name, fn in (("ring", ring_attention), ("uly", ulysses_attention)):
    for flash in (True, False):
        q, k, v = (shard("g" + x, grad=True) for x in "qkv")
        (fn(q, k, v, group=g, causal=True, use_flash=flash) ** 2).sum().backward()
        for x, t in zip("qkv", (q, k, v)):
            out[f"grad_{name}_f{int(flash)}_{x}"] = t.grad
q, k, v = (shard(x)[:, :, :6] for x in "qkv")
try:
    ulysses_attention(q, k, v, group=g)
    refused = ""
except ValueError as e:
    refused = str(e)

# The collectives under the ring, on the seq group of n ranks.
x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3) + 100 * r
out["alltoall"] = C.alltoall(x.requires_grad_(), group=g, split_axis=1, concat_axis=2)
(out["alltoall"] * (r + 1)).sum().backward()
out["alltoall_grad"] = x.grad
y = torch.full((2,), float(r), requires_grad=True)
z = C.ring_shift(y, group=g)
(z * (r + 1)).sum().backward()
out["shift"], out["shift_grad"] = z, y.grad

# group= on a data 2 x seq 2 mesh: rank r sits at unravel_index(r, (2, 2)).
m2 = build_mesh({"data": 2, "seq": -1})
coords = [m2.get_local_rank("data"), m2.get_local_rank("seq")]
sizes = [axis_size(m2, "data"), axis_size(m2, "seq"), data_axis_size(m2)]
avg = C.allreduce(torch.tensor([float(r)]), op=hvd.Average, group=m2.get_group("seq"))
gat = C.allgather(torch.tensor([float(r)]), group=m2.get_group("data"))
bc = C.broadcast(torch.tensor([float(r)]), root_rank=1, group=m2.get_group("seq"))
np.savez(f"{d}/rank{r}.npz", **{k: t.detach().numpy() for k, t in out.items()},
         seq_avg=avg.numpy(), data_gather=gat.numpy(), seq_bcast=bc.numpy())
json.dump({"refused": refused, "coords": coords, "sizes": sizes},
          open(f"{d}/rank{r}.json", "w"))
hvd.shutdown()
'''


def _qkv(B=2, T=32, H=8, D=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) * 0.5 for _ in range(3)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ring")
    q, k, v = _qkv()
    gq, gk, gv = _qkv(B=1, T=16, H=4, D=8)
    np.savez(d / "inputs.npz", q=q, k=k, v=v, gq=gq, gk=gk, gv=gv)
    run_ranks(WORKER, N, d)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]
    meta = [json.loads((d / f"rank{r}.json").read_text()) for r in range(N)]
    return ranks, meta


def _gathered(ranks, key):
    """The ranks' sequence shards, [B, T/n, ...] each, put back in order."""
    return np.concatenate([r[key] for r in ranks], axis=1)


def _seq_mesh():
    return build_mesh({"seq": N}, devices=jax.devices()[:N])


def _jax_sharded(fn, *xs, **kw):
    f = _shard_map(lambda a, b, c: fn(a, b, c, axis_name="seq", **kw), _seq_mesh(),
                   in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"))
    return np.asarray(jax.jit(f)(*xs), np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scheme", ["ring", "ring_dense", "uly", "uly_dense"])
def test_forward_matches_jax(port, scheme, causal):
    """Mirrors test_ring_attention_matches_reference and
    test_ulysses_attention_matches_reference (flash and dense blocks)."""
    ranks, _ = port
    q, k, v = map(jnp.asarray, _qkv())
    fn = ring_attention if scheme.startswith("ring") else ulysses_attention
    want = _jax_sharded(fn, q, k, v, causal=causal, use_flash="dense" not in scheme)
    got = _gathered(ranks, f"{scheme}_c{int(causal)}")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(reference_attention(q, k, v, causal=causal)),
                               rtol=2e-4, atol=2e-5)


def test_ring_bf16_matches_jax(port):
    """Mirrors test_ring_attention_bf16."""
    ranks, _ = port
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv())
    want = _jax_sharded(ring_attention, q, k, v, causal=True)
    np.testing.assert_allclose(_gathered(ranks, "ring_bf16"), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("scheme", ["ring", "uly"])
def test_grads_match_jax(port, scheme, flash):
    """Mirrors test_ring_attention_grad_flows: the gradient of a sum of
    squares flows back around the ring (or through both all-to-alls)."""
    ranks, _ = port
    xs = list(map(jnp.asarray, _qkv(B=1, T=16, H=4, D=8)))
    fn = ring_attention if scheme == "ring" else ulysses_attention
    f = _shard_map(lambda a, b, c: fn(a, b, c, axis_name="seq", causal=True, use_flash=flash),
                   _seq_mesh(), in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"))
    want = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2)))(*xs)
    for x, w in zip("qkv", want):
        got = _gathered(ranks, f"grad_{scheme}_f{int(flash)}_{x}")
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-3, atol=1e-4, err_msg=x)


def test_ulysses_rejects_bad_heads(port):
    """Mirrors test_ulysses_rejects_bad_heads: 6 heads on a 4-rank axis."""
    _, meta = port
    assert all("divisible" in m["refused"] for m in meta)
    q, k, v = (jnp.asarray(x[:, :, :6]) for x in _qkv())
    with pytest.raises(ValueError, match="divisible"):
        _jax_sharded(ulysses_attention, q, k, v)


def test_alltoall_and_ring_shift_match_jax(port):
    """The port's tiled ``alltoall`` and ring shift against ``lax.all_to_all``
    and ``lax.ppermute`` over the same axis, forward and transpose."""
    ranks, _ = port
    x = np.stack([np.arange(24, dtype=np.float32).reshape(2, 4, 3) + 100 * r
                  for r in range(N)])
    w = np.arange(1, N + 1, dtype=np.float32)
    mesh = _seq_mesh()

    f = _shard_map(lambda xs: jax.lax.all_to_all(xs[0], "seq", split_axis=1, concat_axis=2,
                                                 tiled=True)[None],
                   mesh, in_specs=P("seq"), out_specs=P("seq"))
    want = np.asarray(jax.jit(f)(x))
    grad = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * w[:, None, None, None]))(x))
    perm = [(i, (i + 1) % N) for i in range(N)]
    g = _shard_map(lambda ys: jax.lax.ppermute(ys, "seq", perm), mesh,
                   in_specs=P("seq"), out_specs=P("seq"))
    ys = np.repeat(np.arange(N, dtype=np.float32), 2)
    shift = np.asarray(g(ys))
    shift_grad = np.asarray(jax.grad(lambda a: jnp.sum(g(a) * np.repeat(w, 2)))(ys))
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["alltoall"], want[r])
        np.testing.assert_array_equal(ranks[r]["alltoall_grad"], grad[r])
        np.testing.assert_array_equal(ranks[r]["shift"], shift[2 * r:2 * r + 2])
        np.testing.assert_array_equal(ranks[r]["shift_grad"], shift_grad[2 * r:2 * r + 2])


def test_mesh_layout_and_group_collectives(port):
    """``build_mesh`` lays ranks out row-major, last axis fastest, as the
    JAX ``build_mesh`` lays out ``jax.devices()``; Average divides by the
    group's size; allgather and broadcast stay inside their group."""
    ranks, meta = port
    jmesh = build_mesh({"data": 2, "seq": 2}, devices=jax.devices()[:N])
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices)
    for r in range(N):
        assert tuple(meta[r]["coords"]) == tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert meta[r]["sizes"] == [2, 2, 2]
        data_i, seq_i = np.unravel_index(r, (2, 2))
        peers = [data_i * 2 + s for s in range(2)]
        np.testing.assert_array_equal(ranks[r]["seq_avg"], [np.mean(peers)])
        np.testing.assert_array_equal(ranks[r]["seq_bcast"], [peers[1]])
        np.testing.assert_array_equal(ranks[r]["data_gather"],
                                      [0 * 2 + seq_i, 1 * 2 + seq_i])
