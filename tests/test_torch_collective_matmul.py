"""The port's collective-matmul primitives against the JAX package's.

- The ring-shape helpers case for case, as test_collective_matmul.py:45-76
  checks them (``ring_hops``, ``resolve_chunks`` with its knob,
  ``expected_ppermutes``, ``fusable``).
- ``all_gather_matmul`` and ``matmul_reduce_scatter`` at 2 and 4 gloo ranks,
  chunks 1 and 2, forward and both gradients, against
  ``horovod_tpu.ops.collective_matmul``'s primitives under ``_shard_map`` on
  the CPU mesh, at the reference tests' tolerances (2e-6 forward for
  all_gather_matmul, 1e-5 for matmul_reduce_scatter and the gradients):
  test_all_gather_matmul_parity, test_matmul_reduce_scatter_parity,
  test_all_gather_matmul_gradients, test_matmul_reduce_scatter_gradients.
  Also a leading batch dim ([B, T, D], token dim -2), where each source's
  chunk sits at its rows of every batch element.
- The row order bitwise through an identity weight
  (test_all_gather_matmul_row_order_bitwise) and the psum identity to 1e-4
  (test_psum_identity).
- ``collectives.reducescatter`` (SUM and AVERAGE, along a middle dim) and
  the tiled ``allgather``'s backward, which the fused bias gather relies on.
- The wrappers take the plain version only for CPU tensors
  (tests/test_torch_port_imports.py holds the other side).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import horovod_tpu.jax as hvdj
from horovod_tpu.ops import collective_matmul as ref
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu_torch.ops import collective_matmul as port

from torch_port_harness import run_ranks

CHUNKS = (1, 2)
BATCH = 2   # the leading batch dim of the batched cases


def _mesh(n):
    return build_mesh({"model": n}, devices=jax.devices()[:n])


# --- ring shape helpers -------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 16))
def test_ring_hops_match_jax(n):
    assert port.ring_hops(n) == ref.ring_hops(n)
    f, b = port.ring_hops(n)
    if n > 1:
        assert f + b == n - 1 and 0 <= f - b <= 1


@pytest.mark.parametrize("tokens,chunks,knob", [
    (8, 0, None), (8, 3, None), (8, 8, None), (4, 99, None),
    (8, 0, "4"), (8, 0, "5"), (8, 0, "junk"), (7, 0, "3"), (1, 5, None),
])
def test_resolve_chunks_matches_jax(monkeypatch, tokens, chunks, knob):
    if knob is None:
        monkeypatch.delenv("HOROVOD_TP_OVERLAP_CHUNKS", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TP_OVERLAP_CHUNKS", knob)
    assert port.resolve_chunks(tokens, chunks) == ref.resolve_chunks(tokens, chunks)


def test_resolve_chunks_reference_cases(monkeypatch):
    monkeypatch.delenv("HOROVOD_TP_OVERLAP_CHUNKS", raising=False)
    assert port.resolve_chunks(8) == 1
    assert port.resolve_chunks(8, 3) == 2
    assert port.resolve_chunks(8, 8) == 8
    assert port.resolve_chunks(4, 99) == 4
    monkeypatch.setenv("HOROVOD_TP_OVERLAP_CHUNKS", "4")
    assert port.resolve_chunks(8) == 4
    monkeypatch.setenv("HOROVOD_TP_OVERLAP_CHUNKS", "5")
    assert port.resolve_chunks(8) == 4
    monkeypatch.setenv("HOROVOD_TP_OVERLAP_CHUNKS", "junk")
    assert port.resolve_chunks(8) == 1


@pytest.mark.parametrize("n,chunks", [(1, 1), (2, 1), (4, 2), (8, 4), (3, 3)])
def test_expected_ppermutes_match_jax(n, chunks):
    assert port.expected_ppermutes(n, chunks) == ref.expected_ppermutes(n, chunks)


@pytest.mark.parametrize("tokens,n", [(16, 4), (16, 2), (15, 4), (16, 1), (12, 3)])
def test_fusable_matches_jax(tokens, n):
    assert port.fusable(tokens, n) == ref.fusable(tokens, n)


# --- the primitives at 2 and 4 gloo ranks -------------------------------------


def _cases(n):
    """Inputs, made with numpy from seeds, in the reference tests' shapes."""
    rng = np.random.RandomState(n)
    f32 = np.float32
    c = {}
    c["ag_x"] = rng.randn(4 * n, 16).astype(f32)           # test_all_gather_matmul_parity
    c["ag_w"] = rng.randn(16, 24).astype(f32)
    c["rs_y"] = rng.randn(4 * n, 8 * n).astype(f32)        # test_matmul_reduce_scatter_parity
    c["rs_w"] = rng.randn(8 * n, 16).astype(f32)
    g = np.random.RandomState(3)                           # test_all_gather_matmul_gradients
    c["agg_x"] = g.randn(4 * n, 8).astype(f32)
    c["agg_w"] = g.randn(8, 12).astype(f32)
    c["agg_ct"] = g.randn(4 * n, 12).astype(f32)
    g = np.random.RandomState(5)                           # test_matmul_reduce_scatter_gradients
    c["rsg_y"] = g.randn(4 * n, 8 * n).astype(f32)
    c["rsg_w"] = g.randn(8 * n, 8).astype(f32)
    c["rsg_ct"] = g.randn(4 * n, 8).astype(f32)
    g = np.random.RandomState(10 + n)                      # leading batch dim
    c["bag_x"] = g.randn(BATCH, 4 * n, 16).astype(f32)
    c["bag_w"] = g.randn(16, 24).astype(f32)
    c["brs_y"] = g.randn(BATCH, 4 * n, 8 * n).astype(f32)
    c["brs_w"] = g.randn(8 * n, 16).astype(f32)
    c["eye_x"] = np.abs(np.random.RandomState(0).randn(4 * n, 8)).astype(f32)
    g = np.random.RandomState(7)                           # test_psum_identity
    c["ps_y"] = g.randn(4 * n, 8 * n).astype(f32)
    c["ps_w"] = g.randn(8 * n, 8).astype(f32)
    c["coll_x"] = np.random.RandomState(20 + n).randn(n, 3, 2 * n, 5).astype(f32)
    return c


WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collective_matmul as cm
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops.collectives import allgather, allreduce, reducescatter

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
c = {k: torch.from_numpy(v) for k, v in np.load(f"{d}/inputs.npz").items()}
out = {}

def rows(t, dim=-2):
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k).contiguous()

def grads(fn, *args):
    args = [a.clone().requires_grad_() for a in args]
    fn(*args).backward()
    return [a.grad for a in args]

for ch in cfg["chunks"]:
    out[f"ag_{ch}"] = cm.all_gather_matmul(rows(c["ag_x"]), c["ag_w"], chunks=ch)
    out[f"rs_{ch}"] = cm.matmul_reduce_scatter(rows(c["rs_y"], -1), rows(c["rs_w"], 0), chunks=ch)
    out[f"agg_dx_{ch}"], out[f"agg_dw_{ch}"] = grads(
        lambda x, w: (cm.all_gather_matmul(x, w, chunks=ch) * c["agg_ct"]).sum(),
        rows(c["agg_x"]), c["agg_w"])
    out[f"rsg_dy_{ch}"], out[f"rsg_dw_{ch}"] = grads(
        lambda y, w: (cm.matmul_reduce_scatter(y, w, chunks=ch) * rows(c["rsg_ct"])).sum(),
        rows(c["rsg_y"], -1), rows(c["rsg_w"], 0))
    out[f"bag_{ch}"] = cm.all_gather_matmul(rows(c["bag_x"]), c["bag_w"], chunks=ch)
    out[f"brs_{ch}"] = cm.matmul_reduce_scatter(rows(c["brs_y"], -1), rows(c["brs_w"], 0), chunks=ch)

eye = torch.eye(8)
x_loc = rows(c["eye_x"])
out["eye_fused"] = cm.all_gather_matmul(x_loc, eye, chunks=2)
out["eye_gather"] = allgather(x_loc, dim=0)
z = cm.matmul_reduce_scatter(rows(c["ps_y"], -1), rows(c["ps_w"], 0))
psum = allreduce(rows(c["ps_y"], -1) @ rows(c["ps_w"], 0))
out["psum_err"] = (allgather(z, dim=0) - psum).abs().max()
# reducescatter along a middle dim, SUM and AVERAGE; allgather's backward.
mine = c["coll_x"][r]
out["reducescatter_sum"] = reducescatter(mine, dim=1)
out["reducescatter_avg"] = reducescatter(mine, op=ReduceOp.AVERAGE, dim=1)
g = mine[:, : mine.shape[1] // n].clone().requires_grad_()
(allgather(g, dim=1) * mine).sum().backward()
out["allgather_grad"] = g.grad
np.savez(f"{d}/rank{r}.npz", **{k: v.detach().numpy() for k, v in out.items()})
hvd.shutdown()
'''


def _jax_refs(n, c):
    """The reference primitives on a {"model": n} CPU mesh, shaped as the
    reference tests shape them (each shard_map jitted: one compile instead
    of an op-by-op ring)."""
    mesh = _mesh(n)

    def _shard_map(*args, **kwargs):
        return jax.jit(hvdj._shard_map(*args, **kwargs))

    R = {}
    for ch in CHUNKS:
        ag = _shard_map(
            lambda x, w: ref.all_gather_matmul(x, w, axis_name="model", chunks=ch),
            mesh, in_specs=(P("model", None), P(None, None)), out_specs=P(None, None))
        R[f"ag_{ch}"] = np.asarray(ag(c["ag_x"], c["ag_w"]))
        rs = _shard_map(
            lambda y, w: ref.matmul_reduce_scatter(y, w, axis_name="model", chunks=ch),
            mesh, in_specs=(P(None, "model"), P("model", None)), out_specs=P("model", None))
        R[f"rs_{ch}"] = np.asarray(rs(c["rs_y"], c["rs_w"]))
        bag = _shard_map(
            lambda x, w: ref.all_gather_matmul(x, w, axis_name="model", chunks=ch),
            mesh, in_specs=(P(None, "model", None), P(None, None)), out_specs=P(None, None, None))
        R[f"bag_{ch}"] = np.asarray(bag(c["bag_x"], c["bag_w"]))
        brs = _shard_map(
            lambda y, w: ref.matmul_reduce_scatter(y, w, axis_name="model", chunks=ch),
            mesh, in_specs=(P(None, None, "model"), P("model", None)),
            out_specs=P(None, "model", None))
        R[f"brs_{ch}"] = np.asarray(brs(c["brs_y"], c["brs_w"]))

        def agg_body(x_loc, w_rep, cot_rep):
            def fused(args):
                out = ref.all_gather_matmul(args[0], args[1], axis_name="model", chunks=ch)
                return jnp.sum(out * cot_rep)
            return jax.grad(fused)((x_loc, w_rep))

        agg = _shard_map(agg_body, mesh,
                         in_specs=(P("model", None), P(None, None), P(None, None)),
                         out_specs=(P("model", None), P("model", None)))
        dx, dw = agg(c["agg_x"], c["agg_w"], c["agg_ct"])
        R[f"agg_dx_{ch}"], R[f"agg_dw_{ch}"] = np.asarray(dx), np.asarray(dw)

        def rsg_body(y_loc, w_loc, cot_loc):
            def fused(args):
                out = ref.matmul_reduce_scatter(args[0], args[1], axis_name="model", chunks=ch)
                return jnp.sum(out * cot_loc)
            return jax.grad(fused)((y_loc, w_loc))

        rsg = _shard_map(rsg_body, mesh,
                         in_specs=(P(None, "model"), P("model", None), P("model", None)),
                         out_specs=(P(None, "model"), P("model", None)))
        dy, dw = rsg(c["rsg_y"], c["rsg_w"], c["rsg_ct"])
        R[f"rsg_dy_{ch}"], R[f"rsg_dw_{ch}"] = np.asarray(dy), np.asarray(dw)
    eye = _shard_map(
        lambda x: (ref.all_gather_matmul(x, jnp.eye(8, dtype=jnp.float32), axis_name="model",
                                         chunks=2),
                   lax.all_gather(x, "model", axis=0, tiled=True)),
        mesh, in_specs=(P("model", None),), out_specs=(P(None, None), P(None, None)))
    R["eye_fused"], R["eye_gather"] = (np.asarray(a) for a in eye(c["eye_x"]))
    return R


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request, tmp_path_factory):
    n = request.param
    c = _cases(n)
    d = tmp_path_factory.mktemp(f"torch_cm{n}")
    np.savez(d / "inputs.npz", **c)
    (d / "cfg.json").write_text(json.dumps({"chunks": list(CHUNKS)}))
    run_ranks(WORKER, n, d)
    ported = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
    return n, c, ported, _jax_refs(n, c)


def _whole(ported, key, axis):
    return np.concatenate([p[key] for p in ported], axis=axis)


@pytest.mark.parametrize("ch", CHUNKS)
def test_all_gather_matmul_matches_jax(run, ch):
    n, _, ported, R = run
    for r in range(n):
        np.testing.assert_allclose(ported[r][f"ag_{ch}"], R[f"ag_{ch}"], rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(ported[r][f"bag_{ch}"], R[f"bag_{ch}"], rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("ch", CHUNKS)
def test_matmul_reduce_scatter_matches_jax(run, ch):
    _, _, ported, R = run
    np.testing.assert_allclose(_whole(ported, f"rs_{ch}", 0), R[f"rs_{ch}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_whole(ported, f"brs_{ch}", 1), R[f"brs_{ch}"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ch", CHUNKS)
def test_all_gather_matmul_gradients_match_jax(run, ch):
    """dx through the dual primitive (matmul_reduce_scatter of the
    cotangent), dw through the weight-gradient ring."""
    n, _, ported, R = run
    np.testing.assert_allclose(_whole(ported, f"agg_dx_{ch}", 0), R[f"agg_dx_{ch}"],
                               rtol=1e-5, atol=1e-5)
    # dw comes out of shard_map stacked per rank ([n * D, F], P("model")).
    for r in range(n):
        want = np.split(R[f"agg_dw_{ch}"], n, axis=0)[r]
        np.testing.assert_allclose(ported[r][f"agg_dw_{ch}"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ch", CHUNKS)
def test_matmul_reduce_scatter_gradients_match_jax(run, ch):
    """dy through the dual primitive (all_gather_matmul of the cotangent),
    dw through the weight-gradient ring."""
    _, _, ported, R = run
    np.testing.assert_allclose(_whole(ported, f"rsg_dy_{ch}", 1), R[f"rsg_dy_{ch}"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_whole(ported, f"rsg_dw_{ch}", 0), R[f"rsg_dw_{ch}"],
                               rtol=1e-5, atol=1e-5)


def test_row_order_bitwise_through_identity(run):
    """Through an identity weight the primitive is a tiled all-gather, bit
    for bit (x @ I adds only exact zeros), in ``lax.all_gather(tiled)``
    order."""
    n, c, ported, R = run
    for r in range(n):
        np.testing.assert_array_equal(ported[r]["eye_fused"], ported[r]["eye_gather"])
        np.testing.assert_array_equal(ported[r]["eye_fused"], c["eye_x"])
        np.testing.assert_array_equal(ported[r]["eye_fused"], R["eye_fused"])


def test_psum_identity(run):
    """``allreduce(y @ w) == all_gather(matmul_reduce_scatter(y, w))``."""
    n, _, ported, _ = run
    for r in range(n):
        assert float(ported[r]["psum_err"]) <= 1e-4


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_reducescatter_matches_psum_scatter(run, op):
    """``reducescatter`` is ``lax.psum_scatter(tiled=True)`` along a middle
    dim: the sum (or mean) over ranks, rank r keeping chunk r."""
    n, c, ported, _ = run
    total = c["coll_x"].sum(axis=0) / (n if op == "avg" else 1)
    for r in range(n):
        want = np.split(total, n, axis=1)[r]
        np.testing.assert_allclose(ported[r][f"reducescatter_{op}"], want, rtol=1e-6, atol=1e-6)


def test_allgather_backward_is_reducescatter(run):
    """The cotangent of ``allgather(dim=1)`` is the tiled reduce-scatter of
    the downstream cotangents (here each rank's own ``x``), as the transpose
    of ``lax.all_gather(tiled=True)``."""
    n, c, ported, _ = run
    total = c["coll_x"].sum(axis=0)
    for r in range(n):
        np.testing.assert_allclose(ported[r]["allgather_grad"], np.split(total, n, axis=1)[r],
                                   rtol=1e-6, atol=1e-6)


def test_wrappers_take_the_plain_versions_on_cpu(monkeypatch):
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    import torch

    def refuse(*_):
        raise AssertionError("a kernel launcher was reached for a CPU tensor")

    monkeypatch.setattr(port, "_launch_chunk_product", refuse)
    monkeypatch.setattr(port, "_launch_partial_product", refuse)
    monkeypatch.setattr(port, "_launch_epilogue", refuse)
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(2, 5, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(6, 3).astype(np.float32))
    out = torch.zeros(2, 9, 3)
    port._chunk_product(a, w, out[:, 4:9])
    np.testing.assert_allclose(out[:, 4:9].numpy(), (a @ w).numpy(), rtol=1e-6)
    acc = port._partial_product(a, w, port._partial_product(a, w))
    np.testing.assert_allclose(acc.numpy(), 2 * (a @ w).numpy(), rtol=1e-6, atol=1e-6)
    assert port._epilogue(acc, acc, None, torch.bfloat16).dtype == torch.bfloat16


# --- the TMA kernel's operands and tile ---------------------------------------------

# GPT-2-small at tp 4 (d 768, 12 heads, batch 8 x 1024, Tc 256): the (K, N)
# of every chunk product on the fused step's path. B3 forward (q/k/v, MLP
# up), B4 forward (attention out, MLP down), and each as the other's
# backward dual.
GPT2_TP4_B3 = ((768, 576), (768, 768), (768, 192))
GPT2_TP4_B4 = ((192, 768), (768, 768), (576, 768))


def _bf16(*shape):
    import torch

    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("sub_chunks", [1, 2])
def test_tma_ok_accepts_every_gpt2_small_tp4_operand(sub_chunks):
    """Every operand the rings hand the kernels at GPT-2-small tp 4: B3's own
    chunk (a view of x3) and arrivals written into their rows of the
    gathered output, B4's partials of y3[:, row:row + sc] with and without
    an arriving f32 accumulator."""
    import torch

    b, n_ranks, tc = 8, 4, 256
    sc = tc // sub_chunks
    for k, n in GPT2_TP4_B3:
        x3 = _bf16(b, tc, k)
        w = _bf16(k, n)
        out = _bf16(b, n_ranks * tc, n)
        for r in range(n_ranks):
            assert port._tma_ok(x3, w, out[:, r * tc:(r + 1) * tc])
            for s in range(sub_chunks):
                arrived = x3[:, s * sc:(s + 1) * sc].contiguous()
                row = r * tc + s * sc
                assert port._tma_ok(arrived, w, out[:, row:row + sc])
    for k, n in GPT2_TP4_B4:
        y3 = _bf16(b, n_ranks * tc, k)
        w = _bf16(k, n)
        acc = torch.zeros(b, sc, n)
        for dest in range(n_ranks):
            for s in range(sub_chunks):
                row = dest * tc + s * sc
                assert port._tma_ok(y3[:, row:row + sc], w, acc, None)
                assert port._tma_ok(y3[:, row:row + sc], w, acc, acc)


def test_tma_ok_refuses_what_tma_cannot_take():
    """N or K off a multiple of 8 (chip_smoke.py's small case N 70), a
    base address off 16 bytes, a batch stride off 8 elements, f32, and an
    arriving accumulator off 16 bytes: each goes to the earlier kernels."""
    import torch

    assert not port._tma_ok(_bf16(3, 50, 40), _bf16(40, 70), _bf16(3, 200, 70)[:, 100:150])
    assert not port._tma_ok(_bf16(2, 64, 36), _bf16(36, 96), _bf16(2, 64, 96))
    assert not port._tma_ok(_bf16(2, 64, 128), _bf16(128, 70), _bf16(2, 64, 70))
    flat = _bf16(4096)
    assert not port._tma_ok(flat[4:4 + 2 * 16 * 64].view(2, 16, 64), _bf16(64, 64),
                            _bf16(2, 16, 64))
    odd_batch = _bf16(2 * 16 * 64 + 4).as_strided((2, 16, 64), (16 * 64 + 4, 64, 1))
    assert not port._tma_ok(odd_batch, _bf16(64, 64), _bf16(2, 16, 64))
    f32 = torch.zeros(2, 16, 64)
    assert not port._tma_ok(f32, torch.zeros(64, 64), torch.zeros(2, 16, 64))
    acc = torch.zeros(2 * 16 * 64 + 1)[1:].view(2, 16, 64)
    assert not port._tma_ok(_bf16(2, 16, 64), _bf16(64, 64), torch.zeros(2, 16, 64), acc)
    # The same operands, aligned, are taken.
    assert port._tma_ok(_bf16(2, 16, 64), _bf16(64, 64), torch.zeros(2, 16, 64),
                        torch.zeros(2, 16, 64))


@pytest.mark.parametrize("k,n", GPT2_TP4_B3 + GPT2_TP4_B4 + ((128, 96), (72, 200)))
def test_tile_is_a_function_of_k_n_and_dtype_alone(k, n):
    """The tile a launch runs depends on (K, N, dtype) only: the same for a
    chunk of 256 rows and the gathered 1024, for batch 1 and 8, at any row
    offset; so the ring's chunk products are bitwise the product over the
    gathered input. f32, and the earlier kernels asked for by name, take no
    TMA tile."""
    import torch

    tiles = set()
    for batch in (1, 8):
        for rows in (128, 256, 1024):
            a, w = _bf16(batch, rows, k), _bf16(k, n)
            out = _bf16(batch, 2048, n)
            for off in (0, 256, 1024):
                tiles.add(port._tile(a, w, out[:, off:off + rows], (), False))
            assert port._tile(a, w, out[:, :rows], (), True) == port.SIMT_TILE
    assert tiles == {port.tile_for(k, n, torch.bfloat16)}
    assert port.tile_for(k, n, torch.bfloat16) != port.SIMT_TILE
    assert port.tile_for(k, n, torch.float32) == port.SIMT_TILE


def test_chosen_tiles_are_built():
    """Every tile ``tile_for`` can return is one the library builds
    (HVT_CM_CONFIGS in csrc/collective_matmul.cu), and is a shape the
    kernel takes: 64 or 128 rows, whole 64-column boxes up to 256."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(port.__file__), "..", "csrc",
                            "collective_matmul.cu")).read()
    line = re.search(r"#define HVT_CM_CONFIGS (.*)", src).group(1)
    built = {tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", line)}
    for bm, bn, stages in {*port.TILES.values(), port.DEFAULT_TILE}:
        assert (bm, bn, stages) in built
        assert bm in (64, 128) and bn % 64 == 0 and bn <= 256 and stages >= 2
    assert set(port.TILES) >= set(GPT2_TP4_B3 + GPT2_TP4_B4)


def test_tile_sweep_refuses_without_a_card(tmp_path):
    """tools/cm_tile_sweep.py measures on a card or not at all."""
    import torch
    from horovod_tpu_torch.tools import cm_tile_sweep

    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep would run")
    assert cm_tile_sweep.main(["--out", str(tmp_path / "sweep.jsonl")]) == 2
    assert not (tmp_path / "sweep.jsonl").exists()


def test_tile_sweep_candidates_cover_the_committed_tiles():
    """Every committed tile is one of the sweep's candidates, and the sweep
    times every (K, N) the committed table names."""
    from horovod_tpu_torch.tools import cm_tile_sweep

    assert set(port.TILES.values()) <= set(cm_tile_sweep.CANDIDATES)
    assert set(port.TILES) == set(cm_tile_sweep.SHAPES)


def test_tma_kernel_is_named_for_the_spill_check():
    """chip_smoke.py's spill gate and its device timer name the TMA kernel
    as the source defines it."""
    import os
    import chip_smoke

    src = open(os.path.join(os.path.dirname(port.__file__), "..", "csrc",
                            "collective_matmul.cu")).read()
    assert f"\n{chip_smoke.CM_TMA_KERNEL}(" in src
    assert chip_smoke.CM_TMA_KERNEL.startswith("gemm_")


def test_tp_bench_profile_counts_every_b3_b4_kernel():
    """tools/tp_parity.py --bench sums a profiled step's device time by
    family: each B3/B4 kernel (the TMA one too, whose name holds "gemm")
    counts as B3/B4, not as a cuBLAS GEMM."""
    from horovod_tpu_torch.tools import tp_parity

    for name in ("void (anonymous namespace)::gemm_tma_wgmma_kernel<64, 192, 4, false>(...)",
                 "void (anonymous namespace)::gemm_wmma_kernel<true>(...)",
                 "void (anonymous namespace)::mrs_epilogue_kernel<__nv_bfloat16>(...)"):
        assert tp_parity._family(name) == "b3b4", name
    assert tp_parity._family("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64") == "gemm"
    assert tp_parity._family("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)") == "nccl"
