"""The port's two-level collectives and hierarchical DP step against the
JAX package.

- The mesh builders: ``build_hierarchical_mesh`` lays ranks out
  ``cross * local_size + local``, ``build_three_level_mesh`` ``pod`` first,
  ``hierarchy_axes`` as JAX's, and ``flatten_group``'s rank is the
  outer-major index over the axis tuple.
- Every ``hierarchical_*`` collective and every ``lower_*`` form (flat,
  two-level, two-level-sa, the bf16 and int8 wires) at ``(cross 2, local
  4)`` over 8 gloo ranks and at ``(cross 2, local 2)`` (the two data slices
  of a ``(data 2, cross 2, local 2)`` mesh), each rank's result against
  JAX's on the same mesh of CPU devices (tests/test_collectives.py:119):
  the data movements bitwise, the reductions at rtol 1e-5.
- ``quantized_hierarchical_allreduce`` within one quantization step a
  cross hop of JAX's (the ring's bound of tests/test_torch_quantized.py on
  the node sums: XLA on the CPU contracts a hop's ``q*s + c`` into an FMA)
  and within 3% of the exact sum.
- Hierarchical Adasum against ``hierarchical_adasum_reference`` (float64)
  and JAX's at rtol 1e-5.
- The DP step at ``(cross 2, local 2)`` over 4 gloo ranks,
  ``make_train_step(mesh=build_hierarchical_mesh(2), hierarchical=True)``
  alone and with ``overlap``, ``quantized``, ``zero1`` and ``op=Adasum``,
  against JAX's ``make_train_step`` on the same mesh shape: losses at rtol
  1e-5 and the parameters by the plain step's tolerance
  (tests/test_torch_train.py; test_optimizer.py:146 and test_overlap.py:297
  hold hierarchical to flat at 1e-5), the int8 wire's parameters at its
  share of the elements (tests/test_torch_quantized.py), every rank's
  parameters the same; and the two-level step against the port's flat one
  within f32 rounding.
- The JAX builders' ``ValueError``s: error feedback with hierarchical,
  quantized zero1 with hierarchical, the optimizer form's zero1 with
  hierarchical.
- Plan selection: the explicit ``ring`` and ``recursive-halving``
  schedules over the local level (4 ranks of (cross 2, local 4), 2 of
  (cross 2, local 2)) bitwise JAX's for f32 SUM, MIN, MAX and integer SUM;
  ``split`` and the two-level integer SUM against JAX's (rtol 1e-6,
  bitwise); ``select_plan``/``candidate_plans`` on ``model_for_axes`` of
  the groups equal to JAX's on the same axis sizes; ``auto_reduce_fn`` and
  a pinned ``planned_reduce_fn`` against JAX's (rtol 1e-6); and the DP
  step with ``hierarchical="auto"`` (post hoc and streamed) against JAX's
  at the ``hierarchical=True`` tolerances, its ``hvd_topo_plan_info`` and
  ``hvd_topo_bytes_per_hop`` labels JAX's.
"""

import json
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu.jax as hvdj
from horovod_tpu.common.types import ReduceOp as JOp
from horovod_tpu.jax import _shard_map
from horovod_tpu.ops import adasum as jada
from horovod_tpu.ops import collectives as jc
from horovod_tpu.ops import quantized as jq
from horovod_tpu.parallel.mesh import build_hierarchical_mesh as jax_hier_mesh
from horovod_tpu.parallel.mesh import build_mesh as jax_mesh
from horovod_tpu.topo import compositor as jcomp
from horovod_tpu.topo import model as jmodel

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum as tada
from horovod_tpu_torch.topo import compositor as tcomp

from torch_port_harness import (GPT_FIRST_BUCKET, GPT_THRESHOLD, assert_params_close, gpt_setup,
                                run_jax_variant, run_port_variants, run_ranks)

OPS = ("SUM", "AVERAGE", "MIN", "MAX")
# (cross, local) hierarchies: over 8 ranks, and each data slice of a
# (data 2, cross 2, local 2) mesh.
HIERS = {"c2l4": {"cross": 2, "local": 4}, "c2l2": {"data": 2, "cross": 2, "local": 2}}
# Every result key and whether it moves data (bitwise) or reduces (rtol).
MOVES = ["allgather", "allgather_flat", "broadcast_root0", "broadcast_root3",
         "broadcast_flat_root5", "broadcast_sa_root3", "broadcast_sa_ragged", "alltoall",
         "alltoall_flat"]
REDUCES = ([f"allreduce_{op}" for op in OPS] + [f"allreduce_flat_{op}" for op in OPS]
           + ["allreduce_ragged", "allreduce_bf16", "reducescatter", "reducescatter_avg",
              "reducescatter_flat"])


def _inputs():
    rng = np.random.RandomState(0)
    return dict(
        x=rng.randn(8, 16, 3).astype(np.float32),
        ragged=rng.randn(8, 7, 3).astype(np.float32),
        z=(rng.randn(8, 1003) * 0.01).astype(np.float32),
        a=rng.randn(8, 333).astype(np.float32),
        xi=rng.randint(-1000, 1000, (8, 17)).astype(np.int32),
    )


COLLECTIVES_WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import adasum, quantized
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.topo import compositor as C

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r = hvd.rank()
data = np.load(f"{d}/inputs.npz")
x, ragged, z, a, xi = (torch.from_numpy(data[k][r]) for k in ("x", "ragged", "z", "a", "xi"))
out, info = {}, {}
meshes = {"c2l4": M.build_hierarchical_mesh(4), "c2l2": M.build_mesh({"data": 2, "cross": 2, "local": 2})}
three = M.build_three_level_mesh(2, 2, 2)
for h, mesh in meshes.items():
    g = M.axis_groups(mesh, ("cross", "local"))
    cross, local = g
    kw = dict(local_group=local, cross_group=cross)
    for op in ("SUM", "AVERAGE", "MIN", "MAX"):
        out[f"{h}:allreduce_{op}"] = hvd.hierarchical_allreduce(x, op=getattr(ReduceOp, op), **kw)
        out[f"{h}:allreduce_flat_{op}"] = C.lower_allreduce(x, g, op=getattr(ReduceOp, op),
                                                            algorithm="flat")
    out[f"{h}:allreduce_ragged"] = hvd.hierarchical_allreduce(ragged, **kw)
    out[f"{h}:allreduce_bf16"] = C.lower_allreduce(x, g, wire_dtype="bf16")
    out[f"{h}:allgather"] = hvd.hierarchical_allgather(x, **kw)
    out[f"{h}:allgather_flat"] = C.lower_allgather(x, g, algorithm="flat")
    out[f"{h}:reducescatter"] = hvd.hierarchical_reducescatter(x, **kw)
    out[f"{h}:reducescatter_avg"] = hvd.hierarchical_reducescatter(x, op=ReduceOp.AVERAGE, **kw)
    out[f"{h}:reducescatter_flat"] = C.lower_reducescatter(x, g, algorithm="flat")
    out[f"{h}:broadcast_root0"] = hvd.hierarchical_broadcast(x, **kw)
    out[f"{h}:broadcast_root3"] = hvd.hierarchical_broadcast(x, root_rank=3, **kw)
    if h == "c2l4":
        out[f"{h}:broadcast_flat_root5"] = C.lower_broadcast(x, g, root_rank=5, algorithm="flat")
    else:
        out[f"{h}:broadcast_flat_root5"] = C.lower_broadcast(x, g, root_rank=1, algorithm="flat")
    out[f"{h}:broadcast_sa_root3"] = C.lower_broadcast(x, g, root_rank=3, algorithm="two-level-sa")
    out[f"{h}:broadcast_sa_ragged"] = C.lower_broadcast(ragged, g, root_rank=2,
                                                        algorithm="two-level-sa")
    out[f"{h}:alltoall"] = hvd.hierarchical_alltoall(x, **kw)
    out[f"{h}:alltoall_flat"] = C.lower_alltoall(x, g, algorithm="flat")
    out[f"{h}:int8_sum"] = quantized.quantized_hierarchical_allreduce(z, g)
    out[f"{h}:int8_avg"] = quantized.quantized_hierarchical_allreduce(z, g, average=True)
    out[f"{h}:int8_lower"] = C.lower_allreduce(z, g, wire_dtype="int8")
    out[f"{h}:int8_flat"] = C.lower_allreduce(z, g, wire_dtype="int8", algorithm="flat")
    out[f"{h}:adasum"] = adasum.hierarchical_adasum_allreduce(a, **kw)
    out[f"{h}:adasum_fn"] = adasum.adasum_reduce_fn(a, group=g)
    # Plan selection: the explicit single-level schedules over the local
    # level, split and the planned reduce_fns over the grid.
    for algo in ("ring", "recursive-halving"):
        for op in ("SUM", "MIN", "MAX"):
            out[f"{h}:{algo}_{op}"] = C.lower_allreduce(x, (local,), op=getattr(ReduceOp, op),
                                                        algorithm=algo)
        out[f"{h}:{algo}_int"] = C.lower_allreduce(xi, (local,), algorithm=algo)
    frac = C.split_fractions(C.model_for_axes(g))[0]
    out[f"{h}:split"] = C.lower_allreduce(z, g, algorithm="split", split_fraction=frac)
    out[f"{h}:two_level_int"] = C.lower_allreduce(xi, g)
    out[f"{h}:auto_fn"] = C.auto_reduce_fn()(z, op=ReduceOp.AVERAGE, group=g)
    out[f"{h}:planned_split"] = C.planned_reduce_fn(C.model_for_axes(g), g, algorithm="split")(
        z, op=ReduceOp.SUM)
    m = C.model_for_axes(g)
    info.setdefault("plans", {})[h] = {
        "model": m.to_dict(),
        "select": [C.select_plan(m, "allreduce", nb).to_dict() for nb in (4012, 64 << 20)],
        "candidates": {k: p.to_dict() for k, p in C.candidate_plans(m, "reducescatter", 4012).items()}}
    import torch.distributed as dist
    info[h] = {"coords": [mesh.get_local_rank(n) for n in mesh.mesh_dim_names],
               "flat_rank": dist.get_rank(g.flat), "flat_size": dist.get_world_size(g.flat),
               "axes": list(M.hierarchy_axes(mesh))}
info["three"] = {"coords": [three.get_local_rank(n) for n in three.mesh_dim_names],
                 "axes": list(M.hierarchy_axes(three)),
                 "flat_rank": torch.distributed.get_rank(M.flatten_group(three, ("pod", "local")))}
np.savez(f"{d}/rank{r}.npz", **{k: v.numpy() for k, v in out.items()})
json.dump(info, open(f"{d}/info{r}.json", "w"))
hvd.shutdown()
'''


def _jax_body(h):
    """One jitted shard_map per hierarchy computing every JAX result."""
    ops = {op: getattr(JOp, op) for op in OPS}
    axes = ("cross", "local")
    if h == "c2l4":
        mesh, spec = jax_hier_mesh(4, jax.devices()[:8]), P(("cross", "local"))
        flat_root = 5
    else:
        mesh = jax_mesh({"data": 2, "cross": 2, "local": 2}, devices=jax.devices()[:8])
        spec, flat_root = P(("data", "cross", "local")), 1

    def body(x, ragged, z, a, xi):
        x, ragged, z, a, xi = x[0], ragged[0], z[0], a[0], xi[0]
        out = {}
        for name, op in ops.items():
            out[f"allreduce_{name}"] = jc.hierarchical_allreduce(x, op=op)
            out[f"allreduce_flat_{name}"] = jcomp.lower_allreduce(x, axes, op=op, algorithm="flat")
        out["allreduce_ragged"] = jc.hierarchical_allreduce(ragged)
        out["allreduce_bf16"] = jcomp.lower_allreduce(x, axes, wire_dtype="bf16")
        out["allgather"] = jc.hierarchical_allgather(x)
        out["allgather_flat"] = jcomp.lower_allgather(x, axes, algorithm="flat")
        out["reducescatter"] = jc.hierarchical_reducescatter(x)
        out["reducescatter_avg"] = jc.hierarchical_reducescatter(x, op=JOp.AVERAGE)
        out["reducescatter_flat"] = jcomp.lower_reducescatter(x, axes, algorithm="flat")
        out["broadcast_root0"] = jc.hierarchical_broadcast(x)
        out["broadcast_root3"] = jc.hierarchical_broadcast(x, root_rank=3)
        out["broadcast_flat_root5"] = jcomp.lower_broadcast(x, axes, root_rank=flat_root,
                                                           algorithm="flat")
        out["broadcast_sa_root3"] = jcomp.lower_broadcast(x, axes, root_rank=3,
                                                         algorithm="two-level-sa")
        out["broadcast_sa_ragged"] = jcomp.lower_broadcast(ragged, axes, root_rank=2,
                                                          algorithm="two-level-sa")
        out["alltoall"] = jc.hierarchical_alltoall(x)
        out["alltoall_flat"] = jcomp.lower_alltoall(x, axes, algorithm="flat")
        out["int8_sum"] = jq.quantized_hierarchical_allreduce(z, axes)
        out["int8_avg"] = jq.quantized_hierarchical_allreduce(z, axes, average=True)
        out["adasum"] = jada.hierarchical_adasum_allreduce(a)
        for algo in ("ring", "recursive-halving"):
            for name in ("SUM", "MIN", "MAX"):
                out[f"{algo}_{name}"] = jcomp.lower_allreduce(x, ("local",), op=ops[name],
                                                              algorithm=algo)
            out[f"{algo}_int"] = jcomp.lower_allreduce(xi, ("local",), algorithm=algo)
        frac = jcomp.split_fractions(jcomp.model_for_axes(axes))[0]
        out["split"] = jcomp.lower_allreduce(z, axes, algorithm="split", split_fraction=frac)
        out["two_level_int"] = jcomp.lower_allreduce(xi, axes)
        out["auto_fn"] = jcomp.auto_reduce_fn()(z, op=JOp.AVERAGE, axis_name=axes)
        out["planned_split"] = jcomp.planned_reduce_fn(jcomp.model_for_axes(axes), axes,
                                                       algorithm="split")(z, op=JOp.SUM)
        return {k: v[None] for k, v in out.items()}

    fn = _shard_map(body, mesh, in_specs=(spec,) * 5, out_specs=spec)
    return jax.jit(fn)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("hier_collectives")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    run_ranks(COLLECTIVES_WORKER, 8, d)
    port = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    info = [json.loads((d / f"info{r}.json").read_text()) for r in range(8)]
    want = {}
    for h in HIERS:
        res = _jax_body(h)(*(jnp.asarray(inputs[k]) for k in ("x", "ragged", "z", "a", "xi")))
        want[h] = {k: np.asarray(v) for k, v in res.items()}
    return SimpleNamespace(port=port, info=info, jax=want, inputs=inputs)


def test_mesh_builders_lay_ranks_out_outer_major(collectives):
    for r, info in enumerate(collectives.info):
        assert info["c2l4"]["coords"] == [r // 4, r % 4]
        assert info["c2l4"]["axes"] == ["cross", "local"]
        # The flattened (cross, local) group: the world here, its rank the
        # outer-major index; inside a data slice, the slice's 4 ranks.
        assert (info["c2l4"]["flat_rank"], info["c2l4"]["flat_size"]) == (r, 8)
        assert info["c2l2"]["coords"] == [r // 4, (r // 2) % 2, r % 2]
        assert (info["c2l2"]["flat_rank"], info["c2l2"]["flat_size"]) == (r % 4, 4)
        assert info["three"]["coords"] == [r // 4, (r // 2) % 2, r % 2]
        assert info["three"]["axes"] == ["pod", "cross", "local"]
        assert info["three"]["flat_rank"] == 2 * (r // 4) + r % 2


@pytest.mark.parametrize("key", MOVES)
@pytest.mark.parametrize("hier", list(HIERS))
def test_data_movement_bitwise_jax(collectives, hier, key):
    for r in range(8):
        np.testing.assert_array_equal(collectives.port[r][f"{hier}:{key}"],
                                      collectives.jax[hier][key][r], err_msg=f"rank {r}")


def _slice(hier, r):
    """The ranks of rank r's (cross, local) grid."""
    return list(range(8)) if hier == "c2l4" else list(range(4 * (r // 4), 4 * (r // 4) + 4))


@pytest.mark.parametrize("key", REDUCES)
@pytest.mark.parametrize("hier", list(HIERS))
def test_reductions_match_jax(collectives, hier, key):
    """MIN/MAX bitwise; f32 sums at rtol 1e-5. The bf16 wire sums in bf16
    in another order than XLA, so each of its at most n roundings (the cast
    and every partial sum) may move an element by one bf16 ulp (2^-8
    relative) of a partial, which is at most sum_r |x_r|."""
    for r in range(8):
        got = collectives.port[r][f"{hier}:{key}"]
        want = collectives.jax[hier][key][r]
        assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
        if key.endswith(("MIN", "MAX")):
            np.testing.assert_array_equal(got, want)
        elif key == "allreduce_bf16":
            ranks = _slice(hier, r)
            bound = len(ranks) * 2.0 ** -8 * np.abs(collectives.inputs["x"][ranks]).sum(axis=0)
            exact = collectives.inputs["x"][ranks].sum(axis=0)
            assert np.all(np.abs(got - want) <= bound)
            assert np.all(np.abs(got - exact) <= bound)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hier", list(HIERS))
def test_two_level_equals_flat(collectives, hier):
    """The port's two-level schedules against its own flat collectives:
    bitwise where the regrouping commutes, f32 rounding for the sums."""
    for p in collectives.port:
        for a, b in (("allgather", "allgather_flat"), ("alltoall", "alltoall_flat"),
                     ("allreduce_MIN", "allreduce_flat_MIN"),
                     ("allreduce_MAX", "allreduce_flat_MAX")):
            np.testing.assert_array_equal(p[f"{hier}:{a}"], p[f"{hier}:{b}"])
        for a, b in (("allreduce_SUM", "allreduce_flat_SUM"),
                     ("reducescatter", "reducescatter_flat")):
            np.testing.assert_allclose(p[f"{hier}:{a}"], p[f"{hier}:{b}"], rtol=1e-5, atol=1e-6)


def _node_sum_step(z, cross, local):
    """One quantization step per element of the cross-level ring, which
    runs on each local rank's shard of the node sums: the block's largest
    sum over ranks of |z| / 127 (no partial of the ring exceeds it)."""
    bound = np.abs(z).sum(axis=0)
    n = bound.size
    m = -(-n // local)
    padded = np.pad(bound, (0, m * local - n)).reshape(local, m)
    k = -(-m // cross)
    k = -(-k // 256) * 256
    rows = np.pad(padded, ((0, 0), (0, cross * k - m))).reshape(local, -1, 256)
    step = np.repeat(rows.max(axis=2) / 127.0, 256, axis=1).reshape(local, -1)[:, :m]
    return step.reshape(-1)[:n]


@pytest.mark.parametrize("hier", list(HIERS))
def test_quantized_hierarchical_within_a_step_a_hop_of_jax(collectives, hier):
    local = HIERS[hier]["local"]
    slices = [range(8)] if hier == "c2l4" else [range(4), range(4, 8)]
    for ranks in slices:
        z = collectives.inputs["z"][list(ranks)]
        step = _node_sum_step(z, 2, local)
        exact = z.sum(axis=0)
        for r in ranks:
            p = collectives.port[r]
            for key, scale in (("int8_sum", 1.0), ("int8_avg", len(ranks))):
                got, want = p[f"{hier}:{key}"] * scale, collectives.jax[hier][key][r] * scale
                assert np.all(np.abs(got - want) <= (2 - 1) * step + 1e-9), key
                assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 3e-2
            np.testing.assert_array_equal(p[f"{hier}:int8_lower"], p[f"{hier}:int8_sum"])
            np.testing.assert_array_equal(p[f"{hier}:int8_sum"],
                                          collectives.port[ranks[0]][f"{hier}:int8_sum"])
            # Flat int8 over the flattened group: the int8 ring on every hop.
            assert np.linalg.norm(p[f"{hier}:int8_flat"] - exact) / np.linalg.norm(exact) < 3e-2


@pytest.mark.parametrize("hier", list(HIERS))
def test_hierarchical_adasum_matches_reference_and_jax(collectives, hier):
    local = HIERS[hier]["local"]
    slices = [range(8)] if hier == "c2l4" else [range(4), range(4, 8)]
    for ranks in slices:
        want = tada.hierarchical_adasum_reference(list(collectives.inputs["a"][list(ranks)]),
                                                  local)
        np.testing.assert_allclose(
            want, jada.hierarchical_adasum_reference(list(collectives.inputs["a"][list(ranks)]),
                                                     local), rtol=1e-12)
        for r in ranks:
            got = collectives.port[r][f"{hier}:adasum"]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, collectives.jax[hier]["adasum"][r], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(collectives.port[r][f"{hier}:adasum_fn"], got)


class _FakeHop(SimpleNamespace):
    """A level no collective reaches: the refusals raise before any."""

    def exchange(self, x, peer):
        raise AssertionError("no exchange expected")


def _local_slice(hier, r):
    """The ranks of rank r's local level."""
    size = HIERS[hier]["local"]
    return list(range(size * (r // size), size * (r // size) + size))


def _jax_plans(hier):
    """JAX's plans on the model of the same axis sizes."""
    jm = jmodel.synthetic_model(local=HIERS[hier]["local"], cross=2)
    return {"select": [jcomp.select_plan(jm, "allreduce", nb).to_dict()
                       for nb in (4012, 64 << 20)],
            "candidates": {k: p.to_dict() for k, p in
                           jcomp.candidate_plans(jm, "reducescatter", 4012).items()}}


@pytest.mark.parametrize("case", ["ring", "recursive-halving", "split", "select_plan",
                                  "candidate_plans", "auto_reduce_fn", "planned_reduce_fn"])
@pytest.mark.parametrize("hier", list(HIERS))
def test_plan_selection_names_a13(collectives, hier, case):
    """Plan selection against JAX's (it refused, naming ROADMAP A13, until
    ported): the explicit schedules bitwise (each element reduced once and
    copied, so every rank of a level holds the same bits), split and the
    planned reduce_fns to f32 rounding, the plans themselves exactly."""
    for r in range(8):
        port, want = collectives.port[r], collectives.jax[hier]
        if case in ("ring", "recursive-halving"):
            for key in (f"{case}_SUM", f"{case}_MIN", f"{case}_MAX", f"{case}_int"):
                np.testing.assert_array_equal(port[f"{hier}:{key}"], want[key][r], err_msg=key)
                np.testing.assert_array_equal(
                    port[f"{hier}:{key}"], collectives.port[_local_slice(hier, r)[0]][
                        f"{hier}:{key}"])
            np.testing.assert_allclose(port[f"{hier}:{case}_SUM"],
                                       collectives.inputs["x"][_local_slice(hier, r)].sum(0),
                                       rtol=1e-5, atol=1e-5)
        elif case == "split":
            np.testing.assert_allclose(port[f"{hier}:split"], want["split"][r], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_array_equal(port[f"{hier}:two_level_int"], want["two_level_int"][r])
        elif case in ("select_plan", "candidate_plans"):
            plans = collectives.info[r]["plans"][hier]
            key = "select" if case == "select_plan" else "candidates"
            assert plans[key] == _jax_plans(hier)[key]
            assert plans["model"]["hops"] == [
                h.to_dict() for h in jmodel.synthetic_model(local=HIERS[hier]["local"],
                                                            cross=2).hops]
        else:
            key = "auto_fn" if case == "auto_reduce_fn" else "planned_split"
            np.testing.assert_allclose(port[f"{hier}:{key}"], want[key][r], rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("call,match", [
    (lambda h: tcomp.lower_allreduce(torch.ones(4), h, algorithm="flat"), "flattened group"),
    (lambda h: tcomp.lower_allgather(torch.ones(4), h, algorithm="flat"), "flattened group"),
    (lambda h: tcomp.lower_allreduce(torch.ones(4), h, op=hvd.Product), "PRODUCT/ADASUM"),
    (lambda h: tcomp.lower_reducescatter(torch.ones(6), h), "divisible by the grid"),
    (lambda h: tcomp.lower_broadcast(torch.ones(4), h, root_rank=4), "out of range"),
    (lambda h: tcomp.lower_allreduce(torch.ones(4), h, algorithm="nope"), "unknown algorithm"),
    (lambda h: tada.adasum_reduce_fn(torch.ones(4), group=h + h[:1]), "a \\(cross, local\\) pair"),
])
def test_refusals(call, match):
    """Flat over several levels needs their flattened group (never a
    two-level stand-in); the JAX package's other refusals."""
    hops = (_FakeHop(rank=0, n=2), _FakeHop(rank=0, n=2))
    with pytest.raises(ValueError, match=match):
        call(hops)


# --- the DP step ------------------------------------------------------------------

N, LOCAL = 4, 2
KW = dict(fusion_threshold_bytes=GPT_THRESHOLD)
HIER_VARIANTS = {
    "hierarchical": dict(hierarchical=True),
    "hierarchical-overlap": dict(hierarchical=True, overlap=True,
                                 first_bucket_bytes=GPT_FIRST_BUCKET),
    "hierarchical-quantized": dict(hierarchical=True, quantized=True),
    "hierarchical-zero1": dict(hierarchical=True, zero1=True, first_bucket_bytes=GPT_FIRST_BUCKET),
    "hierarchical-adasum": dict(hierarchical=True, op="Adasum"),
    "hierarchical-auto": dict(hierarchical="auto"),
    "hierarchical-auto-overlap": dict(hierarchical="auto", overlap=True,
                                      first_bucket_bytes=GPT_FIRST_BUCKET),
}


@pytest.fixture(scope="module")
def setup():
    return gpt_setup()


@pytest.fixture(scope="module")
def steps(setup, tmp_path_factory):
    variants = {name: {"kwargs": dict(KW, **kw), "local_size": LOCAL,
                       "metrics": kw.get("hierarchical") == "auto"}
                for name, kw in HIER_VARIANTS.items()}
    variants["flat"] = {"kwargs": dict(KW)}
    return run_port_variants(tmp_path_factory.mktemp("hier_steps"), variants, N, setup)


@pytest.fixture(scope="module")
def jax_auto(setup):
    """JAX's hierarchical="auto" steps, once each, with its metrics tap on:
    {name: ((losses, final params, states), the hvd_topo_* series' labels)}."""
    from horovod_tpu import metrics as jmetrics

    out = {}
    for name, kw in HIER_VARIANTS.items():
        if kw.get("hierarchical") != "auto":
            continue
        jmetrics.install(True)
        try:
            run = run_jax_variant(setup, N, local_size=LOCAL, **dict(KW, **kw))
            snap = jmetrics.snapshot()
        finally:
            jmetrics.reset()
        out[name] = run, {k: sorted(sorted(x["labels"].items()) for x in snap[k]["series"])
                          for k in ("hvd_topo_plan_info", "hvd_topo_bytes_per_hop")}
    return out


def _params(arrays):
    return {k: v for k, v in arrays.items() if k.startswith("p:")}


@pytest.mark.parametrize("name", list(HIER_VARIANTS))
def test_hierarchical_step_matches_jax(steps, setup, jax_auto, name):
    kw = dict(KW, **HIER_VARIANTS[name])
    if kw.get("op") == "Adasum":
        kw["op"] = JOp.ADASUM
    if name in jax_auto:
        losses, final, _ = jax_auto[name][0]
    else:
        losses, final, _ = run_jax_variant(setup, N, local_size=LOCAL, **kw)
    port = steps[name]
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=1e-5)
        for key, a in _params(port[0]["arrays"]).items():
            np.testing.assert_array_equal(port[r]["arrays"][key], a, err_msg=key)
    assert losses[-1] < losses[0]
    assert_params_close(port[0]["arrays"], final,
                        share=1e-3 if "quantized" in name else 1e-4)
    if "overlap" in name:
        assert all(launched == total > 1 for launched, _, total in port[0]["groups"])


@pytest.mark.parametrize("name", ["hierarchical-auto", "hierarchical-auto-overlap"])
def test_auto_step_records_the_jax_plans(steps, jax_auto, name):
    """The planned step's ``hvd_topo_plan_info`` and ``hvd_topo_bytes_per_hop``
    labels (``where="stream"``, one series a selected algorithm and hop)
    equal those JAX's step records over the same buckets, on every rank,
    and every bucket's selected algorithm is one JAX's labels name."""
    want = jax_auto[name][1]
    algorithms = {dict(labels)["algorithm"] for labels in want["hvd_topo_plan_info"]}
    assert algorithms >= {"two-level"}
    for r in range(N):
        got = {k: [sorted(map(tuple, labels)) for labels in v]
               for k, v in steps[name][r]["plans"].items()}
        assert got == {k: [sorted(labels) for labels in v] for k, v in want.items()}
        assert set(steps[name][r]["selected"].values()) == algorithms


def test_hierarchical_equals_flat_within_f32_rounding(steps):
    """test_optimizer.py:146: the two-level reduction against the flat one,
    at rtol 1e-5 on the losses and the parameters."""
    for r in range(N):
        for name in ("hierarchical", "hierarchical-overlap", "hierarchical-zero1",
                     "hierarchical-auto", "hierarchical-auto-overlap"):
            np.testing.assert_allclose(steps[name][r]["losses"], steps["flat"][r]["losses"],
                                       rtol=1e-5)
            for key, a in _params(steps["flat"][r]["arrays"]).items():
                np.testing.assert_allclose(steps[name][r]["arrays"][key], a, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{name} {key}")
        # The int8 wire ran: its parameters are not the full-precision ones.
        q, f = steps["hierarchical-quantized"][r]["arrays"], steps["hierarchical"][r]["arrays"]
        assert any(not np.array_equal(q[k], f[k]) for k in _params(f))


# --- the builders' refusals -------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _sgd():
    return torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)


@pytest.mark.parametrize("kwargs,match", [
    (dict(hierarchical=True, quantized=True, error_feedback=True),
     "error feedback compensates the flat int8 ring"),
    (dict(hierarchical=True, quantized=True, zero1=True), "flat int8 ring"),
])
def test_step_refusals_match_jax(one_rank, kwargs, match):
    from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh

    jmesh = jax_hier_mesh(1, jax.devices()[:1])
    with pytest.raises(ValueError, match=match):
        hvdj.make_train_step(lambda p, b: jnp.sum(p), optax.sgd(0.1), jmesh, **kwargs)
    with pytest.raises(ValueError, match=match):
        hvd.make_train_step(lambda p, b: p.sum(), _sgd(), mesh=build_hierarchical_mesh(1),
                            **kwargs)


def test_optimizer_form_zero1_hierarchical_matches_jax(one_rank):
    match = "runs over the flat data axis"
    with pytest.raises(ValueError, match=match):
        hvdj.DistributedOptimizer(optax.sgd(0.1), zero1=True, zero1_shards=1, hierarchical=True)
    with pytest.raises(ValueError, match=match):
        hvd.DistributedOptimizer(_sgd(), zero1=True, hierarchical=True)


def test_hierarchical_needs_a_cross_local_tuple(one_rank):
    with pytest.raises(ValueError, match="needs a \\(cross, local\\) axis tuple"):
        hvd.DistributedOptimizer(_sgd(), hierarchical=True)
    with pytest.raises(ValueError, match="needs a \\(cross, local\\) axis tuple"):
        hvd.make_train_step(lambda p, b: p.sum(), _sgd(), hierarchical=True)


@pytest.mark.parametrize("hierarchical", ["planned", "auto"])
def test_plan_selection_knobs_name_a13(one_rank, hierarchical):
    """``"planned"`` and ``"auto"`` on a (cross, local) mesh build the
    planned step (they refused, naming ROADMAP A13, until ported): at one
    rank every bucket's plan is flat and the update is the plain step's.
    Without a mesh, ``"planned"`` needs the axis tuple as ``True`` does, and
    ``"auto"`` on a one-process topology is flat, as JAX's."""
    from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh, build_mesh

    def run(**kw):
        w = torch.nn.Parameter(torch.zeros(3))
        step = hvd.make_train_step(lambda p, b: (p * b).sum(), torch.optim.SGD([w], lr=0.1),
                                   **kw)
        loss = step(w, torch.tensor([1.0, -2.0, 0.5]))
        return step, float(loss), w.detach().clone()

    step, loss, w = run(hierarchical=hierarchical, mesh=build_hierarchical_mesh(1))
    assert step.optimizer._hierarchical == "planned"
    assert step.optimizer.selected_plans == {12: "flat"}
    _, plain_loss, plain_w = run()
    assert loss == plain_loss and torch.equal(w, plain_w)
    if hierarchical == "planned":
        with pytest.raises(ValueError, match="needs a \\(cross, local\\) axis tuple"):
            hvd.DistributedOptimizer(_sgd(), hierarchical=hierarchical)
    else:
        assert not hvd.DistributedOptimizer(_sgd(), hierarchical="auto")._hierarchical
        # A mesh with no (cross, local) grid resolves "auto" to flat.
        step = hvd.make_train_step(lambda p, b: p.sum(), _sgd(), hierarchical="auto",
                                   mesh=build_mesh({"data": 1}))
        assert not step.optimizer._hierarchical
