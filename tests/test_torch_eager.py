"""The port's eager API (``horovod_tpu_torch.eager``) against the JAX package.

- Size 1, in this process: the eager cases of tests/test_basics.py and
  tests/test_process_sets.py, the same seeded numpy inputs through JAX's
  eager op (its own native core) and the port's (the port's core): data
  movement bitwise, scaled reductions at rtol 1e-6.
- 2 and 4 gloo ranks (tests/torch_port_harness.py): the cases of
  tests/test_multiprocess.py, each rank's result against the JAX package's
  collective functions on a mesh of CPU devices (``ops.collectives``,
  ``ops.adasum``) or, for what they do not express (uneven splits, join,
  process sets), a whole-batch numpy reference. Data movement bitwise, f32
  reductions at rtol 1e-5; half-precision sums of 2 ranks are one rounding,
  so bitwise too. PRODUCT is held to JAX's compiled op: the JAX eager path
  computes a sum for it (ROADMAP queue C).
- The (cross 2, local 2) grid with the hierarchical knobs, and the runtime's
  refusals: no silent fallback to the Python runtime, the planner's
  entry points name A13.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.common.types import ReduceOp as JOp
from horovod_tpu.jax import _shard_map
from horovod_tpu.ops import adasum as jada
from horovod_tpu.ops import collectives as jc

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, native

from torch_port_harness import run_ranks


# --- size 1, in process: JAX's eager op and the port's ------------------------


@pytest.fixture()
def both():
    """JAX's eager runtime and the port's, side by side in this process."""
    jhvd.shutdown()
    hvd.shutdown()
    jhvd.init()
    hvd.init(device="cpu")
    yield SimpleNamespace(j=jhvd, t=hvd)
    hvd.shutdown()
    jhvd.shutdown()


def _x(shape=(3, 4), dtype=np.float32, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _same(port_out, jax_out):
    """Bitwise: values, shape and dtype (the port returns numpy for numpy)."""
    assert isinstance(port_out, np.ndarray), type(port_out)
    want = np.asarray(jax_out)
    assert port_out.dtype == want.dtype and port_out.shape == want.shape
    np.testing.assert_array_equal(port_out, want)


@pytest.mark.parametrize("kw", [
    {}, {"op": "Sum"}, {"average": True}, {"average": False},
    {"op": "Sum", "prescale_factor": 2.0, "postscale_factor": 0.5},
    {"op": "Average", "prescale_factor": 3.0},
    {"op": "Min"}, {"op": "Max"}, {"op": "Product"},
])
def test_allreduce_size1_matches_jax(both, kw):
    x = _x()
    jkw = {k: getattr(jhvd, v) if k == "op" else v for k, v in kw.items()}
    tkw = {k: getattr(hvd, v) if k == "op" else v for k, v in kw.items()}
    got, want = both.t.allreduce(x, **tkw), both.j.allreduce(x, **jkw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    assert got.dtype == np.float32


def test_allreduce_tensor_in_tensor_out(both):
    x = torch.from_numpy(_x())
    out = both.t.allreduce(x, op=hvd.Sum)
    assert isinstance(out, torch.Tensor) and torch.equal(out, x) and out is not x


def test_allreduce_average_and_op_mutually_exclusive(both):
    for h in (both.j, both.t):
        with pytest.raises(ValueError):
            h.allreduce(np.ones(2, np.float32), average=True, op=h.Sum)


def test_allreduce_async_poll_synchronize(both):
    x = np.ones((4,), np.float32)
    h = both.t.allreduce_async(x, name="t0")
    _same(both.t.synchronize(h), both.j.synchronize(both.j.allreduce_async(x, name="t0")))
    assert both.t.poll(h)          # a finished handle polls True


def test_duplicate_name_rejected(both):
    """Two in-flight ops of one name: one of them fails (common.h:160-163)."""
    x = np.ones((2,), np.float32)
    failures = 0
    for _ in range(20):
        ha = both.t.allreduce_async(x, name="dup2")
        hb = both.t.allreduce_async(x, name="dup2")
        for h in (ha, hb):
            try:
                both.t.synchronize(h)
            except RuntimeError:
                failures += 1
    assert failures >= 1


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8])
def test_allgather_broadcast_size1(both, dtype):
    x = (np.arange(6) % 5).astype(dtype).reshape(2, 3)
    _same(both.t.allgather(x), both.j.allgather(x))
    _same(both.t.broadcast(x, root_rank=0), both.j.broadcast(x, root_rank=0))
    _same(both.t.alltoall(x), both.j.alltoall(x))


def test_join_size1(both):
    both.t.join()      # must not deadlock at size 1
    both.t.barrier()


@pytest.mark.parametrize("comp", ["fp16", "bf16"])
def test_compression_size1(both, comp):
    x = np.arange(8, dtype=np.float32) / 7.0
    got = both.t.allreduce(x, compression=getattr(hvd.Compression, comp))
    want = np.asarray(both.j.allreduce(x, compression=getattr(jhvd.Compression, comp)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_reducescatter_size1(both, op):
    x = _x((6,))
    np.testing.assert_allclose(both.t.reducescatter(x, op=getattr(hvd, op)),
                               np.asarray(both.j.reducescatter(x, op=getattr(jhvd, op))),
                               rtol=1e-6)


def test_reducescatter_rejects_bad_args(both):
    for h in (both.j, both.t):
        with pytest.raises(ValueError, match="SUM/AVERAGE"):
            h.reducescatter(np.ones((4,), np.float32), op=h.Min)
        with pytest.raises(ValueError, match="dim0"):
            h.reducescatter(np.float32(1.0))


def test_grouped_allreduce_size1(both):
    xs = [np.full((3,), float(i), np.float32) for i in range(4)]
    for got, want in zip(both.t.grouped_allreduce(xs, op=hvd.Sum),
                         both.j.grouped_allreduce(xs, op=jhvd.Sum)):
        _same(got, want)
    hs = both.t.grouped_allreduce_async(xs, average=True)
    for got, want in zip([both.t.synchronize(h) for h in hs],
                         both.j.grouped_allreduce(xs, average=True)):
        _same(got, want)


def test_grouped_allgather_reducescatter_size1(both):
    xs = [_x((4, 2), seed=i) for i in range(3)]
    for got, want in zip(both.t.grouped_allgather(xs), both.j.grouped_allgather(xs)):
        _same(got, want)
    for got, want in zip(both.t.grouped_reducescatter(xs), both.j.grouped_reducescatter(xs)):
        _same(got, want)


def test_objects_and_variables_size1(both):
    obj = {"k": [1, 2.5, "x"]}
    assert both.t.allgather_object(obj) == both.j.allgather_object(obj) == [obj]
    assert both.t.broadcast_object(obj) == both.j.broadcast_object(obj) == obj
    params = {"w": torch.randn(3, 2), "b": torch.zeros(2)}
    out = both.t.broadcast_variables(params)
    assert set(out) == {"w", "b"} and all(torch.equal(out[k], params[k]) for k in params)
    assert [torch.equal(a, b) for a, b in zip(both.t.broadcast_variables([params["w"]]),
                                               [params["w"]])] == [True]


def test_alltoall_splits_size1(both):
    x = _x((5, 2))
    got, rs = both.t.alltoall(x, splits=[5])
    want, wrs = both.j.alltoall(x, splits=[5])
    _same(got, want)
    np.testing.assert_array_equal(rs, wrs)


def test_init_shutdown_cycle():
    hvd.shutdown()
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    assert hvd.is_initialized()
    assert (hvd.size(), hvd.rank(), hvd.local_rank(), hvd.local_size()) == (1, 0, 0, 1)
    assert (hvd.cross_rank(), hvd.cross_size(), hvd.is_homogeneous()) == (0, 1, True)
    hvd.init(device="cpu")           # a second init does nothing
    assert hvd.is_initialized()
    hvd.shutdown()
    assert not hvd.is_initialized()


def test_uninitialized_raises():
    hvd.shutdown()
    with pytest.raises(Exception):
        hvd.size()
    with pytest.raises(hvd.HorovodInternalError):
        hvd.allreduce(np.ones((2, 2), np.float32))


def test_build_probes():
    import torch.distributed as dist

    assert not hvd.mpi_built() and not hvd.mpi_enabled() and not hvd.mpi_threads_supported()
    assert not hvd.xla_built() and not hvd.xla_enabled()
    assert not hvd.ddl_built() and not hvd.mlsl_built()
    assert hvd.gloo_built() == dist.is_gloo_available()
    assert hvd.nccl_built() == dist.is_nccl_available()
    hvd.init(device="cpu")
    try:
        assert hvd.gloo_enabled() and not hvd.nccl_enabled()
    finally:
        hvd.shutdown()


def test_topology_from_env_matches_jax(monkeypatch):
    from horovod_tpu.common import topology as jtopo
    from horovod_tpu_torch.common import topology as ttopo

    for k, v in (("HOROVOD_RANK", "3"), ("HOROVOD_SIZE", "8"), ("HOROVOD_LOCAL_RANK", "3"),
                 ("HOROVOD_LOCAL_SIZE", "4")):
        monkeypatch.setenv(k, v)
    j, t = jtopo.detect(), ttopo.detect()
    for f in ("rank", "size", "local_rank", "local_size", "cross_rank", "cross_size",
              "is_homogeneous", "source"):
        assert getattr(t, f) == getattr(j, f), f
    monkeypatch.setenv("HOROVOD_CROSS_RANK", "1")
    monkeypatch.setenv("HOROVOD_CROSS_SIZE", "3")
    j, t = jtopo.detect(), ttopo.detect()
    assert (t.cross_rank, t.cross_size, t.is_homogeneous) == (
        j.cross_rank, j.cross_size, j.is_homogeneous) == (1, 3, False)


def test_runtime_timeline_start_stop(tmp_path):
    """The core's catapult timeline for a window of the run."""
    hvd.init(device="cpu")
    try:
        path = str(tmp_path / "tl.json")
        hvd.start_timeline(path, mark_cycles=True)
        with pytest.raises(ValueError):
            hvd.start_timeline(path)      # already active
        hvd.allreduce(np.ones((4,), np.float32), name="tl.t")
        hvd.stop_timeline()
        names = {e.get("name") for e in json.load(open(path))}
        assert "CYCLE" in names, names
    finally:
        hvd.shutdown()


# --- process sets (tests/test_process_sets.py) ---


def test_global_process_set(both):
    g = hvd.global_process_set
    assert g.process_set_id == 0 and g.included()
    assert g.size() == hvd.size() == 1 and g.rank() == hvd.rank() == 0
    with pytest.raises(ValueError):
        hvd.add_process_set(hvd.ProcessSet(None))


def test_process_set_lifecycle(both):
    ps = hvd.add_process_set([0])
    assert ps.process_set_id == 1 and ps.included() and ps.rank() == 0 and ps.size() == 1
    ps2 = hvd.add_process_set(hvd.ProcessSet([0]))
    assert ps2.process_set_id == 2
    with pytest.raises(ValueError):
        hvd.add_process_set(ps)
    hvd.remove_process_set(ps2)
    assert ps2.process_set_id is None
    with pytest.raises(ValueError):
        hvd.remove_process_set(ps2)
    with pytest.raises(ValueError):
        hvd.remove_process_set(hvd.global_process_set)
    hvd.remove_process_set(ps)


@pytest.mark.parametrize("ranks", [[1], [-1], []])
def test_process_set_ranks_validation(both, ranks):
    with pytest.raises(ValueError):
        hvd.add_process_set(ranks)


def test_unregistered_set_rejected(both):
    with pytest.raises(ValueError, match="add_process_set"):
        hvd.allreduce(np.ones(2, np.float32), process_set=hvd.ProcessSet([0]))


def test_collectives_over_singleton_set(both):
    ps, jps = both.t.add_process_set([0]), both.j.add_process_set([0])
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    _same(both.t.allreduce(x, op=hvd.Sum, process_set=ps),
          both.j.allreduce(x, op=jhvd.Sum, process_set=jps))
    _same(both.t.allgather(x, process_set=ps), both.j.allgather(x, process_set=jps))
    _same(both.t.broadcast(x, 0, process_set=ps), both.j.broadcast(x, 0, process_set=jps))
    for got, want in zip(both.t.grouped_allreduce([x, 2 * x], op=hvd.Sum, process_set=ps),
                         both.j.grouped_allreduce([x, 2 * x], op=jhvd.Sum, process_set=jps)):
        _same(got, want)
    assert both.t.allgather_object({"k": 7}, process_set=ps) == [{"k": 7}]
    both.t.remove_process_set(ps)
    both.j.remove_process_set(jps)


def test_shutdown_resets_process_sets():
    hvd.init(device="cpu")
    ps = hvd.add_process_set([0])
    assert ps.process_set_id == 1
    hvd.shutdown()
    assert ps.process_set_id is None
    hvd.init(device="cpu")
    try:
        assert hvd.add_process_set([0]).process_set_id == 1
    finally:
        hvd.shutdown()


# --- the runtime's choices and refusals ---


def test_python_runtime_only_by_request(monkeypatch):
    """HOROVOD_TPU_CORE=python runs the pure-Python runtime; its timeline
    writer is not ported and says so."""
    from horovod_tpu_torch.core.runtime import Runtime

    monkeypatch.setenv("HOROVOD_TPU_CORE", "python")
    hvd.init(device="cpu")
    try:
        assert isinstance(basics._runtime.eager, Runtime)
        x = _x()
        np.testing.assert_array_equal(hvd.allreduce(x, op=hvd.Sum), x)
        outs = hvd.grouped_allreduce([x, x], average=True)
        assert all(np.array_equal(o, x) for o in outs)
        with pytest.raises(NotImplementedError, match="A12"):
            hvd.start_timeline("unused.json")
    finally:
        hvd.shutdown()


def test_native_core_failure_raises(monkeypatch):
    """A core that does not load makes init raise, and leaves nothing
    initialized: no quiet fall back to the Python runtime."""
    def broken():
        raise native.NativeCoreUnavailable("g++ failed on cpp/src/core.cc")

    monkeypatch.setattr(native, "load", broken)
    hvd.shutdown()
    with pytest.raises(native.NativeCoreUnavailable):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_unknown_core_kind_raises(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_CORE", "xla")
    with pytest.raises(ValueError, match="native"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_planner_entry_points_name_a13(monkeypatch):
    with pytest.raises(NotImplementedError, match="A13"):
        hvd.collective_plan("allreduce", 1 << 20)
    monkeypatch.setenv("HOROVOD_TOPOLOGY_PLAN", "auto")
    with pytest.raises(NotImplementedError, match="A13"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


# --- 2 and 4 gloo ranks -------------------------------------------------------

DTYPES = ("f32", "f16", "bf16", "i32", "i64", "u8")
OPS = ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT")
_NP = {"f32": np.float32, "f16": np.float16, "bf16": np.float32, "i32": np.int32,
       "i64": np.int64, "u8": np.uint8}


def _rank_inputs(n: int) -> dict:
    """Seeded inputs, one row per rank."""
    rng = np.random.RandomState(n)
    out = {}
    for dt in DTYPES:
        if dt in ("i32", "i64", "u8"):
            out[dt] = rng.randint(1, 4, size=(n, 5, 3)).astype(_NP[dt])
        else:
            out[dt] = (rng.rand(n, 5, 3) + 0.5).astype(_NP[dt])
    out["scaled"] = rng.randn(n, 7).astype(np.float32)
    out["ada"] = rng.randn(n, 10).astype(np.float32)
    out["even"] = rng.randn(n, 2 * n, 3).astype(np.float32)
    out["grp"] = rng.randn(n, 6, 4).astype(np.float32)
    return out


MULTI_WORKER = r'''
import json, os, time
import numpy as np
import torch
d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
if cfg.get("grid"):
    r0 = int(os.environ["HOROVOD_RANK"])
    os.environ["HOROVOD_LOCAL_SIZE"] = "2"
    os.environ["HOROVOD_LOCAL_RANK"] = str(r0 % 2)
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    os.environ["HOROVOD_HIERARCHICAL_ALLGATHER"] = "1"
os.environ["HOROVOD_CYCLE_TIME"] = "1"
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.core import nccl_executor

plans = []
_orig = nccl_executor.NcclPlanExecutor.execute
def _spy(self, plan, entries, topo):
    plans.append(list(plan.get("names", [])))
    return _orig(self, plan, entries, topo)
nccl_executor.NcclPlanExecutor.execute = _spy

hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
X = {k: data[k][r] for k in data.files}
out, info = {}, {"errors": {}}

def T(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dt == "bf16" else t

def keep(key, v):
    if isinstance(v, torch.Tensor):
        v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    out[key] = np.asarray(v)

if cfg["cases"] == "flat":
    for dt in ("f32", "f16", "bf16", "i32", "i64", "u8"):
        for op in ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT"):
            keep(f"ar:{dt}:{op}", hvd.allreduce(T(X[dt], dt), op=getattr(hvd.ReduceOp, op),
                                                name=f"ar.{dt}.{op}"))
    keep("ar:scaled", hvd.allreduce(X["scaled"], op=hvd.Sum, prescale_factor=0.5,
                                    postscale_factor=3.0))
    keep("ar:scaled_avg", hvd.allreduce(T(X["scaled"]), prescale_factor=2.0))
    keep("adasum", hvd.allreduce(T(X["ada"]), op=hvd.Adasum))
    keep("allgather", hvd.allgather(T(X["even"])))
    keep("allgather_uneven", hvd.allgather(T(X["even"][:r + 1])))
    keep("allgather_uneven_u8", hvd.allgather(np.full((n - r, 2), r, np.uint8)))
    for root in range(n):
        keep(f"broadcast:{root}", hvd.broadcast(T(X["even"]), root_rank=root))
    keep("alltoall", hvd.alltoall(T(X["even"])))
    keep("reducescatter", hvd.reducescatter(T(X["even"])))
    keep("reducescatter_avg", hvd.reducescatter(T(X["even"]), op=hvd.Average))
    keep("reducescatter_uneven", hvd.reducescatter(T(X["even"][:2 * n - 1]), name="rs.uneven"))
    # Skewed splits: rank r sends (r + 1) * 3 rows to rank 0, one row to
    # every other rank.
    splits = [(r + 1) * 3] + [1] * (n - 1)
    rows = np.arange(sum(splits) * 2, dtype=np.float32).reshape(-1, 2) + 100 * r
    got, rs = hvd.alltoall(rows, splits=splits, name="a2av")
    keep("a2av", got); keep("a2av_splits", rs)
    e, ers = hvd.alltoall(np.zeros((0, 2), np.float32), splits=[0] * n, name="a2av.empty")
    info["a2av_empty"] = [list(e.shape), ers.tolist()]
    os.environ["HOROVOD_ALLTOALLV_CARRIER_FACTOR"] = "1"
    got, rs = hvd.alltoall(rows, splits=splits, name="a2av.capped")
    keep("a2av_capped", got)
    info["carrier"] = hvd.alltoall._last_carrier_rows
    plans.clear()
    grp = hvd.grouped_allreduce([T(g) for g in X["grp"]], op=hvd.Sum, name="grp")
    for i, g in enumerate(grp):
        keep(f"grp:{i}", g)
    info["grp_plans"] = [p for p in plans if any(nm.startswith("grp.") for nm in p)]
    for i, g in enumerate(hvd.grouped_allgather([T(X["even"][:r + 1]), T(X["grp"][0])],
                                                name="gag")):
        keep(f"gag:{i}", g)
    for i, g in enumerate(hvd.grouped_reducescatter([T(X["even"]), T(X["grp"][0])],
                                                    name="grs")):
        keep(f"grs:{i}", g)
    info["objs"] = hvd.allgather_object({"rank": r, "pad": "x" * r})
    info["bobj"] = hvd.broadcast_object({"from": r, "v": [r] * 3}, root_rank=n - 1)
    hvd.barrier()
    try:
        hvd.allreduce(np.ones((4,) if r == 0 else (5,), np.float32), name="mismatch")
        info["errors"]["mismatch"] = ""
    except RuntimeError as exc:
        info["errors"]["mismatch"] = str(exc)
    # Join with uneven steps: rank r runs r + 1 steps.
    for i in range(r + 1):
        keep(f"join:sum{i}", hvd.allreduce(T(np.full((2,), float(r + 1), np.float32)),
                                           name=f"join.sum{i}", op=hvd.Sum))
        keep(f"join:avg{i}", hvd.allreduce(T(np.full((2,), float(r + 1), np.float32)),
                                           name=f"join.avg{i}"))
    hvd.join()
    info["joined"] = True

if cfg["cases"] == "sets":
    keep("adasum", hvd.allreduce(T(X["ada"]), op=hvd.Adasum))
    for op in ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT"):
        keep(f"ar:f32:{op}", hvd.allreduce(T(X["f32"]), op=getattr(hvd.ReduceOp, op)))
    lo, hi = hvd.add_process_set([0, 1]), hvd.add_process_set([2, 3])
    mine = lo if r < 2 else hi
    keep("ps:sum", hvd.allreduce(T(X["f32"]), op=hvd.Sum, process_set=mine))
    keep("ps:gather", hvd.allgather(T(X["even"][:r % 2 + 1]), process_set=mine))
    keep("ps:bcast", hvd.broadcast(T(X["even"]), root_rank=mine.ranks[1], process_set=mine))
    keep("ps:rs", hvd.reducescatter(T(X["even"]), process_set=mine))
    info["ps_ids"] = [lo.process_set_id, hi.process_set_id]
    info["ps_obj"] = hvd.allgather_object(r, process_set=mine)
    try:
        hvd.broadcast(T(X["even"]), root_rank=(r + 2) % 4, process_set=mine)
    except ValueError as exc:
        info["errors"]["foreign_root"] = str(exc)
    hvd.barrier(process_set=mine)
    hvd.remove_process_set(lo)
    hvd.remove_process_set(hi)
    try:
        hvd.add_process_set([0, 1] if r != 3 else [0, 2])
        info["errors"]["divergent"] = ""
    except ValueError as exc:
        info["errors"]["divergent"] = str(exc)
    keep("after", hvd.allreduce(T(X["f32"]), op=hvd.Sum, name="after"))

if cfg["cases"] == "grid":
    ex = basics._runtime.eager.executor
    info["grid"] = ex.has_grid
    info["topo"] = [hvd.cross_rank(), hvd.cross_size(), hvd.local_rank(), hvd.local_size()]
    keep("hier:sum", hvd.allreduce(T(X["f32"]), op=hvd.Sum))
    keep("hier:avg", hvd.allreduce(T(X["f32"])))
    keep("hier:gather", hvd.allgather(T(X["even"])))
    keep("hier:gather_uneven", hvd.allgather(T(X["even"][:r + 1])))
    keep("hier:adasum", hvd.allreduce(T(X["ada"]), op=hvd.Adasum))

np.savez(f"{d}/rank{r}.npz", **out)
json.dump(info, open(f"{d}/info{r}.json", "w"))
hvd.shutdown()
'''


def _run(tmp_path_factory, tag: str, n: int, cases: str, grid: bool = False):
    d = tmp_path_factory.mktemp(tag)
    inputs = _rank_inputs(n)
    np.savez(d / "inputs.npz", **inputs)
    (d / "cfg.json").write_text(json.dumps({"cases": cases, "grid": grid}))
    run_ranks(MULTI_WORKER, n, d)
    return SimpleNamespace(
        n=n, inputs=inputs,
        port=[dict(np.load(d / f"rank{r}.npz")) for r in range(n)],
        info=[json.loads((d / f"info{r}.json").read_text()) for r in range(n)])


def _jax_ranks(fn, n: int, *arrays, axes=("data",), shape=None):
    """Each rank's result of ``fn`` (on its own row of every array) on a
    mesh of n CPU devices."""
    devs = np.array(jax.devices()[:n]).reshape(shape or (n,))
    mesh = Mesh(devs, axes)
    spec = P(axes if len(axes) > 1 else axes[0])
    body = _shard_map(lambda *xs: fn(*(x[0] for x in xs))[None], mesh,
                      in_specs=(spec,) * len(arrays), out_specs=spec)
    return np.asarray(jax.jit(body)(*(jnp.asarray(a) for a in arrays)))


@pytest.fixture(scope="module")
def flat2(tmp_path_factory):
    return _run(tmp_path_factory, "eager_flat2", 2, "flat")


@pytest.fixture(scope="module")
def sets4(tmp_path_factory):
    return _run(tmp_path_factory, "eager_sets4", 4, "sets")


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    return _run(tmp_path_factory, "eager_grid4", 4, "grid", grid=True)


def _jax_allreduce(dt: str, op: str, arr, n: int):
    a = jnp.asarray(arr).astype(jnp.bfloat16) if dt == "bf16" else jnp.asarray(arr)
    res = _jax_ranks(lambda x: jc.allreduce(x, op=getattr(JOp, op)), n, a)
    return res.astype(np.float32) if dt == "bf16" else res


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", DTYPES)
def test_allreduce_every_op_and_dtype_two_ranks(flat2, dt, op):
    """Against JAX's compiled collective. MIN/MAX/PRODUCT and the 2-rank
    half sums (one rounding) bitwise; f32 sums and averages at rtol 1e-5;
    integer AVERAGE truncates as JAX's does."""
    want = _jax_allreduce(dt, op, flat2.inputs[dt], 2)
    for r in range(2):
        got = flat2.port[r][f"ar:{dt}:{op}"]
        assert got.shape == want[r].shape
        if dt in ("f32",) and op in ("SUM", "AVERAGE"):
            np.testing.assert_allclose(got, want[r], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, want[r].astype(got.dtype), err_msg=f"rank {r}")
        if dt == "i64":
            assert got.dtype == np.int64     # JAX narrows to int32; the port keeps int64


def test_product_is_a_product_two_ranks(flat2):
    """The true product (JAX's compiled op), not the JAX eager path's sum."""
    x = flat2.inputs["f32"]
    for r in range(2):
        np.testing.assert_allclose(flat2.port[r]["ar:f32:PRODUCT"], x[0] * x[1], rtol=1e-6)
        assert not np.allclose(flat2.port[r]["ar:f32:PRODUCT"], x[0] + x[1])


def test_scaled_allreduce_two_ranks(flat2):
    x = flat2.inputs["scaled"]
    want = _jax_ranks(lambda v: jc.allreduce(v, op=JOp.SUM, prescale_factor=0.5,
                                             postscale_factor=3.0), 2, x)
    want_avg = _jax_ranks(lambda v: jc.allreduce(v, op=JOp.AVERAGE, prescale_factor=2.0), 2, x)
    for r in range(2):
        np.testing.assert_allclose(flat2.port[r]["ar:scaled"], want[r], rtol=1e-5)
        np.testing.assert_allclose(flat2.port[r]["ar:scaled_avg"], want_avg[r], rtol=1e-5)


def test_adasum_matches_jax(flat2, sets4):
    for job in (flat2, sets4):
        want = _jax_ranks(lambda v: jada.adasum_allreduce(v, axis_name="data"), job.n,
                          job.inputs["ada"])
        ref = jada.adasum_allreduce_reference(list(job.inputs["ada"]))
        for r in range(job.n):
            np.testing.assert_allclose(job.port[r]["adasum"], want[r], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(job.port[r]["adasum"], ref, rtol=1e-5, atol=1e-6)


def test_allgather_even_and_uneven_two_ranks(flat2):
    """Even: JAX's allgather. Uneven dim 0 (which a shard_map cannot take):
    the ranks' rows concatenated in rank order."""
    x = flat2.inputs["even"]
    want = _jax_ranks(lambda v: jc.allgather(v, axis_name="data"), 2, x)
    for r in range(2):
        np.testing.assert_array_equal(flat2.port[r]["allgather"], want[r])
        np.testing.assert_array_equal(flat2.port[r]["allgather_uneven"],
                                      np.concatenate([x[s][:s + 1] for s in range(2)]))
        np.testing.assert_array_equal(
            flat2.port[r]["allgather_uneven_u8"],
            np.concatenate([np.full((2 - s, 2), s, np.uint8) for s in range(2)]))


@pytest.mark.parametrize("root", [0, 1])
def test_broadcast_every_root_two_ranks(flat2, root):
    want = _jax_ranks(lambda v: jc.broadcast(v, root_rank=root, axis_name="data"), 2,
                      flat2.inputs["even"])
    for r in range(2):
        np.testing.assert_array_equal(flat2.port[r][f"broadcast:{root}"], want[r])


def test_alltoall_even_two_ranks(flat2):
    want = _jax_ranks(lambda v: jc.alltoall(v, axis_name="data"), 2, flat2.inputs["even"])
    for r in range(2):
        np.testing.assert_array_equal(flat2.port[r]["alltoall"], want[r])


def test_reducescatter_two_ranks(flat2):
    x = flat2.inputs["even"]
    want = _jax_ranks(lambda v: jc.reducescatter(v, axis_name="data"), 2, x)
    want_avg = _jax_ranks(lambda v: jc.reducescatter(v, op=JOp.AVERAGE, axis_name="data"), 2, x)
    total = x[:, :3].sum(axis=0)          # the uneven case: 3 rows, rank 0 keeps 2
    for r in range(2):
        np.testing.assert_allclose(flat2.port[r]["reducescatter"], want[r], rtol=1e-5)
        np.testing.assert_allclose(flat2.port[r]["reducescatter_avg"], want_avg[r], rtol=1e-5)
        np.testing.assert_allclose(flat2.port[r]["reducescatter_uneven"],
                                   total[:2] if r == 0 else total[2:], rtol=1e-5)


def test_alltoall_skewed_splits_bounded_carrier(flat2):
    n = 2
    splits = [[(s + 1) * 3] + [1] * (n - 1) for s in range(n)]
    rows = [np.arange(sum(sp) * 2, dtype=np.float32).reshape(-1, 2) + 100 * s
            for s, sp in enumerate(splits)]
    offs = [np.concatenate([[0], np.cumsum(sp)]) for sp in splits]
    for d in range(n):
        expect = np.concatenate([rows[s][offs[s][d]:offs[s][d + 1]] for s in range(n)])
        np.testing.assert_array_equal(flat2.port[d]["a2av"], expect)
        np.testing.assert_array_equal(flat2.port[d]["a2av_capped"], expect)
        np.testing.assert_array_equal(flat2.port[d]["a2av_splits"],
                                      [splits[s][d] for s in range(n)])
        assert flat2.info[d]["a2av_empty"] == [[0, 2], [0] * n]
    # factor 1: the carrier is capped at n * ceil(total / n^2) rows, not n * max.
    total = sum(sum(sp) for sp in splits)
    assert flat2.info[0]["carrier"] == n * -(-total // (n * n)) < n * 6


def test_grouped_ops_one_plan_two_ranks(flat2):
    g = flat2.inputs["grp"]
    for r in range(2):
        assert len(flat2.info[r]["grp_plans"]) == 1, flat2.info[r]["grp_plans"]
        assert sorted(flat2.info[r]["grp_plans"][0]) == [f"grp.{i}" for i in range(6)]
        for i in range(6):
            np.testing.assert_allclose(flat2.port[r][f"grp:{i}"], g[:, i].sum(axis=0), rtol=1e-6)
        np.testing.assert_array_equal(
            flat2.port[r]["gag:0"], np.concatenate([flat2.inputs["even"][s][:s + 1]
                                                    for s in range(2)]))
        np.testing.assert_array_equal(flat2.port[r]["gag:1"], g[:, 0].reshape(-1))
        want = _jax_ranks(lambda v: jc.reducescatter(v, axis_name="data"), 2,
                          flat2.inputs["even"])
        np.testing.assert_allclose(flat2.port[r]["grs:0"], want[r], rtol=1e-5)
        np.testing.assert_allclose(flat2.port[r]["grs:1"], g[:, 0].sum(axis=0)[2 * r:2 * r + 2],
                                   rtol=1e-6)


def test_object_ops_two_ranks(flat2):
    for r in range(2):
        assert flat2.info[r]["objs"] == [{"rank": s, "pad": "x" * s} for s in range(2)]
        assert flat2.info[r]["bobj"] == {"from": 1, "v": [1, 1, 1]}


def test_shape_mismatch_raises_core_message_on_every_rank(flat2):
    for r in range(2):
        msg = flat2.info[r]["errors"]["mismatch"]
        assert "mismatch" in msg and "shape" in msg.lower(), msg


def test_join_uneven_ranks_participants_divisor(flat2):
    """Rank r runs r + 1 steps; a joined rank contributes zeros and AVERAGE
    divides by the ranks still submitting."""
    n = 2
    for r in range(n):
        assert flat2.info[r]["joined"]
        for i in range(r + 1):
            live = [s for s in range(n) if s >= i]
            np.testing.assert_array_equal(flat2.port[r][f"join:sum{i}"],
                                          np.full(2, float(sum(s + 1 for s in live))))
            np.testing.assert_allclose(flat2.port[r][f"join:avg{i}"],
                                       np.full(2, sum(s + 1 for s in live) / len(live)))


def test_disjoint_process_sets_four_ranks(sets4):
    x, e = sets4.inputs["f32"], sets4.inputs["even"]
    sub = {0: [0, 1], 1: [0, 1], 2: [2, 3], 3: [2, 3]}
    for r in range(4):
        members = sub[r]
        want = _jax_ranks(lambda v: jc.allreduce(v, op=JOp.SUM, axis_name="data"), 2, x[members])
        np.testing.assert_allclose(sets4.port[r]["ps:sum"], want[0], rtol=1e-5)
        np.testing.assert_array_equal(sets4.port[r]["ps:gather"],
                                      np.concatenate([e[s][:s % 2 + 1] for s in members]))
        np.testing.assert_array_equal(sets4.port[r]["ps:bcast"], e[members[1]])
        rs = _jax_ranks(lambda v: jc.reducescatter(v, axis_name="data"), 2, e[members])
        np.testing.assert_allclose(sets4.port[r]["ps:rs"], rs[members.index(r)], rtol=1e-5)
        assert sets4.info[r]["ps_ids"] == [1, 2]
        assert sets4.info[r]["ps_obj"] == members
        assert "not a rank" in sets4.info[r]["errors"]["foreign_root"]


def test_divergent_registration_fails_on_every_rank(sets4):
    for r in range(4):
        assert "identically on every rank" in sets4.info[r]["errors"]["divergent"]
        # The job goes on: a global allreduce after the failed registration.
        np.testing.assert_allclose(sets4.port[r]["after"], sets4.inputs["f32"].sum(axis=0),
                                   rtol=1e-5)


@pytest.mark.parametrize("op", OPS)
def test_allreduce_four_ranks(sets4, op):
    want = _jax_allreduce("f32", op, sets4.inputs["f32"], 4)
    for r in range(4):
        np.testing.assert_allclose(sets4.port[r][f"ar:f32:{op}"], want[r], rtol=1e-5)


def test_hierarchical_knobs_on_the_grid(grid4):
    """(cross 2, local 2) with HOROVOD_HIERARCHICAL_ALLREDUCE/ALLGATHER: the
    two-level schedules give the flat results; Adasum on the grid runs the
    hierarchical exchange between node averages."""
    x, e, a = grid4.inputs["f32"], grid4.inputs["even"], grid4.inputs["ada"]
    hier = _jax_ranks(lambda v: jc.hierarchical_allreduce(v, op=JOp.SUM), 4, x,
                      axes=("cross", "local"), shape=(2, 2))
    ada = _jax_ranks(lambda v: jada.hierarchical_adasum_allreduce(v / 2), 4, a,
                     axes=("cross", "local"), shape=(2, 2))
    ref = jada.hierarchical_adasum_reference(list(a / 2), local_size=2)
    for r in range(4):
        assert grid4.info[r]["grid"]
        assert grid4.info[r]["topo"] == [r // 2, 2, r % 2, 2]
        np.testing.assert_allclose(grid4.port[r]["hier:sum"], hier[r], rtol=1e-5)
        np.testing.assert_allclose(grid4.port[r]["hier:avg"], hier[r] / 4, rtol=1e-5)
        np.testing.assert_array_equal(grid4.port[r]["hier:gather"], e.reshape(-1, 3))
        np.testing.assert_array_equal(grid4.port[r]["hier:gather_uneven"],
                                      np.concatenate([e[s][:s + 1] for s in range(4)]))
        np.testing.assert_allclose(grid4.port[r]["hier:adasum"], ada[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grid4.port[r]["hier:adasum"], ref, rtol=1e-5, atol=1e-6)
