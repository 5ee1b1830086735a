"""The port's ctypes binding to the native core (``common/native.py``).

The cases of tests/test_native_core.py through the port's own copy of the
binding and its own build of ``cpp/src``: fusion, the threshold, a
ticket's lifecycle and errors, duplicate names, broadcast not fused, the
join plan, the response cache, grouped holds, the threshold exemption and
the split count. Then what is the port's alone: the library builds into
``horovod_tpu_torch/build/`` keyed by the sources and flags, a failed build
raises with the compiler's output, and the JAX package's core and the
port's run side by side in one process as two separate cores.
"""

import os
import time

import pytest

import horovod_tpu as jhvd
from horovod_tpu.common import basics as jbasics

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import native
from horovod_tpu_torch.common.env import Config
from horovod_tpu_torch.common.native import NativeCore, _CoreError
from horovod_tpu_torch.common.topology import Topology

SINGLE = Topology(rank=0, size=1, local_rank=0, local_size=1)


@pytest.fixture()
def core(monkeypatch):
    hvd.shutdown()      # the core is a per-library singleton
    # A generous fusion window so a loaded host's enqueue gaps cannot split
    # one burst across cycles.
    monkeypatch.setenv("HOROVOD_TPU_LINGER_US", "20000")
    c = NativeCore()
    cfg = Config()
    cfg.cycle_time_ms = 50.0
    c.init(cfg, SINGLE)
    yield c
    c.shutdown()


def _fresh(**fields):
    hvd.shutdown()
    c = NativeCore()
    cfg = Config()
    cfg.cycle_time_ms = 1.0
    for k, v in fields.items():
        setattr(cfg, k, v)
    c.init(cfg, SINGLE)
    return c


def _drain_plans(core, max_plans=10, timeout_ms=500):
    plans = []
    deadline = time.monotonic() + timeout_ms / 1000.0
    while time.monotonic() < deadline and len(plans) < max_plans:
        p = core.next_plan(timeout_ms=50)
        if isinstance(p, dict):
            plans.append(p)
            core.plan_done(p["id"], 0, "", 0.001, int(p.get("total_bytes", 0)))
        elif p == -1:
            break
    return plans


def _wait_ticket(core, t, timeout=2.0):
    deadline = time.monotonic() + timeout
    state, err = 0, ""
    while time.monotonic() < deadline:
        state, err = core.ticket_status(t)
        if state != 0:
            break
        time.sleep(0.005)
    return state, err


def test_fusion_groups_same_dtype(core):
    for i in range(3):
        core.enqueue(0, f"t{i}", 7, [4, 4], -1, 2, 1.0, 1.0)
    core.enqueue(0, "t_int", 4, [8], -1, 2, 1.0, 1.0)
    by_names = {tuple(sorted(p["names"])): p for p in _drain_plans(core, max_plans=4)}
    assert ("t0", "t1", "t2") in by_names and ("t_int",) in by_names, by_names
    fused = by_names[("t0", "t1", "t2")]
    assert fused["total_bytes"] == 3 * 16 * 4
    assert fused["shapes"] == [[4, 4], [4, 4], [4, 4]]


def test_fusion_respects_threshold():
    c = _fresh(fusion_threshold_bytes=100)   # 2 x 16 floats do not fit
    try:
        c.enqueue(0, "a", 7, [16], -1, 2, 1.0, 1.0)
        c.enqueue(0, "b", 7, [16], -1, 2, 1.0, 1.0)
        plans = _drain_plans(c, max_plans=2)
        assert len(plans) == 2 and all(len(p["names"]) == 1 for p in plans)
    finally:
        c.shutdown()


def test_ticket_lifecycle(core):
    t = core.enqueue(0, "x", 7, [2], -1, 2, 1.0, 1.0)
    assert t > 0
    assert _drain_plans(core, max_plans=1)
    assert _wait_ticket(core, t)[0] == 1


def test_ticket_error_propagates(core):
    t = core.enqueue(0, "bad", 7, [2], -1, 2, 1.0, 1.0)
    p, deadline = None, time.monotonic() + 2
    while time.monotonic() < deadline and not isinstance(p, dict):
        p = core.next_plan(timeout_ms=50)
    core.plan_done(p["id"], 1, "boom", 0.0, 0)
    state, err = _wait_ticket(core, t)
    assert state < 0 and "boom" in err


def test_duplicate_name_rejected_at_core(core):
    core.enqueue(0, "dup", 7, [2], -1, 2, 1.0, 1.0)
    with pytest.raises(_CoreError):
        core.enqueue(0, "dup", 7, [2], -1, 2, 1.0, 1.0)
    _drain_plans(core, max_plans=1)


def test_broadcast_not_fused(core):
    core.enqueue(2, "b0", 7, [4], 0, 2, 1.0, 1.0)
    core.enqueue(2, "b1", 7, [4], 0, 2, 1.0, 1.0)
    plans = _drain_plans(core, max_plans=2)
    assert len(plans) == 2 and all(p["type"] == 2 and p["root"] == 0 for p in plans)


def test_join_plan_roundtrip(core):
    t = core.enqueue_join()
    p, deadline = None, time.monotonic() + 2
    while time.monotonic() < deadline and not isinstance(p, dict):
        p = core.next_plan(timeout_ms=50)
    assert isinstance(p, dict) and p["type"] == 3
    core.plan_done(p["id"], 0, "", 0.0, 0)
    assert _wait_ticket(core, t)[0] == 1


def test_response_cache_roundtrip(core):
    core.enqueue(0, "cached", 7, [8], -1, 2, 1.0, 1.0)
    assert _drain_plans(core, max_plans=1) and core.cache_size() >= 1
    t = core.enqueue(0, "cached", 7, [8], -1, 2, 1.0, 1.0)   # a cache bit this time
    plans = _drain_plans(core, max_plans=1)
    assert plans and plans[0]["names"] == ["cached"] and plans[0]["shapes"] == [[8]]
    assert _wait_ticket(core, t)[0] == 1


def test_grouped_requests_hold_until_complete(core):
    gid = 77
    core.enqueue(0, "g.0", 7, [4], -1, 2, 1.0, 1.0, gid, 3)
    assert _drain_plans(core, max_plans=1, timeout_ms=120) == []
    core.enqueue(0, "g.1", 7, [4], -1, 2, 1.0, 1.0, gid, 3)
    assert _drain_plans(core, max_plans=1, timeout_ms=120) == []
    core.enqueue(0, "g.2", 7, [4], -1, 2, 1.0, 1.0, gid, 3)
    plans = _drain_plans(core, max_plans=2, timeout_ms=500)
    assert len(plans) == 1 and sorted(plans[0]["names"]) == ["g.0", "g.1", "g.2"], plans


def test_grouped_fusion_exempt_from_threshold(core):
    core.shutdown()
    c = _fresh(fusion_threshold_bytes=16)
    try:
        for i in range(3):
            c.enqueue(0, f"big.{i}", 7, [64], -1, 2, 1.0, 1.0, 88, 3)
        plans = _drain_plans(c, max_plans=3, timeout_ms=500)
        assert len(plans) == 1 and len(plans[0]["names"]) == 3, plans
    finally:
        c.shutdown()


def test_grouped_heterogeneous_dtypes_split_counted(core):
    before = core.grouped_splits()
    core.enqueue(0, "mix.0", 7, [4], -1, 2, 1.0, 1.0, 99, 2)   # f32
    core.enqueue(0, "mix.1", 4, [4], -1, 2, 1.0, 1.0, 99, 2)   # i32
    assert len(_drain_plans(core, max_plans=3, timeout_ms=500)) == 2
    assert core.grouped_splits() == before + 1


def test_process_set_registration_at_core(core):
    core.register_process_set(5, [0])
    t = core.enqueue(0, "ps.x", 7, [2], -1, 2, 1.0, 1.0, 0, 0, 5)
    plans = _drain_plans(core, max_plans=1)
    assert plans and plans[0]["process_set"] == 5
    assert _wait_ticket(core, t)[0] == 1
    core.remove_process_set(5)
    with pytest.raises(_CoreError, match="not registered"):
        core.enqueue(0, "ps.y", 7, [2], -1, 2, 1.0, 1.0, 0, 0, 5)


# --- the port's build and the two cores --------------------------------------


def test_library_builds_into_the_port_keyed_by_sources_and_flags(monkeypatch):
    """The key covers the sources, the flags and the compiler's version, and
    the C++ runtime is linked in (no shared libstdc++ dependence)."""
    path = native.ensure_built()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libhvd_core-") and path.endswith(".so")
    mtime = os.path.getmtime(path)
    assert native.ensure_built() == path and os.path.getmtime(path) == mtime   # cached
    assert native.library_path() == path
    assert "-static-libstdc++" in native.LINK_FLAGS and "-static-libgcc" in native.LINK_FLAGS
    monkeypatch.setattr(native, "COMPILE_FLAGS", native.COMPILE_FLAGS + ("-DHVD_KEY_TEST",))
    flagged = native.library_path()
    assert flagged != path                    # another flag, another library
    monkeypatch.setattr(native, "_compiler_version", lambda cxx: "0.0.1")
    assert native.library_path() not in (path, flagged)   # another compiler too


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "COMPILE_FLAGS", native.COMPILE_FLAGS + ("-DHVD_BROKEN",
                                                                         "--no-such-flag"))
    with pytest.raises(native.NativeCoreUnavailable, match="g\\+\\+ failed on cpp/src/"):
        native.ensure_built()
    assert not any(p.endswith(".so") for p in os.listdir(tmp_path))


def test_jax_core_and_port_core_in_one_process():
    """Two cores side by side: each library has its own Core singleton, so
    each sees only its own requests and outlives the other's shutdown."""
    jhvd.shutdown()
    hvd.shutdown()
    jcore, tcore = jbasics.NativeCore(), NativeCore()
    assert os.path.realpath(jbasics._LIB_PATH) != os.path.realpath(native.library_path())
    from horovod_tpu.common.env import Config as JConfig
    from horovod_tpu.common.topology import Topology as JTopology

    jcfg, tcfg = JConfig(), Config()
    jcfg.cycle_time_ms = tcfg.cycle_time_ms = 1.0
    jcore.init(jcfg, JTopology(rank=0, size=1, local_rank=0, local_size=1, cross_rank=0,
                               cross_size=1))
    tcore.init(tcfg, SINGLE)
    try:
        assert jcore.initialized() and tcore.initialized()
        jcore.enqueue(0, "from_jax", 7, [2], -1, 2, 1.0, 1.0)
        tcore.enqueue(0, "from_port", 7, [3], -1, 2, 1.0, 1.0)
        jplans, tplans = _drain_plans(jcore, 1), _drain_plans(tcore, 1)
        assert [p["names"] for p in jplans] == [["from_jax"]]
        assert [p["names"] for p in tplans] == [["from_port"]]
        jcore.shutdown()
        assert not jcore.initialized() and tcore.initialized()
        t = tcore.enqueue(0, "after", 7, [1], -1, 2, 1.0, 1.0)
        assert _drain_plans(tcore, 1) and _wait_ticket(tcore, t)[0] == 1
    finally:
        jcore.shutdown()
        tcore.shutdown()


def test_jax_runtime_and_port_runtime_together():
    """The two packages' eager APIs initialized at once in one process."""
    import numpy as np

    jhvd.shutdown()
    hvd.shutdown()
    jhvd.init()
    hvd.init(device="cpu")
    try:
        x = np.arange(4, dtype=np.float32)
        np.testing.assert_array_equal(hvd.allreduce(x, name="both"), np.asarray(
            jhvd.allreduce(x, name="both")))
        hvd.shutdown()
        assert jhvd.is_initialized()
        np.testing.assert_array_equal(np.asarray(jhvd.allreduce(x, name="again")), x)
    finally:
        hvd.shutdown()
        jhvd.shutdown()


def test_reference_core_build_waits_for_the_lock():
    """The harness makes the JAX package's lazy in-place build of
    ``cpp/libhvd_core.so`` one process at a time: a loader waits while
    another process holds the lock, so it never opens a library that a
    concurrent ``make`` is still linking (a segmentation fault in an xdist
    worker otherwise)."""
    import fcntl
    import threading

    import torch_port_harness

    assert getattr(jbasics.ensure_built, "serialized", False)
    lock_path = os.path.join(torch_port_harness.REPO, "horovod_tpu_torch", "build",
                             "reference_core.lock")
    os.makedirs(os.path.dirname(lock_path), exist_ok=True)
    got = []
    with open(lock_path, "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        t = threading.Thread(target=lambda: got.append(jbasics.ensure_built()), daemon=True)
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive() and not got
    t.join(timeout=300)
    assert got and os.path.exists(got[0]) and got[0].endswith("libhvd_core.so")
