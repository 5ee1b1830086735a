"""The port's eager static checks (``horovod_tpu_torch.analysis``) against
the JAX package's.

The same traces and groups go through both packages and the findings must
be equal, rule, severity, location and message: the cross-rank ordering
lint on hand-written traces and on ranks simulated through each package's
own eager API (the name registry included), the grouped-collective checks
on numpy arrays and on torch tensors against the same arrays in JAX, the
fusion-plan check, the JSON form, and the opt-in pre-flight
(``HOROVOD_TPU_STATIC_CHECKS``): the submission ledger, the grouped check
before any member is enqueued, and ``verify_cross_rank_order``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.analysis import findings as jfind
from horovod_tpu.analysis import groups as jgroups
from horovod_tpu.analysis import ordering as jorder
from horovod_tpu.analysis import preflight as jpre

import horovod_tpu_torch as hvd
from horovod_tpu_torch.analysis import findings as tfind
from horovod_tpu_torch.analysis import groups as tgroups
from horovod_tpu_torch.analysis import ordering as torder
from horovod_tpu_torch.analysis import preflight as tpre


def _key(findings):
    return [(f.rule, f.severity, f.location, f.message, f.details) for f in findings]


def _traces(mod, spec):
    return {r: [mod.CollectiveCall(*c) for c in calls] for r, calls in spec.items()}


TRACES = {
    "agree": {0: [("allreduce", "a", 0, "float32", (4,))] * 2,
              1: [("allreduce", "a", 0, "float32", (4,))] * 2},
    "order": {0: [("allreduce", "grad.w", 0, "float32", (4,)),
                  ("allreduce", "grad.b", 0, "float32", (4,))],
              1: [("allreduce", "grad.b", 0, "float32", (4,)),
                  ("allreduce", "grad.w", 0, "float32", (4,))]},
    "missing": {0: [("allreduce", "a", 0, "float32", (4,)),
                    ("allgather", "b", 0, "float32", (4,))],
                1: [("allreduce", "a", 0, "float32", (4,))]},
    "signature": {0: [("allreduce", "g", 0, "float32", (4,))],
                  1: [("allreduce", "g", 0, "float32", (8,))]},
    "per_set": {0: [("allreduce", "a", 1, "float32", (4,)), ("allreduce", "x", 2, "float32", (4,))],
                1: [("allreduce", "x", 2, "float32", (4,)), ("allreduce", "a", 1, "float32", (4,))]},
    "three_ranks": {0: [("broadcast", "p", 0, "int32", (2,))],
                    1: [("broadcast", "p", 0, "int32", (2,))],
                    2: [("broadcast", "q", 0, "int32", (2,))]},
}


@pytest.mark.parametrize("case", list(TRACES))
def test_cross_rank_order_findings_equal_jax(case):
    got = torder.check_cross_rank_order(_traces(torder, TRACES[case]))
    want = jorder.check_cross_rank_order(_traces(jorder, TRACES[case]))
    assert _key(got) == _key(want)
    assert bool(got) == (case not in ("agree", "per_set"))


def _program(h, arr, ps_ranks=None):
    """One rank's eager program, written against package ``h``."""
    def fn():
        a = arr(np.ones(4, np.float32))
        h.allreduce(a)                                        # auto name
        h.allgather(arr(np.ones((2, 3), np.float32)), name="ag.x")
        if h.rank() == 1:
            h.broadcast(a, 0, name="second")
            h.allreduce(a, name="first")
        else:
            h.allreduce(a, name="first")
            h.broadcast(a, 0, name="second")
        h.grouped_allreduce([a, a], name="grp")
        h.allgather_object({"r": h.rank()})
        if ps_ranks is not None:
            ps = h.add_process_set(ps_ranks)
            if ps.included():
                h.allreduce(arr(np.ones(3, np.int32)), name="ps.sum", process_set=ps)
            h.barrier()
        if h.rank() == 0:
            h.allreduce(a, name="only.rank0")
    return fn


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_simulated_traces_and_findings_equal_jax(size, form):
    arr = (lambda x: x) if form == "numpy" else torch.from_numpy
    got_traces = torder.simulate_ranks(_program(hvd, arr, [0, 1]), size)
    want_traces = jorder.simulate_ranks(_program(jhvd, lambda x: x, [0, 1]), size)
    assert {r: [tuple(vars(c).values()) for c in t] for r, t in got_traces.items()} == {
        r: [tuple(vars(c).values()) for c in t] for r, t in want_traces.items()}
    got = torder.check_cross_rank_order(got_traces)
    assert _key(got) == _key(jorder.check_cross_rank_order(want_traces))
    assert {f.rule for f in got} >= {tfind.RULE_ORDER_MISMATCH}
    assert not hvd.is_initialized()          # the simulation left nothing behind


GROUPS = {
    "mixed": ([np.ones(4, np.float32), np.ones(4, np.float16)], None),
    "budget": ([np.ones(1024, np.float32)] * 2, 4096),
    "clean": ([np.ones(8, np.float32)] * 3, 1 << 20),
    "both": ([np.ones(600, np.float32), np.ones(600, np.int32)], 1024),
    "specs": ([("float32", 100), ("bfloat16", 40)], 120),
}


@pytest.mark.parametrize("case", list(GROUPS))
def test_group_findings_equal_jax(case):
    tensors, thr = GROUPS[case]
    want = jgroups.check_group(tensors, threshold_bytes=thr, name=case)
    assert _key(tgroups.check_group(tensors, threshold_bytes=thr, name=case)) == _key(want)
    if case != "specs":
        as_torch = [torch.from_numpy(t) for t in tensors]
        as_jax = [jnp.asarray(t) for t in tensors]
        assert _key(tgroups.check_group(as_torch, threshold_bytes=thr, name=case)) == _key(
            jgroups.check_group(as_jax, threshold_bytes=thr, name=case))


def test_bf16_group_findings_equal_jax():
    t = [torch.ones(4, dtype=torch.bfloat16), torch.ones(4)]
    j = [jnp.ones(4, jnp.bfloat16), jnp.ones(4)]
    assert _key(tgroups.check_group(t, name="b")) == _key(jgroups.check_group(j, name="b"))


def test_fusion_plan_findings_equal_jax():
    leaves = [np.ones(n, np.float32) for n in (10, 300, 20, 5000, 7)]
    got = tgroups.check_fusion_plan([torch.from_numpy(x) for x in leaves], 2048)
    want = jgroups.check_fusion_plan([jnp.asarray(x) for x in leaves], 2048)
    assert _key(got) == _key(want)


def test_findings_json_equal_jax():
    def make(mod):
        return [mod.Finding(rule="b-rule", severity="warning", message="w", location="z",
                            details={"k2": 1, "k1": 2}),
                mod.Finding(rule="a-rule", severity="error", message="e", location="a")]

    assert tfind.findings_to_json(make(tfind)) == jfind.findings_to_json(make(jfind))
    doc = json.loads(tfind.findings_to_json(make(tfind)))
    assert doc["summary"] == {"total": 2, "errors": 1, "warnings": 1}
    assert [f.render() for f in make(tfind)] == [f.render() for f in make(jfind)]


def test_suppressions_filter_alike():
    fs = torder.check_cross_rank_order(_traces(torder, TRACES["order"]))
    with tfind.suppressions("cross-rank-order@order:*"):
        assert tfind.apply_suppressions(fs) == []
    assert tfind.apply_suppressions(fs, suppress=["other-rule"]) == fs


# --- the pre-flight ---


@pytest.fixture()
def checks_on(monkeypatch):
    monkeypatch.setattr(tpre, "_enabled_cache", True)
    monkeypatch.setattr(jpre, "_enabled_cache", True)
    tpre.clear_ledger()
    jpre.clear_ledger()
    jhvd.shutdown()
    hvd.shutdown()
    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jhvd.shutdown()
    tpre._reset_for_tests(None)
    jpre._reset_for_tests(None)


def test_enabled_reads_the_knob(monkeypatch):
    tpre._reset_for_tests(None)
    monkeypatch.setenv("HOROVOD_TPU_STATIC_CHECKS", "1")
    assert tpre.enabled()
    tpre._reset_for_tests(None)
    monkeypatch.setenv("HOROVOD_TPU_STATIC_CHECKS", "0")
    assert not tpre.enabled()
    tpre._reset_for_tests(None)


def test_ledger_records_like_jax(checks_on):
    for h in (hvd, jhvd):
        x = np.ones((2, 3), np.float32)
        h.allreduce(x, name="l.a")
        h.allgather(x, name="l.g")
        h.broadcast(np.arange(4, dtype=np.int32), 0, name="l.b")
        h.reducescatter(x, name="l.rs")
        h.alltoall(x, name="l.a2a")
    assert tpre.ledger() == [torder.CollectiveCall(*vars(c).values()) for c in jpre.ledger()]
    assert [c.op for c in tpre.ledger()] == ["allreduce", "allgather", "broadcast",
                                             "reducescatter", "alltoall"]
    tpre.clear_ledger()
    assert tpre.ledger() == []
    hvd.allreduce(torch.ones(3, dtype=torch.bfloat16), name="l.bf16")
    assert tpre.ledger()[0].dtype == "bfloat16"


def test_grouped_preflight_raises_before_enqueue(checks_on):
    for h, err in ((hvd, tfind.CollectiveSafetyError), (jhvd, jfind.CollectiveSafetyError)):
        with pytest.raises(err) as exc:
            h.grouped_allreduce([np.ones(4, np.float32), np.ones(4, np.float16)],
                                name="pf.mixed")
        assert tfind.RULE_GROUP_DTYPE in str(exc.value)
    assert all(not c.name.startswith("pf.mixed") for c in tpre.ledger())


def test_verify_cross_rank_order(checks_on):
    hvd.allreduce(np.ones(4, np.float32), name="v.a")
    mine = tpre.ledger()

    def gather_same(payload, name):
        return [payload, payload]

    assert tpre.verify_cross_rank_order(gather_same) == []

    def gather_diverged(payload, name):
        other = [("allreduce", "v.other", 0, "float32", (4,))]
        return [payload, other]

    with pytest.raises(tfind.CollectiveSafetyError, match="v.other"):
        tpre.verify_cross_rank_order(gather_diverged)
    # Through the real allgather_object of a one-rank job.
    assert tpre.verify_cross_rank_order() == [] and tpre.ledger()[:1] == mine
