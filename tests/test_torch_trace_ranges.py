"""The hook-driven path's tracing in one process on the native core and
the ``LocalPlanExecutor``:

- under a ``torch.profiler`` session the binding, the runtime and the
  executor open their ranges with these names and this nesting, and
  ``hvd.enqueue`` carries the tensor's name;
- with no session and both taps off, none of them builds a
  ``RecordFunction``;
- every plan's stamps are ordered: enqueue <= ``taken_ns``;
- a ring span and a profiler range opened together line up once the
  profiler's ``trace_start_ns`` is added.

The two-rank gloo job of ``tests/test_torch_binding.py`` holds the
executor's ``hvd.pack``/``hvd.allreduce``/``hvd.unpack`` ranges.
"""

import sys
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch import trace as port_trace

STEPS = 3
PORT = "horovod_tpu_torch"


@pytest.fixture(autouse=True)
def _one_process():
    port_trace.reset()
    port_metrics.reset()
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    port_trace.reset()
    port_metrics.reset()


@pytest.fixture
def built(monkeypatch):
    """(name, args) of every ``record_function`` the port's code builds."""
    seen = []
    init = autograd_profiler.record_function.__init__

    def spy(self, name, args=None):
        if PORT in sys._getframe(1).f_code.co_filename:
            seen.append((name, args))
        init(self, name, args)

    monkeypatch.setattr(autograd_profiler.record_function, "__init__", spy)
    return seen


def _model():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 1))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   named_parameters=m.named_parameters())
    x = torch.randn(8, 6)

    def step():
        opt.zero_grad()
        m(x).square().mean().backward()
        opt.step()

    return m, step


def _all_threads():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _ranges(prof):
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("hvd")]


def _inside(inner, outer):
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def test_ranges_have_their_names_and_nesting(built):
    m, step = _model()
    step()
    with _all_threads() as prof:
        for _ in range(STEPS):
            step()
    ranges = _ranges(prof)
    by = {}
    for r in ranges:
        key = "hvd_plan" if r[0].startswith("hvd_plan_") else r[0]
        by.setdefault(key, []).append(r)
    n_params = len(list(m.parameters()))
    assert len(by["hvd.enqueue"]) == n_params * STEPS
    assert len(by["hvd.sync"]) == STEPS
    assert len(by["hvd.sync.copyback"]) == STEPS
    assert by["hvd.sync.wait"] and by["hvd_plan"]
    for r in by["hvd.sync.copyback"]:
        assert any(_inside(r, s) for s in by["hvd.sync"]), r
    # Every wait of the step is one of the write-back loop's.
    for r in by["hvd.sync.wait"]:
        assert any(_inside(r, c) for c in by["hvd.sync.copyback"]), r
    # hvd.sync.wait is a leaf: a plan run inline by the caller is outside it.
    for w in by["hvd.sync.wait"]:
        assert not [r for r in ranges if r is not w and _inside(r, w)], w
    sync_thread = by["hvd.sync"][0][1]
    for p in by["hvd_plan"]:
        if p[1] == sync_thread:
            assert any(_inside(p, s) for s in by["hvd.sync"]), p
    names = {f"DistributedOptimizer.{n}" for n, _ in m.named_parameters()}
    enqueued = {args for name, args in built if name == "hvd.enqueue"}
    assert enqueued == names


def test_no_range_without_a_profiler_session(built):
    assert not port_trace.ACTIVE and not port_metrics.ACTIVE
    _, step = _model()
    for _ in range(STEPS):
        step()
    hvd.allreduce(torch.ones(3), name="plain")
    assert built == []
    assert port_trace.profiled("hvd.sync") is port_trace.profiled("hvd.pack")


def test_plan_stamps_are_ordered():
    port_trace.install(True)
    port_metrics.install(True)
    _, step = _model()
    for _ in range(STEPS):
        step()
    handles = [hvd.allreduce_async(torch.full((4,), float(i)), name=f"t{i}") for i in range(5)]
    for h in handles:
        hvd.synchronize(h)
    plans = [e for e in port_trace.TAP.window()["events"] if e["name"] == "hvd_plan"]
    assert len(plans) >= STEPS + 1
    for e in plans:
        a = e["args"]
        assert a["enqueue_first_ns"] <= a["enqueue_last_ns"] <= a["taken_ns"], a
        assert e["ts"] == a["taken_ns"] / 1e9 and e["dur"] >= 0
    snap = port_metrics.snapshot()
    negotiated = snap["hvd_op_negotiate_seconds"]["series"]
    assert sum(s["count"] for s in negotiated) == sum(e["args"]["tensors"] for e in plans)
    assert min(s["sum"] for s in negotiated) >= 0


def test_ring_span_and_profiler_range_line_up():
    port_trace.install(True)
    _, step = _model()
    step()
    with _all_threads() as prof:
        with port_trace.profiled("warm-up"):
            pass
        step()
        with port_trace.TAP.span("probe"), port_trace.profiled("probe"):
            time.sleep(0.005)
        warm = {e["args"]["plan"] for e in port_trace.TAP.window()["events"]
                if e["name"] == "hvd_plan"}
        for _ in range(STEPS):
            step()
    base_s = prof.profiler.kineto_results.trace_start_ns() / 1e9
    events = {e.name: e for e in prof.events()}
    window = port_trace.TAP.window()["events"]
    (ring,) = [e for e in window if e["name"] == "probe"]
    probe = events["probe"]
    assert abs(base_s + probe.time_range.start / 1e6 - ring["ts"]) < 1e-3
    assert abs(base_s + probe.time_range.end / 1e6 - (ring["ts"] + ring["dur"])) < 1e-3
    plans = [e for e in window if e["name"] == "hvd_plan" and e["args"]["plan"] not in warm]
    assert plans
    starts = [base_s + events[e["args"]["plan"]].time_range.start / 1e6 - e["ts"]
              for e in plans]
    assert np.max(np.abs(starts)) < 1e-3, starts
