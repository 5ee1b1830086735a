"""The port's fleet trace (horovod_tpu_torch/trace) and Python timeline
(horovod_tpu_torch/utils/timeline.py) against the JAX package's:

- the JAX package's own tap, ring, flight-recorder, excepthook, skew,
  merge and timeline tests (tests/test_trace.py), run against the port's
  modules (``wrap_step(f) is f`` when off, the bounded ring, the dumps, the
  restart of ``start_timeline``/``stop_timeline`` on the port's runtime);
- the same windows merged by both packages into the same JSON bytes (live
  view, postmortem, ``--stats``; the two ``trace_merge`` tools);
- the port's ``TracePusher`` against the port's KV server and the JAX
  one, and ``StepSkewTracker`` against JAX's on seeded windows;
- the Python runtime's timeline for a fixed op sequence: the same event
  names and phases, in the same order, as the JAX Python runtime's;
- ``make_train_step``'s step spans and plan notes with the tap on.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import metrics as jax_metrics
from horovod_tpu import trace as jax_trace
from horovod_tpu.run.http_server import KVStoreServer as JaxKVServer
from horovod_tpu.trace import merge as jax_merge
from horovod_tpu.trace import pusher as jax_pusher

import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch import trace as port_trace
from horovod_tpu_torch.run.http_server import KVStoreServer
from horovod_tpu_torch.trace import merge as port_merge
from horovod_tpu_torch.trace import pusher as port_pusher
from horovod_tpu_torch.utils import timeline as port_timeline

import test_trace as ref_tests
from torch_port_harness import run_reference_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _taps_off():
    for m in (port_trace, port_metrics, jax_trace, jax_metrics):
        m.reset()
    yield
    for m in (port_trace, port_metrics, jax_trace, jax_metrics):
        m.reset()


PORTABLE = [
    "test_disabled_tap_is_shared_noop_singleton", "test_wrap_step_is_identity_when_disabled",
    "test_install_and_reset_swap_the_singleton", "test_activate_from_env",
    "test_wrap_step_records_spans_with_meta_and_plan_args", "test_ring_is_bounded",
    "test_commit_step_spans_between_commits_and_defers_to_wrapped",
    "test_span_contextmanager_and_timeline_mirror", "test_flight_dump_atomic_and_counted",
    "test_flight_dump_without_dir_is_safe", "test_excepthook_dumps_on_uncaught",
    "test_clock_estimate_unreachable_returns_none", "test_skew_tracker_attributes_worst_rank_once",
    "test_skew_tracker_waits_for_all_ranks_and_single_rank_noop",
    "test_merge_windows_lanes_clock_and_determinism",
    "test_merge_postmortem_death_markers_and_window_trim",
    "test_read_flight_dumps_prefers_driver_bundle",
    "test_load_chrome_trace_tolerates_unterminated",
    "test_timeline_writer_crash_warns_once_and_counts_drops",
    "test_timeline_writer_crash_counts_queued_backlog",
    "test_timeline_shutdown_join_timeout_detected", "test_timeline_emit_mirrors_into_trace_ring",
    "test_start_stop_timeline_restart_cycle_two_loadable_traces",
    "test_second_start_timeline_rejected_while_active",
]

# The port's top-level API where the reference tests call ``hvd``: init on
# the CPU.
_PORT_HVD = SimpleNamespace(**{k: getattr(hvd, k) for k in dir(hvd) if not k.startswith("_")})
_PORT_HVD.init = lambda: hvd.init(device="cpu")


@pytest.mark.parametrize("name", PORTABLE)
def test_reference_trace_test_holds_for_the_port(name, request):
    run_reference_test(ref_tests, name, {
        "hvd_trace": port_trace, "hvd_metrics": port_metrics, "tmerge": port_merge,
        "tpush": port_pusher, "Timeline": port_timeline.Timeline,
        "TimelineWriter": port_timeline.TimelineWriter, "hvd": _PORT_HVD,
    }, request)
    hvd.shutdown()


def _windows(seed: int = 0, ranks: int = 3):
    """Seeded rank windows in ``TraceTap.window()``'s shape, with steps,
    spans, instants, timeline-mirrored records, clocks and event logs."""
    rng = np.random.RandomState(seed)
    out = {}
    t0 = 1.7e9
    for r in range(ranks):
        events, steps = [], []
        t = t0 + rng.uniform(0, 0.01)
        for s in range(4):
            dur = float(rng.uniform(0.05, 0.2))
            steps.append([s, t, t + dur])
            events.append({"name": "hvd_step", "ph": "X", "ts": t, "dur": dur, "cat": "step",
                           "tid": 0, "args": {"step": s, "fusion_path": "posthoc"}})
            events.append({"name": "hvd_plan", "ph": "X", "ts": t + 0.01, "dur": 0.003,
                           "cat": "plan", "tid": 0,
                           "args": {"plan": f"hvd_plan_{s}", "op": "ALLREDUCE",
                                    "bytes": int(rng.randint(1, 1 << 20))}})
            events.append({"name": "XLA_ALLREDUCE", "ph": "B", "ts": t + 0.02, "cat": "timeline",
                           "tid": 1 + s % 2})
            events.append({"name": "thread_name", "ph": "M", "ts": t, "cat": "timeline",
                           "tid": 1, "args": {"name": "grad"}})
            t += dur + float(rng.uniform(0, 0.01))
        events.append({"name": "guard", "ph": "i", "ts": t, "cat": "event", "tid": 0})
        out[r] = {"schema": 1, "rank": r, "gen": 0,
                  "clock": {"offset_s": float(rng.uniform(-1e-3, 1e-3)), "rtt_s": 1e-4,
                            "estimated": True},
                  "plan": {"fusion_path": "posthoc"}, "events": events, "steps": steps,
                  "event_log": [{"seq": 1, "site": "kv", "action": "drop"}],
                  "reason": f"crash:{r}", "dumped_at": t + 0.5}
    return out


def test_merge_matches_jax(tmp_path):
    ranks = _windows()
    driver = {"events": [{"name": "hvd_sim_plan", "ph": "i", "ts": 1.7e9, "cat": "event",
                          "args": {"group": 0}}]}
    for fn, args in ((lambda m: m.merge_windows(ranks, driver), ()),
                     (lambda m: m.merge_windows(ranks), ()),
                     (lambda m: m.merge_postmortem(ranks, window_s=0.3), ()),
                     (lambda m: m.stats_summary(ranks, driver), ())):
        assert (json.dumps(fn(port_merge), sort_keys=True)
                == json.dumps(fn(jax_merge), sort_keys=True))
    port_merge.write_trace(str(tmp_path / "p.json"), port_merge.merge_windows(ranks))
    jax_merge.write_trace(str(tmp_path / "j.json"), jax_merge.merge_windows(ranks))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_trace_merge_tools_agree(tmp_path):
    """The port's ``tools/trace_merge`` and the JAX package's script turn
    one trace directory into the same bytes (live and postmortem)."""
    from horovod_tpu_torch.tools import trace_merge as port_cli

    spec = importlib.util.spec_from_file_location(
        "jax_trace_merge", os.path.join(REPO, "tools", "trace_merge.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    for r, doc in _windows(seed=1).items():
        (tmp_path / f"rank.{r}.json").write_text(json.dumps(doc))
        (tmp_path / f"flight.rank{r}.json").write_text(json.dumps(doc))
    for extra in ([], ["--postmortem"], ["--stats"]):
        assert port_cli.main([str(tmp_path), "-o", str(tmp_path / "p.out"), *extra]) == 0
        assert jax_cli.main([str(tmp_path), "-o", str(tmp_path / "j.out"), *extra]) == 0
        assert (tmp_path / "p.out").read_bytes() == (tmp_path / "j.out").read_bytes()


@pytest.mark.parametrize("server_cls", [KVStoreServer, JaxKVServer], ids=["port", "jax"])
def test_trace_pusher_ships_window(server_cls):
    srv = server_cls(port=0)
    srv.start()
    port_trace.install(True)
    port_trace.TAP.event("shipped", cat="op")
    try:
        p = port_pusher.TracePusher("127.0.0.1", srv.port, rank=3, interval=60)
        p.push_once()
        doc = port_pusher.decode_window(srv.snapshot(port_trace.KV_SCOPE)["rank.3"])
        assert doc["clock"]["estimated"] is True and doc["rank"] == port_trace.TAP.rank
        assert any(e["name"] == "shipped" for e in doc["events"])
        assert doc["event_log"] == []       # no fault plan is installed
        # The JAX driver's decoder reads the port's window.
        assert jax_pusher.decode_window(srv.snapshot(port_trace.KV_SCOPE)["rank.3"]) == doc
        p.stop()
    finally:
        srv.stop()


def test_skew_tracker_matches_jax():
    windows = _windows(seed=2, ranks=4)
    port, ref = port_pusher.StepSkewTracker(0.01), jax_pusher.StepSkewTracker(0.01)
    for cut in (2, 4):
        part = {r: dict(w, steps=w["steps"][:cut]) for r, w in windows.items()}
        assert port.update(part) == ref.update(part)
    port.reset_generation(1)
    ref.reset_generation(1)
    assert port.update(windows) == ref.update(windows) == []


def _timeline_events(path):
    """(name, phase, lane name) of every record, timestamps dropped; the
    XLA run facts the JAX runtime adds as metadata (its perf preset, its
    interconnect model) are left out: the port has neither."""
    events = json.loads(open(path).read())
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    return [(e["name"], e["ph"], lanes.get(e.get("tid"))) for e in events
            if e["name"] not in ("hvd_topo_model", "hvd_xla_perf_preset")]


def test_python_runtime_timeline_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_CORE", "python")
    jhvd.shutdown()
    hvd.shutdown()
    files = {}
    for key, h, init in (("jax", jhvd, lambda: jhvd.init()),
                         ("port", hvd, lambda: hvd.init(device="cpu"))):
        files[key] = str(tmp_path / f"{key}.json")
        monkeypatch.setenv("HOROVOD_TIMELINE", files[key])
        init()
        try:
            x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
            h.allreduce(x, name="tl.a")
            h.allgather(x, name="tl.b")
            h.broadcast(x, 0, name="tl.c")
            h.allreduce(x, name="tl.a")
            h.reducescatter(x, name="tl.d")
        finally:
            h.shutdown()
    got, want = _timeline_events(files["port"]), _timeline_events(files["jax"])
    assert got == want
    assert ("XLA_ALLREDUCE", "B", "tl.a") in got and ("NEGOTIATE_ALLGATHER", "E", "tl.b") in got


def test_make_train_step_step_spans_and_plan_notes():
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    hvd.init(device="cpu")
    try:
        model = TransformerLM(vocab_size=64, d_model=32, n_heads=2, n_layers=1, max_len=16,
                              dtype=torch.float32, device="cpu", seed=0)
        rng = np.random.RandomState(0)
        batch = tuple(torch.from_numpy(rng.randint(0, 64, (2, 16))) for _ in range(2))

        def loss(m, b):
            return lm_loss(m(b[0]), b[1])

        def make():
            return hvd.make_train_step(loss, torch.optim.AdamW(model.parameters(), lr=1e-3))

        off = make()
        assert not hasattr(off, "__wrapped__")      # wrap_step(f) is f when off
        off(model, batch)
        port_trace.install(True)
        port_metrics.install(True)
        on = make()
        assert on.__wrapped__ is not None and on.optimizer is not None
        for _ in range(3):
            on(model, batch)
        window = port_trace.TAP.window()
        spans = [e for e in window["events"] if e["name"] == "hvd_step"]
        assert [s["args"]["step"] for s in spans] == [0, 1, 2] and len(window["steps"]) == 3
        assert spans[0]["args"]["optimizer"] == "DistributedOptimizer"
        assert spans[0]["args"]["wire_dtype"] == "f32" and "overlap" in spans[0]["args"]
        # One rank: one fusion plan noted and gauged, no wire bytes (the
        # JAX step records none for an axis of one).
        assert spans[-1]["args"]["fusion_path"] == "posthoc"
        snap = port_metrics.snapshot()
        assert snap["hvd_fusion_buckets"]["series"][0]["labels"] == {"path": "posthoc"}
        assert "hvd_axis_wire_bytes_total" not in snap
        assert snap["hvd_fusion_bucket_bytes"]["series"][0]["count"] == \
            snap["hvd_fusion_buckets"]["series"][0]["value"]   # once for three steps
    finally:
        hvd.shutdown()
