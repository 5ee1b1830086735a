"""The port's metrics registry (horovod_tpu_torch/metrics) against the JAX
package's (horovod_tpu/metrics):

- the JAX package's own registry, tap and exposition tests
  (tests/test_metrics.py), run against the port's modules;
- one seeded snapshot rendered by both packages: byte-identical Prometheus
  text, equal parses, equal ``aggregate_kv_snapshots`` and cross-package
  rendering (a JAX driver scrapes port workers unchanged);
- the shared no-op singleton and the top-level ``metrics()`` /
  ``metrics_snapshot()`` while off;
- one fixed eager op sequence at size 1 through the JAX eager runtime and
  the port's, on the native core and on the Python runtime: equal
  ``hvd_ops_submitted_total``/``hvd_plans_total`` values and equal
  histogram counts (bytes: equal sums too);
- the KV server's ``/metrics`` over pushed worker snapshots, and the
  worker-side ``MetricsPusher``.

The DP step's plan taps against JAX's ``make_train_step`` are in
tests/test_torch_run.py, on the job the launcher starts there.
"""

import json
import urllib.request

import numpy as np
import pytest

import horovod_tpu as jhvd
from horovod_tpu import metrics as jax_metrics
from horovod_tpu.metrics import export as jax_export

import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.metrics import export as port_export
from horovod_tpu_torch.metrics import registry as port_registry

import test_metrics as ref_tests
from torch_port_harness import run_reference_test


@pytest.fixture(autouse=True)
def _taps_off():
    port_metrics.reset()
    jax_metrics.reset()
    yield
    port_metrics.reset()
    jax_metrics.reset()


PORTABLE = [
    "test_histogram_bucket_edges", "test_histogram_labels_and_count",
    "test_counter_concurrent_increments", "test_counter_rejects_negative_and_type_clash",
    "test_gauge_set_overwrites", "test_activation_installs_live_tap_and_reset_restores_singleton",
    "test_activate_from_env", "test_callable_module_returns_flat_dict",
    "test_render_parse_roundtrip_with_rank_labels",
    "test_render_cumulative_bucket_monotonicity",
    "test_render_drops_mismatched_histogram_edges", "test_label_escaping_roundtrip",
    "test_aggregate_kv_snapshots_skips_garbage",
]


@pytest.mark.parametrize("name", PORTABLE)
def test_reference_metrics_test_holds_for_the_port(name, request):
    run_reference_test(ref_tests, name, {"hvd_metrics": port_metrics, "mexport": port_export,
                                         "mreg": port_registry}, request)


def test_metrics_dump_tool(tmp_path, capsys):
    """tests/test_metrics.py's metrics_dump case, through the port's copy
    of the tool."""
    from horovod_tpu_torch.tools import metrics_dump

    t = port_metrics.MetricsTap()
    t.inc("hvd_plans_total", 2, op="ALLREDUCE")
    t.observe("hvd_op_execute_seconds", 0.25, op="ALLREDUCE")
    a = tmp_path / "a.json"
    a.write_text(json.dumps(t.snapshot()))
    t.inc("hvd_plans_total", 3, op="ALLREDUCE")
    b = tmp_path / "b.json"
    b.write_text(json.dumps(t.snapshot()))
    assert metrics_dump.main([str(a)]) == 0
    out = capsys.readouterr().out
    assert 'hvd_plans_total{op="ALLREDUCE"}' in out and "count=1" in out
    assert metrics_dump.main([str(a), str(b)]) == 0
    assert "+3" in capsys.readouterr().out


def _record(tap, seed: int = 0):
    """One seeded run of every metric kind into ``tap``: counters and
    gauges with labels (escapes included), histograms on the latency and
    the byte buckets, and an explicit edge set."""
    rng = np.random.RandomState(seed)
    for i in range(20):
        op = ["ALLREDUCE", "ALLGATHER", 'we"ird\\op\n'][i % 3]
        tap.inc("hvd_ops_submitted_total", op=op)
        tap.inc("hvd_axis_wire_bytes_total", float(rng.randint(1, 1 << 30)), axis="data",
                collective="allreduce")
        tap.set("hvd_queue_depth", float(rng.randint(0, 9)))
        tap.set("hvd_fusion_buckets", float(i), path=f"stream:g{i % 4}")
        tap.observe("hvd_op_execute_seconds", float(rng.exponential(0.01)), op=op)
        tap.observe("hvd_op_bytes", float(rng.randint(1, 1 << 28)), op=op)
        tap.observe("hvd_fusion_bucket_bytes", float(rng.randint(1, 1 << 26)))
    tap.registry.histogram("custom_h", "help text", buckets=(0.5, 1.5)).observe(1.0, a="b")
    return tap.snapshot()


def test_prometheus_text_byte_identical_to_jax():
    jsnap = _record(jax_metrics.MetricsTap())
    psnap = _record(port_metrics.MetricsTap())
    assert psnap == jsnap
    for parts in ([({}, psnap)], [({"rank": "0"}, psnap), ({"rank": "1"}, psnap)]):
        jparts = [(labels, jsnap) for labels, _ in parts]
        text = port_export.render_prometheus(parts)
        assert text.encode() == jax_export.render_prometheus(jparts).encode()
        # Either package renders the other's snapshot to the same bytes.
        assert jax_export.render_prometheus(parts) == text
        assert port_export.parse_prometheus(text) == jax_export.parse_prometheus(text)
    assert port_export.flatten(psnap) == jax_export.flatten(jsnap)
    entries = {f"rank.{r}": json.dumps({"labels": {"rank": str(r)}, "snapshot": psnap}).encode()
               for r in range(3)}
    entries["rank.9"] = b"\xff not json"
    assert (port_export.aggregate_kv_snapshots(entries, local_snapshot=psnap)
            == jax_export.aggregate_kv_snapshots(entries, local_snapshot=jsnap))


def test_disabled_tap_and_top_level_api():
    assert not port_metrics.ACTIVE
    assert port_metrics.TAP is port_metrics.NULL_TAP is port_metrics.tap()
    port_metrics.TAP.inc("hvd_plans_total")
    port_metrics.TAP.observe("hvd_op_bytes", 9.0)
    assert hvd.metrics() == {} and hvd.metrics_snapshot() == {}
    port_metrics.install(True)
    port_metrics.TAP.inc("hvd_plans_total", 2, op="ALLREDUCE")
    assert hvd.metrics()['hvd_plans_total{op="ALLREDUCE"}'] == 2.0
    assert hvd.metrics_snapshot()["hvd_plans_total"]["type"] == "counter"
    port_metrics.reset()
    assert port_metrics.TAP is port_metrics.NULL_TAP


def _eager_sequence(h):
    """The fixed op sequence: each op synchronous, so each is one plan."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    h.allreduce(x, name="m.ar0")
    h.allreduce(x * 2, name="m.ar1", op=h.Sum)
    h.allgather(rng.randn(4, 3).astype(np.float32), name="m.ag")
    h.broadcast(rng.randn(5).astype(np.float32), 0, name="m.bc")
    h.reducescatter(rng.randn(8, 2).astype(np.float32), name="m.rs")
    h.allreduce(np.arange(6, dtype=np.int32), name="m.ar2", op=h.Sum)


def _values(snap, name):
    return sorted((tuple(sorted(s["labels"].items())), s["value"])
                  for s in snap.get(name, {}).get("series", []))


def _counts(snap, name, with_sum=False):
    return sorted((tuple(sorted(s["labels"].items())), s["count"])
                  + ((s["sum"],) if with_sum else ())
                  for s in snap.get(name, {}).get("series", []))


@pytest.mark.parametrize("core", ["native", "python"])
def test_eager_op_metrics_match_jax(core, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_CORE", core)
    jhvd.shutdown()
    hvd.shutdown()
    snaps = {}
    for key, h, metrics, init in (("jax", jhvd, jax_metrics, lambda: jhvd.init()),
                                  ("port", hvd, port_metrics, lambda: hvd.init(device="cpu"))):
        metrics.install(True)
        init()
        try:
            _eager_sequence(h)
        finally:
            h.shutdown()
        snaps[key] = metrics.snapshot()
        metrics.reset()
    j, p = snaps["jax"], snaps["port"]
    for name in ("hvd_ops_submitted_total", "hvd_plans_total", "hvd_op_errors_total"):
        assert _values(p, name) == _values(j, name), name
    for name in ("hvd_op_execute_seconds", "hvd_op_negotiate_seconds"):
        assert _counts(p, name) == _counts(j, name), name
    # Six ops, one plan each (the Python runtime, as JAX's, counts no
    # hvd_plans_total: its executed responses are the histograms' counts).
    assert sum(c for _, c in _counts(p, "hvd_op_execute_seconds")) == 6
    assert _counts(p, "hvd_op_bytes", True) == _counts(j, "hvd_op_bytes", True)


def test_kv_server_metrics_and_pusher():
    """Worker snapshots pushed by the port's MetricsPusher into the port's
    KV server come back on ``/metrics`` with their rank labels, beside the
    serving process's own registry (``role="driver"``), as the JAX
    server renders the same entries."""
    from horovod_tpu_torch.run.http_server import KVStoreServer

    port_metrics.install(True)
    port_metrics.TAP.inc("hvd_plans_total", 4, op="ALLREDUCE")
    server = KVStoreServer()
    server.start()
    try:
        pusher = port_export.MetricsPusher("127.0.0.1", server.port, rank=3, interval=60)
        pusher.stop()       # the final push
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics",
                                    timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == port_export.CONTENT_TYPE
            text = resp.read().decode()
        samples = port_export.parse_prometheus(text)["hvd_plans_total"]["samples"]
        assert {labels.get("rank") or labels.get("role") for _, labels, _ in samples} \
            == {"3", "driver"}
        pushed = server.snapshot(port_export.KV_SCOPE)
        assert text == jax_export.aggregate_kv_snapshots(
            pushed, local_snapshot=port_metrics.snapshot())
    finally:
        server.stop()


def test_init_starts_pushers_and_goes_on_without_a_kv_server(monkeypatch):
    """With both taps on and a KV address in the environment, ``init``
    starts the metrics and trace pushers (``horovod_tpu/__init__.py:
    230-290``); a KV server that cannot be reached is logged and the job
    goes on, and ``shutdown``'s final pushes fail quietly."""
    from horovod_tpu_torch import trace as port_trace
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.metrics.export import MetricsPusher
    from horovod_tpu_torch.trace.pusher import TracePusher

    monkeypatch.setenv("HOROVOD_ELASTIC_KV_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_ELASTIC_KV_PORT", "1")     # nothing listens there
    monkeypatch.setenv("HOROVOD_RPC_RETRIES", "0")
    port_metrics.install(True)
    port_trace.install(True)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        kinds = sorted(type(p).__name__ for p in basics._runtime.pushers)
        assert kinds == sorted([MetricsPusher.__name__, TracePusher.__name__])
        assert hvd.allreduce(np.ones(2, np.float32), name="push.x").tolist() == [1.0, 1.0]
    finally:
        hvd.shutdown()
        port_trace.reset()
    assert hvd.metrics()['hvd_plans_total{op="ALLREDUCE"}'] == 1.0


def test_int8_wire_counters_match_jax_once_per_plan():
    """The int8 wire's ``hvd_quantized_*`` counters: the port records each
    float bucket of a plan once however many times the plan runs, with the
    values the JAX package's ``record_wire_bytes`` gives the same buckets;
    integer buckets record nothing."""
    import torch

    from horovod_tpu.ops import quantized as jax_quantized
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.quantized import quantized_reduce_fn

    rng = np.random.RandomState(0)
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((300,), (17, 9), (1000,), (5, 5))] + [torch.arange(7)]
    threshold = 2048
    hvd.init(device="cpu")
    try:
        port_metrics.install(True)
        for _ in range(3):
            fusion.fused_allreduce(leaves, threshold_bytes=threshold, label="posthoc",
                                   wire_dtype="int8", reduce_fn=quantized_reduce_fn("flat"))
        psnap = port_metrics.snapshot()
    finally:
        hvd.shutdown()
    jax_metrics.install(True)
    for bucket in fusion.plan_buckets(leaves, threshold):
        if leaves[bucket[0]].is_floating_point():
            jax_quantized.record_wire_bytes(sum(leaves[i].numel() for i in bucket) * 4,
                                            "quantized")
    jsnap = jax_metrics.snapshot()
    for name in ("hvd_quantized_wire_bytes_total", "hvd_quantized_bytes_saved_total",
                 "hvd_quantized_buckets_total"):
        assert _values(psnap, name) == _values(jsnap, name) != [], name
    assert _values(psnap, "hvd_fusion_buckets") == [((("path", "posthoc"),), 4.0)]
