"""Runtime metrics & introspection.

The port of ``horovod_tpu/metrics``: the same catalog, taps and snapshot
shape. The runtimes, the DP step (``ops/fusion.py``), the guard and the
serving engine record through :data:`TAP` behind ``if metrics.ACTIVE:``.

The observability counterpart of the Chrome-trace timeline
(``utils/timeline.py``): where the timeline reconstructs ONE run post-hoc,
this subsystem keeps low-overhead counters, gauges, and fixed-bucket
histograms that a fleet monitor can scrape continuously — per-op
negotiate/execute latency and bytes, RPC retry/backoff, stall-ladder
escalations, and elastic generation/blacklist/preemption events.

Tap discipline — identical to ``fault/injector.py``: with
``HOROVOD_METRICS`` unset (the production default) the module-level
:data:`ACTIVE` flag is False, :data:`TAP` is the shared no-op singleton
:data:`NULL_TAP`, and instrumented call sites skip their tap entirely
(``if _metrics.ACTIVE: ...`` is the whole overhead). With
``HOROVOD_METRICS=1`` the tap records into a process-local
:class:`~horovod_tpu_torch.metrics.registry.Registry`.

Three consumers (docs/metrics.md):

- ``GET /metrics`` on the driver's rendezvous HTTP server — Prometheus
  text exposition aggregating the driver's own registry with worker
  snapshots pushed over the KV plane, labeled by rank;
- ``hvd.metrics()`` / ``hvd.metrics_snapshot()`` — plain dicts, in
  process;
- ``python -m horovod_tpu_torch.tools.metrics_dump`` — pretty-print or diff snapshots offline.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from .registry import (  # noqa: F401 (re-exported)
    BYTE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    Registry,
)

METRICS_ENV = "HOROVOD_METRICS"
METRICS_PORT_ENV = "HOROVOD_METRICS_PORT"
METRICS_PUSH_INTERVAL_ENV = "HOROVOD_METRICS_PUSH_INTERVAL_S"

# Help strings + bucket overrides for the shipped metric catalog
# (docs/metrics.md). Names not listed here still work — they get an empty
# help line and suffix-derived buckets.
_CATALOG: Dict[str, str] = {
    "hvd_op_negotiate_seconds":
        "Per-op latency from submission to coordinator readiness",
    "hvd_op_execute_seconds": "Per-op fused-plan execution latency",
    "hvd_op_bytes": "Per-plan fused payload size in bytes",
    "hvd_ops_submitted_total": "Collectives submitted by this rank",
    "hvd_op_errors_total": "Collectives that completed with an error",
    "hvd_plans_total": "Fused plans executed by this rank",
    "hvd_queue_depth": "Pending tensors in the runtime queue",
    "hvd_cycle_seconds": "Background negotiation-cycle duration",
    "hvd_fusion_buckets": "Fusion buckets planned for one reduction path "
                          "(trace-time; labeled by path)",
    "hvd_fusion_bucket_bytes": "Planned fusion-bucket payload sizes",
    "hvd_overlap_groups": "Streamed-reduction layer groups registered by "
                          "the overlap path (trace-time)",
    "hvd_xla_perf_preset_info": "Resolved XLA perf-flag preset (value is "
                                "always 1; preset/flags in labels)",
    "hvd_xla_cache_hits_total": "Compiled-collective cache hits",
    "hvd_xla_cache_misses_total": "Compiled-collective cache misses",
    "hvd_xla_compile_seconds": "Compiled-collective build time",
    "hvd_rpc_requests_total": "Control-plane RPCs issued",
    "hvd_rpc_retries_total": "Control-plane RPC retries (backoff fired)",
    "hvd_rpc_failures_total": "Control-plane RPCs failed after retries",
    "hvd_rpc_timeouts_total": "Control-plane RPCs answered with a "
                              "server-side phase timeout",
    "hvd_kv_requests_total": "Rendezvous KV requests (client side)",
    "hvd_kv_retries_total": "Rendezvous KV request retries",
    "hvd_kv_server_requests_total": "Rendezvous KV requests served",
    "hvd_stall_warnings_total": "Stall-ladder rung-1 warnings",
    "hvd_stall_aborts_total": "Stall-ladder rung-2 per-tensor aborts",
    "hvd_stall_shutdowns_total": "Stall-ladder rung-3 runtime shutdowns",
    "hvd_elastic_generation": "Current world generation (driver)",
    "hvd_elastic_world_size": "Current world size (driver)",
    "hvd_elastic_generations_total": "World generations published",
    "hvd_elastic_worker_failures_total": "Worker process failures",
    "hvd_elastic_blacklists_total": "Hosts quarantined",
    "hvd_elastic_readmissions_total": "Hosts re-admitted after quarantine",
    "hvd_elastic_blacklisted_hosts": "Hosts currently quarantined",
    "hvd_elastic_preempt_notices_total": "Preemption notices delivered",
    "hvd_elastic_respawn_requests_total": "Worker-requested respawns",
    "hvd_elastic_restarts_total": "Respawn-mode world restarts",
    "hvd_elastic_rollbacks_total": "State rollbacks after collective "
                                   "failure (worker)",
    "hvd_elastic_snapshot_quarantined_total":
        "Unreadable persisted snapshots quarantined to *.corrupt",
    # Elastic resharding (docs/fault_tolerance.md "Elastic resharding").
    "hvd_reshard_total": "Sharded-state reshard executions (labeled by "
                         "trigger: resize/checkpoint/snapshot-restore/"
                         "manual)",
    "hvd_reshard_bytes_total": "Bytes redistributed across ranks by "
                               "reshards (labeled by mesh axis)",
    "hvd_reshard_ef_dropped_elements_total":
        "Error-feedback residual elements dropped or zeroed across a "
        "reshard (labeled by policy; never silent)",
    # Data-plane integrity guard (docs/fault_tolerance.md).
    "hvd_guard_nonfinite_total": "Non-finite gradient detections "
                                 "(labeled by policy and path)",
    "hvd_guard_skipped_steps_total": "Optimizer steps skipped by "
                                     "cross-rank agreement (policy skip)",
    "hvd_guard_metadata_aborts_total": "Collectives aborted by cross-rank "
                                       "metadata validation",
    "hvd_guard_digest_checks_total": "Parameter-digest agreement rounds",
    "hvd_guard_digest_mismatches_total": "Digest rounds that found "
                                         "diverged replicas",
    "hvd_guard_heals_total": "Digest mismatches healed by re-broadcast",
    "hvd_guard_rollbacks_total": "Digest mismatches with no quorum "
                                 "(elastic rollback raised)",
    "hvd_elastic_host_interrupts_total": "Membership-change interrupts "
                                         "(worker)",
    "hvd_elastic_preemptions_total": "Preemption interrupts (worker)",
    "hvd_elastic_rejoins_total": "World rejoins completed (worker)",
    # Compiled-path offline tuning (docs/autotune.md).
    "hvd_tuned_info": "Compiled-path tuned source (value is always 1; "
                      "source=arg/file/env/none, signature hash, "
                      "matched, where in labels)",
    # Fleet simulation (docs/simulation.md).
    "hvd_sim_divergence_ratio": "Replay-mode modeled-over-measured time "
                                "per interconnect hop (hop='step' = "
                                "whole-step scope); drift from 1 means "
                                "the cost model is mispricing links",
    # Topology-aware collective compositor (docs/topology.md).
    "hvd_topo_plan_info": "Selected compositor lowering plan (value is "
                          "always 1; collective/algorithm/op/where in "
                          "labels)",
    "hvd_topo_bytes_per_hop": "Planned per-rank bytes-on-wire per "
                              "interconnect hop for the selected plan",
    "hvd_mesh_fallback_total": "build_mesh degraded to a bare device "
                               "reshape (ICI adjacency lost)",
    # Fleet tracing (docs/timeline.md "Fleet tracing").
    "hvd_timeline_dropped_total": "Timeline events dropped after a "
                                  "writer-thread failure or an "
                                  "undrained shutdown",
    "hvd_step_skew_seconds": "Cross-rank spread of step-end times per "
                             "step (driver-side, raw wall clock)",
    "hvd_straggler_total": "Steps on which this rank finished last with "
                           "skew above the straggler threshold "
                           "(labeled by rank)",
    "hvd_trace_pushes_total": "Trace windows pushed to the driver over "
                              "the KV plane",
    "hvd_trace_collections_total": "Trace windows collected by the "
                                   "driver's supervision loop",
    "hvd_trace_flight_dumps_total": "Flight-recorder dumps written "
                                    "(labeled by reason)",
    "hvd_trace_clock_offset_seconds": "This worker's estimated wall-"
                                      "clock offset vs the driver "
                                      "(KV ping RTT/2; recorded, never "
                                      "applied)",
    # Inference serving (docs/serving.md, docs/metrics.md "Serving").
    "hvd_request_latency_seconds": "End-to-end request latency, "
                                   "admission to completion (the SLO "
                                   "histogram)",
    "hvd_request_total": "Requests finished, labeled by outcome "
                         "(ok/dropped/rejected)",
    "hvd_serve_queue_depth": "Requests waiting in the continuous "
                             "batcher's admission queue",
    "hvd_serve_batch_occupancy": "Live requests in the most recent "
                                 "dispatched batch (padding excluded)",
    "hvd_serve_kv_pages_in_use": "KV-cache pages currently granted to "
                                 "live requests",
    "hvd_serve_replicas": "DP serving replicas currently running",
    "hvd_serve_tokens_total": "Tokens generated across all requests",
    "hvd_serve_requeues_total": "In-flight requests re-queued after a "
                                "replica died mid-batch (each is still "
                                "answered exactly once)",
    "hvd_serve_scale_decisions_total": "Serving autoscale verdicts "
                                       "(labeled by action: "
                                       "scale-out/scale-in)",
}

_BUCKET_OVERRIDES = {
    "hvd_op_bytes": BYTE_BUCKETS,
}

# Counter families pre-seeded at activation so the exposition always
# carries the alerting-relevant zeros (a counter that never fired still
# scrapes as 0, the Prometheus idiom).
_PRESEED_COUNTERS = (
    "hvd_rpc_retries_total",
    "hvd_rpc_failures_total",
    "hvd_kv_retries_total",
    "hvd_stall_warnings_total",
    "hvd_stall_aborts_total",
    "hvd_stall_shutdowns_total",
    "hvd_op_errors_total",
)


class MetricsTap:
    """The live tap: name-keyed get-or-create access into one registry.
    Call sites stay one-liners; metric types are derived from the method
    (``inc`` → counter, ``set`` → gauge, ``observe`` → histogram) and
    histogram buckets from the catalog or the ``_bytes`` name suffix."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()

    def _buckets(self, name: str):
        b = _BUCKET_OVERRIDES.get(name)
        if b is not None:
            return b
        return BYTE_BUCKETS if name.endswith("_bytes") else LATENCY_BUCKETS_S

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        self.registry.counter(name, _CATALOG.get(name, "")).inc(
            value, **labels
        )

    def set(self, name: str, value: float, **labels) -> None:
        self.registry.gauge(name, _CATALOG.get(name, "")).set(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.registry.histogram(
            name, _CATALOG.get(name, ""), buckets=self._buckets(name)
        ).observe(value, **labels)

    def snapshot(self) -> Dict[str, dict]:
        return self.registry.snapshot()


class _NullTap:
    """Shared no-op tap installed while metrics are disabled. Sites that
    gate on :data:`ACTIVE` never reach it; sites that hold a tap
    reference pay one empty method call."""

    registry = None

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        pass

    def set(self, name: str, value: float, **labels) -> None:
        pass

    def observe(self, name: str, value: float, **labels) -> None:
        pass

    def snapshot(self) -> Dict[str, dict]:
        return {}


NULL_TAP = _NullTap()

ACTIVE = False
TAP = NULL_TAP

_lock = threading.Lock()


def enabled() -> bool:
    return ACTIVE


def tap():
    """The process-wide tap: the live one when enabled, else the shared
    no-op singleton (``metrics.tap() is metrics.NULL_TAP``)."""
    return TAP


def install(active: bool) -> None:
    """(De)activate metrics for this process."""
    global ACTIVE, TAP
    with _lock:
        if active:
            t = MetricsTap()
            for name in _PRESEED_COUNTERS:
                # inc(0) materializes an unlabeled zero series, so the
                # family scrapes as an explicit 0 before it ever fires.
                t.registry.counter(name, _CATALOG.get(name, "")).inc(0)
            TAP = t
            ACTIVE = True
        else:
            TAP = NULL_TAP
            ACTIVE = False


def activate_from_env() -> bool:
    v = os.environ.get(METRICS_ENV, "").strip().lower()
    install(v not in ("", "0", "false", "no", "off"))
    return ACTIVE


def reset() -> None:
    install(False)


def snapshot() -> Dict[str, dict]:
    """Plain-dict snapshot of every metric in this process ({} when
    disabled)."""
    return TAP.snapshot()


def flat() -> Dict[str, float]:
    """Flat ``{name{label="v"}: value}`` view of :func:`snapshot` — the
    value ``hvd.metrics()`` returns."""
    from .export import flatten

    return flatten(snapshot())


class _CallableModule(type(os)):
    """``hvd.metrics`` must be BOTH this subpackage (``hvd.metrics.TAP``,
    ``hvd.metrics.export``) and the documented ``hvd.metrics()`` API
    returning a plain dict. A module attribute cannot be shadowed by a
    same-named function without breaking ``from .. import metrics`` at
    every instrumented call site, so the module itself is made callable
    (the PEP 562 ``__class__``-swap idiom)."""

    def __call__(self):
        return flat()


import sys as _sys  # noqa: E402

_sys.modules[__name__].__class__ = _CallableModule


# Arm at import (mirrors fault/injector.py): worker processes spawned
# with HOROVOD_METRICS in their environment record without code changes.
if os.environ.get(METRICS_ENV, "").strip():
    activate_from_env()
