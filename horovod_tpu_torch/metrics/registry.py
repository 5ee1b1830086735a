"""Dependency-free metric primitives: counters, gauges, fixed-bucket
histograms, and the registry that owns them.

The port's copy of ``horovod_tpu/metrics/registry.py``, line for line, so
a snapshot of either package renders to the same exposition. Design
constraints (docs/metrics.md):

- **No third-party client.** The worker image must not grow a
  ``prometheus_client`` dependency; the text exposition format is tiny and
  is rendered by :mod:`horovod_tpu_torch.metrics.export`.
- **Hot-path cheap.** A counter increment is one dict lookup + one locked
  float add. Histograms use ``bisect`` over a fixed edge tuple — no
  allocation after the first observation of a label set.
- **Snapshot = plain data.** ``Registry.snapshot()`` returns nothing but
  dicts/lists/numbers, so it pickles/JSONs through the KV rendezvous plane
  unchanged and ``hvd.metrics_snapshot()`` can hand it straight to users.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# Latency edges (seconds): sub-millisecond RPC turnarounds up to
# stall-scale minutes. Histograms are fixed-bucket so cross-rank
# aggregation is a per-bucket sum, never a re-bin.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Payload edges (bytes): one element to past the 64 MB fusion threshold.
BYTE_BUCKETS: Tuple[float, ...] = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0, 1048576.0,
    4194304.0, 16777216.0, 67108864.0, 268435456.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Base: one named metric holding one series per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _snapshot_series(self) -> List[dict]:
        raise NotImplementedError

    def snapshot(self) -> dict:
        out = {"type": self.kind, "help": self.help,
               "series": self._snapshot_series()}
        return out


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            return [
                {"labels": dict(k), "value": float(v)}
                for k, v in sorted(self._series.items())
            ]


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            return [
                {"labels": dict(k), "value": float(v)}
                for k, v in sorted(self._series.items())
            ]


class Histogram(Metric):
    """Fixed-bucket histogram. ``buckets[i]`` counts observations with
    ``value <= edges[i]`` exclusively of lower buckets (non-cumulative in
    the snapshot; the Prometheus renderer accumulates). One extra slot at
    the end counts the +Inf overflow."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help)
        edges = tuple(sorted(float(b) for b in (buckets or LATENCY_BUCKETS_S)))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.edges = edges

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        idx = bisect_left(self.edges, value)
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"buckets": [0] * (len(self.edges) + 1),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            st["buckets"][idx] += 1
            st["sum"] += value
            st["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return int(st["count"]) if st else 0

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            return [
                {"labels": dict(k), "buckets": list(v["buckets"]),
                 "sum": float(v["sum"]), "count": int(v["count"])}
                for k, v in sorted(self._series.items())
            ]

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["bucket_edges"] = list(self.edges)
        return out


class Registry:
    """Thread-safe name → metric table with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, Metric]" = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is already registered as {m.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
