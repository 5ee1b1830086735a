"""Snapshot aggregation and Prometheus text exposition.

The port's copy of ``horovod_tpu/metrics/export.py``: the same rendering,
byte for byte, and the same KV push format, so the port's workers and the
JAX package's driver read each other's snapshots.

The driver never scrapes workers: workers PUSH their registry snapshots
over the existing KV rendezvous plane (``MetricsPusher``, one small JSON
PUT per interval), and the driver's ``GET /metrics`` handler merges
whatever snapshots are present with its own registry, stamping each
source's identity labels (``rank="0"`` / ``role="driver"``) onto every
series. Fixed-bucket histograms make the merge a relabeling, never a
re-bin.

``parse_prometheus`` is a deliberately small reader of the subset this
module emits — enough for ``tools/metrics_dump.py`` and the test suite to
validate the exposition without a prometheus client dependency.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger("horovod_tpu_torch.metrics")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# KV scope worker snapshots are pushed under (driver-side aggregation
# reads the same scope).
KV_SCOPE = "metrics"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    )


def _labelstr(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(
    parts: Iterable[Tuple[Dict[str, str], Dict[str, dict]]]
) -> str:
    """Render ``(extra_labels, snapshot)`` parts as one text exposition.

    Series from every part are merged under their metric name with the
    part's extra labels applied; the first part to introduce a name wins
    the HELP/TYPE line (the catalog keeps them identical across ranks
    anyway). A histogram whose bucket edges disagree with the first
    sighting is dropped with a log line rather than corrupting the
    exposition."""
    merged: "Dict[str, dict]" = {}
    for extra, snap in parts:
        for name, metric in (snap or {}).items():
            m = merged.get(name)
            if m is None:
                m = {
                    "type": metric.get("type", "untyped"),
                    "help": metric.get("help", ""),
                    "bucket_edges": metric.get("bucket_edges"),
                    "series": [],
                }
                merged[name] = m
            if metric.get("type") != m["type"]:
                logger.warning(
                    "metric %s: type mismatch across sources (%s vs %s); "
                    "dropping the latecomer", name, metric.get("type"),
                    m["type"],
                )
                continue
            if (m["type"] == "histogram"
                    and metric.get("bucket_edges") != m["bucket_edges"]):
                logger.warning(
                    "metric %s: bucket edges differ across sources; "
                    "dropping the latecomer", name,
                )
                continue
            for s in metric.get("series", []):
                labels = dict(s.get("labels", {}))
                labels.update(extra or {})
                merged[name]["series"].append({**s, "labels": labels})

    lines: List[str] = []
    for name in sorted(merged):
        m = merged[name]
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        if m["type"] == "histogram":
            edges = m["bucket_edges"] or []
            for s in m["series"]:
                labels = s["labels"]
                cum = 0
                counts = s.get("buckets", [])
                for i, edge in enumerate(edges):
                    cum += counts[i] if i < len(counts) else 0
                    lab = dict(labels)
                    lab["le"] = _fmt(edge)
                    lines.append(
                        f"{name}_bucket{_labelstr(lab)} {cum}"
                    )
                cum += counts[len(edges)] if len(counts) > len(edges) else 0
                lab = dict(labels)
                lab["le"] = "+Inf"
                lines.append(f"{name}_bucket{_labelstr(lab)} {cum}")
                lines.append(
                    f"{name}_sum{_labelstr(labels)} {_fmt(s.get('sum', 0))}"
                )
                lines.append(
                    f"{name}_count{_labelstr(labels)} "
                    f"{_fmt(s.get('count', 0))}"
                )
        else:
            for s in m["series"]:
                lines.append(
                    f"{name}{_labelstr(s['labels'])} "
                    f"{_fmt(s.get('value', 0))}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Parse a text exposition into
    ``{name: {"type": t, "samples": [(labels, value), ...]}}``.
    Histogram ``_bucket``/``_sum``/``_count`` samples are filed under
    their base metric name."""
    out: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            fields = line.split(None, 3)
            if len(fields) >= 4 and fields[1] == "TYPE":
                types[fields[2]] = fields[3].strip()
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {raw!r}")
        name, labelstr, value = m.groups()
        labels = {
            k: v.replace(r"\"", '"').replace(r"\n", "\n").replace(
                "\\\\", "\\"
            )
            for k, v in _LABEL_RE.findall(labelstr or "")
        }
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)] if name.endswith(suffix) else None
            if stem and types.get(stem) == "histogram":
                base = stem
                break
        entry = out.setdefault(
            base, {"type": types.get(base, "untyped"), "samples": []}
        )
        entry["samples"].append(
            (name, labels, float("inf") if value == "+Inf" else float(value))
        )
    return out


def flatten(snapshot: Dict[str, dict]) -> Dict[str, float]:
    """Human-oriented flat view (``hvd.metrics()``): one
    ``name{label="v"}`` key per series; histograms contribute their
    ``_count`` and ``_sum``."""
    flat: Dict[str, float] = {}
    for name, metric in (snapshot or {}).items():
        for s in metric.get("series", []):
            lab = _labelstr(s.get("labels", {}))
            if metric.get("type") == "histogram":
                flat[f"{name}_count{lab}"] = float(s.get("count", 0))
                flat[f"{name}_sum{lab}"] = float(s.get("sum", 0.0))
            else:
                flat[f"{name}{lab}"] = float(s.get("value", 0.0))
    return flat


class MetricsPusher:
    """Worker-side background publisher: every ``interval`` seconds (and
    once more at stop) the local registry snapshot is PUT to the driver's
    KV store under ``metrics/rank.<rank>``, stamped with this worker's
    identity labels. Push failures are swallowed — metrics must never
    take down training — and the KV client's own bounded retry/backoff
    absorbs transient driver unreachability."""

    def __init__(self, addr: str, port: int, rank: int,
                 interval: Optional[float] = None):
        import os

        from ..run.http_server import KVStoreClient

        self._kv = KVStoreClient(addr, port)
        self._rank = int(rank)
        if interval is None:
            try:
                interval = float(os.environ.get(
                    "HOROVOD_METRICS_PUSH_INTERVAL_S", "") or 2.0)
            except ValueError:
                interval = 2.0
        self._interval = max(float(interval), 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd_metrics_pusher", daemon=True
        )
        self._thread.start()

    def push_once(self) -> None:
        from . import snapshot as _snapshot

        snap = _snapshot()
        if not snap:
            return
        payload = json.dumps(
            {"labels": {"rank": str(self._rank)}, "snapshot": snap}
        ).encode()
        try:
            self._kv.put(KV_SCOPE, f"rank.{self._rank}", payload)
        except Exception:  # noqa: BLE001 - advisory plane only
            logger.debug("metrics push failed", exc_info=True)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.push_once()

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        # Final push so short jobs still land their terminal counts.
        self.push_once()


def aggregate_kv_snapshots(
    kv_entries: Dict[str, bytes],
    local_snapshot: Optional[Dict[str, dict]] = None,
    local_labels: Optional[Dict[str, str]] = None,
) -> str:
    """Driver-side assembly for ``GET /metrics``: decode worker-pushed KV
    payloads (unreadable entries are skipped) and render them with the
    serving process's own snapshot."""
    parts: List[Tuple[Dict[str, str], Dict[str, dict]]] = []
    if local_snapshot:
        parts.append((local_labels or {"role": "driver"}, local_snapshot))
    for key in sorted(kv_entries):
        try:
            payload = json.loads(kv_entries[key].decode())
            parts.append(
                (dict(payload.get("labels", {})),
                 dict(payload.get("snapshot", {})))
            )
        except (ValueError, AttributeError, UnicodeDecodeError):
            logger.warning("unreadable metrics snapshot under %s", key)
    return render_prometheus(parts)
