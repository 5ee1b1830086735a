"""Worker-side trace shipping + driver-side skew attribution.

Same transport pattern as ``metrics/export.MetricsPusher``: workers PUSH
their bounded span windows to the driver's KV rendezvous store (one
small JSON PUT per interval, scope ``trace``, key ``rank.<rank>``); the
driver never scrapes workers. The elastic driver collects the windows
(``run/elastic_driver.ElasticDriver._trace_collect``), persists them for ``trace/merge.py``, and feeds the per-step end
timestamps into :class:`StepSkewTracker` — the seam behind
``hvd_step_skew_seconds`` and ``hvd_straggler_total{rank}``.

Clock alignment: at pusher start (worker attach) the driver's wall clock
is sampled over the KV plane (``GET /clock``) a few times; the estimate
``offset = driver_time - (t_send + t_recv)/2`` from the minimum-RTT ping
is RECORDED as trace metadata on every pushed window — never silently
applied to timestamps (docs/timeline.md "Fleet tracing" spells out the
caveat). Skew numbers therefore compare raw wall clocks; on NTP-synced
fleets that is the honest signal, and the recorded offsets let a reader
re-align lanes by hand when it is not.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import KV_SCOPE, _count
from . import tap as _tap

logger = logging.getLogger("horovod_tpu_torch.trace")

# Fault event-log lines shipped per window (the tail is enough to
# correlate injections with spans; the full log lives on disk).
EVENT_LOG_TAIL = 200

CLOCK_PINGS = 5


def estimate_clock_offset(addr: str, port: int,
                          pings: int = CLOCK_PINGS) -> Optional[Dict[str, float]]:
    """Estimate this process's wall-clock offset against the driver via
    the KV server's ``/clock`` endpoint: of ``pings`` samples the one
    with the smallest RTT wins (its midpoint is the best bound on when
    the driver read its clock). Returns ``{"offset_s", "rtt_s"}`` or
    None when the endpoint is unreachable."""
    import http.client

    best: Optional[Tuple[float, float]] = None  # (rtt, offset)
    for _ in range(max(pings, 1)):
        try:
            t0 = time.time()
            conn = http.client.HTTPConnection(addr, port, timeout=5)
            try:
                conn.request("GET", "/clock")
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    continue
            finally:
                conn.close()
            t1 = time.time()
            driver_t = float(json.loads(data.decode())["time"])
        except Exception:  # noqa: BLE001 - advisory estimate only
            continue
        rtt = t1 - t0
        offset = driver_t - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    if best is None:
        return None
    return {"offset_s": best[1], "rtt_s": best[0]}


class TracePusher:
    """Background publisher of this rank's span window to the driver's
    KV store. Push failures are swallowed — tracing must never take down
    training; the KV client's bounded retry/backoff absorbs transient
    driver unreachability."""

    def __init__(self, addr: str, port: int, rank: int,
                 interval: Optional[float] = None):
        import os

        from ..run.http_server import KVStoreClient

        from . import TRACE_PUSH_INTERVAL_ENV

        self._kv = KVStoreClient(addr, port)
        self._rank = int(rank)
        if interval is None:
            try:
                interval = float(
                    os.environ.get(TRACE_PUSH_INTERVAL_ENV, "") or 2.0
                )
            except ValueError:
                interval = 2.0
        self._interval = max(float(interval), 0.05)
        # Clock-offset estimate at attach, recorded into the tap's
        # metadata (and the hvd_trace_clock_offset_seconds gauge).
        est = estimate_clock_offset(addr, port)
        if est is not None:
            _tap().set_clock(est["offset_s"], est["rtt_s"])
            from .. import metrics as _metrics

            if _metrics.ACTIVE:
                _metrics.TAP.set(
                    "hvd_trace_clock_offset_seconds", est["offset_s"]
                )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd_trace_pusher", daemon=True
        )
        self._thread.start()

    def push_once(self) -> None:
        doc = _tap().window()
        if not doc:
            return
        # Ship the deterministic fault event-log tail beside the spans,
        # so a merged trace shows injections inline with their steps.
        from ..fault import injector as _fault

        doc["event_log"] = _fault.events()[-EVENT_LOG_TAIL:]
        try:
            self._kv.put(
                KV_SCOPE, f"rank.{self._rank}",
                json.dumps(doc, sort_keys=True).encode(),
            )
            _count("hvd_trace_pushes_total")
        except Exception:  # noqa: BLE001 - advisory plane only
            logger.debug("trace push failed", exc_info=True)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.push_once()

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        # Final push so short jobs still land their terminal window.
        self.push_once()


def decode_window(payload: bytes) -> Optional[Dict[str, Any]]:
    """Driver-side decode of one pushed window (None on junk)."""
    try:
        doc = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


class StepSkewTracker:
    """Driver-side per-step cross-rank skew attribution.

    Feed it the freshest windows per rank; for every step index that ALL
    currently-reporting ranks have finished (and that was not already
    charged), it emits ``(step, skew_s, worst_rank)`` where skew is the
    spread of raw wall-clock step-end times and worst_rank the last
    finisher. Each step is charged exactly once — the pushed windows are
    cumulative, so re-observing an index must not double-count."""

    def __init__(self, threshold_s: Optional[float] = None):
        from . import straggler_threshold_s

        self.threshold_s = (
            straggler_threshold_s() if threshold_s is None
            else float(threshold_s)
        )
        self._done: set = set()
        # Keep the charged-set bounded for long runs: indices below the
        # watermark are implicitly done.
        self._watermark = -1
        # Generation the charged-set is keyed to: after an elastic
        # resize ranks are renumbered (and workers restart their step
        # ledgers), so cumulative windows from the old world must never
        # charge the new world's ranks. ``None`` = ungated (non-elastic
        # callers feed windows with no ``gen`` stamp).
        self.generation: Optional[int] = None

    def reset_generation(self, gen: Optional[int] = None) -> None:
        """Re-key the tracker for a new world generation: drop every
        charged index and only consume windows stamped with ``gen``
        from now on. Charges from the OLD generation die with it — a
        parked or removed rank is never charged for steps it did not
        run (tests/test_selfdrive.py locks this)."""
        self._done = set()
        self._watermark = -1
        self.generation = None if gen is None else int(gen)

    def update(self, windows: Dict[int, Dict[str, Any]]
               ) -> List[Tuple[int, float, int]]:
        if self.generation is not None:
            windows = {
                r: doc for r, doc in windows.items()
                if int(doc.get("gen", 0) or 0) == self.generation
            }
        if len(windows) < 2:
            return []
        per_rank: Dict[int, Dict[int, float]] = {}
        for rank, doc in windows.items():
            ends: Dict[int, float] = {}
            for entry in doc.get("steps") or []:
                try:
                    idx, _t0, t1 = entry
                    ends[int(idx)] = float(t1)
                except (TypeError, ValueError):
                    continue
            if ends:
                per_rank[int(rank)] = ends
        if len(per_rank) < 2:
            return []
        common = set.intersection(*(set(e) for e in per_rank.values()))
        out: List[Tuple[int, float, int]] = []
        for idx in sorted(common):
            if idx <= self._watermark or idx in self._done:
                continue
            ends = {r: e[idx] for r, e in per_rank.items()}
            worst = max(ends, key=lambda r: (ends[r], r))
            skew = max(ends.values()) - min(ends.values())
            out.append((idx, skew, worst))
            self._done.add(idx)
        # Compact: everything at-or-below the smallest pending gap.
        while (self._watermark + 1) in self._done:
            self._done.discard(self._watermark + 1)
            self._watermark += 1
        return out
