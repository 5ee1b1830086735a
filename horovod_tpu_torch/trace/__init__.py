"""Fleet-wide distributed tracing (docs/timeline.md "Fleet tracing").

The port of ``horovod_tpu/trace``: the same span ring, window and flight
dump format, so ``trace/merge.py`` of either package merges the other's
windows. The eager runtimes' ``hvd_plan``/``hvd_response`` spans, the DP
step's plan notes and step spans (``train.make_train_step``) and the
serving engine's request spans record through :data:`TAP`.

The per-rank catapult timeline (``utils/timeline.py``) answers "what did
THIS process do"; this package makes the fleet answerable as ONE
artifact:

- **Span ring + KV shipping**: every rank keeps a bounded in-memory ring
  of recent spans/events (wall-clock stamped) and a background pusher
  ships the window to the driver over the existing KV rendezvous plane
  (same pattern as the metrics snapshot pusher).
  ``python -m horovod_tpu_torch.tools.trace_merge`` renders the collected
  windows as one Perfetto/Chrome trace with one process lane per rank
  plus the driver's elastic/HA events on their own lane.
- **Step spans + straggler attribution**: ``make_train_step`` (and the
  elastic ``State.commit`` seam) record host-side step-boundary
  timestamps with the step index and the active plan/correlation ids
  (fusion path, topo plan algorithm, ``wire_dtype``); the driver compares
  per-step end times across ranks into the ``hvd_step_skew_seconds``
  histogram and ``hvd_straggler_total{rank}`` counters.
- **Flight recorder**: the ring doubles as an always-on crash recorder —
  dumped atomically (:func:`atomic_write`: tmp+fsync+replace, the
  discipline of the JAX package's ``utils/checkpoint.py``) on guard
  abort, stall-ladder escalation and uncaught crashes, so "the last N
  seconds before death, all ranks, aligned" survives the process
  (``tools/trace_merge --postmortem``).

Tap discipline — identical to ``fault/injector.py`` / ``metrics`` /
``guard``: with no trace knob set (the production default) the
module-level :data:`ACTIVE` flag is False, :data:`TAP` IS the shared
no-op singleton :data:`NULL_TAP`, instrumented call sites skip the tap
entirely (``if _trace.ACTIVE: ...`` is the whole overhead), and
:func:`wrap_step` returns the step function UNCHANGED (``wrap_step(f)
is f`` — the zero-overhead proof the tests assert).

Profiler ranges: the hook-driven path also opens ``torch.profiler``
ranges (:func:`profiled`), under a gate of their own: a profiler session
is recording. They cost one flag check a call site without one.

- ``hvd.enqueue``: a gradient hook's compress and enqueue; its input is
  the tensor's name (``DistributedOptimizer.<param>``).
- ``hvd.sync``: ``DistributedOptimizer.synchronize``, and inside it
  ``hvd.sync.copyback``, the loop that takes each reduced gradient and
  writes it into ``p.grad``.
- ``hvd.sync.wait``: ``NativeRuntime.synchronize`` polling the core with
  no plan to run; closed while the caller runs a plan inline, a leaf.
- ``hvd_plan_<id>``: one plan's execution, the id of the core's timeline;
  inside it ``hvd.pack``, ``hvd.allreduce`` and ``hvd.unpack`` on allreduce
  and Adasum plans.

A session records the thread that started it and autograd's threads; the
executor thread's plans only under ``profile_all_threads``.

Clock caveat: rings are stamped with ``time.time()`` (wall clock). The
per-worker offset the pusher estimates against the driver's ``/clock``
endpoint (KV ping RTT/2) is RECORDED as trace metadata, never silently
applied — cross-rank comparisons in the merged trace must be read with
the per-lane ``hvd_clock_offset`` metadata in hand (docs/timeline.md).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Optional

import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("horovod_tpu_torch.trace")

TRACE_ENV = "HOROVOD_TRACE"
TRACE_DIR_ENV = "HOROVOD_TRACE_DIR"
TRACE_RING_ENV = "HOROVOD_TRACE_RING_EVENTS"
TRACE_PUSH_INTERVAL_ENV = "HOROVOD_TRACE_PUSH_INTERVAL_S"
TRACE_STRAGGLER_THRESHOLD_ENV = "HOROVOD_TRACE_STRAGGLER_THRESHOLD_S"

# KV scope worker trace windows are pushed under (driver-side collection
# reads the same scope; mirrors metrics/export.KV_SCOPE).
KV_SCOPE = "trace"

DEFAULT_RING_EVENTS = 2048
DEFAULT_STRAGGLER_THRESHOLD_S = 0.01

# Current flight-dump / pushed-window schema.
SCHEMA = 1


def _ring_capacity() -> int:
    try:
        n = int(os.environ.get(TRACE_RING_ENV, "") or DEFAULT_RING_EVENTS)
    except ValueError:
        n = DEFAULT_RING_EVENTS
    return max(n, 16)


def straggler_threshold_s() -> float:
    """Cross-rank step skew above which the slowest rank is charged one
    ``hvd_straggler_total{rank}`` count (driver-side)."""
    try:
        return float(
            os.environ.get(TRACE_STRAGGLER_THRESHOLD_ENV, "")
            or DEFAULT_STRAGGLER_THRESHOLD_S
        )
    except ValueError:
        return DEFAULT_STRAGGLER_THRESHOLD_S


def trace_dir() -> Optional[str]:
    """Directory for flight-recorder dumps and driver-collected rank
    windows (None = flight dumps disabled)."""
    d = os.environ.get(TRACE_DIR_ENV, "").strip()
    return d or None


def atomic_write(final_path: str, write_fn) -> None:
    """Write via a same-directory temp file + ``os.replace`` so a crash
    mid-write can never leave a torn file under the final name: readers
    see the complete old content or the complete new content, nothing in
    between (POSIX rename atomicity)."""
    tmp = f"{final_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final_path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _rank() -> int:
    v = os.environ.get("HOROVOD_RANK", "")
    return int(v) if v.isdigit() else 0


def _count(name: str, value: float = 1.0, **labels) -> None:
    from .. import metrics as _metrics

    if _metrics.ACTIVE:
        _metrics.TAP.inc(name, value, **labels)


class TraceTap:
    """The live tap: a thread-safe bounded ring of span/event records
    plus the step ledger the straggler attribution feeds on.

    Record shape (plain dicts so windows JSON through the KV plane
    unchanged): ``{"name", "ph" ("X"|"i"|"B"|"E"|"M"), "ts" (wall-clock
    seconds), "dur" (seconds, "X" only), "cat", "tid", "args"}``."""

    def __init__(self, ring_capacity: Optional[int] = None):
        cap = ring_capacity or _ring_capacity()
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=cap)
        # (step_index, t_begin, t_end) wall-clock step boundaries — the
        # feed the driver's skew tracker consumes.
        self._steps: "deque[tuple]" = deque(maxlen=cap)
        self._step_idx = 0
        # Wrapped-step activity: while a wrap_step tap is recording real
        # step spans, the State.commit marker stays a plain instant so
        # one training step is never double-counted in the skew feed.
        self._wrapped_steps = 0
        self._last_commit_t: Optional[float] = None
        self._commit_idx = 0
        # Correlation ids noted at trace time by the fusion/compositor
        # layers; stamped onto every step span (docs/timeline.md).
        self._plan_args: Dict[str, Any] = {}
        # Clock-offset estimate vs the driver (recorded metadata, never
        # applied to timestamps).
        self.clock: Dict[str, Any] = {
            "offset_s": 0.0, "rtt_s": 0.0, "estimated": False,
        }
        self.rank = _rank()

    # ------------------------------------------------------------ record
    def event(self, name: str, ph: str = "i", cat: str = "event",
              dur: Optional[float] = None, ts: Optional[float] = None,
              tid: int = 0, **args) -> dict:
        rec: Dict[str, Any] = {
            "name": name,
            "ph": ph,
            "ts": time.time() if ts is None else float(ts),
            "cat": cat,
            "tid": int(tid),
        }
        if dur is not None:
            rec["dur"] = float(dur)
        if args:
            rec["args"] = args
        with self._lock:
            self._ring.append(rec)
        return rec

    @contextmanager
    def span(self, name: str, cat: str = "phase", **args):
        t0 = time.time()
        try:
            yield
        finally:
            self.event(name, ph="X", cat=cat, ts=t0,
                       dur=time.time() - t0, **args)

    @contextmanager
    def request(self, request_id: Any, **args):
        """One serving-request span (docs/serving.md): an ``hvd_request``
        "X" event on cat ``request`` covering admission → completion,
        stamped with the request id — the serving analogue of the step
        span, renderable by ``tools/trace_merge`` on the same lane
        machinery."""
        t0 = time.time()
        try:
            yield
        finally:
            self.event(
                "hvd_request", ph="X", cat="request", ts=t0,
                dur=time.time() - t0, request_id=str(request_id), **args,
            )

    def timeline_event(self, ev: dict) -> None:
        """Mirror one catapult-timeline record into the ring (wall-clock
        restamped — the timeline's own clock is perf_counter-relative).
        Called from ``utils/timeline.py`` under the ACTIVE gate."""
        rec = {
            "name": ev.get("name", ""),
            "ph": ev.get("ph", "i"),
            "ts": time.time(),
            "cat": "timeline",
            "tid": int(ev.get("tid", 0) or 0),
        }
        args = ev.get("args")
        if args:
            rec["args"] = args
        with self._lock:
            self._ring.append(rec)

    # ------------------------------------------------------- step spans
    def begin_step(self):
        with self._lock:
            idx = self._step_idx
            self._step_idx += 1
        return idx, time.time()

    def end_step(self, token, **args) -> None:
        idx, t0 = token
        t1 = time.time()
        rec = {
            "name": "hvd_step",
            "ph": "X",
            "ts": t0,
            "dur": t1 - t0,
            "cat": "step",
            "tid": 0,
            "args": {"step": idx, **self.plan_args(), **args},
        }
        with self._lock:
            self._ring.append(rec)
            self._steps.append((idx, t0, t1))
            self._wrapped_steps += 1

    @contextmanager
    def step(self, **args):
        token = self.begin_step()
        try:
            yield token[0]
        finally:
            self.end_step(token, **args)

    def commit_step(self, **args) -> None:
        """Mark one elastic commit boundary (``State.commit``). Between
        two commits lies exactly one training step for loops that commit
        per step, so the inter-commit window doubles as the step span —
        unless a :func:`wrap_step` tap is already recording real step
        spans, in which case this stays a plain instant marker (no
        double-counting in the skew feed)."""
        now = time.time()
        with self._lock:
            wrapped = self._wrapped_steps > 0
            last = self._last_commit_t
            self._last_commit_t = now
            idx = self._commit_idx
            self._commit_idx += 1
            self._ring.append({
                "name": "hvd_commit",
                "ph": "i",
                "ts": now,
                "cat": "step",
                "tid": 0,
                "args": {"commit": idx, **args},
            })
            if not wrapped and last is not None:
                self._steps.append((idx - 1, last, now))

    def step_summary(self) -> Dict[str, Any]:
        """Local step-span statistics (``bench.py`` report block)."""
        with self._lock:
            durs = sorted(t1 - t0 for _, t0, t1 in self._steps)
        if not durs:
            return {"steps": 0}

        def pct(p: float) -> float:
            return durs[min(int(p * (len(durs) - 1)), len(durs) - 1)]

        return {
            "steps": len(durs),
            "p50_s": round(pct(0.50), 6),
            "p99_s": round(pct(0.99), 6),
        }

    # ------------------------------------------------- correlation ids
    def note_plan(self, **kw) -> None:
        """Record the active plan/correlation ids (fusion bucket plan,
        topo algorithm, wire dtype) — stamped onto every later step span
        so one trace links step → bucket → collective → hop."""
        with self._lock:
            self._plan_args.update(
                {k: v for k, v in kw.items() if v is not None}
            )

    def plan_args(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._plan_args)

    # ------------------------------------------------------- shipping
    def window(self) -> Dict[str, Any]:
        """The pushable/dumpable view of this rank's recent activity —
        plain data only, bounded by the ring capacity. The window is
        stamped with the CURRENT elastic generation (0 outside elastic
        runs): rank numbers are only meaningful within a generation, so
        the driver's skew attribution must never mix windows across a
        resize (a renumbered or departed rank would be charged for a
        stranger's steps)."""
        with self._lock:
            events = [dict(e) for e in self._ring]
            steps = [list(s) for s in self._steps]
        gen = os.environ.get("HOROVOD_ELASTIC_GEN", "")
        return {
            "schema": SCHEMA,
            "rank": self.rank,
            "gen": int(gen) if gen.isdigit() else 0,
            "clock": dict(self.clock),
            "plan": self.plan_args(),
            "events": events,
            "steps": steps,
        }

    def reset_steps(self) -> None:
        """Restart the step ledger at a world re-formation boundary:
        after an elastic resize ranks are renumbered and a freshly
        promoted worker starts counting from 0, so carrying the old
        cumulative step indices across the generation would misalign
        every cross-rank comparison. The event ring is kept (history is
        still history); only the step-index feed restarts."""
        with self._lock:
            self._steps.clear()
            self._step_idx = 0
            self._wrapped_steps = 0
            self._last_commit_t = None
            self._commit_idx = 0

    def set_clock(self, offset_s: float, rtt_s: float) -> None:
        self.clock = {
            "offset_s": float(offset_s),
            "rtt_s": float(rtt_s),
            "estimated": True,
        }
        self.event(
            "hvd_clock_offset", ph="M", cat="clock",
            offset_s=float(offset_s), rtt_s=float(rtt_s),
        )

    # -------------------------------------------------- flight recorder
    def flight_dump(self, reason: str,
                    directory: Optional[str] = None) -> Optional[str]:
        """Atomically persist the ring (:func:`atomic_write`) as this
        rank's flight-recorder dump. Returns the path, or None when no trace directory is configured. Must never
        raise — it runs on abort/crash paths."""
        try:
            d = directory or trace_dir()
            if not d:
                logger.warning(
                    "flight recorder: no %s configured; dropping the "
                    "%r dump", TRACE_DIR_ENV, reason,
                )
                return None
            os.makedirs(d, exist_ok=True)
            doc = self.window()
            doc["reason"] = reason
            doc["dumped_at"] = time.time()
            payload = json.dumps(doc, sort_keys=True).encode()
            path = os.path.join(d, f"flight.rank{self.rank}.json")
            atomic_write(path, lambda f: f.write(payload))
            _count("hvd_trace_flight_dumps_total", reason=reason)
            logger.warning(
                "flight recorder: dumped %d events to %s (reason: %s)",
                len(doc["events"]), path, reason,
            )
            return path
        except Exception:  # noqa: BLE001 - crash paths must stay crashable
            logger.exception("flight recorder dump failed")
            return None


class _NullTraceTap:
    """Shared no-op tap installed while tracing is disabled. Sites gate
    on :data:`ACTIVE` and never reach it; holders of a tap reference pay
    one empty method call."""

    rank = 0
    clock: Dict[str, Any] = {}

    def event(self, *a, **kw) -> dict:
        return {}

    @contextmanager
    def span(self, *a, **kw):
        yield

    @contextmanager
    def request(self, *a, **kw):
        yield

    def timeline_event(self, ev: dict) -> None:
        pass

    def begin_step(self):
        return (0, 0.0)

    def end_step(self, token, **args) -> None:
        pass

    @contextmanager
    def step(self, **args):
        yield 0

    def commit_step(self, **args) -> None:
        pass

    def step_summary(self) -> Dict[str, Any]:
        return {"steps": 0}

    def note_plan(self, **kw) -> None:
        pass

    def plan_args(self) -> Dict[str, Any]:
        return {}

    def window(self) -> Dict[str, Any]:
        return {}

    def reset_steps(self) -> None:
        pass

    def set_clock(self, offset_s: float, rtt_s: float) -> None:
        pass

    def flight_dump(self, reason: str,
                    directory: Optional[str] = None) -> Optional[str]:
        return None


NULL_TAP = _NullTraceTap()

ACTIVE = False
TAP: Any = NULL_TAP

_lock = threading.Lock()
_prev_excepthook = None


def enabled() -> bool:
    return ACTIVE


def tap():
    """The process-wide tap: the live one when enabled, else the shared
    no-op singleton (``trace.tap() is trace.NULL_TAP``)."""
    return TAP


def _excepthook(exc_type, exc, tb):
    """Uncaught-crash hook: dump the flight ring, then defer to the
    previous hook (the default prints the traceback)."""
    try:
        if ACTIVE and not issubclass(exc_type, KeyboardInterrupt):
            TAP.flight_dump(f"crash:{exc_type.__name__}")
    except Exception:  # noqa: BLE001 - the hook must never mask the crash
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def install(active: bool) -> None:
    """(De)activate fleet tracing for this process. Activation arms the
    uncaught-crash flight-dump hook; deactivation restores the previous
    ``sys.excepthook``."""
    global ACTIVE, TAP, _prev_excepthook
    with _lock:
        if active:
            TAP = TraceTap()
            ACTIVE = True
            if sys.excepthook is not _excepthook:
                _prev_excepthook = sys.excepthook
                sys.excepthook = _excepthook
        else:
            TAP = NULL_TAP
            ACTIVE = False
            if sys.excepthook is _excepthook:
                sys.excepthook = _prev_excepthook or sys.__excepthook__
                _prev_excepthook = None


def activate_from_env() -> bool:
    v = os.environ.get(TRACE_ENV, "").strip().lower()
    on = v not in ("", "0", "false", "no", "off")
    # Pointing a trace dir at the recorder without the master switch
    # still arms it — the flight recorder is the always-on half.
    install(on or bool(os.environ.get(TRACE_DIR_ENV, "").strip()))
    return ACTIVE


def reset() -> None:
    install(False)


def wrap_step(fn, **meta):
    """Wrap a step function with the host-side step tap. With tracing
    disabled this returns ``fn`` ITSELF — the zero-overhead contract
    (``wrap_step(f) is f``) the tests assert. ``meta`` is stamped onto
    every step span's args alongside the noted plan/correlation ids."""
    if not ACTIVE:
        return fn
    tap_ref = TAP

    def traced_step(*args, **kwargs):
        token = tap_ref.begin_step()
        out = fn(*args, **kwargs)
        tap_ref.end_step(token, **meta)
        return out

    traced_step.__wrapped__ = fn
    traced_step.__hvd_trace_wrapped__ = True
    traced_step.__name__ = getattr(fn, "__name__", "step")
    return traced_step


_NO_RANGE = nullcontext()


def profiled(name: str, args: Optional[str] = None):
    """A ``torch.profiler`` range named ``name`` while a profiler session
    records (``torch.autograd.profiler._is_profiler_enabled``, set for the
    whole process), else a shared no-op context: no ``RecordFunction`` is
    built. ``args`` travels as the range's input. A session records the
    ranges of the thread that started it and of autograd's threads; the
    executor thread's only under ``profile_all_threads``."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name, args)
    return _NO_RANGE


def flight_dump(reason: str) -> Optional[str]:
    """Module-level convenience for abort paths: dump when active, no-op
    otherwise."""
    if not ACTIVE:
        return None
    return TAP.flight_dump(reason)


def step_summary() -> Dict[str, Any]:
    return TAP.step_summary()


# Re-exported for the driver/tools (lazy submodule import keeps worker
# import cost at zero when tracing is off).
def __getattr__(name: str):
    if name in ("pusher", "merge"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)


# Arm at import (mirrors fault/injector.py, metrics, guard): worker
# processes spawned with HOROVOD_TRACE/HOROVOD_TRACE_DIR in their
# environment record without code changes.
if (os.environ.get(TRACE_ENV, "").strip()
        or os.environ.get(TRACE_DIR_ENV, "").strip()):
    try:
        activate_from_env()
    except Exception:  # noqa: BLE001 - a malformed knob must not take
        # down production init; surfaced by the trace tools/tests.
        logger.exception("could not arm fleet tracing from env")
