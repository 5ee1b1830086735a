"""Horovod Timeline — Chrome-tracing ("catapult") JSON writer.

The port of ``horovod_tpu/utils/timeline.py``, the pure-Python runtime's
timeline (``HOROVOD_TPU_CORE=python``; the native core writes its own).
Parity with the reference timeline (``horovod/common/timeline.h:47-126``,
``timeline.cc``): a dedicated writer thread fed by a queue records
per-tensor NEGOTIATE_* phases, top-level op events, nested activities, and
optional cycle markers. Enabled by ``HOROVOD_TIMELINE=<file>``.

The activity names are the JAX package's (``XLA_ALLREDUCE``, ...) although
the port's collectives run over NCCL or gloo: the native core
(``cpp/src``), shared by both packages, stamps those names on every plan,
and the two runtimes' timelines must read alike. The JSON loads in
chrome://tracing / Perfetto exactly like the reference's.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Optional

from .. import metrics as _metrics
from .. import trace as _trace

logger = logging.getLogger("horovod_tpu_torch.timeline")

# Activity names, mirroring reference common.h:31-59 where applicable.
QUEUE = "QUEUE"
FUSION_PACK = "MEMCPY_IN_FUSION_BUFFER"
FUSION_UNPACK = "MEMCPY_OUT_FUSION_BUFFER"
XLA_ALLREDUCE = "XLA_ALLREDUCE"
XLA_ALLGATHER = "XLA_ALLGATHER"
XLA_BROADCAST = "XLA_BROADCAST"
XLA_ALLTOALL = "XLA_ALLTOALL"
XLA_REDUCESCATTER = "XLA_REDUCESCATTER"
XLA_ADASUM = "XLA_ADASUM"
NEGOTIATE_PREFIX = "NEGOTIATE_"
CYCLE_NAME = "CYCLE"


class TimelineWriter:
    """Background thread that serializes events to the trace file."""

    def __init__(self, filename: str):
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._filename = filename
        self._healthy = True
        self._drop_lock = threading.Lock()
        self._crash_exc: Optional[BaseException] = None
        self._warned = False
        # Events lost to a dead writer thread or an undrained shutdown —
        # also counted in hvd_timeline_dropped_total so a silently
        # truncated trace is visible on /metrics.
        self.dropped = 0
        self._thread = threading.Thread(
            target=self._run, name="hvd_timeline_writer", daemon=True
        )
        self._thread.start()

    def _note_drops(self, n: int, why: str) -> None:
        if n <= 0:
            return
        with self._drop_lock:
            self.dropped += n
            first = not self._warned
            self._warned = True
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_timeline_dropped_total", n)
        if first:
            # One-shot: name the ORIGINAL failure — every later enqueue
            # is dropped for the same root cause, and re-warning per
            # event would bury it.
            logger.warning(
                "timeline %s: dropping events (%s; original error: %r); "
                "further drops are counted in hvd_timeline_dropped_total "
                "only", self._filename, why, self._crash_exc,
            )

    def enqueue(self, event: dict) -> None:
        if self._healthy:
            self._queue.put(event)
        else:
            self._note_drops(1, "writer thread died")

    def shutdown(self, timeout: float = 5.0) -> None:
        self._queue.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # The join timed out with the thread still draining (or
            # wedged on a slow filesystem): whatever is still queued
            # will never be written by the time callers treat the file
            # as final — say so instead of returning as if complete.
            pending = self._queue.qsize()
            logger.warning(
                "timeline: writer thread still alive after %.1fs "
                "shutdown timeout; ~%d queued event(s) will not reach "
                "%s", timeout, pending, self._filename,
            )
            self._note_drops(max(pending, 1), "shutdown join timed out")

    def _run(self) -> None:
        try:
            with open(self._filename, "w") as f:
                # Chrome tracing JSON array format; leave unterminated like
                # the reference so partial traces still load
                # (timeline.cc WriteAtFileStart writes "[\n").
                f.write("[\n")
                first = True
                while True:
                    ev = self._queue.get()
                    if ev is None:
                        break
                    if not first:
                        f.write(",\n")
                    json.dump(ev, f)
                    first = False
                    if self._queue.empty():
                        f.flush()
                f.write("\n]\n")
        except OSError as exc:
            self._crash_exc = exc
            self._healthy = False
            # Anything already queued behind the crash is lost too.
            self._note_drops(self._queue.qsize(), "writer thread died")


class Timeline:
    """Per-process timeline state machine.

    States per tensor: NEGOTIATING → TOP_LEVEL → ACTIVITY (reference
    ``timeline.h:77-126``). Thread-safe; no-ops when not initialized.
    """

    def __init__(self):
        self._writer: Optional[TimelineWriter] = None
        self._lock = threading.RLock()
        self._start = time.perf_counter()
        self._tensor_tids: dict[str, int] = {}
        self._next_tid = 1
        self._rank = 0

    def initialize(self, filename: str, rank: int = 0) -> None:
        with self._lock:
            if self._writer is not None or not filename:
                return
            self._rank = rank
            # A restarted session (runtime start/stop_timeline) gets its
            # own clock origin and re-emits thread_name metadata into
            # ITS file — stale tids would leave unnamed tracks.
            self._start = time.perf_counter()
            self._tensor_tids.clear()
            self._next_tid = 1
            self._writer = TimelineWriter(filename)
            self._emit(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": self._rank,
                    "args": {"name": f"rank {self._rank}"},
                }
            )

    @property
    def initialized(self) -> bool:
        return self._writer is not None

    def shutdown(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.shutdown()
                self._writer = None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._start) * 1e6

    def _tid(self, tensor_name: str) -> int:
        tid = self._tensor_tids.get(tensor_name)
        if tid is None:
            tid = self._next_tid
            self._next_tid += 1
            self._tensor_tids[tensor_name] = tid
            self._emit(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self._rank,
                    "tid": tid,
                    "args": {"name": tensor_name},
                }
            )
        return tid

    def _emit(self, ev: dict) -> None:
        if self._writer is not None:
            self._writer.enqueue(ev)
            if _trace.ACTIVE:
                # Fleet tracing mirror (docs/timeline.md "Fleet
                # tracing"): the same record lands in the bounded trace
                # ring, wall-clock stamped, so the driver-merged fleet
                # view and the flight recorder carry the per-tensor
                # phases too. Disabled → not reached.
                _trace.TAP.timeline_event(ev)

    def metadata(self, name: str, args: dict) -> None:
        """Emit a process-scoped metadata record (Chrome-trace "M" phase) —
        run facts a trace reader needs to interpret timings."""
        with self._lock:
            if self._writer is None:
                return
            self._emit(
                {"name": name, "ph": "M", "pid": self._rank, "args": args}
            )

    # --- public recording API ---
    def negotiate_start(self, tensor_name: str, op_name: str) -> None:
        self._dur_begin(tensor_name, NEGOTIATE_PREFIX + op_name)

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        with self._lock:
            if self._writer is None:
                return
            self._emit(
                {
                    "name": str(rank),
                    "ph": "i",
                    "s": "t",
                    "pid": self._rank,
                    "tid": self._tid(tensor_name),
                    "ts": self._now_us(),
                }
            )

    def negotiate_end(self, tensor_name: str, op_name: str) -> None:
        self._dur_end(tensor_name, NEGOTIATE_PREFIX + op_name)

    def start(self, tensor_name: str, op_name: str) -> None:
        self._dur_begin(tensor_name, op_name)

    def end(self, tensor_name: str, op_name: str) -> None:
        self._dur_end(tensor_name, op_name)

    def activity_start(self, tensor_name: str, activity: str) -> None:
        self._dur_begin(tensor_name, activity)

    def activity_end(self, tensor_name: str, activity: str) -> None:
        self._dur_end(tensor_name, activity)

    def mark_cycle_start(self) -> None:
        with self._lock:
            if self._writer is None:
                return
            self._emit(
                {
                    "name": CYCLE_NAME,
                    "ph": "i",
                    "s": "g",
                    "pid": self._rank,
                    "tid": 0,
                    "ts": self._now_us(),
                }
            )

    def _dur_begin(self, tensor_name: str, name: str) -> None:
        with self._lock:
            if self._writer is None:
                return
            self._emit(
                {
                    "name": name,
                    "ph": "B",
                    "pid": self._rank,
                    "tid": self._tid(tensor_name),
                    "ts": self._now_us(),
                }
            )

    def _dur_end(self, tensor_name: str, name: str) -> None:
        with self._lock:
            if self._writer is None:
                return
            self._emit(
                {
                    "name": name,
                    "ph": "E",
                    "pid": self._rank,
                    "tid": self._tid(tensor_name),
                    "ts": self._now_us(),
                }
            )
