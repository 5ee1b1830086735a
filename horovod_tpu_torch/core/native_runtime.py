"""The eager runtime over the native control-plane core.

The port of ``horovod_tpu/core/native_runtime.py``. The C++ core
(``common/native.py``) owns the background cycle, cross-rank negotiation,
fusion, the response cache, stall detection, the timeline and autotune.
Payloads never cross the ABI: Python keeps the tensors, takes fused plans
from the core, runs them through a :class:`PlanExecutor` and reports
completion.

On the card an operation keeps to streams (the reference's ready events,
``operations.cc:261-285``): enqueue records an event on the caller's
current stream, the executor's stream waits on it before it reads the
input, and ``synchronize`` makes the caller's current stream wait on the
plan's done event, so the host never waits on the device for an operation
on the card.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import torch

from . import as_tensor, record_ready, to_caller
from .. import fault as _fault
from .. import guard as _guard
from .. import metrics as _metrics
from .. import trace as _trace
from ..common.env import Config
from ..common.native import NativeCore, _CoreError
from ..common.topology import Topology
from ..common.types import (
    ReduceOp,
    RequestType,
    ResponseType,
    Status,
    StatusType,
    TensorTableEntry,
    dtype_from_array,
    torch_dtype,
)

logger = logging.getLogger("horovod_tpu_torch")


class PlanExecutor:
    """Executes one fused plan's entries; returns {name: output}."""

    def execute(self, plan: dict, entries, topo: Topology) -> Dict[str, Any]:
        raise NotImplementedError

    def zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A joined rank's stand-in input for a plan it did not enqueue."""
        return torch.zeros(shape, dtype=dtype)

    def thread_init(self) -> None:
        """Called once on the executor thread before its first plan."""

    def done_event(self):
        """The event that marks the last plan's outputs on the card, or
        None when they are ready as returned."""
        return None


class LocalPlanExecutor(PlanExecutor):
    """A one-process job on the CPU: the collectives are (scaled)
    identities. Outputs are new tensors."""

    def execute(self, plan: dict, entries, topo: Topology) -> Dict[str, Any]:
        outputs: Dict[str, Any] = {}
        participants = max(int(plan.get("participants", 1)), 1)
        for entry in entries:
            t = entry.tensor
            if plan["type"] in (ResponseType.ALLREDUCE, ResponseType.ADASUM):
                factor = entry.prescale_factor * entry.postscale_factor
                if entry.reduce_op == ReduceOp.AVERAGE:
                    factor /= participants
                outputs[entry.name] = t.clone() if factor == 1.0 else t * factor
            else:
                outputs[entry.name] = t.clone()
        return outputs


class NativeRuntime:
    """The producer API of ``core.runtime.Runtime`` over the C++ core; an
    executor thread (or a caller blocked in ``synchronize``) consumes its
    plans."""

    def __init__(self, config: Config, topology: Topology,
                 executor: Optional[PlanExecutor] = None,
                 coord_addr: str = "", coord_port: int = 0):
        self.config = config
        self.topology = topology
        if executor is None:
            if topology.size > 1:
                raise NotImplementedError(
                    f"an eager job of {topology.size} processes needs a plan executor over "
                    "torch.distributed (core.nccl_executor.NcclPlanExecutor)")
            executor = LocalPlanExecutor()
        self.executor = executor
        self.core = NativeCore()
        self.core.init(config, topology, coord_addr, coord_port)
        # Per-name FIFO: a name may be enqueued again while its
        # predecessor's plan runs; plans come in acceptance order.
        self._entries: Dict[str, "deque[TensorTableEntry]"] = {}
        self._entries_lock = threading.Lock()
        self._outputs: Dict[str, deque] = {}     # name -> FIFO of (output, done event)
        self._ticket_names: Dict[int, str] = {}
        self._done: Dict[int, tuple] = {}
        self._cv = threading.Condition()
        # Inline execution: a caller blocked in synchronize() pops and runs
        # plans itself, skipping the executor thread's wakeup. Pop and
        # execute are one unit under this lock, so plans run in the core's
        # order whichever thread takes them; an RLock so that a callback
        # may synchronize another handle.
        self._consumer_lock = threading.RLock()
        self._inline_sync = os.environ.get("HOROVOD_INLINE_SYNC", "1") not in ("0", "false")
        self._flush_hint = os.environ.get("HOROVOD_FLUSH_HINT", "1") not in ("0", "false")
        # While any caller waits in synchronize(), the executor thread parks
        # so the waiting thread keeps the consumer role.
        self._sync_waiters = 0
        self._no_waiters = threading.Event()
        self._no_waiters.set()
        self._core_down = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._executor_loop, name="hvd_plan_executor",
                                        daemon=True)
        self._thread.start()

    # --- lifecycle ---
    def start(self) -> None:  # parity with core.runtime.Runtime
        pass

    @property
    def running(self) -> bool:
        return not self._stop.is_set() and self.core.initialized()

    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self.core.shutdown()
        self._thread.join(timeout=30.0)
        with self._cv:
            for t in list(self._ticket_names):
                if t not in self._done:
                    self._done[t] = (Status.Aborted("Horovod has been shut down."), None)
            self._cv.notify_all()

    # --- timeline (later-reference API) ---
    def start_timeline(self, file_path: str, mark_cycles: bool = False):
        code = self.core.start_timeline(file_path, mark_cycles)
        if code:
            raise ValueError(f"could not start timeline at {file_path!r} (status {code}: "
                             "already active, or unwritable path)")

    def stop_timeline(self) -> None:
        self.core.stop_timeline()

    # --- enqueue ---
    def _enqueue(self, request_type: RequestType, name: str, tensor: Any, *,
                 root_rank: int = -1, reduce_op: ReduceOp = ReduceOp.SUM,
                 prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                 callback: Optional[Callable] = None, group_id: int = 0,
                 group_size: int = 0, process_set_id: int = 0) -> int:
        if not self.running:
            from ..common.basics import HorovodInternalError

            raise HorovodInternalError(
                "Horovod runtime is shut down or was never initialized; call hvd.init() first.")
        tensor, host = as_tensor(tensor)
        if _fault.ACTIVE:
            _fault.fault_point("enqueue", name)
            tensor = _fault.payload_fault("payload", name, tensor)
        if _guard.ACTIVE and request_type in (RequestType.ALLREDUCE, RequestType.ADASUM):
            tensor = _guard.TAP.check_payload(name, tensor)
        dtype = int(dtype_from_array(tensor))
        entry = TensorTableEntry(
            name=name, tensor=tensor, root_rank=root_rank, callback=callback,
            reduce_op=reduce_op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            context={"host": host, "ready": record_ready(tensor)})
        if _metrics.ACTIVE:
            entry.context["metrics_enqueue_ts"] = time.monotonic()
            _metrics.TAP.inc("hvd_ops_submitted_total", op=request_type.name)
        with self._entries_lock:
            self._entries.setdefault(name, deque()).append(entry)
        try:
            ticket = self.core.enqueue(
                int(request_type), name, dtype, [int(d) for d in tensor.shape], root_rank,
                int(reduce_op), prescale_factor, postscale_factor, group_id, group_size,
                process_set_id)
        except _CoreError as e:
            with self._entries_lock:
                q = self._entries.get(name)
                # Identity, not equality: only the thread that removes the
                # entry owns its completion.
                idx = next((i for i, x in enumerate(q or ()) if x is entry), None)
                owned = idx is not None
                if owned:
                    del q[idx]
                    if not q:
                        del self._entries[name]
            status = Status(StatusType(e.code if 0 < e.code <= 5 else 1), str(e))
            if owned and entry.callback is not None:
                try:
                    entry.callback(status, None)
                except Exception:  # noqa: BLE001 - the handle carries the error
                    logger.exception("error callback for %s raised", entry.name)
            # A failed handle, like the reference's callback error path.
            with self._cv:
                fake = -int(time.monotonic_ns() % (1 << 62)) - 1
                self._done[fake] = (status, None)
                return fake
        with self._cv:
            self._ticket_names[ticket] = name
        return ticket

    def enqueue_allreduce(self, name, tensor, **kw) -> int:
        return self._enqueue(RequestType.ALLREDUCE, name, tensor, **kw)

    def enqueue_adasum(self, name, tensor, **kw) -> int:
        kw.setdefault("reduce_op", ReduceOp.ADASUM)
        return self._enqueue(RequestType.ADASUM, name, tensor, **kw)

    def enqueue_allgather(self, name, tensor, **kw) -> int:
        return self._enqueue(RequestType.ALLGATHER, name, tensor, **kw)

    def enqueue_broadcast(self, name, tensor, root_rank, **kw) -> int:
        return self._enqueue(RequestType.BROADCAST, name, tensor, root_rank=root_rank, **kw)

    def enqueue_alltoall(self, name, tensor, **kw) -> int:
        return self._enqueue(RequestType.ALLTOALL, name, tensor, **kw)

    def enqueue_reducescatter(self, name, tensor, **kw) -> int:
        return self._enqueue(RequestType.REDUCESCATTER, name, tensor, **kw)

    def enqueue_join(self) -> int:
        if not self.running:
            from ..common.basics import HorovodInternalError

            raise HorovodInternalError("Horovod runtime is shut down.")
        return self.core.enqueue_join()

    # --- process sets ---
    def register_process_set(self, psid: int, ranks) -> None:
        """Register a rank subset in the core (the caller holds the
        cross-rank agreement barrier; the executor's group is created once
        every rank agreed, :meth:`bind_process_set`)."""
        self.core.register_process_set(psid, list(ranks))

    def bind_process_set(self, psid: int, ranks) -> None:
        reg = getattr(self.executor, "register_process_set", None)
        if reg is not None:
            reg(psid, ranks)

    def remove_process_set(self, psid: int) -> None:
        self.core.remove_process_set(psid)
        rem = getattr(self.executor, "remove_process_set", None)
        if rem is not None:
            rem(psid)

    # --- executor loop ---
    def _executor_loop(self) -> None:
        try:
            self.executor.thread_init()
            while not self._stop.is_set() and not self._core_down.is_set():
                if self._sync_waiters > 0:
                    self._no_waiters.wait(timeout=0.05)
                    continue
                with self._consumer_lock:
                    if self._sync_waiters > 0:
                        continue
                    plan = self.core.next_plan(timeout_ms=100)
                    if plan == -1:
                        break
                    if plan in (0, -2):
                        continue
                    self._execute_plan(plan)
        finally:
            # Entries that never reached a plan still hold callbacks: fail
            # them (handle waiters are failed by the core itself).
            with self._entries_lock:
                orphaned = [e for q in self._entries.values() for e in q]
                self._entries.clear()
            status = Status.Aborted("Horovod control plane is down (peer loss or shutdown).")
            for entry in orphaned:
                if entry.callback is not None:
                    try:
                        entry.callback(status, None)
                    except Exception:  # noqa: BLE001
                        logger.exception("error callback for %s raised", entry.name)

    def _execute_plan(self, plan: dict) -> None:
        t0 = time.perf_counter()
        names = plan.get("names", [])
        shapes = plan.get("shapes", [])
        entries = []
        for i, name in enumerate(names):
            with self._entries_lock:
                q = self._entries.get(name)
                entry = q.popleft() if q else None
                if q is not None and not q:
                    del self._entries[name]
            if entry is None:
                # A joined rank: zeros of the coordinator's shape, on the
                # executor's device (the reference's joined-rank behavior).
                entry = TensorTableEntry(
                    name=name,
                    tensor=self.executor.zeros(tuple(shapes[i]) if i < len(shapes) else (),
                                               torch_dtype(plan["dtype"])),
                    reduce_op=ReduceOp(plan["op"]) if plan.get("op") else ReduceOp.SUM,
                    prescale_factor=plan.get("prescale", 1.0),
                    postscale_factor=plan.get("postscale", 1.0),
                    context={"joined": True})
            entries.append(entry)
        ptype = int(plan["type"])
        op_label = ResponseType(ptype).name if ptype <= ResponseType.ERROR else str(ptype)
        status_code, error = 0, ""
        outputs: Dict[str, Any] = {}
        done = None
        if ptype == ResponseType.ERROR:
            # A coordinator-detected conflict: a named abort.
            status_code = int(StatusType.ABORTED)
            error = plan.get("error", "coordinator reported an error")
            logger.error("coordinator abort: %s", error)
        elif ptype != ResponseType.JOIN:
            try:
                # The "hvd_plan_<id>" string of the core's timeline names the
                # plan's range in a torch.profiler trace.
                with torch.profiler.record_function(f"hvd_plan_{plan['id']}"):
                    outputs = self.executor.execute(plan, entries, self.topology)
                done = self.executor.done_event()
            except Exception as exc:  # noqa: BLE001 - reported through the handles
                logger.exception("plan execution failed")
                status_code = int(StatusType.UNKNOWN_ERROR)
                error = f"{type(exc).__name__}: {exc}"
        if _fault.ACTIVE and status_code == 0:
            for entry in entries:
                if entry.name in outputs:
                    outputs[entry.name] = _fault.payload_fault("output", entry.name,
                                                               outputs[entry.name])
        duration = time.perf_counter() - t0
        status = Status.OK() if status_code == 0 else Status(StatusType(status_code), error)
        nbytes = int(plan.get("total_bytes", 0) or 0)
        if _trace.ACTIVE:
            _trace.TAP.event("hvd_plan", ph="X", cat="plan", ts=time.time() - duration,
                             dur=duration, plan=f"hvd_plan_{plan['id']}", op=op_label,
                             tensors=len(names), bytes=nbytes, ok=status_code == 0)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_plans_total", op=op_label)
            _metrics.TAP.observe("hvd_op_execute_seconds", duration, op=op_label)
            if nbytes:
                _metrics.TAP.observe("hvd_op_bytes", nbytes, op=op_label)
            if status_code != 0:
                _metrics.TAP.inc("hvd_op_errors_total", op=op_label)
        for entry in entries:
            if entry.context.get("joined"):
                continue
            out = outputs.get(entry.name)
            if out is not None:
                out = to_caller(out, entry.context.get("host", False))
            if entry.callback is not None:
                try:
                    entry.callback(status, out)
                except Exception:  # noqa: BLE001
                    logger.exception("callback for %s raised", entry.name)
            if status.ok():
                with self._cv:
                    self._outputs.setdefault(entry.name, deque()).append((out, done))
        self.core.plan_done(int(plan["id"]), status_code, error, duration, nbytes)
        with self._cv:
            self._cv.notify_all()

    # --- sync ---
    def poll(self, handle: int) -> bool:
        with self._cv:
            if handle in self._done:
                return True
        state, err = self.core.ticket_status(handle)
        if state == 0:
            return False
        with self._cv:
            name = self._ticket_names.pop(handle, None)
            if state == 1:
                out = (None, None)
                q = self._outputs.get(name) if name else None
                if q:
                    out = q.popleft()
                    if not q:
                        del self._outputs[name]
                self._done[handle] = (Status.OK(), out)
            else:
                code = -state
                self._done[handle] = (Status(StatusType(code if 0 < code <= 5 else 1), err),
                                      None)
        return True

    @staticmethod
    def _hand_over(result):
        """The output of a finished plan, ordered on the caller's current
        stream after the plan's work."""
        out, done = result if isinstance(result, tuple) else (result, None)
        if done is not None and isinstance(out, torch.Tensor) and out.device.type == "cuda":
            stream = torch.cuda.current_stream(out.device)
            stream.wait_event(done)
            out.record_stream(stream)
        return out

    def synchronize(self, handle: int, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._inline_sync:
            with self._cv:
                self._sync_waiters += 1
                self._no_waiters.clear()
        if self._flush_hint:
            # This thread is committed to waiting: the core may seal the
            # next cycle at once.
            self.core.flush_hint()
        try:
            while True:
                if self.poll(handle):
                    with self._cv:
                        status, out = self._done.pop(handle)
                    if not status.ok():
                        from ..common.basics import HorovodInternalError

                        raise HorovodInternalError(status.reason)
                    return self._hand_over(out)
                if deadline is not None and time.monotonic() > deadline:
                    with self._cv:
                        name = self._ticket_names.get(handle, "")
                    raise TimeoutError(
                        "operation " + (f"'{name}' " if name else f"handle {handle} ")
                        + f"did not complete within {timeout}s; it is still in progress")
                if self._inline_sync and self._consumer_lock.acquire(blocking=False):
                    try:
                        if self._stop.is_set():
                            continue
                        plan = self.core.next_plan(timeout_ms=1)
                        if plan == -1:
                            # Core down: wake the executor thread for its drain.
                            self._core_down.set()
                            self._no_waiters.set()
                        elif plan not in (0, -2):
                            self._execute_plan(plan)
                        continue
                    finally:
                        self._consumer_lock.release()
                with self._cv:
                    self._cv.wait(timeout=0.001 if self._inline_sync else 0.01)
        finally:
            if self._inline_sync:
                with self._cv:
                    self._sync_waiters -= 1
                    if self._sync_waiters == 0:
                        self._no_waiters.set()
