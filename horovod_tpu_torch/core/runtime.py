"""The pure-Python eager runtime: named async enqueue and a background loop.

The port of ``horovod_tpu/core/runtime.py``, chosen with
``HOROVOD_TPU_CORE=python`` (the native core of :mod:`.native_runtime` is
the default). All collective work happens on one background thread
(``operations.cc:306-326``): callers enqueue named tensors into a
``TensorQueue``, and the loop wakes every ``cycle_time_ms`` to validate,
fuse and execute. Like the JAX package's, this runtime serves a job of one
process: a multi-process job runs on the native core.

``HOROVOD_TIMELINE`` and ``start_timeline`` write the catapult timeline of
``utils/timeline.py`` with the JAX runtime's events and names; the
metrics (``hvd_op_*``, ``hvd_queue_depth``, ``hvd_cycle_seconds``, the
stall counters) and the ``hvd_response`` spans sit at the JAX runtime's
sites, as do the fault plan's taps (``enqueue`` and ``payload`` at
submission, ``response`` and ``output`` at execution).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import as_tensor, record_ready, to_caller
from ..fault import injector as _fault
from .. import guard as _guard
from .. import metrics as _metrics
from .. import trace as _trace
from ..common.env import Config
from ..common.topology import Topology
from ..common.types import (
    DUPLICATE_NAME_ERROR_FMT,
    SHUT_DOWN_ERROR,
    DataType,
    ReduceOp,
    RequestType,
    ResponseType,
    Status,
    TensorTableEntry,
    dtype_from_array,
    dtype_size,
)
from ..utils.timeline import (
    XLA_ADASUM,
    XLA_ALLGATHER,
    XLA_ALLREDUCE,
    XLA_ALLTOALL,
    XLA_BROADCAST,
    XLA_REDUCESCATTER,
    Timeline,
)

logger = logging.getLogger("horovod_tpu_torch")

# The timeline's activity name of each request type: the JAX runtime's, which
# the native core stamps too (utils/timeline.py says why the port keeps them).
_REQ_TO_TIMELINE = {
    RequestType.ALLREDUCE: XLA_ALLREDUCE,
    RequestType.ALLGATHER: XLA_ALLGATHER,
    RequestType.BROADCAST: XLA_BROADCAST,
    RequestType.ALLTOALL: XLA_ALLTOALL,
    RequestType.REDUCESCATTER: XLA_REDUCESCATTER,
    RequestType.ADASUM: XLA_ADASUM,
}


@dataclass
class Request:
    """Readiness announcement for one named tensor (reference message.h:46-96)."""

    rank: int
    request_type: RequestType
    tensor_name: str
    dtype: int = 0
    shape: Tuple[int, ...] = ()
    root_rank: int = -1
    reduce_op: int = int(ReduceOp.SUM)
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    group_id: int = 0
    group_size: int = 0
    process_set_id: int = 0


@dataclass
class Response:
    """Coordinator verdict: tensors to execute together, or an error
    (reference message.h:126-216)."""

    response_type: ResponseType
    tensor_names: List[str] = field(default_factory=list)
    error_message: str = ""


def describe_request(req: Request) -> str:
    """Human-readable announcement signature for conflict messages."""
    try:
        dtype = DataType(req.dtype).name.lower()
    except ValueError:
        dtype = str(req.dtype)
    parts = [req.request_type.name.lower(), f"dtype={dtype}", f"shape={tuple(req.shape)}"]
    if req.request_type in (RequestType.ALLREDUCE, RequestType.ADASUM):
        parts.append(f"op={ReduceOp(req.reduce_op).name}")
    if req.request_type == RequestType.BROADCAST:
        parts.append(f"root={req.root_rank}")
    if req.process_set_id:
        parts.append(f"process_set={req.process_set_id}")
    return " ".join(parts)


class NegotiationTable:
    """Cross-rank metadata validation (the coordinator half of
    ``Controller::ConstructResponse``'s checks): each announcement of a
    name is checked against the first one seen, and a conflict (operation,
    dtype, shape, root, reduce op, process set) returns a message naming
    the tensor and both ranks. The native core does the same checks on its
    coordinator thread."""

    def __init__(self):
        self._first: Dict[str, Request] = {}

    def clear(self, names: Sequence[str]) -> None:
        for n in names:
            self._first.pop(n, None)

    def observe(self, req: Request) -> Optional[str]:
        if req.request_type == RequestType.JOIN:
            return None
        first = self._first.get(req.tensor_name)
        if first is None or first.rank == req.rank:
            self._first[req.tensor_name] = req
            return None

        def conflict(kind: str) -> str:
            return (f"{kind} for tensor '{req.tensor_name}': rank {first.rank} announced "
                    f"[{describe_request(first)}] but rank {req.rank} announced "
                    f"[{describe_request(req)}]")

        if req.process_set_id != first.process_set_id:
            return conflict("Mismatched process sets")
        if req.request_type != first.request_type:
            return conflict("Mismatched collective operations")
        if req.dtype != first.dtype:
            return conflict("Mismatched data types")
        if req.request_type == RequestType.BROADCAST and req.root_rank != first.root_rank:
            return conflict("Mismatched root ranks")
        if (req.request_type in (RequestType.ALLREDUCE, RequestType.ADASUM)
                and req.reduce_op != first.reduce_op):
            return conflict("Mismatched reduce operations")
        if req.request_type == RequestType.ALLGATHER:
            if len(req.shape) != len(first.shape) or req.shape[1:] != first.shape[1:]:
                return conflict("Mismatched allgather dimensions")
        elif tuple(req.shape) != tuple(first.shape):
            return conflict("Mismatched shapes")
        return None

    def validate(self, requests: Sequence[Request]) -> List[Response]:
        """Observe a batch of announcements and emit one error Response per
        conflicting tensor."""
        out: List[Response] = []
        failed: set = set()
        for req in requests:
            if req.tensor_name in failed:
                continue
            msg = self.observe(req)
            if msg is not None:
                failed.add(req.tensor_name)
                out.append(Response(ResponseType.ERROR, [req.tensor_name], error_message=msg))
                self._first.pop(req.tensor_name, None)
        return out


class TensorQueue:
    """Thread-safe pending-tensor table (reference tensor_queue.cc): rejects
    duplicate names (common.h:160-163) and drains with an abort status on
    shutdown."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: "OrderedDict[str, Tuple[Request, TensorTableEntry]]" = OrderedDict()
        self._pending: List[Request] = []

    def add(self, request: Request, entry: TensorTableEntry) -> Status:
        with self._lock:
            if entry.name in self._table:
                op = request.request_type.name.lower()
                return Status.PreconditionError(DUPLICATE_NAME_ERROR_FMT.format(op=op))
            self._table[entry.name] = (request, entry)
            self._pending.append(request)
            return Status.OK()

    def pop_requests(self) -> List[Request]:
        with self._lock:
            out, self._pending = self._pending, []
            return out

    def take_entry(self, name: str) -> Optional[TensorTableEntry]:
        with self._lock:
            item = self._table.pop(name, None)
            return item[1] if item is not None else None

    def size(self) -> int:
        with self._lock:
            return len(self._table)

    def drain(self, status: Status) -> None:
        with self._lock:
            entries = [e for _, e in self._table.values()]
            self._table.clear()
            self._pending.clear()
        for entry in entries:
            if entry.callback is not None:
                entry.callback(status, None)


class HandleManager:
    """Handle -> (status, output) for the async API (reference
    torch/handle_manager.cc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next = 0
        self._results: Dict[int, Tuple[Status, Any]] = {}
        self._names: Dict[int, str] = {}

    def allocate(self, name: str = "") -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = (Status.InProgress(), None)
            if name:
                self._names[h] = name
            return h

    def mark_done(self, handle: int, status: Status, output: Any) -> None:
        with self._cv:
            self._results[handle] = (status, output)
            self._cv.notify_all()

    def poll(self, handle: int) -> bool:
        with self._lock:
            if handle not in self._results:
                # Already synchronized and released: complete.
                return True
            return not self._results[handle][0].in_progress()

    def wait(self, handle: int, timeout: Optional[float] = None) -> Tuple[Status, Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                st, out = self._results.get(handle, (Status.InProgress(), None))
                if not st.in_progress():
                    self._results.pop(handle, None)
                    self._names.pop(handle, None)
                    return st, out
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    # The handle stays allocated: the op may still complete.
                    name = self._names.get(handle, "")
                    return Status.TimedOut(
                        "operation " + (f"'{name}' " if name else f"handle {handle} ")
                        + f"did not complete within {timeout}s; it is still in progress"), None
                self._cv.wait(timeout=0.1 if remaining is None else min(0.1, remaining))


@dataclass
class StallReport:
    warned: List[str] = field(default_factory=list)
    aborted: List[str] = field(default_factory=list)
    shutdown: bool = False


class StallInspector:
    """Escalation ladder for tensors waiting too long (reference
    stall_inspector.cc and the JAX package's rungs): warn after
    ``stall_warning_time_seconds`` and re-warn every
    ``stall_rewarn_seconds``; abort the tensor after
    ``stall_abort_time_seconds``; shut the runtime down after
    ``stall_shutdown_time_seconds``."""

    def __init__(self, config: Config):
        self._config = config
        self._first_seen: Dict[str, float] = {}
        self._last_warned: Dict[str, float] = {}
        self.should_shutdown = False

    def record(self, names: Sequence[str]) -> None:
        now = time.monotonic()
        for n in names:
            self._first_seen.setdefault(n, now)

    def clear(self, names: Sequence[str]) -> None:
        for n in names:
            self._first_seen.pop(n, None)
            self._last_warned.pop(n, None)

    def stalled_names(self) -> List[str]:
        return sorted(self._first_seen)

    def check(self, missing_ranks: Optional[Dict[str, List[int]]] = None) -> StallReport:
        report = StallReport()
        cfg = self._config
        if cfg.stall_check_disable:
            return report
        now = time.monotonic()
        rewarn = cfg.stall_rewarn_seconds or cfg.stall_warning_time_seconds
        for n, t in self._first_seen.items():
            if now - t <= cfg.stall_warning_time_seconds:
                continue
            last = self._last_warned.get(n)
            if last is None or now - last > rewarn:
                report.warned.append(n)
        if report.warned:
            known = {n: missing_ranks[n] for n in report.warned
                     if missing_ranks and missing_ranks.get(n)}
            detail = (" Missing ranks: " + "; ".join(
                f"{n} <- {sorted(r)}" for n, r in sorted(known.items()))) if known else ""
            logger.warning(
                "One or more tensors were submitted to be reduced, gathered or broadcasted by "
                "subset of ranks and are waiting for remainder of ranks for more than %d "
                "seconds. Stalled ops: %s.%s", int(cfg.stall_warning_time_seconds),
                ", ".join(sorted(report.warned)), detail)
            for n in report.warned:
                self._last_warned[n] = now
        if cfg.stall_abort_time_seconds > 0:
            report.aborted = [n for n, t in self._first_seen.items()
                              if now - t > cfg.stall_abort_time_seconds]
        if cfg.stall_shutdown_time_seconds > 0 and any(
                now - t > cfg.stall_shutdown_time_seconds for t in self._first_seen.values()):
            self.should_shutdown = report.shutdown = True
        return report


class Coordinator:
    """Controller protocol seam (reference controller.h:63-97): this rank's
    new requests in, globally agreed fused Responses out."""

    def compute_response_list(self, requests: List[Request], queue: TensorQueue,
                              config: Config) -> List[Response]:
        raise NotImplementedError

    def missing_ranks(self) -> Dict[str, List[int]]:
        return {}

    def shutdown(self) -> None:
        pass


def dtype_size_or(dtype: int, default: int = 4) -> int:
    try:
        return dtype_size(DataType(dtype))
    except (ValueError, KeyError):
        return default


class SingleProcessCoordinator(Coordinator):
    """Everything announced is ready: fuse same-signature allreduces up to
    the fusion threshold in submission order (reference FuseResponses,
    controller.cc:626-750). Grouped members are held until the group is
    complete, then fuse regardless of the threshold."""

    def __init__(self):
        self._groups: Dict[int, List[Request]] = {}

    def compute_response_list(self, requests: List[Request], queue: TensorQueue,
                              config: Config) -> List[Response]:
        emit: List[Request] = []
        for req in requests:
            if req.request_type != RequestType.JOIN and req.group_id:
                members = self._groups.setdefault(req.group_id, [])
                members.append(req)
                if len(members) >= req.group_size:
                    emit.extend(self._groups.pop(req.group_id))
            else:
                emit.append(req)
        responses: List[Response] = []
        current: Optional[Response] = None
        current_key = None
        current_bytes = 0
        for req in emit:
            if req.request_type == RequestType.JOIN:
                responses.append(Response(ResponseType.JOIN, [req.tensor_name]))
                current, current_key = None, None
                continue
            rtype = ResponseType(int(req.request_type))
            nbytes = math.prod(req.shape or (1,)) * dtype_size_or(req.dtype)
            key = (rtype, req.dtype, req.reduce_op, req.root_rank, req.prescale_factor,
                   req.postscale_factor, req.group_id, req.process_set_id)
            fusable = rtype in (ResponseType.ALLREDUCE, ResponseType.ADASUM)
            if (fusable and current is not None and key == current_key
                    and (req.group_id
                         or current_bytes + nbytes <= config.fusion_threshold_bytes)):
                current.tensor_names.append(req.tensor_name)
                current_bytes += nbytes
            else:
                current = Response(rtype, [req.tensor_name])
                current_key = key if fusable else None
                current_bytes = nbytes
                responses.append(current)
        return responses


class DataPlane:
    """Executes one fused Response's entries."""

    def execute(self, response: Response, entries: List[TensorTableEntry],
                topo: Topology) -> Status:
        raise NotImplementedError


class LocalDataPlane(DataPlane):
    """Size-1 data plane: the collectives are (scaled) identities, computed
    on the tensor's own device, outputs new tensors. On the card it waits on
    the entry's ready event and returns once the results are computed (this
    runtime serves development runs; the native core's executor is the one
    that keeps work on streams)."""

    def execute(self, response: Response, entries: List[TensorTableEntry],
                topo: Topology) -> Status:
        for entry in entries:
            t = entry.tensor
            ready = entry.context.get("ready")
            if ready is not None:
                torch.cuda.current_stream(t.device).wait_event(ready)
            if response.response_type in (ResponseType.ALLREDUCE, ResponseType.ADASUM):
                factor = entry.prescale_factor * entry.postscale_factor
                if entry.reduce_op == ReduceOp.AVERAGE:
                    factor /= topo.size
                entry.output = t.clone() if factor == 1.0 else t * factor
            elif response.response_type in (ResponseType.ALLGATHER, ResponseType.BROADCAST,
                                            ResponseType.ALLTOALL, ResponseType.REDUCESCATTER):
                entry.output = t.clone()
            else:
                return Status.UnknownError(f"Unsupported response type {response.response_type}")
            if t.device.type == "cuda":
                torch.cuda.current_stream(t.device).synchronize()
        return Status.OK()


class Runtime:
    """Background-loop owner; the analogue of HorovodGlobalState and
    BackgroundThreadLoop (``operations.cc:328-529``)."""

    def __init__(self, config: Config, topology: Topology,
                 coordinator: Optional[Coordinator] = None,
                 data_plane: Optional[DataPlane] = None):
        self.config = config
        self.topology = topology
        self.coordinator = coordinator or SingleProcessCoordinator()
        if data_plane is None:
            if topology.size > 1:
                # Never run a multi-rank job on the identity plane.
                raise NotImplementedError(
                    f"the pure-Python runtime serves a job of one process; a job of "
                    f"{topology.size} runs on the native core (HOROVOD_TPU_CORE=native)")
            data_plane = LocalDataPlane()
        self.data_plane = data_plane
        self.tensor_queue = TensorQueue()
        self.handle_manager = HandleManager()
        self.timeline = Timeline()
        self.stall_inspector = StallInspector(config)
        self.negotiation = NegotiationTable()
        self.joined = False
        self._drain_status: Optional[Status] = None
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._initialized = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self._process_sets: Dict[int, List[int]] = {}

    # --- process sets ---
    def register_process_set(self, psid: int, ranks) -> None:
        rs = sorted(int(r) for r in ranks)
        if not rs or rs[0] < 0 or rs[-1] >= self.topology.size:
            raise ValueError("process set ranks must lie in [0, size)")
        with self._state_lock:
            self._process_sets[int(psid)] = rs

    def remove_process_set(self, psid: int) -> None:
        with self._state_lock:
            if self._process_sets.pop(int(psid), None) is None:
                raise ValueError(f"process set {psid} is not registered")

    # --- lifecycle ---
    def start(self) -> None:
        if self._thread is not None:
            return
        if self.config.timeline_filename:
            self.timeline.initialize(self.config.timeline_filename, self.topology.rank)
        self._thread = threading.Thread(target=self._background_loop, name="hvd_background",
                                        daemon=True)
        self._thread.start()
        self._initialized.wait(timeout=60.0)

    def shutdown(self) -> None:
        if self._thread is None:
            return
        self._shutdown.set()
        self._wake.set()
        self._thread.join(timeout=30.0)
        self._thread = None
        self.tensor_queue.drain(SHUT_DOWN_ERROR)
        self.coordinator.shutdown()
        self.timeline.shutdown()

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._shutdown.is_set()

    # --- enqueue (reference EnqueueTensor*, operations.cc:783-934) ---
    def _enqueue(self, request_type: RequestType, name: str, tensor: Any, *,
                 root_rank: int = -1, reduce_op: ReduceOp = ReduceOp.SUM,
                 prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                 callback: Optional[Callable[[Status, Any], None]] = None,
                 group_id: int = 0, group_size: int = 0, process_set_id: int = 0) -> int:
        if self._shutdown.is_set() or self._thread is None:
            from ..common.basics import HorovodInternalError

            raise HorovodInternalError(
                "Horovod runtime is shut down or was never initialized; call hvd.init() first.")
        if process_set_id != 0:
            with self._state_lock:
                members = self._process_sets.get(process_set_id)
            if members is None:
                raise RuntimeError(f"process set {process_set_id} is not registered on this rank")
            if self.topology.rank not in members:
                raise RuntimeError(
                    f"rank {self.topology.rank} is not a member of process set {process_set_id}")
        if _fault.ACTIVE:
            _fault.fault_point("enqueue", name)
            tensor = _fault.payload_fault("payload", name, tensor)
        if _guard.ACTIVE and request_type in (RequestType.ALLREDUCE, RequestType.ADASUM):
            tensor = _guard.TAP.check_payload(name, tensor)
        context = {}
        if tensor is not None:
            tensor, context["host"] = as_tensor(tensor)
            context["ready"] = record_ready(tensor)
        handle = self.handle_manager.allocate(name)

        def _done(status: Status, output: Any) -> None:
            if callback is not None:
                try:
                    callback(status, output)
                except Exception:  # noqa: BLE001 - a user callback must not kill the loop
                    logger.exception("callback for %s raised", name)
            self.handle_manager.mark_done(handle, status, output)

        request = Request(
            rank=self.topology.rank, request_type=request_type, tensor_name=name,
            dtype=int(dtype_from_array(tensor)) if tensor is not None else 0,
            shape=tuple(int(d) for d in getattr(tensor, "shape", ())),
            root_rank=root_rank, reduce_op=int(reduce_op), prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, group_id=group_id, group_size=group_size,
            process_set_id=process_set_id)
        entry = TensorTableEntry(
            name=name, tensor=tensor, root_rank=root_rank, callback=_done, reduce_op=reduce_op,
            prescale_factor=prescale_factor, postscale_factor=postscale_factor,
            context=context)
        status = self.tensor_queue.add(request, entry)
        if not status.ok():
            self.handle_manager.mark_done(handle, status, None)
            return handle
        if _metrics.ACTIVE:
            entry.context["metrics_enqueue_ts"] = time.monotonic()
            _metrics.TAP.inc("hvd_ops_submitted_total", op=request_type.name)
        if self.timeline.initialized:
            self.timeline.negotiate_start(name, request_type.name)
        self._wake.set()
        return handle

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
        with self._state_lock:
            self.joined = True
        return self._enqueue(RequestType.JOIN, f"join.{self.topology.rank}", None)

    # --- background loop (reference RunLoopOnce, operations.cc:531-581) ---
    def _background_loop(self) -> None:
        self._initialized.set()
        cycle_s = max(self.config.cycle_time_ms, 0.05) / 1000.0
        while not self._shutdown.is_set():
            self._wake.wait(timeout=cycle_s)
            self._wake.clear()
            if self._shutdown.is_set():
                break
            try:
                self._run_cycle_once()
            except Exception:  # noqa: BLE001 - drained below, never hangs a waiter
                logger.exception("background cycle raised; draining queue")
                self.tensor_queue.drain(Status.UnknownError("background loop failure"))
        self.tensor_queue.drain(self._drain_status or SHUT_DOWN_ERROR)

    def _run_cycle_once(self) -> None:
        cycle_t0 = time.perf_counter() if _metrics.ACTIVE else 0.0
        if self.timeline.initialized and self.config.timeline_mark_cycles:
            self.timeline.mark_cycle_start()
        requests = self.tensor_queue.pop_requests()
        self.stall_inspector.record([r.tensor_name for r in requests])
        error_responses = self.negotiation.validate(requests)
        if error_responses:
            failed = {n for r in error_responses for n in r.tensor_names}
            requests = [r for r in requests if r.tensor_name not in failed]
            for response in error_responses:
                self._perform_operation(response)
        for response in self.coordinator.compute_response_list(
                requests, self.tensor_queue, self.config):
            self._perform_operation(response)
        missing = self.coordinator.missing_ranks()
        report = self.stall_inspector.check(missing)
        if _metrics.ACTIVE:
            _metrics.TAP.set("hvd_queue_depth", float(self.tensor_queue.size()))
            _metrics.TAP.observe("hvd_cycle_seconds", time.perf_counter() - cycle_t0)
            if report.warned:
                _metrics.TAP.inc("hvd_stall_warnings_total", len(report.warned))
            if report.aborted:
                _metrics.TAP.inc("hvd_stall_aborts_total", len(report.aborted))
            if report.shutdown:
                _metrics.TAP.inc("hvd_stall_shutdowns_total")
        if report.aborted and _trace.ACTIVE:
            _trace.TAP.flight_dump("stall-abort")
        for name in report.aborted:
            entry = self.tensor_queue.take_entry(name)
            self.stall_inspector.clear([name])
            if entry is None:
                continue
            ranks = missing.get(name) if missing else None
            status = Status.Aborted(
                f"collective '{name}' aborted: waited longer than "
                f"HOROVOD_STALL_ABORT_TIME_SECONDS={self.config.stall_abort_time_seconds:g}s "
                "for peer ranks" + (f" {sorted(ranks)}" if ranks else "") + " to submit it")
            logger.error("%s", status.reason)
            if entry.callback is not None:
                entry.callback(status, None)
        if self.stall_inspector.should_shutdown:
            stalled = self.stall_inspector.stalled_names()
            self._drain_status = Status.Aborted(
                "stall shutdown: tensors [" + ", ".join(stalled)
                + "] exceeded HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
                f"{self.config.stall_shutdown_time_seconds:g}s; aborting the runtime")
            logger.error("%s", self._drain_status.reason)
            if _trace.ACTIVE:
                _trace.TAP.flight_dump("stall-shutdown")
            self._shutdown.set()

    def _perform_operation(self, response: Response) -> None:
        # Reference PerformOperation (operations.cc:227-304).
        if response.response_type == ResponseType.JOIN:
            with self._state_lock:
                self.joined = False
            self.stall_inspector.clear(response.tensor_names)
            for name in response.tensor_names:
                entry = self.tensor_queue.take_entry(name)
                if entry and entry.callback:
                    entry.callback(Status.OK(), None)
            return
        entries = [e for e in (self.tensor_queue.take_entry(n) for n in response.tensor_names)
                   if e is not None]
        if not entries:
            return
        if _fault.ACTIVE:
            _fault.fault_point("response", entries[0].name)
        self.stall_inspector.clear([e.name for e in entries])
        self.negotiation.clear([e.name for e in entries])
        rtype = int(response.response_type)
        timeline_name = _REQ_TO_TIMELINE.get(
            RequestType(rtype) if rtype <= int(RequestType.ADASUM) else None, "OP")
        op_label = timeline_name.replace("XLA_", "")
        if self.timeline.initialized:
            for e in entries:
                self.timeline.negotiate_end(e.name, op_label)
                self.timeline.start(e.name, timeline_name)
        if _metrics.ACTIVE:
            now = time.monotonic()
            for e in entries:
                ts = e.context.pop("metrics_enqueue_ts", None)
                if ts is not None:
                    _metrics.TAP.observe("hvd_op_negotiate_seconds", now - ts, op=op_label)
        exec_t0 = time.perf_counter() if (_metrics.ACTIVE or _trace.ACTIVE) else 0.0
        if response.response_type == ResponseType.ERROR:
            status = Status.Aborted(response.error_message)
            logger.error("%s", response.error_message)
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_guard_metadata_aborts_total")
        else:
            try:
                status = self.data_plane.execute(response, entries, self.topology)
            except Exception as exc:  # noqa: BLE001 - reported through the handles
                logger.exception("data plane failure")
                status = Status.UnknownError(str(exc))
        nbytes = sum(int(getattr(e.tensor, "nbytes", 0) or 0) for e in entries)
        if _metrics.ACTIVE:
            _metrics.TAP.observe("hvd_op_execute_seconds", time.perf_counter() - exec_t0,
                                 op=op_label)
            if nbytes:
                _metrics.TAP.observe("hvd_op_bytes", nbytes, op=op_label)
            if not status.ok():
                _metrics.TAP.inc("hvd_op_errors_total", op=op_label)
        if _trace.ACTIVE:
            dur = time.perf_counter() - exec_t0
            _trace.TAP.event("hvd_response", ph="X", cat="op", ts=time.time() - dur, dur=dur,
                             op=op_label, tensors=len(entries), nbytes=nbytes,
                             ok=bool(status.ok()))
        if self.timeline.initialized:
            for e in entries:
                self.timeline.end(e.name, timeline_name)
        if _fault.ACTIVE and status.ok():
            # The output tap: a scheduled corrupt flips a bit of THIS rank's
            # result only (the silent-divergence model).
            for e in entries:
                e.output = _fault.payload_fault("output", e.name, e.output)
        for entry in entries:
            if entry.callback is not None:
                entry.callback(status, to_caller(entry.output, entry.context.get("host", False))
                               if status.ok() else None)

    # --- timeline (later-reference API) ---
    def start_timeline(self, file_path: str, mark_cycles: bool = False):
        if self.timeline.initialized:
            raise ValueError("timeline is already active")
        # The writer opens its file on its own thread: probe writability
        # here, so an unwritable path raises instead of blocking later starts.
        with open(file_path, "w"):
            pass
        self.config.timeline_mark_cycles = bool(mark_cycles)
        self.timeline.initialize(file_path, self.topology.rank)

    def stop_timeline(self) -> None:
        self.timeline.shutdown()

    # --- sync ---
    def poll(self, handle: int) -> bool:
        return self.handle_manager.poll(handle)

    def synchronize(self, handle: int, timeout: Optional[float] = None) -> Any:
        status, output = self.handle_manager.wait(handle, timeout)
        if status.in_progress():
            raise TimeoutError(status.reason or "Horovod operation timed out")
        if not status.ok():
            from ..common.basics import HorovodInternalError

            raise HorovodInternalError(status.reason)
        return output
