"""The eager Horovod API: named asynchronous collectives over the native core.

The port of ``horovod_tpu/__init__.py:345-1220``. Each operation is
enqueued by name into the eager runtime ``init`` started (the native core
by default, the pure-Python runtime of a one-process job with
``HOROVOD_TPU_CORE=python``); the core negotiates across ranks, fuses and
hands plans to the executor (``core/nccl_executor.py``). ``*_async``
returns a handle for ``poll``/``synchronize``; the plain forms wait.

Inputs are torch tensors on the card or the CPU, or numpy arrays. An
output comes back as its input came: on the input's device, numpy for
numpy. On the card the operation is ordered on the caller's current
stream: ``synchronize`` returns with the stream waiting on the result, not
the host.

Differences from the JAX package: PRODUCT computes the product (the JAX
eager path sums); a broadcast root outside the job or the set raises
``ValueError`` at the call; a process set's group is created once every
rank agreed on the registration; the planner's entry points
(``collective_plan``) are ROADMAP A13.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import random
import socket
import threading
from typing import Any, Optional

import numpy as np
import torch

from .common import basics as _basics
from .common.compression import Compression
from .common.env import Config
from .common.types import ReduceOp, dtype_from_array
from .core import as_tensor, to_caller

_lock = threading.Lock()


def _rt():
    rt = _basics._runtime.eager if _basics._runtime is not None else None
    if rt is None or not rt.running:
        raise _basics.HorovodInternalError("Horovod has not been initialized; use hvd.init().")
    return rt


# --- starting the runtime (called by common.basics.init) ---
_CORE_ATTEMPTS = 3


def _free_port() -> int:
    """A port that binds now, below Linux's ephemeral range (32768 up), so
    no outgoing connection can take it between this probe and the core's
    bind."""
    rng = random.SystemRandom()
    for _ in range(64):
        port = rng.randrange(20000, 32000)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in [20000, 32000) for the native core's controller")


def _controller_host(topo) -> str:
    if os.environ.get("MASTER_ADDR"):
        return os.environ["MASTER_ADDR"]
    if topo.local_size == topo.size:
        return "127.0.0.1"
    return socket.gethostbyname(socket.gethostname())


def _native_runtime(cfg: Config, topo, executor):
    """The native runtime, its controller endpoint agreed through the
    process group's store: ``HOROVOD_CONTROLLER_ADDR``/``PORT`` when set,
    else rank 0 publishes a free port under a generation key and, should
    the core's bind fail, a fresh one under the next key."""
    from .core.native_runtime import NativeRuntime

    if topo.size == 1:
        return NativeRuntime(cfg, topo, executor)
    addr = os.environ.get("HOROVOD_CONTROLLER_ADDR", "")
    port = int(os.environ.get("HOROVOD_CONTROLLER_PORT", "0") or 0)
    if addr and port:
        return NativeRuntime(cfg, topo, executor, addr, port)
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    # Every rank counts its own inits, so a store reused by a later init in
    # the same processes never serves a stale endpoint.
    epoch = store.add(f"hvd_core/epoch/{topo.rank}", 1)
    for gen in range(_CORE_ATTEMPTS):
        key = f"hvd_core/{epoch}/{gen}"
        if topo.rank == 0:
            addr, port = _controller_host(topo), _free_port()
            store.set(key, f"{addr}:{port}")
        else:
            addr, port = store.get(key).decode().rsplit(":", 1)
            port = int(port)
        try:
            return NativeRuntime(cfg, topo, executor, addr, port)
        except RuntimeError as exc:
            last = gen == _CORE_ATTEMPTS - 1
            if topo.rank == 0:
                if last or "bind" not in str(exc):
                    raise
            elif last or not store.check([f"hvd_core/{epoch}/{gen + 1}"]):
                raise


def start_runtime(cfg: Optional[Config], topo, device: torch.device):
    """The eager runtime of a fresh process group: the native core and,
    unless the job is one process on the CPU, the executor over
    ``torch.distributed``. A core that does not build or load raises;
    ``HOROVOD_TPU_CORE=python`` is the only way to the Python runtime."""
    cfg = cfg or Config.from_env()
    kind = os.environ.get("HOROVOD_TPU_CORE", "native").strip().lower()
    if kind == "python":
        from .core.runtime import Runtime

        rt = Runtime(cfg, topo)
        rt.start()
        return rt
    if kind != "native":
        raise ValueError(f"HOROVOD_TPU_CORE={kind!r}: choose 'native' or 'python'")
    if cfg.topology_plan == "auto":
        raise NotImplementedError(
            "HOROVOD_TOPOLOGY_PLAN=auto selects each eager collective's lowering through the "
            "topology compositor's planner, which is not ported yet (ROADMAP A13)")
    executor = None
    if topo.size > 1 or device.type == "cuda":
        from .core.nccl_executor import NcclPlanExecutor

        executor = NcclPlanExecutor(topo, device, cfg)
    return _native_runtime(cfg, topo, executor)


def reset() -> None:
    """Forget the process sets and the barrier sequence (``shutdown``)."""
    global _ps_barrier_seq
    with _lock:
        for ps in _process_sets.values():
            ps.process_set_id = None
        _process_sets.clear()
        _ps_barrier_seq = 0


def collective_plan(*args: Any, **kwargs: Any) -> dict:
    raise NotImplementedError(
        "collective_plan reports the topology compositor's plan selection, which is not "
        "ported yet (ROADMAP A13)")


# Build probes (reference operations.cc:683-769): the port's data plane is
# torch.distributed, NCCL on the card and gloo on the CPU.
def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    import torch.distributed as dist

    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    return _basics.is_initialized() and _basics.device().type == "cpu"


def nccl_built() -> bool:
    import torch.distributed as dist

    return dist.is_nccl_available()


def nccl_enabled() -> bool:
    return _basics.is_initialized() and _basics.device().type == "cuda"


def ddl_built() -> bool:
    return False


def mlsl_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def xla_enabled() -> bool:
    return False


# --- names ---
_name_counters: dict = {}


def _auto_name(prefix: str, name: Optional[str]) -> str:
    if name is not None:
        return name
    with _lock:
        n = _name_counters.get(prefix, 0)
        _name_counters[prefix] = n + 1
    return f"{prefix}.noname.{n}"


def _preflight_record(op: str, name: str, psid: int, tensor: Any) -> None:
    """The submission ledger of ``HOROVOD_TPU_STATIC_CHECKS=1`` (the
    cross-rank ordering lint); a cached env read when the knob is off."""
    from .analysis import preflight

    if preflight.enabled():
        preflight.record_submission(op, name, psid, tensor)


def _resolve_op(average: Optional[bool], op: Optional[ReduceOp]) -> ReduceOp:
    # Reference horovod/torch/mpi_ops.py:101-124.
    if average is not None and op is not None:
        raise ValueError("The op parameter supersedes average; provide only one.")
    if op is not None:
        return op
    return ReduceOp.SUM if average is False else ReduceOp.AVERAGE


# --- process sets ---
class ProcessSet:
    """A subset of ranks that collectives can run over (the later
    reference's ``horovod.ProcessSet``). Register it with
    :func:`add_process_set`, called identically on every rank; its plans run
    on a process group over its ranks. ``global_process_set`` is every rank."""

    def __init__(self, ranks=None):
        self.ranks = sorted({int(r) for r in ranks}) if ranks is not None else None
        self.process_set_id: Optional[int] = None

    def _resolved_ranks(self) -> list:
        return self.ranks if self.ranks is not None else list(range(_basics.size()))

    def size(self) -> int:
        return len(self._resolved_ranks())

    def included(self) -> bool:
        return _basics.rank() in self._resolved_ranks()

    def rank(self) -> int:
        """This process's position within the set."""
        rs = self._resolved_ranks()
        me = _basics.rank()
        if me not in rs:
            raise RuntimeError(f"rank {me} is not a member of process set {self.process_set_id}")
        return rs.index(me)

    def __repr__(self):
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={'GLOBAL' if self.ranks is None else self.ranks})")


global_process_set = ProcessSet(None)
global_process_set.process_set_id = 0

_process_sets: dict = {}
# The k-th registration call (add or remove) uses barrier name k and, for
# an add, set id k on EVERY rank, also where local validation failed, so a
# divergent call meets its peers in the agreement exchange and fails on all
# of them, and a failed call never skews later ids.
_ps_barrier_seq = 0


def _ps_barrier(payload, seq: int, n: int) -> list:
    if n <= 1:
        return [payload]
    return allgather_object(payload, name=f"hvd.ps.bar.{seq}")


def _psid(process_set: Optional[ProcessSet]) -> int:
    if process_set is None or process_set.process_set_id == 0:
        return 0
    if process_set.process_set_id is None:
        raise ValueError("process set must be registered with hvd.add_process_set() before use")
    return int(process_set.process_set_id)


def add_process_set(process_set) -> ProcessSet:
    """Register a process set (a ``ProcessSet`` or a list of ranks). Call it
    identically, in the same order, on every rank: the registration is a
    cross-rank agreement, so a divergent call fails on every rank instead of
    hanging the first collective."""
    global _ps_barrier_seq
    ps = process_set if isinstance(process_set, ProcessSet) else ProcessSet(process_set)
    rt = _rt()
    n = _basics.size()
    with _lock:
        _ps_barrier_seq += 1
        seq = _ps_barrier_seq
    # Errors go into the barrier's payload: raising before it would strand
    # the healthy peers inside it.
    err = None
    if ps.ranks is None:
        err = "the global process set is registered implicitly"
    elif ps.process_set_id is not None:
        err = f"process set is already registered (id {ps.process_set_id})"
    elif not ps.ranks or ps.ranks[0] < 0 or ps.ranks[-1] >= n:
        err = f"process set ranks must lie in [0, {n})"
    psid = None
    if err is None:
        psid = seq
        try:
            # The core registers BEFORE the barrier: a member may use the
            # set once its own barrier returns, when every rank registered.
            rt.register_process_set(psid, ps.ranks)
        except Exception as exc:  # noqa: BLE001 - poisons the barrier
            err = str(exc)
            psid = None
    payload = ("add", psid, tuple(ps.ranks or ())) if err is None else ("err", err)
    agreement = _ps_barrier(payload, seq, n)
    unanimous = len(set(agreement)) == 1 and agreement[0][0] == "add"
    if err is not None or not unanimous:
        if psid is not None:
            rt.remove_process_set(psid)
        if err is not None:
            raise ValueError(err)
        raise ValueError("add_process_set must be called identically on every rank; "
                         f"cross-rank registrations: {agreement}")
    # Every rank agreed: create the set's group, in one order on all ranks
    # (dist.new_group over ranks that disagree would hang).
    bind = getattr(rt, "bind_process_set", None)
    if bind is not None:
        bind(psid, ps.ranks)
    with _lock:
        ps.process_set_id = psid
        _process_sets[psid] = ps
    return ps


def remove_process_set(process_set: ProcessSet) -> None:
    """Deregister a process set: collective, called identically on every
    rank (a divergent call fails on all of them)."""
    global _ps_barrier_seq
    rt = _rt()
    n = _basics.size()
    with _lock:
        _ps_barrier_seq += 1
        seq = _ps_barrier_seq
    psid = process_set.process_set_id
    err = ("only registered non-global process sets can be removed"
           if psid in (None, 0) else None)
    agreement = _ps_barrier(("rm", psid) if err is None else ("err", err), seq, n)
    if err is not None:
        raise ValueError(err)
    if any(a != ("rm", psid) for a in agreement):
        raise ValueError("remove_process_set must be called identically on every rank; "
                         f"cross-rank calls: {agreement}")
    rt.remove_process_set(psid)
    with _lock:
        _process_sets.pop(psid, None)
        process_set.process_set_id = None


# --- the eager collectives ---
def allreduce_async(tensor: Any, average: Optional[bool] = None, name: Optional[str] = None,
                    op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, process_set: Optional[ProcessSet] = None,
                    _group: tuple = (0, 0)) -> int:
    rop = _resolve_op(average, op)
    rt = _rt()
    tensor_name = _auto_name("allreduce", name)
    psid = _psid(process_set)
    _preflight_record("allreduce", tensor_name, psid, tensor)
    kw = dict(prescale_factor=prescale_factor, postscale_factor=postscale_factor,
              group_id=_group[0], group_size=_group[1], process_set_id=psid)
    if rop == ReduceOp.ADASUM:
        return rt.enqueue_adasum(tensor_name, tensor, **kw)
    return rt.enqueue_allreduce(tensor_name, tensor, reduce_op=rop, **kw)


def allreduce(tensor: Any, average: Optional[bool] = None, name: Optional[str] = None,
              compression=Compression.none, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> Any:
    t, host = as_tensor(tensor)
    compressed, ctx = compression.compress(t)
    out = synchronize(allreduce_async(
        compressed, average=average, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))
    return to_caller(compression.decompress(out, ctx), host)


def allgather_async(tensor: Any, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None, _group: tuple = (0, 0)) -> int:
    tensor_name = _auto_name("allgather", name)
    psid = _psid(process_set)
    _preflight_record("allgather", tensor_name, psid, tensor)
    return _rt().enqueue_allgather(tensor_name, tensor, process_set_id=psid,
                                   group_id=_group[0], group_size=_group[1])


def allgather(tensor: Any, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> Any:
    """Every member's tensor concatenated on dim 0 in member order; dim 0
    may differ between ranks (Allgatherv)."""
    return synchronize(allgather_async(tensor, name, process_set))


def allgather_object(obj, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> list:
    """One picklable object per member rank, in member order, on every
    member: a size allgather, then the uneven uint8 payload allgather."""
    data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
    base = name or _auto_name("gather_obj", None)
    sizes = allgather(np.array([len(data)], dtype=np.int64), name=f"{base}.size",
                      process_set=process_set)
    payload = allgather(data, name=f"{base}.data", process_set=process_set)
    out, off = [], 0
    for count in np.asarray(sizes).tolist():
        out.append(pickle.loads(payload[off:off + count].tobytes()))
        off += count
    return out


def _check_root(root_rank: int, process_set: Optional[ProcessSet]) -> None:
    members = (process_set._resolved_ranks() if process_set is not None
               else list(range(_basics.size())))
    if int(root_rank) not in members:
        raise ValueError(f"broadcast root_rank {root_rank} is not a rank of "
                         f"{'the job' if process_set is None else process_set} "
                         f"(ranks {members[0]}..{members[-1]})")


def broadcast_async(tensor: Any, root_rank: int, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    # root_rank is a GLOBAL rank, also within a process set.
    _check_root(root_rank, process_set)
    tensor_name = _auto_name("broadcast", name)
    psid = _psid(process_set)
    _preflight_record("broadcast", tensor_name, psid, tensor)
    return _rt().enqueue_broadcast(tensor_name, tensor, int(root_rank), process_set_id=psid)


def broadcast(tensor: Any, root_rank: int, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> Any:
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def alltoall_async(tensor: Any, name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None) -> int:
    tensor_name = _auto_name("alltoall", name)
    psid = _psid(process_set)
    _preflight_record("alltoall", tensor_name, psid, tensor)
    return _rt().enqueue_alltoall(tensor_name, tensor, process_set_id=psid)


def alltoall(tensor: Any, splits: Any = None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None) -> Any:
    """All-to-all of dim-0 blocks. Without ``splits`` dim 0 divides evenly
    by the set's size and rank r receives block r from every rank. With
    ``splits`` (one entry per member, summing to dim 0), rank d receives
    the ``splits[d]`` rows every rank sends it, and the call returns
    ``(collected, received_splits)``.

    The uneven exchange shares the count matrix by an allgather, then moves
    the blocks through even all-to-alls of a carrier capped at ``k *
    total_rows / n`` rows (``k`` = ``HOROVOD_ALLTOALLV_CARRIER_FACTOR``,
    default 4; at least ``n`` rows), so a hot destination rides several
    rounds instead of padding every block to the largest
    (``horovod_tpu/__init__.py:827-931``)."""
    if splits is None:
        return synchronize(alltoall_async(tensor, name, process_set))
    name = _auto_name("alltoall", name)
    if process_set is not None and process_set.ranks is not None:
        n, me = process_set.size(), process_set.rank()
    else:
        n, me = _basics.size(), _basics.rank()
    local, host = as_tensor(tensor)
    splits = np.asarray(splits, np.int32).reshape(-1)
    if splits.shape[0] != n:
        raise ValueError(f"splits must have one entry per rank ({n}), got {splits.shape[0]}")
    if (splits < 0).any():
        raise ValueError(f"splits must be non-negative, got {splits.tolist()}")
    if int(splits.sum()) != int(local.shape[0]):
        raise ValueError(f"splits sum ({int(splits.sum())}) must equal dim0 "
                         f"({int(local.shape[0])})")
    # matrix[src, dst] = rows src sends to dst.
    matrix = np.asarray(allgather(splits, name=f"{name}.splits",
                                  process_set=process_set)).reshape(n, n)
    received_splits = matrix[:, me].copy()
    if int(matrix.max()) == 0:
        return to_caller(local[:0], host), received_splits
    chunk, rounds = _alltoallv_schedule(matrix, n)
    alltoall._last_carrier_rows = n * chunk  # diagnostic hook, as in the JAX package
    rest = tuple(local.shape[1:])
    offs = np.concatenate([[0], np.cumsum(splits)[:-1]])
    pieces: list = [[] for _ in range(n)]
    for r in range(rounds):
        lo = r * chunk
        carrier = local.new_zeros((n * chunk,) + rest)
        for d in range(n):
            take = min(max(int(splits[d]) - lo, 0), chunk)
            if take:
                carrier[d * chunk:d * chunk + take] = local[offs[d] + lo:offs[d] + lo + take]
        out = synchronize(alltoall_async(carrier, f"{name}.round{r}" if rounds > 1 else name,
                                         process_set))
        for s in range(n):
            take = min(max(int(received_splits[s]) - lo, 0), chunk)
            if take:
                pieces[s].append(out[s * chunk:s * chunk + take])
    parts = [c for p in pieces for c in p]
    collected = torch.cat(parts) if parts else local[:0]
    return to_caller(collected, host), received_splits


def _alltoallv_schedule(matrix: Any, n: int) -> tuple:
    """(chunk_rows, rounds) of the uneven alltoall: the carrier capped at
    ``factor * total_rows / n`` rows (at least ``n``)."""
    m = np.asarray(matrix)
    max_block = int(m.max())
    factor = int(os.environ.get("HOROVOD_ALLTOALLV_CARRIER_FACTOR", "4"))
    cap = max(1, (factor * int(m.sum()) + n * n - 1) // (n * n))
    chunk = min(max_block, cap)
    return chunk, (max_block + chunk - 1) // chunk


def reducescatter_async(tensor: Any, name: Optional[str] = None, op: Optional[ReduceOp] = None,
                        process_set: Optional[ProcessSet] = None, _group: tuple = (0, 0)) -> int:
    """Sum (or average) over the members and keep this rank's dim-0 shard:
    ``d // n`` rows when n divides d, else ``d // n + (r < d % n)`` rows,
    the earlier ranks taking the remainder (MPI_Reduce_scatter's
    convention)."""
    op = op if op is not None else ReduceOp.SUM
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports SUM/AVERAGE only")
    if not tuple(getattr(tensor, "shape", ())):
        raise ValueError("reducescatter needs a tensor with a dim0 to scatter")
    tensor_name = _auto_name("reducescatter", name)
    psid = _psid(process_set)
    _preflight_record("reducescatter", tensor_name, psid, tensor)
    return _rt().enqueue_reducescatter(tensor_name, tensor, reduce_op=op, process_set_id=psid,
                                       group_id=_group[0], group_size=_group[1])


def reducescatter(tensor: Any, name: Optional[str] = None, op: Optional[ReduceOp] = None,
                  process_set: Optional[ProcessSet] = None) -> Any:
    return synchronize(reducescatter_async(tensor, name, op, process_set))


# --- grouped operations ---
def _group_id(base: str) -> int:
    """A nonzero group id, the same on every rank for the same base name,
    within 63 bits (it travels through signed int64 channels)."""
    raw = int.from_bytes(hashlib.md5(base.encode()).digest()[:8], "little")
    return (raw & ((1 << 63) - 1)) or 1


def _drain_group(handles) -> None:
    """A bounded wait on the members already submitted when a later
    member's enqueue failed: the group can never complete, so the wait
    gives up after a second (the stall inspector reports the orphans)."""
    for h in handles:
        try:
            _rt().synchronize(h, timeout=1.0)
        except Exception:  # noqa: BLE001 - the original error is raised by the caller
            pass


def _grouped_async(enqueue_one, tensors, base, validate_one=None) -> list:
    """Every member carries the group id and count, so the coordinator holds
    the group until every member is ready on every rank. Every member is
    validated before any is enqueued."""
    tensors = list(tensors)
    for t in tensors:
        dtype_from_array(t)
        if validate_one is not None:
            validate_one(t)
    from .analysis import preflight

    if preflight.enabled():
        preflight.check_grouped(tensors, _rt().config.fusion_threshold_bytes, base)
    gid = _group_id(base)
    handles = []
    try:
        for i, t in enumerate(tensors):
            handles.append(enqueue_one(t, f"{base}.{i}", (gid, len(tensors))))
    except Exception:
        _drain_group(handles)
        raise
    return handles


def grouped_sync_first_error(handles, synchronize_fn):
    """Wait on every handle even when one fails; raise the first error."""
    outputs, first_error = [], None
    for h in handles:
        try:
            outputs.append(synchronize_fn(h))
        except Exception as exc:  # noqa: BLE001 - raised below
            if first_error is None:
                first_error = exc
    if first_error is not None:
        raise first_error
    return outputs


def grouped_allreduce_async(tensors, average: Optional[bool] = None, name: Optional[str] = None,
                            op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: Optional[ProcessSet] = None):
    """Enqueue the tensors as ONE group and return their handles: the
    coordinator fuses the members into a single plan whatever the cycle
    boundaries or the fusion threshold (one plan per dtype when they mix)."""
    base = name if name is not None else _auto_name("grouped_allreduce", None)
    return _grouped_async(
        lambda t, n, g: allreduce_async(t, average=average, name=n, op=op,
                                        prescale_factor=prescale_factor,
                                        postscale_factor=postscale_factor,
                                        process_set=process_set, _group=g),
        tensors, base)


def grouped_allreduce(tensors, average: Optional[bool] = None, name: Optional[str] = None,
                      op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, process_set: Optional[ProcessSet] = None):
    return grouped_sync_first_error(grouped_allreduce_async(
        tensors, average=average, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set), synchronize)


def grouped_allgather_async(tensors, name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None):
    base = name if name is not None else _auto_name("grouped_allgather", None)
    return _grouped_async(lambda t, n, g: allgather_async(t, n, process_set, _group=g),
                          tensors, base)


def grouped_allgather(tensors, name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None):
    return grouped_sync_first_error(grouped_allgather_async(tensors, name, process_set),
                                    synchronize)


def grouped_reducescatter_async(tensors, name: Optional[str] = None,
                                op: Optional[ReduceOp] = None,
                                process_set: Optional[ProcessSet] = None):
    base = name if name is not None else _auto_name("grouped_reducescatter", None)
    if (op if op is not None else ReduceOp.SUM) not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports SUM/AVERAGE only")

    def validate_one(t):
        if not tuple(getattr(t, "shape", ())):
            raise ValueError("reducescatter needs a tensor with a dim0 to scatter")

    return _grouped_async(
        lambda t, n, g: reducescatter_async(t, n, op, process_set, _group=g),
        tensors, base, validate_one=validate_one)


def grouped_reducescatter(tensors, name: Optional[str] = None, op: Optional[ReduceOp] = None,
                          process_set: Optional[ProcessSet] = None):
    return grouped_sync_first_error(grouped_reducescatter_async(tensors, name, op, process_set),
                                    synchronize)


# --- control ---
def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start the core's catapult timeline for a window of the run."""
    _rt().start_timeline(file_path, mark_cycles)


def stop_timeline() -> None:
    _rt().stop_timeline()


def join() -> None:
    """This rank is out of data: block until every rank joins. Meanwhile
    this rank takes part in its peers' collectives with zeros, and AVERAGE
    divides by the ranks that still submit (reference ``hvd.join``)."""
    synchronize(_rt().enqueue_join())


def barrier(name: Optional[str] = None, process_set: Optional[ProcessSet] = None) -> None:
    """Block until every member reaches the barrier: a one-element
    allreduce, whose negotiation is the barrier."""
    allreduce(np.zeros((1,), np.float32), op=ReduceOp.SUM, name=_auto_name("barrier", name),
              process_set=process_set)


def poll(handle: int) -> bool:
    return _rt().poll(handle)


def synchronize(handle: int, timeout: Optional[float] = None) -> Any:
    return _rt().synchronize(handle, timeout)


def broadcast_object(obj: Any, root_rank: int = 0, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """A picklable object from the root: a size broadcast, then the uint8
    payload's."""
    name = name or _auto_name("bcast_obj", None)
    if _basics.rank() == root_rank:
        data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
    else:
        data = np.zeros((0,), np.uint8)
    sz = broadcast(np.asarray([data.shape[0]], np.int64), root_rank, name=f"{name}.size",
                   process_set=process_set)
    payload = data if data.shape[0] == int(sz[0]) else np.zeros(int(sz[0]), np.uint8)
    payload = broadcast(payload, root_rank, name=f"{name}.data", process_set=process_set)
    return pickle.loads(np.asarray(payload).tobytes())


def broadcast_variables(variables: Any, root_rank: int = 0) -> Any:
    """The root's tensors, for a dict or a list/tuple of them (the reference's
    ``broadcast_variables``). Every tensor is enqueued before the first wait,
    so one negotiation cycle can take them all."""
    if isinstance(variables, dict):
        keys, leaves = list(variables), list(variables.values())
    else:
        keys, leaves = None, list(variables)
    handles = [broadcast_async(leaf, root_rank, name=f"bcast.var.{i}")
               for i, leaf in enumerate(leaves)]
    outs = [synchronize(h) for h in handles]
    if keys is not None:
        return dict(zip(keys, outs))
    return type(variables)(outs) if isinstance(variables, tuple) else outs
