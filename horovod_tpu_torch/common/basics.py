"""Process-wide runtime state: ``init``, ``shutdown`` and the rank queries.

The counterpart of the ``init``/``shutdown`` of ``horovod_tpu/__init__.py``
(``:49-201, 305-343``), on ``torch.distributed``: NCCL when the job runs
on the card, gloo when the caller asks for the CPU. ``init`` creates the
process group, then the eager runtime (``eager.start_runtime``: the native
core and its plan executor); ``shutdown`` stops them in the reverse order.
A native core that fails to build or load makes ``init`` raise: the
pure-Python runtime runs only where ``HOROVOD_TPU_CORE=python`` asks for
it.

With ``HOROVOD_METRICS``/``HOROVOD_TRACE`` set and the elastic KV plane's
address in ``HOROVOD_ELASTIC_KV_ADDR``/``PORT``, ``init`` also starts the
worker-side pushers of ``horovod_tpu/__init__.py:230-290``, which ship
this rank's metrics snapshot and span window to that KV server; a pusher
that cannot start is logged and the job goes on, as there.

With ``HOROVOD_PROFILER_DIR`` set, ``init`` starts a ``torch.profiler``
session (CPU and CUDA activities) once the runtime runs, and ``shutdown``
stops it and writes this rank's chrome trace, ``<dir>/rank.<r>.pt.trace.json``
(``horovod_tpu/__init__.py:203-223, 335-341``, where JAX writes an XLA
profile). The eager plans carry their ``hvd_plan_<id>`` ranges, the names
of the core's timeline. A session that cannot start is a warning.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from .topology import Topology, detect


class HorovodInternalError(RuntimeError):
    """An error the job cannot recover from in place (the reference's
    ``HorovodInternalError``): the non-finite guard's ``abort`` policy
    raises it from the step, for an elastic layer to roll back from."""


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for the card where there is none
    raises: a run never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclass
class _Runtime:
    topology: Topology
    device: torch.device
    store_dir: Optional[str]
    eager: Any = None       # core.native_runtime.NativeRuntime or core.runtime.Runtime
    pushers: tuple = ()     # metrics.export.MetricsPusher / trace.pusher.TracePusher
    profiler: Any = None    # (torch.profiler.profile, its directory) under HOROVOD_PROFILER_DIR
    mesh: Any = None        # mesh()'s DeviceMesh, built at first use


_runtime: Optional[_Runtime] = None
# The card this process was first bound to: an elastic re-formation keeps it.
_bound_card: Optional[int] = None


def _elastic() -> bool:
    return os.environ.get("HOROVOD_ELASTIC") == "1"


def elastic_timeout() -> timedelta:
    """The process group's timeout in an elastic job: the stall shutdown
    window, else the stall warning's (the module docstring)."""
    for var, default in (("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
                         ("HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0)):
        try:
            seconds = float(os.environ.get(var, "") or default)
        except ValueError:
            seconds = default
        if seconds > 0:
            return timedelta(seconds=seconds)
    return timedelta(seconds=60.0)


def init(device=None, *, init_method: Optional[str] = None, config=None) -> None:
    """Create the ``torch.distributed`` process group and start the eager
    runtime (``config``: a ``common.env.Config``, else the environment's).

    ``device`` None is this process's card, ``cuda:<local_rank>``; a card
    named with its index is taken as named. ``init_method`` is any URL ``torch.distributed`` takes. Left as None, a
    single-process job rendezvouses through a ``FileStore`` in a temporary
    directory (so a script needs no launcher), and a multi-process job uses
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``, as torchrun sets them).
    Calling ``init`` again while initialized does nothing."""
    global _runtime, _bound_card
    if _runtime is not None:
        return
    if os.environ.get("HOROVOD_ELASTIC_SPARE") == "1":
        from ..elastic import maybe_wait_as_spare

        maybe_wait_as_spare()
    dev = resolve_device(device)
    topo = detect()
    if dev.type == "cuda" and dev.index is None and topo.local_size > torch.cuda.device_count():
        raise RuntimeError(
            f"{topo.local_size} local ranks on this host but {torch.cuda.device_count()} "
            f"visible CUDA devices: rank {topo.rank} (local rank {topo.local_rank}) "
            "would share a card; start at most one rank per card")
    store_dir = None
    if init_method is None:
        if topo.size == 1 and not (_elastic() and "MASTER_ADDR" in os.environ):
            # An elastic generation names its own store, even at one rank.
            store_dir = tempfile.mkdtemp(prefix="hvd_torch_store_")
            init_method = "file://" + os.path.join(store_dir, "store")
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            raise ValueError(
                f"a job of {topo.size} processes needs init_method= or "
                f"MASTER_ADDR/MASTER_PORT to rendezvous"
            )
    if dev.type == "cuda":
        dev = torch.device("cuda", topo.local_rank if dev.index is None else dev.index)
        if _elastic() and _bound_card is not None and dev.index != _bound_card:
            raise RuntimeError(
                f"elastic: this process's state lives on cuda:{_bound_card}, but generation "
                f"{os.environ.get('HOROVOD_ELASTIC_GEN', '?')} gives it local rank "
                f"{topo.local_rank} (cuda:{dev.index}); a rank never moves to another card")
        torch.cuda.set_device(dev)
        _bound_card = dev.index
    kw = {}
    if _elastic():
        kw["timeout"] = elastic_timeout()
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, rank=topo.rank, world_size=topo.size, **kw,
    )
    from .. import eager

    try:
        rt = eager.start_runtime(config, topo, dev)
    except BaseException:
        dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
        raise
    _runtime = _Runtime(topology=topo, device=dev, store_dir=store_dir, eager=rt,
                        pushers=_start_pushers(topo),
                        profiler=_start_profiler(rt.config.profiler_dir, dev))


def _start_profiler(directory: str, dev: torch.device):
    """The ``HOROVOD_PROFILER_DIR`` session (the module docstring), or None."""
    if not directory:
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(directory, exist_ok=True)
        # All threads: the plans run on the executor's thread, the hooks
        # on autograd's, not only on the thread that called init.
        from torch._C._profiler import _ExperimentalConfig

        prof = profile(activities=activities,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
    except Exception as exc:  # noqa: BLE001 - profiling is best-effort, as in the JAX package
        logging.getLogger("horovod_tpu_torch").warning(
            "could not start the torch.profiler session in %s: %s", directory, exc)
        return None
    return prof, directory


def _stop_profiler(session, rank: int) -> None:
    prof, directory = session
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(directory, f"rank.{rank}.pt.trace.json"))
    except Exception as exc:  # noqa: BLE001 - shutdown goes on without the trace
        logging.getLogger("horovod_tpu_torch").warning(
            "could not write the torch.profiler trace in %s: %s", directory, exc)


def _start_pushers(topo: Topology) -> tuple:
    """The worker-side metrics and trace pushers (the module docstring);
    none without an armed tap or a KV address."""
    from .. import metrics, trace

    if trace.ACTIVE:
        # The tap armed at import, maybe before the rank was known.
        trace.TAP.rank = topo.rank
    addr = os.environ.get("HOROVOD_ELASTIC_KV_ADDR", "")
    port = os.environ.get("HOROVOD_ELASTIC_KV_PORT", "")
    if not addr or not port:
        return ()
    pushers = []
    for active, what in ((metrics.ACTIVE, "metrics"), (trace.ACTIVE, "trace")):
        if not active:
            continue
        try:
            if what == "metrics":
                from ..metrics.export import MetricsPusher as cls
            else:
                from ..trace.pusher import TracePusher as cls
            pushers.append(cls(addr, int(port), topo.rank))
        except Exception as exc:  # noqa: BLE001 - observability never blocks init
            logging.getLogger("horovod_tpu_torch").warning(
                "could not start the %s pusher: %s", what, exc)
    return tuple(pushers)


def _abort_group() -> None:
    """Abort every process group without waiting on it; a backend that
    cannot abort is destroyed instead."""
    from torch.distributed import distributed_c10d as c10d

    try:
        c10d._abort_process_group()
    except Exception as exc:  # noqa: BLE001 - gloo may not abort: destroy it
        logging.getLogger("horovod_tpu_torch").info("abort of the process group: %s", exc)
        if dist.is_initialized():
            dist.destroy_process_group()


def shutdown(abort: bool = False) -> None:
    """Stop the eager runtime, then the process group. ``abort`` (a group a
    failed peer broke) aborts the group first and never waits on it."""
    global _runtime
    if _runtime is None:
        return
    from .. import eager

    rt, _runtime = _runtime, None
    if abort and dist.is_initialized():
        _abort_group()
    try:
        if rt.profiler is not None:
            _stop_profiler(rt.profiler, rt.topology.rank)
        rt.eager.shutdown()
        eager.reset()
        # Stopped after the runtime, so the final push carries the
        # teardown-time counts and spans.
        for pusher in rt.pushers:
            try:
                pusher.stop()
            except Exception:  # noqa: BLE001 - a dead KV server must not fail shutdown
                pass
    finally:
        graphs = sys.modules.get("horovod_tpu_torch.utils.step_graph")
        if graphs is not None:
            # NCCL frees a communicator only after the graphs that use it.
            graphs.release_all()
        if dist.is_initialized():
            dist.destroy_process_group()
        if rt.store_dir is not None:
            shutil.rmtree(rt.store_dir, ignore_errors=True)


atexit.register(shutdown)


def is_initialized() -> bool:
    return _runtime is not None


def _require() -> _Runtime:
    if _runtime is None:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; call init() first"
        )
    return _runtime


def rank() -> int:
    return _require().topology.rank


def size() -> int:
    return _require().topology.size


def local_rank() -> int:
    return _require().topology.local_rank


def local_size() -> int:
    return _require().topology.local_size


def cross_rank() -> int:
    return _require().topology.cross_rank


def cross_size() -> int:
    return _require().topology.cross_size


def is_homogeneous() -> bool:
    return _require().topology.is_homogeneous


def device() -> torch.device:
    """The device ``init`` bound this process to."""
    return _require().device


def mesh():
    """The job's device mesh (``horovod_tpu/__init__.py:466-476``), built at
    first use over the process group: one ``data`` axis over every rank, or
    ``HOROVOD_TPU_MESH_AXES``'s axes. A re-formed world builds its own."""
    rt = _require()
    if rt.mesh is None:
        from ..parallel import mesh as mesh_mod

        rt.mesh = mesh_mod.build_mesh(mesh_mod.parse_axes(rt.eager.config.mesh_axes) or None)
    return rt.mesh
