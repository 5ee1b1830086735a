"""Process-wide runtime state: ``init``, ``shutdown`` and the rank queries.

The counterpart of the ``init``/``shutdown`` of ``horovod_tpu/__init__.py``
(``:49-201, 305-343``), on ``torch.distributed``: NCCL when the job runs
on the card, gloo when the caller asks for the CPU. ``init`` creates the
process group, then the eager runtime (``eager.start_runtime``: the native
core and its plan executor); ``shutdown`` stops them in the reverse order.
A native core that fails to build or load makes ``init`` raise: the
pure-Python runtime runs only where ``HOROVOD_TPU_CORE=python`` asks for
it.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from dataclasses import dataclass
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


_runtime: Optional[_Runtime] = None


def init(device=None, *, init_method: Optional[str] = None, config=None) -> None:
    """Create the ``torch.distributed`` process group and start the eager
    runtime (``config``: a ``common.env.Config``, else the environment's).

    ``device`` None is this process's card, ``cuda:<local_rank>``; a card
    named with its index is taken as named. ``init_method`` is any URL ``torch.distributed`` takes. Left as None, a
    single-process job rendezvouses through a ``FileStore`` in a temporary
    directory (so a script needs no launcher), and a multi-process job uses
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``, as torchrun sets them).
    Calling ``init`` again while initialized does nothing."""
    global _runtime
    if _runtime is not None:
        return
    dev = resolve_device(device)
    topo = detect()
    store_dir = None
    if init_method is None:
        if topo.size == 1:
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
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, rank=topo.rank, world_size=topo.size,
    )
    from .. import eager

    try:
        rt = eager.start_runtime(config, topo, dev)
    except BaseException:
        dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
        raise
    _runtime = _Runtime(topology=topo, device=dev, store_dir=store_dir, eager=rt)


def shutdown() -> None:
    """Stop the eager runtime, then the process group."""
    global _runtime
    if _runtime is None:
        return
    from .. import eager

    rt, _runtime = _runtime, None
    try:
        rt.eager.shutdown()
        eager.reset()
    finally:
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
