"""Process-wide runtime state: ``init``, ``shutdown`` and the rank queries.

The counterpart of ``horovod_tpu/common/basics.py`` and the ``init`` of
``horovod_tpu/__init__.py``, on ``torch.distributed``: NCCL when the job
runs on the card, gloo when the caller asks for the CPU.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Optional

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


_runtime: Optional[_Runtime] = None


def init(device=None, *, init_method: Optional[str] = None) -> None:
    """Create the ``torch.distributed`` process group.

    ``init_method`` is any URL ``torch.distributed`` takes. Left as None, a
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
        dev = torch.device("cuda", topo.local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, rank=topo.rank, world_size=topo.size,
    )
    _runtime = _Runtime(topology=topo, device=dev, store_dir=store_dir)


def shutdown() -> None:
    global _runtime
    if _runtime is None:
        return
    dist.destroy_process_group()
    if _runtime.store_dir is not None:
        shutil.rmtree(_runtime.store_dir, ignore_errors=True)
    _runtime = None


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


def device() -> torch.device:
    """The device ``init`` bound this process to."""
    return _require().device
