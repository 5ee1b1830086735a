"""The eager control plane's runtimes and the data plane that runs plans.

``native_runtime.NativeRuntime`` drives the C++ core (the default);
``runtime.Runtime`` is the pure-Python runtime of a one-process job
(``HOROVOD_TPU_CORE=python``); ``nccl_executor.NcclPlanExecutor`` runs the
core's plans on ``torch.distributed``.

The helpers here are what both runtimes do to a caller's input at enqueue
and to an output on its way back: numpy arrays (and other array-likes)
travel as CPU tensors and return as numpy; a CUDA tensor gets a ready event
on the caller's current stream.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch


def as_tensor(x: Any) -> Tuple[torch.Tensor, bool]:
    """(tensor, host): a torch tensor as it is, anything else as a CPU
    tensor over ``np.asarray(x)`` with host=True (it returns as numpy)."""
    if isinstance(x, torch.Tensor):
        return x, False
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))), True


def record_ready(t: torch.Tensor):
    """The CUDA event that marks ``t``'s producers on the caller's current
    stream (None for a CPU tensor): the reference's ready event,
    operations.cc:261-285."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def to_caller(out: Any, host: bool) -> Any:
    """An output as the caller passed its input: numpy for host=True."""
    if host and isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return out
