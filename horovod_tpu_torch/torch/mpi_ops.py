"""Handle-based collectives on torch tensors: the binding's op surface.

The port of ``horovod_tpu/torch/mpi_ops.py`` (``allreduce[_async][_]``,
``allgather[_async]``, ``broadcast[_async][_]``, ``alltoall[_async]`` with
``splits``, the grouped operations, ``poll``, ``synchronize``, ``join``)
over the eager API of :mod:`horovod_tpu_torch.eager`: each call is a named
operation that the native core negotiates and the plan executor runs. The
divisor of Average and the in-place forms follow the reference
(``horovod/torch/mpi_ops.py:95-254``).

A tensor enters the eager plane as it is and its output comes back on its
device: the JAX binding's DLPack bridge (``_to_plane``/``_from_plane``)
has no counterpart, and a CUDA tensor never leaves the card. On the card
``synchronize`` returns with the caller's current stream ordered after the
plan, not the host. The in-place forms write the result back into the
caller's tensor there, on that stream, so the tensor keeps its storage.
"""

from __future__ import annotations

import threading
import numpy as np
import torch

from .. import eager
from ..common.compression import Compression
from ..common.types import Adasum, Average, ReduceOp, Sum  # noqa: F401

# handle -> the caller's tensor an in-place operation writes back into. The
# hooks of a DistributedOptimizer enqueue from autograd's device thread, so
# the map is shared between threads.
_handle_meta: dict = {}
_meta_lock = threading.Lock()


def _in_place(handle: int, target: torch.Tensor) -> int:
    with _meta_lock:
        _handle_meta[handle] = target
    return handle


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0) -> int:
    return eager.allreduce_async(
        tensor.detach(), average=average, name=eager._auto_name("allreduce.torch", name),
        op=op, prescale_factor=prescale_factor, postscale_factor=postscale_factor)


def allreduce(tensor, average=None, name=None, compression=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0):
    compression = compression or Compression.none
    compressed, ctx = compression.compress(tensor)
    handle = allreduce_async(compressed, average=average, name=name, op=op,
                             prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor)
    return compression.decompress(synchronize(handle), ctx)


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0) -> int:
    """In-place async allreduce: ``synchronize`` writes the result back
    into ``tensor`` (reference ``allreduce_async_``)."""
    return _in_place(allreduce_async(tensor, average=average, name=name, op=op,
                                     prescale_factor=prescale_factor,
                                     postscale_factor=postscale_factor), tensor)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0):
    return synchronize(allreduce_async_(tensor, average=average, name=name, op=op,
                                        prescale_factor=prescale_factor,
                                        postscale_factor=postscale_factor))


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0):
    """Enqueue ``tensors`` as ONE group and return their handles: the
    coordinator holds the group until every member is ready on every rank
    and fuses it into one plan."""
    if eager._resolve_op(average, op) == ReduceOp.ADASUM:
        raise ValueError("grouped_allreduce does not support op=Adasum; use the "
                         "DistributedAdasumOptimizer (delta-space) path instead")
    return eager.grouped_allreduce_async(
        [t.detach() for t in tensors], average=average,
        name=eager._auto_name("grouped_allreduce.torch", name), op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor)


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0):
    """Synchronous grouped allreduce; outputs in input order."""
    return eager.grouped_sync_first_error(grouped_allreduce_async(
        tensors, average=average, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor), synchronize)


def grouped_allgather_async(tensors, name=None):
    return eager.grouped_allgather_async(
        [t.detach() for t in tensors], name=eager._auto_name("grouped_allgather.torch", name))


def grouped_allgather(tensors, name=None):
    return eager.grouped_sync_first_error(grouped_allgather_async(tensors, name), synchronize)


def grouped_reducescatter_async(tensors, name=None, op=None):
    return eager.grouped_reducescatter_async(
        [t.detach() for t in tensors],
        name=eager._auto_name("grouped_reducescatter.torch", name), op=op)


def grouped_reducescatter(tensors, name=None, op=None):
    return eager.grouped_sync_first_error(grouped_reducescatter_async(tensors, name, op),
                                          synchronize)


def allgather_async(tensor, name=None) -> int:
    return eager.allgather_async(tensor.detach(), eager._auto_name("allgather.torch", name))


def allgather(tensor, name=None):
    return synchronize(allgather_async(tensor, name))


def broadcast_async(tensor, root_rank, name=None) -> int:
    return eager.broadcast_async(tensor.detach(), root_rank,
                                 eager._auto_name("broadcast.torch", name))


def broadcast(tensor, root_rank, name=None):
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_async_(tensor, root_rank, name=None) -> int:
    return _in_place(broadcast_async(tensor, root_rank, name), tensor)


def broadcast_(tensor, root_rank, name=None):
    return synchronize(broadcast_async_(tensor, root_rank, name))


def alltoall_async(tensor, name=None) -> int:
    return eager.alltoall_async(tensor.detach(), eager._auto_name("alltoall.torch", name))


def alltoall(tensor, splits=None, name=None):
    """Even alltoall, or with ``splits`` (the later reference's alltoallv
    form) ``(collected, received_splits)`` as torch tensors."""
    if splits is None:
        return synchronize(alltoall_async(tensor, name))
    if isinstance(splits, torch.Tensor):
        splits = splits.detach().cpu().numpy()
    out, received = eager.alltoall(tensor.detach(), splits,
                                   name=eager._auto_name("alltoall.torch", name))
    return out, torch.from_numpy(np.array(received))


def poll(handle: int) -> bool:
    return eager.poll(handle)


def synchronize(handle: int):
    """The operation's output; for an in-place operation the caller's own
    tensor, with the result written into it."""
    with _meta_lock:
        target = _handle_meta.pop(handle, None)
    out = eager.synchronize(handle)
    if target is None:
        return out
    with torch.no_grad():
        target.copy_(out.reshape(target.shape))
    return target


def join() -> None:
    eager.join()
