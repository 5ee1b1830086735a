"""horovod_tpu_torch.torch: the Horovod PyTorch binding (``import
horovod.torch as hvd``).

The port of ``horovod_tpu/torch/__init__.py``: the hook-driven
``DistributedOptimizer`` (a post-accumulate-grad hook per parameter
enqueues an async allreduce once ``backward_passes_per_step`` backward
passes have accumulated; ``step()`` synchronizes, then steps the wrapped
optimizer), the delta-space Adasum optimizer, ``broadcast_parameters``,
``broadcast_optimizer_state``, ``allgather_object``, ``broadcast_object``,
``SyncBatchNorm`` and the op surface of :mod:`.mpi_ops`, over the eager API
(the native core and the NCCL plan executor on its own CUDA stream).

On the card a hook runs on autograd's thread for the device, not the
caller's: it records the gradient's ready event on the stream autograd
produced it on, and the optimizer's bookkeeping is shared under a lock.
``step()`` writes each reduced gradient back into ``p.grad`` on the
caller's stream, ordered after the plan; the host does not wait on the
card. The elastic state and ``ElasticSampler`` are :mod:`.elastic`
(``horovod_tpu/torch/elastic.py``).

While a ``torch.profiler`` session records, the optimizer's hook opens an
``hvd.enqueue`` range (its input the tensor's name), ``synchronize`` an
``hvd.sync`` range and, inside it, one ``hvd.sync.copyback`` range over
the loop that takes each reduced gradient and writes it into ``p.grad``.

Run a script that imports this module with ``python -m`` or from the
repository root: run by path from inside ``horovod_tpu_torch/``, Python
would find this directory's ``torch`` before PyTorch.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import eager
from .. import trace as _trace
from ..common import basics as _basics
from ..common.basics import (  # noqa: F401 - the reference exposes these here too
    cross_rank,
    cross_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from ..common.types import Adasum, Average, ReduceOp, Sum  # noqa: F401
from .compression import Compression
from .mpi_ops import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce,
    grouped_allreduce_async,
    grouped_reducescatter,
    grouped_reducescatter_async,
    join,
    poll,
    synchronize,
)
from .sync_batch_norm import SyncBatchNorm  # noqa: F401

barrier = eager.barrier


def _named(optimizer, named_parameters) -> List[Tuple[str, Any]]:
    """``named_parameters`` as a list, or ``param.<i>`` in the optimizer's
    order; duplicate names are refused (the reference raises on them)."""
    if named_parameters is not None:
        named = list(named_parameters)
    else:
        named = [(f"param.{i}", p) for i, p in
                 enumerate(p for group in optimizer.param_groups for p in group["params"])]
    names = [n for n, _ in named]
    if len(names) != len(set(names)):
        raise ValueError("named_parameters contains duplicate parameter names")
    return named


class _DistributedOptimizer:
    """Wraps a torch optimizer (reference ``horovod/torch/__init__.py:54-209``):
    a post-accumulate-grad hook per parameter enqueues an async allreduce of
    its gradient once ``backward_passes_per_step`` backward passes have
    accumulated; ``step()`` synchronizes every outstanding handle, writes
    the results into ``p.grad``, then steps the wrapped optimizer."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none, backward_passes_per_step=1,
                 op=Average, sparse_as_dense=False):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._sparse_as_dense = sparse_as_dense
        self.backward_passes_per_step = backward_passes_per_step
        self._param_names = {p: n for n, p in _named(optimizer, named_parameters)}
        # Written by the hooks on autograd's thread, read by step() on the
        # caller's: every access holds the lock.
        self._lock = threading.Lock()
        self._handles: Dict[Any, Tuple[int, Any]] = {}
        self._passes: Dict[Any, int] = {}
        self._hook_handles = []
        self._register_hooks()

    def __getattr__(self, item):
        return getattr(self._opt, item)

    @property
    def param_groups(self):
        return self._opt.param_groups

    def _register_hooks(self) -> None:
        for group in self._opt.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                with self._lock:
                    self._passes[p] = 0
                self._hook_handles.append(p.register_post_accumulate_grad_hook(self._hook))

    def _hook(self, param) -> None:
        with self._lock:
            self._passes[param] += 1
            ready = self._passes[param] == self.backward_passes_per_step
            if ready:
                self._passes[param] = 0
        if ready:
            self._allreduce_grad_async(param)

    def _allreduce_grad_async(self, p) -> None:
        name = f"DistributedOptimizer.{self._param_names.get(p, f'param.{id(p)}')}"
        with _trace.profiled("hvd.enqueue", name):
            grad = p.grad
            if grad.is_sparse:
                # The collectives are dense: sparse_as_dense densifies the
                # gradient (on its device) before the allreduce.
                if not self._sparse_as_dense:
                    raise ValueError(
                        "Gradient for parameter is sparse; construct "
                        "DistributedOptimizer with sparse_as_dense=True to "
                        "densify sparse gradients before the allreduce.")
                grad = grad.to_dense()
                with torch.no_grad():
                    p.grad = grad
            if self.backward_passes_per_step > 1:
                grad = grad / self.backward_passes_per_step
            compressed, ctx = self._compression.compress(grad)
            handle = allreduce_async(compressed, name=name, op=self._op)
        with self._lock:
            self._handles[p] = (handle, ctx)

    def synchronize(self) -> None:
        with _trace.profiled("hvd.sync"):
            try:
                with self._lock:
                    missing = [p for group in self._opt.param_groups for p in group["params"]
                               if p not in self._handles and p.requires_grad
                               and p.grad is not None]
                # A gradient no hook reduced (backward() not run through the
                # hooks): reduce it now, the reference's missing-handle path.
                for p in missing:
                    self._allreduce_grad_async(p)
                with self._lock:
                    pending = list(self._handles.items())
                with _trace.profiled("hvd.sync.copyback"):
                    for p, (handle, ctx) in pending:
                        out = self._compression.decompress(synchronize(handle), ctx)
                        with torch.no_grad():
                            p.grad.copy_(out.reshape(p.grad.shape))
                with self._lock:
                    self._handles.clear()
            except Exception:
                # A failed collective leaves the whole in-flight set dead:
                # drop it and the accumulation counters, so that training
                # can start again without tripping zero_grad()'s guard.
                self.reset()
                raise

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def reset(self) -> None:
        """Drop in-flight handles and accumulation counters."""
        with self._lock:
            self._handles.clear()
            for k in self._passes:
                self._passes[k] = 0

    def zero_grad(self, *args, **kwargs):
        with self._lock:
            pending = bool(self._handles)
        if pending:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize().")
        return self._opt.zero_grad(*args, **kwargs)

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, *args, **kwargs):
        return self._opt.load_state_dict(*args, **kwargs)


class _DistributedAdasumOptimizer:
    """Delta-space Adasum (reference ``horovod/torch/__init__.py:211-379``):
    the wrapped optimizer steps on the LOCAL gradients, and what is
    Adasum-reduced is the parameter delta it produced, so adaptive state
    (Adam's moments, momentum) stays local."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none, backward_passes_per_step=1):
        self._opt = optimizer
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._param_names = {p: n for n, p in _named(optimizer, named_parameters)}

    def __getattr__(self, item):
        return getattr(self._opt, item)

    @property
    def param_groups(self):
        return self._opt.param_groups

    def _params(self):
        return [p for group in self._opt.param_groups for p in group["params"]]

    def step(self, closure=None):
        if self.backward_passes_per_step > 1:
            if closure is not None:
                # A closure would recompute the gradients after the
                # accumulation divisor below, silently dropping it.
                raise ValueError(
                    "DistributedAdasumOptimizer does not support a step "
                    "closure together with backward_passes_per_step > 1: "
                    "the closure recomputes gradients after the "
                    "accumulation divisor is applied.")
            with torch.no_grad():
                for p in self._params():
                    if p.grad is not None:
                        p.grad.div_(self.backward_passes_per_step)
        if closure is not None and all(p.grad is None for p in self._params()
                                       if p.requires_grad):
            # The closure would be the gradient producer (LBFGS): no delta
            # could be observed and nothing would be Adasum-reduced.
            raise ValueError(
                "DistributedAdasumOptimizer cannot reduce "
                "closure-computed gradients: call loss.backward() before "
                "step() so parameter deltas are observable.")
        # Only parameters with a gradient step, so the skip is structural
        # and the same on every rank.
        with torch.no_grad():
            starts = {p: p.detach().clone() for p in self._params() if p.grad is not None}
        loss = self._opt.step(closure)
        if closure is not None:
            for p in self._params():
                if p not in starts and p.grad is not None:
                    raise RuntimeError(
                        "DistributedAdasumOptimizer: the step closure "
                        "produced gradients for parameters that had "
                        "none before step(); their updates cannot be "
                        "Adasum-reduced. Call loss.backward() before "
                        "step() instead.")
        # Adasum-allreduce each local delta, then rebase: p = start + adasum(delta).
        handles = []
        with torch.no_grad():
            for p in self._params():
                if p not in starts:
                    continue
                name = self._param_names.get(p, f"param.{id(p)}")
                compressed, ctx = self._compression.compress(p - starts[p])
                handles.append((p, allreduce_async(
                    compressed, name=f"AdasumOptimizer.delta.{name}", op=Adasum), ctx))
            for p, handle, ctx in handles:
                out = self._compression.decompress(synchronize(handle), ctx)
                p.copy_(starts[p] + out.reshape(p.shape).to(p.dtype))
        return loss

    def synchronize(self) -> None:
        """Adasum reduces inside step(): nothing is outstanding between
        steps (kept for the API of _DistributedOptimizer)."""

    def zero_grad(self, *args, **kwargs):
        return self._opt.zero_grad(*args, **kwargs)

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, *args, **kwargs):
        return self._opt.load_state_dict(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,  # noqa: N802
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average,
                         sparse_as_dense=False):
    """``hvd.DistributedOptimizer`` (reference
    ``horovod/torch/__init__.py:381-435``): ``op=Adasum`` gives the
    delta-space Adasum optimizer; ``sparse_as_dense`` densifies sparse
    (embedding) gradients before the allreduce."""
    if op == Adasum:
        if sparse_as_dense:
            raise ValueError(
                "sparse_as_dense is not supported with op=Adasum: the "
                "delta-space Adasum optimizer reduces parameter deltas "
                "(always dense), not gradients.")
        return _DistributedAdasumOptimizer(
            optimizer, named_parameters=named_parameters, compression=compression,
            backward_passes_per_step=backward_passes_per_step)
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters, compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op,
        sparse_as_dense=sparse_as_dense)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite every rank's tensors in place with the root's: a
    ``state_dict`` or a list of ``(name, tensor)``. Every broadcast is
    enqueued before the first wait."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    handles = [broadcast_async_(p.data if hasattr(p, "data") else p, root_rank,
                                name=f"bcast.{name}")
               for name, p in items if p is not None]
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Overwrite every rank's optimizer state and numeric hyperparameters
    with the root's (reference ``horovod/torch/__init__.py:437-560``).

    A fresh optimizer has no state yet: a dummy step on zero gradients
    creates it first, as the reference does. With a weight decay that step
    moves the parameters. Python numbers travel as float64 tensors on
    ``hvd``'s device; a state tensor travels where it lives (AdamW's ``step``
    on the CPU stays there)."""
    if isinstance(optimizer, (_DistributedOptimizer, _DistributedAdasumOptimizer)):
        # The wrapped step would fire collectives that ranks skipping the
        # dummy step below never post.
        optimizer = optimizer._opt

    state_dict = optimizer.state_dict()
    if not state_dict.get("state"):
        # The zeroing is unconditional (a live gradient would be applied as
        # a real update); the callers' gradients are put back after.
        stashed = []
        try:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.requires_grad:
                        stashed.append((p, p.grad))
                        p.grad = torch.zeros_like(p)
            optimizer.step()
        finally:
            for p, g in stashed:
                p.grad = g
        state_dict = optimizer.state_dict()

    callbacks, handles = [], []

    def _bcast_scalar(container, key, value, name):
        t = torch.tensor([value], dtype=torch.float64, device=_basics.device())
        h = broadcast_async_(t, root_rank, name=name)

        def write_back():
            synchronize(h)
            container[key] = bool(t.item()) if isinstance(value, bool) else type(value)(t.item())

        callbacks.append(write_back)

    for gi, group in enumerate(state_dict["param_groups"]):
        for key, value in group.items():
            if key != "params" and isinstance(value, (int, float)):
                _bcast_scalar(group, key, value, f"opt.group{gi}.{key}")
    for pid, pstate in state_dict["state"].items():
        for key, value in pstate.items():
            name = f"opt.state.{pid}.{key}"
            if torch.is_tensor(value):
                handles.append(broadcast_async_(value, root_rank, name=name))
            elif isinstance(value, (int, float)):
                _bcast_scalar(pstate, key, value, name)
    for h in handles:
        synchronize(h)
    for cb in callbacks:
        cb()
    optimizer.load_state_dict(state_dict)


def allgather_object(obj, name: Optional[str] = None) -> list:
    """One picklable object per rank, in rank order, on every rank (sizes
    may differ: the uneven allgather)."""
    return eager.allgather_object(obj, name=name)


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """A picklable object from the root (a size broadcast, then the uint8
    payload's)."""
    return eager.broadcast_object(obj, root_rank=root_rank, name=name)
