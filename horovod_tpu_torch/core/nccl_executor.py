"""The eager data plane: the native core's plans on ``torch.distributed``.

The counterpart of ``horovod_tpu/core/xla_executor.py``. A plan's entries
are packed into one flat buffer, reduced by ONE collective and unpacked
(allreduce, Adasum); the other plans run one collective an entry. The
collectives run on a process group of the executor's own, created at init
on every rank in one order: NCCL for a job on the card, gloo on the CPU.
The eager plane's calls therefore never interleave with the training
step's on the default group (one communicator driven by two threads in
different orders deadlocks across ranks; the reference kept separate
communicators for this reason).

Semantics kept from the reference executor:
 - AVERAGE divides by the plan's ``participants`` (the join-aware divisor,
   ``xla_executor.py:523-524``), not the group's size;
 - prescale and postscale multiply by the factor (in f32 for half
   precision: ``ops.collectives._maybe_scale``, as the JAX collectives');
 - MIN, MAX and PRODUCT reduce with the group's own op (the true product:
   the JAX eager path sends PRODUCT to a sum, ROADMAP queue C);
 - Adasum: the pairwise exchange (``ops/adasum.py``), hierarchical on a
   ``(cross, local)`` grid between node averages;
 - ``hierarchical_allreduce``/``hierarchical_allgather`` (the config knobs,
   or the autotuner's flags a plan carries) run the two-level schedules of
   ``topo/compositor.py`` when the job is a homogeneous grid with
   ``rank = cross_rank * local_size + local_rank``;
 - allgather with uneven dim 0 pads to the largest rank's rows and
   compacts; reducescatter gives rank r ``d0 // n + (r < d0 % n)`` rows;
 - a process set's plans run on the set's own group, broadcast roots are
   global ranks.

On the card every plan runs on the executor's stream: it waits on each
input's ready event (recorded on the caller's stream at enqueue), marks
the inputs as used on its stream (``record_stream``) and records a done
event after the unpack, on which ``synchronize`` orders the caller's
stream. CPU inputs and numpy arrays travel to the card and come back on
the CPU. The planner's choices (``HOROVOD_TOPOLOGY_PLAN=auto``, the split
algorithm) are ROADMAP A13: ``eager.start_runtime`` refuses them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..common.topology import Topology
from ..common.types import ReduceOp, ResponseType
from ..ops.collectives import _TORCH_OPS, _maybe_scale
from .native_runtime import PlanExecutor


class _SetContext:
    """A registered process set: its ranks, its group and this rank's
    position in it (-1 on a non-member, which never receives its plans)."""

    def __init__(self, psid: int, ranks, group, my_rank: int):
        self.id = int(psid)
        self.ranks = sorted(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.group = group
        self.index = self.ranks.index(my_rank) if my_rank in self.ranks else -1


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n in x's dtype; integers truncate toward zero."""
    if x.is_floating_point() or x.is_complex():
        return x / n
    return torch.div(x, n, rounding_mode="trunc")


class NcclPlanExecutor(PlanExecutor):
    def __init__(self, topology: Topology, device: torch.device, config=None):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._topo = topology
        self._config = config
        n = topology.size
        # The eager plane's own communicator, created by every rank in one order.
        self._group = dist.new_group(list(range(n)))
        self._sets: Dict[int, _SetContext] = {}
        # The (cross, local) groups of a homogeneous grid, for the two-level
        # lowerings (the reference's LOCAL/CROSS communicator pair).
        self._grid = None
        ls, cs = topology.local_size, topology.cross_size
        if topology.is_homogeneous and ls > 1 and cs > 1 and ls * cs == n:
            local_group, _ = dist.new_subgroups_by_enumeration(
                [[c * ls + j for j in range(ls)] for c in range(cs)])
            cross_group, _ = dist.new_subgroups_by_enumeration(
                [[c * ls + j for c in range(cs)] for j in range(ls)])
            self._grid = (cross_group, local_group)
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._done = None

    # --- PlanExecutor hooks ---
    def thread_init(self) -> None:
        # A new thread does not inherit the current device.
        if self._cuda:
            torch.cuda.set_device(self.device)

    def zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def done_event(self):
        return self._done

    @property
    def has_grid(self) -> bool:
        return self._grid is not None

    # --- process sets ---
    def register_process_set(self, psid: int, ranks) -> None:
        """Create the set's group: collective over every rank of the job,
        called in one order on all of them."""
        ranks = sorted(int(r) for r in ranks)
        self._sets[int(psid)] = _SetContext(psid, ranks, dist.new_group(ranks),
                                            self._topo.rank)

    def remove_process_set(self, psid: int) -> None:
        self._sets.pop(int(psid), None)

    def _set_ctx(self, plan: dict) -> Optional[_SetContext]:
        psid = int(plan.get("process_set", 0))
        if psid == 0:
            return None
        ctx = self._sets.get(psid)
        if ctx is None:
            raise RuntimeError(f"process set {psid} is not registered on this rank")
        return ctx

    def _plan_knob(self, plan: dict, name: str, bit: int) -> bool:
        """The autotuner's flags a plan carries win (the same on every rank);
        -1 means autotune is off: the config knob."""
        flags = int(plan.get("tuned_flags", -1))
        if flags >= 0:
            return bool(flags & bit)
        return bool(getattr(self._config, name, False)) if self._config else False

    # --- execution ---
    def execute(self, plan: dict, entries, topo: Topology) -> Dict[str, Any]:
        ctx = self._set_ctx(plan)
        with contextlib.ExitStack() as stack:
            if self._cuda:
                stack.enter_context(torch.cuda.device(self.device))
                stack.enter_context(torch.cuda.stream(self._stream))
                for e in entries:
                    ready = e.context.get("ready")
                    if ready is not None:
                        self._stream.wait_event(ready)
                    if e.tensor.device.type == "cuda":
                        e.tensor.record_stream(self._stream)
            ptype = int(plan["type"])
            if ptype in (ResponseType.ALLREDUCE, ResponseType.ADASUM):
                out = self._allreduce(plan, entries, ptype == ResponseType.ADASUM, ctx)
            elif ptype == ResponseType.ALLGATHER:
                out = self._per_entry(entries, lambda x: self._allgather(plan, x, ctx))
            elif ptype == ResponseType.BROADCAST:
                out = self._per_entry(entries, lambda x: self._broadcast(plan, x, ctx))
            elif ptype == ResponseType.ALLTOALL:
                out = self._per_entry(entries, lambda x: self._alltoall(x, ctx))
            elif ptype == ResponseType.REDUCESCATTER:
                out = self._per_entry(entries, lambda x: self._reducescatter(plan, x, ctx))
            else:
                raise RuntimeError(f"unsupported plan type {ptype}")
            if self._cuda:
                self._done = torch.cuda.Event()
                self._done.record(self._stream)
        return out

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The input on the executor's device."""
        if t.device != self.device:
            if t.device.type == "cuda" and not self._cuda:
                raise RuntimeError(f"a CUDA tensor was enqueued on a runtime on {self.device}")
            return t.to(self.device)
        return t

    @staticmethod
    def _restore(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The output on the input's device."""
        return out if out.device == like.device else out.to(like.device)

    def _per_entry(self, entries, fn) -> Dict[str, Any]:
        return {e.name: self._restore(fn(self._stage(e.tensor)), e.tensor) for e in entries}

    def _group_of(self, ctx: Optional[_SetContext]):
        return ctx.group if ctx is not None else self._group

    def _size_of(self, ctx: Optional[_SetContext]) -> int:
        return ctx.size if ctx is not None else self._topo.size

    # --- allreduce / Adasum: pack -> one collective -> unpack ---
    def _allreduce(self, plan, entries, adasum: bool, ctx) -> Dict[str, Any]:
        op = ReduceOp(plan.get("op", int(ReduceOp.SUM)))
        pre = float(plan.get("prescale", 1.0))
        post = float(plan.get("postscale", 1.0))
        participants = max(int(plan.get("participants", self._size_of(ctx))), 1)
        adasum = adasum or op == ReduceOp.ADASUM
        # Process sets run flat on their group; MIN/MAX/PRODUCT stay flat
        # (the reference's hierarchy covers sums); Adasum on a grid is
        # always hierarchical, as the reference's CUDA variant is.
        hier = ctx is None and self._grid is not None and (
            adasum or (op in (ReduceOp.SUM, ReduceOp.AVERAGE)
                       and self._plan_knob(plan, "hierarchical_allreduce", 1)))
        tensors = [self._stage(e.tensor) for e in entries]
        shapes = [tuple(t.shape) for t in tensors]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        r = _maybe_scale(flat, pre)
        if adasum:
            from ..ops.adasum import adasum_allreduce, hierarchical_adasum_allreduce

            if hier:
                # Node averages, so that Adasum of identical inputs is the
                # identity, as the flat exchange's is.
                cross, local = self._grid
                r = hierarchical_adasum_allreduce(
                    (r / self._topo.local_size).to(r.dtype), local_group=local,
                    cross_group=cross)
            else:
                r = adasum_allreduce(r, group=self._group_of(ctx))
        elif hier:
            from ..topo import compositor

            r = compositor.lower_allreduce(r, self._grid, op=ReduceOp.SUM,
                                           algorithm="two-level")
            if op == ReduceOp.AVERAGE:
                r = _divide(r, participants)
        else:
            # torch.cat copies: the caller's tensors are never reduced into.
            dist.all_reduce(r, op=_TORCH_OPS[op], group=self._group_of(ctx))
            if op == ReduceOp.AVERAGE:
                r = _divide(r, participants)
        r = _maybe_scale(r, post)
        outputs, off = {}, 0
        for e, shape in zip(entries, shapes):
            n = math.prod(shape)
            outputs[e.name] = self._restore(r[off:off + n].reshape(shape), e.tensor)
            off += n
        return outputs

    # --- the one-collective-an-entry plans ---
    def _allgather(self, plan, x: torch.Tensor, ctx) -> torch.Tensor:
        if x.dim() == 0:
            raise RuntimeError("allgather needs a tensor with a dim0 to gather")
        n = self._size_of(ctx)
        rank_sizes = [int(s) for s in plan.get("rank_sizes", [])]
        uneven = bool(rank_sizes) and len(set(rank_sizes)) > 1
        rows = max(rank_sizes) if uneven else x.shape[0]
        send = x.contiguous()
        if uneven and rows > x.shape[0]:
            send = torch.cat([send, send.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])
        hier = ctx is None and self._grid is not None and self._plan_knob(
            plan, "hierarchical_allgather", 2)
        if hier:
            from ..topo import compositor

            gathered = compositor.lower_allgather(send, self._grid, algorithm="two-level")
        else:
            gathered = send.new_empty((n * rows,) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(gathered, send, group=self._group_of(ctx))
        if uneven:
            gathered = torch.cat([gathered[i * rows:i * rows + rank_sizes[i]] for i in range(n)])
        return gathered

    def _broadcast(self, plan, x: torch.Tensor, ctx) -> torch.Tensor:
        root = int(plan.get("root", 0))
        if ctx is not None:
            if root not in ctx.ranks:
                raise RuntimeError(f"broadcast root {root} is not a member of process set "
                                   f"{ctx.id}")
            root = ctx.ranks.index(root)
        out = x.contiguous().clone()
        dist.broadcast(out, group=self._group_of(ctx), group_src=root)
        return out

    def _reducescatter(self, plan, x: torch.Tensor, ctx) -> torch.Tensor:
        if x.dim() == 0:
            raise RuntimeError("reducescatter needs a tensor with a dim0 to scatter")
        n = self._size_of(ctx)
        my = ctx.index if ctx is not None else self._topo.rank
        participants = int(plan.get("participants", n)) or n
        op = int(plan.get("op", int(ReduceOp.SUM)))
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise RuntimeError("reducescatter supports SUM/AVERAGE only")
        d0 = x.shape[0]
        base, rem = divmod(d0, n)
        rows = base + (1 if rem else 0)
        send = x.contiguous()
        if rem:
            # Block r holds rank r's rows [r*base + min(r, rem), + count_r),
            # padded with a zero row to the block size.
            idx = torch.full((n * rows,), d0, dtype=torch.long)
            for r in range(n):
                start, cnt = r * base + min(r, rem), base + (1 if r < rem else 0)
                idx[r * rows:r * rows + cnt] = torch.arange(start, start + cnt)
            send = torch.cat([send, send.new_zeros((1,) + tuple(x.shape[1:]))])[
                idx.to(send.device)]
        out = send.new_empty((rows,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, send, group=self._group_of(ctx))
        if op == ReduceOp.AVERAGE:
            # The JAX executor's (out / float32(participants)).astype(dtype).
            wide = torch.float64 if out.dtype == torch.float64 else torch.float32
            out = (out.to(wide) / participants).to(out.dtype)
        return out[:base + (1 if my < rem else 0)] if rem else out

    def _alltoall(self, x: torch.Tensor, ctx) -> torch.Tensor:
        n = self._size_of(ctx)
        if x.dim() == 0 or x.shape[0] % n:
            raise RuntimeError(f"alltoall dim0 ({x.shape[0] if x.dim() else 0}) must be "
                               f"divisible by size ({n})")
        send = x.contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self._group_of(ctx))
        return out
