"""Cross-rank collective-ordering lint (the deadlock class).

The port's copy of ``horovod_tpu/analysis/ordering.py``, over the port's
eager API (``horovod_tpu_torch.eager``).

The classic Horovod failure mode: ranks submit named collectives in
different orders, or one rank skips a collective its peers submit, and the
job deadlocks until the stall inspector notices ~60 s later
(``StallInspector``). SPMD jaxprs cannot diverge, but the eager named-op
path can — each rank's submission order is user code. This module makes
that order checkable *statically*:

 - :func:`record_rank_trace` runs a user function against a recording
   runtime stub (no collectives execute; every op is an identity/replicate
   simulation) and returns the rank's submission sequence, using the same
   tensor-name registry (``eager._auto_name``) production code uses,
   so auto-generated names line up across simulated ranks;
 - :func:`check_cross_rank_order` diffs per-process-set sequences across
   ranks and reports the first divergence, naming both tensors and both
   ranks — the diagnostic the dynamic stall checker can only approximate
   after its timeout.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .findings import (
    Finding,
    RULE_MISSING_COLLECTIVE,
    RULE_ORDER_MISMATCH,
    RULE_SIGNATURE_MISMATCH,
    SEVERITY_ERROR,
)


@dataclass(frozen=True)
class CollectiveCall:
    """One recorded submission: the identity the coordinator would match
    across ranks (reference Request fields, message.h:46-96)."""

    op: str
    name: str
    process_set_id: int = 0
    dtype: str = ""
    shape: Tuple[int, ...] = ()

    def signature(self) -> Tuple[str, str, str, Tuple[int, ...]]:
        return (self.op, self.name, self.dtype, self.shape)


class _RecordingRuntime:
    """Stand-in runtime installed by :func:`record_rank_trace`: records
    every enqueue and simulates completion locally (allreduce/broadcast/
    alltoall return the input; allgather replicates it member-count times
    so payload-size protocols like ``allgather_object`` keep working)."""

    def __init__(self, rank: int, size: int):
        from ..common.topology import Topology

        self.topology = Topology(rank=rank, size=size, local_rank=rank, local_size=size)
        from ..common.env import Config

        self.config = Config()
        self.calls: List[CollectiveCall] = []
        self._results: Dict[int, Any] = {}
        self._process_sets: Dict[int, List[int]] = {}
        self.running = True

    # -- process sets --
    def register_process_set(self, psid: int, ranks) -> None:
        self._process_sets[int(psid)] = sorted(int(r) for r in ranks)

    def remove_process_set(self, psid: int) -> None:
        self._process_sets.pop(int(psid), None)

    def _members(self, psid: int) -> int:
        if psid and psid in self._process_sets:
            return len(self._process_sets[psid])
        return self.topology.size

    # -- enqueue recording --
    def _record(self, op: str, name: str, tensor: Any,
                process_set_id: int = 0, **_kw: Any) -> int:
        import numpy as np
        import torch

        if isinstance(tensor, torch.Tensor):
            # Named as numpy names it, so traces read alike in both packages.
            tensor = tensor.detach().cpu().numpy()
        arr = np.asarray(tensor) if tensor is not None else None
        self.calls.append(
            CollectiveCall(
                op=op,
                name=name,
                process_set_id=int(process_set_id),
                dtype=str(arr.dtype) if arr is not None else "",
                shape=tuple(arr.shape) if arr is not None else (),
            )
        )
        handle = len(self.calls) - 1
        if op == "allgather" and arr is not None:
            n = self._members(process_set_id)
            out = np.concatenate([arr] * n, axis=0) if arr.ndim else arr
        else:
            out = tensor
        self._results[handle] = out
        return handle

    def enqueue_allreduce(self, name, tensor, **kw) -> int:
        return self._record("allreduce", name, tensor, **_psid_only(kw))

    def enqueue_adasum(self, name, tensor, **kw) -> int:
        return self._record("adasum", name, tensor, **_psid_only(kw))

    def enqueue_allgather(self, name, tensor, **kw) -> int:
        return self._record("allgather", name, tensor, **_psid_only(kw))

    def enqueue_broadcast(self, name, tensor, root_rank, **kw) -> int:
        return self._record("broadcast", name, tensor, **_psid_only(kw))

    def enqueue_alltoall(self, name, tensor, **kw) -> int:
        return self._record("alltoall", name, tensor, **_psid_only(kw))

    def enqueue_reducescatter(self, name, tensor, **kw) -> int:
        return self._record("reducescatter", name, tensor, **_psid_only(kw))

    def enqueue_join(self) -> int:
        return self._record("join", f"join.{self.topology.rank}", None)

    # -- sync --
    def poll(self, handle: int) -> bool:
        return True

    def synchronize(self, handle: int, timeout: Optional[float] = None):
        return self._results.get(handle)


def _psid_only(kw: Dict[str, Any]) -> Dict[str, Any]:
    return {"process_set_id": int(kw.get("process_set_id", 0))}


@contextlib.contextmanager
def _simulated_rank(rank: int, size: int):
    """Swap the process's runtime for a recorder and reset the tensor-name
    registry so auto names are deterministic per simulated rank; restore
    everything on exit."""
    import torch

    from .. import eager
    from ..common import basics

    saved = (basics._runtime, dict(eager._name_counters), dict(eager._process_sets),
             eager._ps_barrier_seq)
    recorder = _RecordingRuntime(rank, size)
    basics._runtime = basics._Runtime(topology=recorder.topology, device=torch.device("cpu"),
                                      store_dir=None, eager=recorder)
    eager._name_counters.clear()
    eager._process_sets.clear()
    eager._ps_barrier_seq = 0
    try:
        yield recorder
    finally:
        basics._runtime, counters, sets, eager._ps_barrier_seq = saved
        eager._name_counters.clear()
        eager._name_counters.update(counters)
        eager._process_sets.clear()
        eager._process_sets.update(sets)


def record_rank_trace(
    fn: Callable[..., Any], rank: int, size: int, *args: Any, **kwargs: Any
) -> List[CollectiveCall]:
    """Run ``fn(*args, **kwargs)`` as simulated ``rank`` of ``size`` with
    a recording runtime and return its collective-submission sequence.
    ``fn`` may read ``hvd.rank()`` / ``hvd.size()``: the stub answers
    with the simulated identity."""
    with _simulated_rank(rank, size) as recorder:
        fn(*args, **kwargs)
    return recorder.calls


def simulate_ranks(
    fn: Callable[..., Any], size: int, *args: Any, **kwargs: Any
) -> Dict[int, List[CollectiveCall]]:
    """Record every rank's trace of ``fn`` (called once per simulated
    rank)."""
    return {
        r: record_rank_trace(fn, r, size, *args, **kwargs)
        for r in range(size)
    }


def check_cross_rank_order(
    traces: Dict[int, Sequence[CollectiveCall]],
) -> List[Finding]:
    """Compare per-process-set collective sequences across ranks.

    A divergence is reported at its first occurrence, naming the two
    tensors and the two ranks involved — the exact diagnostic a deadlocked
    job needs, emitted before anything is submitted. Rank membership is
    taken from the traces themselves: a rank that never touches a process
    set is assumed to be a non-member (legal), but a rank whose sequence
    *diverges* from a peer's is an error.
    """
    findings: List[Finding] = []
    psids = sorted(
        {c.process_set_id for calls in traces.values() for c in calls}
    )
    for psid in psids:
        per_rank = {
            r: [c for c in calls if c.process_set_id == psid]
            for r, calls in traces.items()
        }
        # Non-members (no submissions at all for this set) are skipped.
        members = {r: seq for r, seq in per_rank.items() if seq}
        if len(members) < 2:
            continue
        ref_rank = min(members)
        ref = members[ref_rank]
        for r in sorted(members):
            if r == ref_rank:
                continue
            seq = members[r]
            findings.extend(
                _diff_sequences(psid, ref_rank, ref, r, seq)
            )
    return findings


def _diff_sequences(
    psid: int,
    rank_a: int,
    seq_a: Sequence[CollectiveCall],
    rank_b: int,
    seq_b: Sequence[CollectiveCall],
) -> List[Finding]:
    loc = f"order:process_set={psid}"
    for i, (ca, cb) in enumerate(zip(seq_a, seq_b)):
        if ca.name != cb.name or ca.op != cb.op:
            return [
                Finding(
                    rule=RULE_ORDER_MISMATCH,
                    severity=SEVERITY_ERROR,
                    message=(
                        f"collective order diverges at position {i} of "
                        f"process set {psid}: rank {rank_a} submits "
                        f"{ca.op} '{ca.name}' while rank {rank_b} submits "
                        f"{cb.op} '{cb.name}' — these ranks would "
                        "deadlock waiting for each other"
                    ),
                    location=loc,
                    details={
                        "position": i,
                        "process_set_id": psid,
                        "rank_a": rank_a,
                        "rank_b": rank_b,
                        "tensor_a": ca.name,
                        "tensor_b": cb.name,
                    },
                )
            ]
        if (ca.dtype, ca.shape) != (cb.dtype, cb.shape):
            return [
                Finding(
                    rule=RULE_SIGNATURE_MISMATCH,
                    severity=SEVERITY_ERROR,
                    message=(
                        f"'{ca.name}' (position {i}, process set {psid}) "
                        f"has mismatched signatures: rank {rank_a} "
                        f"submits {ca.dtype}{list(ca.shape)} while rank "
                        f"{rank_b} submits {cb.dtype}{list(cb.shape)}"
                    ),
                    location=loc,
                    details={
                        "position": i,
                        "process_set_id": psid,
                        "rank_a": rank_a,
                        "rank_b": rank_b,
                        "tensor": ca.name,
                        "signature_a": f"{ca.dtype}{list(ca.shape)}",
                        "signature_b": f"{cb.dtype}{list(cb.shape)}",
                    },
                )
            ]
    if len(seq_a) != len(seq_b):
        longer_rank, longer, i = (
            (rank_a, seq_a, len(seq_b))
            if len(seq_a) > len(seq_b)
            else (rank_b, seq_b, len(seq_a))
        )
        shorter_rank = rank_b if longer_rank == rank_a else rank_a
        extra = longer[i]
        return [
            Finding(
                rule=RULE_MISSING_COLLECTIVE,
                severity=SEVERITY_ERROR,
                message=(
                    f"rank {longer_rank} submits {extra.op} "
                    f"'{extra.name}' (position {i}, process set {psid}) "
                    f"that rank {shorter_rank} never submits — rank "
                    f"{longer_rank} would hang in it forever"
                ),
                location=loc,
                details={
                    "position": i,
                    "process_set_id": psid,
                    "rank_present": longer_rank,
                    "rank_missing": shorter_rank,
                    "tensor": extra.name,
                },
            )
        ]
    return []
