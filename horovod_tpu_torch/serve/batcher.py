"""Continuous-batching policy: the pure decision core of the serving engine.

The counterpart of ``horovod_tpu/serve/batcher.py`` (a copy: that module
sits in the JAX package). :class:`ContinuousBatcher` is a policy object
with no clock, no threads and no tensors: every input is explicit
(timestamps are caller-supplied microsecond integers), so the
max-wait/max-batch trade-off is unit-testable.

Dispatch rule (the classic continuous-batching contract):

- a batch becomes ready the moment ``max_batch_size`` requests are
  queued, **or**
- when the OLDEST queued request has waited ``max_wait_us``: a deadline on
  the head of a FIFO, which bounds how long any request waits beyond the
  front of the queue, because assembly is strictly oldest-first.

Admission is bounded by ``queue_bound``: :meth:`offer` refuses (returns
False) rather than queueing unboundedly; the engine answers such a request
``rejected`` (HTTP 429). Re-queued requests (a replica died mid-batch)
re-enter at the FRONT via :meth:`requeue`, keeping their original
admission timestamps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class BatchDecision:
    """One :meth:`ContinuousBatcher.poll` verdict. ``ready`` batches
    carry the dispatched request ids (oldest first); ``reason`` is
    ``"full"`` / ``"deadline"`` for ready batches, ``"empty"`` /
    ``"waiting"`` otherwise."""

    ready: bool
    reason: str
    request_ids: Tuple[Any, ...] = ()


class ContinuousBatcher:
    """max-batch-size x max-wait-us continuous batcher (pure policy)."""

    def __init__(self, max_batch_size: int = 8, max_wait_us: int = 2000,
                 queue_bound: int = 1024):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got "
                             f"{max_batch_size}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        self.max_batch_size = int(max_batch_size)
        self.max_wait_us = int(max_wait_us)
        self.queue_bound = int(queue_bound)
        self._queue: List[Any] = []          # request ids, oldest first
        self._enqueued_us: Dict[Any, int] = {}

    @staticmethod
    def from_env(env: Optional[dict] = None) -> "ContinuousBatcher":
        import os

        from ..common import env as _env

        e = os.environ if env is None else env

        def _int(name: str, default: int) -> int:
            v = (e.get(name) or "").strip()
            try:
                return int(v) if v else default
            except ValueError:
                return default

        return ContinuousBatcher(
            max_batch_size=_int(_env.HOROVOD_SERVE_MAX_BATCH, 8),
            max_wait_us=_int(_env.HOROVOD_SERVE_MAX_WAIT_US, 2000),
            queue_bound=_int(_env.HOROVOD_SERVE_QUEUE_BOUND, 1024),
        )

    # ------------------------------------------------------------ queue
    def depth(self) -> int:
        return len(self._queue)

    def offer(self, request_id: Any, now_us: int) -> bool:
        """Admit one request at ``now_us``. False = queue bound hit (the
        caller must refuse the request loudly, not drop it silently)."""
        if request_id in self._enqueued_us:
            raise ValueError(f"request {request_id!r} is already queued")
        if len(self._queue) >= self.queue_bound:
            return False
        self._queue.append(request_id)
        self._enqueued_us[request_id] = int(now_us)
        return True

    def requeue(self, request_id: Any, enqueued_us: int) -> None:
        """Return an in-flight request to the FRONT of the queue (replica
        died mid-batch). Keeps the original admission timestamp so its
        max-wait deadline stays honest, and bypasses ``queue_bound`` —
        a re-queued request was already admitted once."""
        if request_id in self._enqueued_us:
            raise ValueError(f"request {request_id!r} is already queued")
        self._queue.insert(0, request_id)
        self._enqueued_us[request_id] = int(enqueued_us)

    def cancel(self, request_id: Any) -> bool:
        """Remove a queued request (client gone, injected drop)."""
        if request_id not in self._enqueued_us:
            return False
        self._queue.remove(request_id)
        del self._enqueued_us[request_id]
        return True

    def wait_us(self, request_id: Any, now_us: int) -> int:
        return int(now_us) - self._enqueued_us[request_id]

    # ----------------------------------------------------------- policy
    def poll(self, now_us: int, max_size: Optional[int] = None
             ) -> BatchDecision:
        """Assemble a batch at virtual time ``now_us``. Ready batches are
        REMOVED from the queue (single consumer per replica loop; the
        engine serializes pollers). ``max_size`` optionally caps the
        batch below ``max_batch_size`` (KV-page pressure)."""
        if not self._queue:
            return BatchDecision(False, "empty")
        cap = self.max_batch_size if max_size is None else max(
            1, min(int(max_size), self.max_batch_size)
        )
        if len(self._queue) >= cap:
            reason = "full"
        elif int(now_us) - self._enqueued_us[self._queue[0]] \
                >= self.max_wait_us:
            reason = "deadline"
        else:
            return BatchDecision(False, "waiting")
        ids = tuple(self._queue[:cap])
        del self._queue[:cap]
        for rid in ids:
            del self._enqueued_us[rid]
        return BatchDecision(True, reason, ids)

    def next_deadline_us(self) -> Optional[int]:
        """Virtual time at which the head of the queue forces a dispatch
        (None when empty) — what a real engine sleeps until and the
        simulator schedules its next dispatch event at."""
        if not self._queue:
            return None
        return self._enqueued_us[self._queue[0]] + self.max_wait_us
