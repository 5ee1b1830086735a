"""Bounded retry with exponential backoff + deterministic jitter.

The port's copy of ``horovod_tpu/fault/backoff.py``.

Used by the launcher control plane (``run/network.py``) and the rendezvous
KV client (``run/http_server.py``) so a dropped or delayed control-plane
message costs one backoff, not a job.  Jitter draws from a seeded
``random.Random`` so chaos runs are reproducible: with
``HOROVOD_FAULT_SEED`` set, the exact sleep sequence is a pure function of
the seed and the knobs.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

HOROVOD_RPC_RETRIES = "HOROVOD_RPC_RETRIES"
HOROVOD_RPC_BACKOFF_BASE_S = "HOROVOD_RPC_BACKOFF_BASE_S"
HOROVOD_RPC_BACKOFF_MAX_S = "HOROVOD_RPC_BACKOFF_MAX_S"
HOROVOD_RPC_BACKOFF_JITTER = "HOROVOD_RPC_BACKOFF_JITTER"
HOROVOD_FAULT_SEED = "HOROVOD_FAULT_SEED"


@dataclass
class Backoff:
    """Retry budget: ``retries`` attempts AFTER the first, sleeping
    ``base * multiplier**i`` (capped at ``max_s``) plus up to
    ``jitter`` fraction of that delay between attempts."""

    retries: int = 3
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    seed: Optional[int] = None
    _rng: random.Random = field(default=None, repr=False)  # type: ignore

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    @staticmethod
    def from_env(env=None) -> "Backoff":
        e = env or os.environ

        def _f(name, default):
            try:
                return float(e.get(name, "") or default)
            except ValueError:
                return default

        seed = e.get(HOROVOD_FAULT_SEED, "").strip()
        return Backoff(
            retries=int(_f(HOROVOD_RPC_RETRIES, 3)),
            base_s=_f(HOROVOD_RPC_BACKOFF_BASE_S, 0.05),
            max_s=_f(HOROVOD_RPC_BACKOFF_MAX_S, 2.0),
            jitter=_f(HOROVOD_RPC_BACKOFF_JITTER, 0.1),
            seed=int(seed) if seed.lstrip("-").isdigit() else None,
        )

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based)."""
        d = min(self.max_s, self.base_s * (self.multiplier ** attempt))
        if self.jitter:
            d += d * self.jitter * self._rng.random()
        return d


def retry_call(
    fn: Callable,
    *,
    retryable: Tuple[Type[BaseException], ...] = (OSError, EOFError),
    backoff: Optional[Backoff] = None,
    describe: str = "",
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` with up to ``backoff.retries`` retries on ``retryable``
    exceptions; re-raises the last error once the budget is spent, with
    the attempt count appended so logs show the retry history."""
    bo = backoff or Backoff()
    last: Optional[BaseException] = None
    for attempt in range(bo.retries + 1):
        try:
            return fn()
        except retryable as exc:  # noqa: PERF203 - retry loop
            last = exc
            if attempt >= bo.retries:
                break
            d = bo.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, exc, d)
            sleep(d)
    assert last is not None
    raise type(last)(
        f"{last} [{describe + ': ' if describe else ''}gave up after "
        f"{bo.retries + 1} attempts]"
    ) from last
