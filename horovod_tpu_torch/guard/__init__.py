"""The data-plane guard's policy half: which non-finite policy a step runs.

The port's copy of ``resolve_policy`` of ``horovod_tpu/guard/__init__.py``.
The policy comes from the caller, else ``HOROVOD_GUARD_NONFINITE``, else
``off``:

- ``zero`` replaces non-finite gradient entries with 0 before the wire
  (per streamed group under overlap), so one rank's NaN never reaches its
  peers;
- ``warn`` logs when the reduced gradients hold a non-finite value;
- ``skip`` agrees across ranks on a skip flag and leaves the parameters,
  the optimizer state and the error-feedback residual unchanged on every
  rank;
- ``abort`` agrees the same flag and raises ``HorovodInternalError`` from
  the step.

The sentinels themselves are in :mod:`.nonfinite`; the DP step counts
its detections in ``hvd_guard_nonfinite_total`` and
``hvd_guard_skipped_steps_total``, and, while a fault plan or an event-log
file is active, every detection (eager or DP step) is also a ``guard``
line of the fault event log (:func:`record_guard_event`).

The periodic parameter-digest agreement (``HOROVOD_GUARD_DIGEST_STEPS=N``,
``horovod_tpu/guard/__init__.py:43-95``): every N elastic commits each rank
hashes its tracked state (:mod:`.digest`), the digests are allgathered and
compared, and a mismatch heals by a re-broadcast from the agreeing
quorum's reference rank, or rolls back to the last commit where no
quorum exists (``HOROVOD_GUARD_NO_QUORUM=rollback|root``). The agreement
itself runs in ``elastic.State.commit``; a digest cadence alone arms the
tap (``ACTIVE``) with the non-finite policy ``off``.

The eager runtimes call ``TAP.check_payload(name, tensor)`` on
allreduce/Adasum submissions behind ``if guard.ACTIVE:``, the JAX
package's eager sentinel (``horovod_tpu/guard/__init__.py:122-185``):
armed at import from ``HOROVOD_GUARD_NONFINITE`` (any policy but
``off``), it counts a non-finite payload, raises under ``abort`` (after a
flight dump), logs under ``warn`` and zeroes the non-finite entries under
``zero`` and ``skip`` (a per-submission skip would strand the peers
inside the collective). Off, the ``ACTIVE`` check is the whole cost.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

from ..common.env import (
    HOROVOD_GUARD_DIGEST_STEPS,
    HOROVOD_GUARD_NO_QUORUM,
    HOROVOD_GUARD_NONFINITE,
)

GUARD_NONFINITE_ENV = HOROVOD_GUARD_NONFINITE
GUARD_DIGEST_STEPS_ENV = HOROVOD_GUARD_DIGEST_STEPS
GUARD_NO_QUORUM_ENV = HOROVOD_GUARD_NO_QUORUM

NONFINITE_POLICIES = ("off", "warn", "zero", "skip", "abort")
NO_QUORUM_ACTIONS = ("rollback", "root")


def resolve_policy(explicit: Optional[str] = None) -> str:
    """Resolve the non-finite policy: explicit argument >
    ``HOROVOD_GUARD_NONFINITE`` > ``off``. Raises on unknown values: a
    typoed policy silently meaning "off" would be a disabled guard that
    looks enabled."""
    name = (explicit or os.environ.get(HOROVOD_GUARD_NONFINITE, "")
            or "off").strip().lower()
    if name not in NONFINITE_POLICIES:
        raise ValueError(
            f"unknown {HOROVOD_GUARD_NONFINITE} policy {name!r}; choose from "
            f"{NONFINITE_POLICIES}"
        )
    return name


logger = logging.getLogger("horovod_tpu_torch.guard")


def digest_steps() -> int:
    """Digest-agreement cadence in commits (0 = disabled)."""
    v = os.environ.get(GUARD_DIGEST_STEPS_ENV, "").strip()
    if not v:
        return 0
    try:
        return max(int(v), 0)
    except ValueError:
        logger.warning("%s=%r is not an integer; digest agreement disabled",
                       GUARD_DIGEST_STEPS_ENV, v)
        return 0


def no_quorum_action() -> str:
    """What a digest mismatch with no agreeing majority does: ``rollback``
    (default: restore the last elastic commit) or ``root`` (trust the sync
    root's replica and re-broadcast from it, the only heal at 2 ranks)."""
    name = (os.environ.get(GUARD_NO_QUORUM_ENV, "") or "rollback").strip().lower()
    if name not in NO_QUORUM_ACTIONS:
        logger.warning("unknown %s %r; using 'rollback'", GUARD_NO_QUORUM_ENV, name)
        return "rollback"
    return name


def _count(name: str, value: float = 1.0, **labels) -> None:
    from .. import metrics as _metrics

    if _metrics.ACTIVE:
        _metrics.TAP.inc(name, value, **labels)


_event_lock = threading.Lock()
_guard_event_hits = 0


def record_guard_event(action: str, detail: str = "") -> None:
    """Append one guard detection to the deterministic fault event log
    (site ``guard``; ``horovod_tpu/guard/__init__.py:105-123``), so seeded
    chaos runs diff the guard's answers with the faults. Recorded only
    while a fault plan or an event-log file is active: a long run with a
    chatty policy must not grow the in-memory event list without bound."""
    from ..fault import injector as _injector

    if not (_injector.ACTIVE or os.environ.get(_injector.FAULT_EVENT_LOG_ENV, "")):
        return
    global _guard_event_hits
    with _event_lock:
        _guard_event_hits += 1
        hit = _guard_event_hits
    _injector.record_event("guard", hit, action, detail)


class GuardTap:
    """The live tap: the eager payload sentinel and its counter."""

    def __init__(self, policy: str):
        self.policy = policy

    def check_payload(self, name: str, tensor: Any) -> Any:
        """Apply the non-finite policy to one eager reduction payload (a
        tensor or an array) before it is enqueued; returns it, sanitized
        under ``zero``/``skip``. Reads the payload on the host."""
        import numpy as np
        import torch

        if self.policy == "off" or tensor is None:
            return tensor
        t = tensor if torch.is_tensor(tensor) else torch.as_tensor(np.asarray(tensor))
        if not t.is_floating_point():
            return tensor
        finite = torch.isfinite(t)
        n_bad = int(t.numel() - int(finite.sum()))
        if n_bad == 0:
            return tensor
        _count("hvd_guard_nonfinite_total", n_bad, policy=self.policy, path="eager")
        record_guard_event(f"nonfinite-{self.policy}", f"{name} n={n_bad}")
        if self.policy == "abort":
            from .. import trace as _trace
            from ..common.basics import HorovodInternalError

            if _trace.ACTIVE:
                _trace.TAP.flight_dump("guard-abort")
            raise HorovodInternalError(
                f"non-finite gradient guard (policy abort): tensor '{name}' contains {n_bad} "
                "non-finite value(s); refusing to submit it to the collective")
        if self.policy == "warn":
            logger.warning("non-finite guard: tensor '%s' contains %d non-finite value(s); "
                           "submitting anyway (policy warn)", name, n_bad)
            return tensor
        if self.policy == "skip":
            logger.warning("non-finite guard: policy 'skip' applies step-level agreement in "
                           "the DP step only; eager tensor '%s' is sanitized (zeroed) instead",
                           name)
        out = torch.where(finite, t, torch.zeros((), dtype=t.dtype, device=t.device))
        return out if torch.is_tensor(tensor) else out.numpy()


class _NullTap:
    policy = "off"

    def check_payload(self, name: str, tensor: Any) -> Any:
        return tensor


NULL_TAP = _NullTap()
ACTIVE = False
TAP: Any = NULL_TAP
_lock = threading.Lock()


def install(policy: Optional[str] = None, digest: Optional[int] = None) -> None:
    """(De)activate the guard: with the policy ``off`` and the digest
    cadence 0 the no-op tap is installed."""
    global ACTIVE, TAP
    pol = resolve_policy(policy)
    steps = digest_steps() if digest is None else max(int(digest), 0)
    with _lock:
        if pol == "off" and steps <= 0:
            TAP, ACTIVE = NULL_TAP, False
        else:
            TAP, ACTIVE = GuardTap(pol), True


def activate_from_env() -> bool:
    """(Re)load the guard configuration from the environment."""
    install()
    return ACTIVE


def reset() -> None:
    global _guard_event_hits
    install("off", digest=0)
    with _event_lock:
        _guard_event_hits = 0


# Armed at import, as in the JAX package: a worker started with the knobs in
# its environment is guarded without code changes.
if (os.environ.get(HOROVOD_GUARD_NONFINITE, "").strip()
        or os.environ.get(HOROVOD_GUARD_DIGEST_STEPS, "").strip()):
    try:
        activate_from_env()
    except Exception:  # noqa: BLE001 - a malformed knob must not take down import
        logger.exception("could not arm the data-plane guard from the environment")
