"""Graceful preemption: notice → commit → drain → rejoin.

The port's copy of ``horovod_tpu/fault/preemption.py``. Nothing on the
fixed launch path installs the SIGTERM handler: ``elastic.run`` does
(unless ``HOROVOD_PREEMPTION_GRACEFUL=0``), and its ``State.commit`` and
rejoin are steps 2 and 3 below.

A TPU maintenance event / spot preemption arrives as a notice (SIGTERM
from the platform, or a simulated notice from the fault plan) some grace
period before the hardware goes away.  The recovery contract:

1. the notice sets a process-wide flag (nothing is interrupted mid-step);
2. the next ``State.commit()`` observes the flag, reaches cross-rank
   agreement through the same allreduce that powers
   ``HostsUpdatedInterrupt``, and raises :class:`PreemptionInterrupt` on
   the preempted rank (peers see a plain membership-change interrupt);
3. the elastic wrapper keeps the just-committed state (no rollback),
   drains in-flight collectives via the runtime shutdown, and rejoins
   through the existing elastic path — persist-and-respawn when in-process
   re-formation is unsupported, in-process re-rendezvous otherwise.

``install_sigterm_handler`` is chained: the previous handler still runs,
so launcher-driven termination semantics are preserved.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger("horovod_tpu_torch.fault")


class PreemptionInterrupt(Exception):
    """Raised inside the training function on the preempted rank after
    cross-rank agreement; the elastic wrapper drains and rejoins with the
    state that was just committed."""


_flag = threading.Event()
_reason: Optional[str] = None
_installed = False
_prev_handler = None


def request_preemption(reason: str = "") -> None:
    """Deliver a (possibly simulated) preemption notice to this process."""
    global _reason
    _reason = reason or "preemption notice"
    if not _flag.is_set():
        logger.warning(
            "preemption notice received (%s); will drain at the next "
            "commit", _reason,
        )
        try:
            # Flight recorder: a SIGTERM'd worker may
            # be gone before the graceful drain completes — persist the
            # last moments the instant the notice lands. No-op when
            # tracing is disabled.
            from .. import trace as _trace

            if _trace.ACTIVE:
                _trace.TAP.flight_dump(f"preempt:{_reason}")
        except Exception:  # noqa: BLE001 - the notice path must not die
            pass
    _flag.set()


def preemption_requested() -> bool:
    return _flag.is_set()


def preemption_reason() -> str:
    return _reason or ""


def clear() -> None:
    global _reason
    _flag.clear()
    _reason = None


def _on_sigterm(signum, frame):  # noqa: ARG001
    request_preemption("SIGTERM")
    if callable(_prev_handler):
        _prev_handler(signum, frame)


def install_sigterm_handler() -> bool:
    """Install the notice handler (main thread only — signal.signal's own
    constraint).  Idempotent; returns True when installed/active."""
    global _installed, _prev_handler
    if _installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        logger.warning(
            "cannot install SIGTERM preemption handler off the main "
            "thread; preemption notices must be delivered via "
            "request_preemption()"
        )
        return False
    prev = signal.signal(signal.SIGTERM, _on_sigterm)
    _prev_handler = prev if prev not in (
        signal.SIG_DFL, signal.SIG_IGN, None
    ) else None
    _installed = True
    return True
