"""The chaos-injection seam of the eager runtime (inactive).

The port's counterpart of ``horovod_tpu/fault/injector.py``'s taps. The
runtimes call :func:`fault_point` and :func:`payload_fault` behind
``if fault.ACTIVE:``, at the sites the JAX package names (``enqueue``,
``response``, ``payload``, ``output``; the serving engine's ``request``
and ``replica``). ``ACTIVE`` is False: fault plans are not ported yet
(ROADMAP A12b), so the check is the whole cost. The exceptions an active
plan raises are here already, because the serving engine catches
:class:`ReplicaKilled` at its replica loop.
"""

from __future__ import annotations

from typing import Any, Optional


class InjectedFault(ConnectionError):
    """A fault injected by the active plan (a dropped message, a severed
    connection). A ``ConnectionError``, so the retry paths treat it as a
    real transport failure (``horovod_tpu/fault/injector.py``)."""


class ReplicaKilled(InjectedFault):
    """A ``kill_replica`` fault: the serving replica that hit the
    ``replica`` site mid-batch aborts. The engine catches it at the
    replica loop, re-queues every request of the batch not yet answered
    and retires the replica."""


ACTIVE = False


def fault_point(site: str, name: Optional[str] = None) -> None:
    """A scheduled kill or delay at ``site`` (none while inactive)."""


def payload_fault(site: str, name: str, tensor: Any) -> Any:
    """A scheduled payload corruption at ``site``; the tensor as it is
    while inactive."""
    return tensor
