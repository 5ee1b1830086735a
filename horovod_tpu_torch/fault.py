"""The chaos-injection seam of the eager runtime (inactive).

The port's counterpart of ``horovod_tpu/fault/injector.py``'s taps. The
runtimes call :func:`fault_point` and :func:`payload_fault` behind
``if fault.ACTIVE:``, at the sites the JAX package names (``enqueue``,
``response``, ``payload``, ``output``). ``ACTIVE`` is False: fault plans
are not ported yet (ROADMAP A12), so the check is the whole cost.
"""

from __future__ import annotations

from typing import Any, Optional

ACTIVE = False


def fault_point(site: str, name: Optional[str] = None) -> None:
    """A scheduled kill or delay at ``site`` (none while inactive)."""


def payload_fault(site: str, name: str, tensor: Any) -> Any:
    """A scheduled payload corruption at ``site``; the tensor as it is
    while inactive."""
    return tensor
