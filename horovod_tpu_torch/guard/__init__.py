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

The sentinels themselves are in :mod:`.nonfinite`. The digest agreement
and the ``hvd_guard_*`` metrics are not ported (ROADMAP A12).

The eager runtimes' payload tap is a seam here: they call
``TAP.check_payload(name, tensor)`` on allreduce/Adasum submissions behind
``if guard.ACTIVE:``. ``ACTIVE`` is False (the eager sentinel is ROADMAP
A12), so the check is the whole cost.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ..common.env import HOROVOD_GUARD_NONFINITE

NONFINITE_POLICIES = ("off", "warn", "zero", "skip", "abort")


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


class _NullTap:
    def check_payload(self, name: str, tensor: Any) -> Any:
        return tensor


ACTIVE = False
TAP = _NullTap()
