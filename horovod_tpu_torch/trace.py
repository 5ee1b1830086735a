"""The fleet-trace seam of the eager runtime (inactive).

The port's counterpart of ``horovod_tpu/trace``' ``ACTIVE``/``TAP``: the
runtimes emit an ``hvd_plan`` span per executed plan, carrying the same
``hvd_plan_<id>`` string the core's timeline stamps, and a flight-recorder
dump on a stall abort, behind ``if trace.ACTIVE:``. ``ACTIVE`` is False and
``TAP`` records nothing: the span window and its shipping are ROADMAP A12.
"""

from __future__ import annotations

from typing import Any

ACTIVE = False


class _NullTap:
    def event(self, name: str, **fields: Any) -> None:
        pass

    def flight_dump(self, reason: str) -> None:
        pass


TAP = _NullTap()
