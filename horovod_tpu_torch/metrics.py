"""The metrics seam of the eager runtime (inactive).

The port's counterpart of ``horovod_tpu/metrics``' ``ACTIVE``/``TAP``: the
runtimes record their counters and histograms (``hvd_ops_submitted_total``,
``hvd_plans_total``, ``hvd_op_execute_seconds``, ``hvd_op_bytes``, ...)
through ``TAP`` behind ``if metrics.ACTIVE:``. ``ACTIVE`` is False and
``TAP`` records nothing: the registry and its export are ROADMAP A12.
"""

from __future__ import annotations

from typing import Any

ACTIVE = False


class _NullTap:
    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        pass

    def set(self, name: str, value: float, **labels: Any) -> None:
        pass

    def observe(self, name: str, value: float, **labels: Any) -> None:
        pass


TAP = _NullTap()
