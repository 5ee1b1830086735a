"""Per-host NIC probe entry (``python -m horovod_tpu_torch.run.probe <index>
<num_tasks>``), the port of ``horovod_tpu/run/probe.py`` and the
counterpart of the reference's
``python -m horovod.run.task_fn`` (``run/task_fn.py:56-67``). Driver
addresses and the HMAC secret arrive via environment, not argv, so the
secret never shows in ``ps``."""

from __future__ import annotations

import os
import sys

from . import network


def main() -> int:
    index = int(sys.argv[1])
    num_tasks = int(sys.argv[2])
    key = network.decode_key(os.environ[network.SECRET_ENV])
    driver_addrs = network.parse_addresses(
        os.environ["HOROVOD_PROBE_DRIVER_ADDRS"]
    )
    network.run_task_probe(index, num_tasks, driver_addrs, key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
