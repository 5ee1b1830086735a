"""Start n ranks of a port script on this host, one process each.

    codes = launch_ranks("horovod_tpu_torch.tools.sp_parity", argv, n)

Rank r runs ``python -m <module> <argv>`` with ``HOROVOD_RANK=r``,
``HOROVOD_SIZE=n`` and the local equivalents (the environment hvdrun
sets), so it uses GPU r when it runs on the card. The ranks rendezvous
through a ``FileStore`` in a temporary directory named by
``HVD_TORCH_STORE_DIR``: a worker passes :func:`store_url` to ``init``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from typing import Sequence

STORE_DIR_VAR = "HVD_TORCH_STORE_DIR"


def store_url() -> str:
    """The rendezvous URL of a rank started by :func:`launch_ranks`."""
    return f"file://{os.environ[STORE_DIR_VAR]}/store"


def launch_ranks(module: str, argv: Sequence[str], n: int) -> int:
    """Run ``module`` as ranks 0..n-1 and wait up to ten minutes for all of
    them; returns the largest exit code (a rank killed by a signal counts as
    failed). Every rank still running at the end, or on an error, is
    killed."""
    store_dir = tempfile.mkdtemp(prefix="hvd_torch_ranks_")
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv],
                env={**os.environ, "HOROVOD_RANK": str(r), "HOROVOD_SIZE": str(n),
                     "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": str(n),
                     STORE_DIR_VAR: store_dir},
            ))
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(store_dir, ignore_errors=True)
    return max(abs(c) for c in codes)
