"""On-disk result cache with TTL.

The port's copy of ``horovod_tpu/run/disk_cache.py``. Role parity with the reference's launcher check cache
(``horovod/run/util/cache.py``, used by the cached SSH reachability
check at ``run/run.py:62-115``): repeated launches skip slow pre-flight
probes while the cached result is fresh. One JSON file, atomic replace,
tolerant of corruption (a broken cache never breaks a launch).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Optional


class DiskCache:
    def __init__(self, path: str, ttl_seconds: float = 300.0):
        self._path = path
        self._ttl = ttl_seconds

    def _load(self) -> dict:
        try:
            with open(self._path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, key: str) -> Optional[Any]:
        """Cached value, or None when absent or older than the TTL."""
        entry = self._load().get(key)
        if not isinstance(entry, dict):
            return None
        if time.time() - entry.get("t", 0) > self._ttl:
            return None
        return entry.get("v")

    def put(self, key: str, value: Any) -> None:
        self.put_many({key: value})

    def put_many(self, items: dict) -> None:
        """One read-modify-replace for a batch of keys: concurrent
        per-key puts would lose each other's entries (last writer wins on
        the whole file), so batch writers must use this."""
        data = self._load()
        now = time.time()
        for key, value in items.items():
            data[key] = {"v": value, "t": now}
        try:
            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(self._path) or ".", suffix=".cache"
            )
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._path)
        except OSError:
            pass  # best-effort: a read-only FS must not break the launch


def default_cache(ttl_seconds: float = 300.0) -> DiskCache:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return DiskCache(
        os.path.join(base, "horovod_tpu_torch", "launch_checks.json"), ttl_seconds
    )
