"""An elastic job's rendezvous stores, in a process that outlives its driver.

    python horovod_tpu_torch/run/store_host.py <kv_addr> <kv_port> <timeout_s>

The elastic driver starts one host a job (its own session, so the driver's
death does not take it down) and asks it for one ``torch.distributed``
TCPStore a generation over the driver's KV plane, scope ``elastic``:

- ``stores.want``: a JSON list of the generations whose stores should be
  up. The host binds a TCPStore on a port the OS picks for each new one
  and answers ``stores.port.<gen>``; a generation no longer listed is
  dropped (its server stops).
- ``stores.done``: the job ended: every store is dropped and the host exits.

Workers' process groups reach their generation's store after ``init``
(NCCL's watchdog and lazy communicators), so the stores must stay up while
a crashed driver is resumed: the host keeps serving them, polling the KV
plane through the outage, and exits only when the plane has not answered
for ``timeout_s`` seconds (the workers' own elastic timeout).

It runs as a file, importing only ``torch.distributed`` and the standard
library: no fault taps, no metrics, no package import.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request
from datetime import timedelta

POLL_S = 0.02
STORE_TIMEOUT_S = 1800  # as launcher.STORE_TIMEOUT_S


def _get(base: str, key: str):
    try:
        with urllib.request.urlopen(f"{base}/elastic/{key}", timeout=2) as r:
            return r.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return b""
        raise


def _put(base: str, key: str, value: bytes) -> None:
    req = urllib.request.Request(f"{base}/elastic/{key}", data=value, method="PUT")
    with urllib.request.urlopen(req, timeout=2):
        pass


def serve(kv_addr: str, kv_port: int, timeout_s: float) -> int:
    import torch.distributed as dist

    base = f"http://{kv_addr}:{kv_port}"
    stores = {}
    last_seen = time.monotonic()
    reachable = True
    while True:
        try:
            want = json.loads(_get(base, "stores.want") or b"[]")
            done = bool(_get(base, "stores.done"))
            for gen in want:
                if gen not in stores:
                    store = dist.TCPStore("127.0.0.1", 0, None, True,
                                          timedelta(seconds=STORE_TIMEOUT_S),
                                          wait_for_workers=False)
                    stores[gen] = store
                    _put(base, f"stores.port.{gen}", str(store.port).encode())
            for gen in [g for g in stores if g not in want or done]:
                del stores[gen]
            last_seen, reachable = time.monotonic(), True
            if done:
                return 0
        except Exception as exc:  # noqa: BLE001 - the host must outlive any driver failure
            # The driver is down, between incarnations, or died mid-answer
            # (an HTTP exception, not an OSError): keep the stores.
            if reachable:
                print(f"store host: the KV plane stopped answering ({exc!r}); keeping "
                      f"generations {sorted(stores)}", file=sys.stderr, flush=True)
                reachable = False
            if time.monotonic() - last_seen > timeout_s:
                return 0
            time.sleep(0.2)
        time.sleep(POLL_S)


if __name__ == "__main__":
    sys.exit(serve(sys.argv[1], int(sys.argv[2]), float(sys.argv[3])))
