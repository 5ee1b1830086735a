"""Metrics smoke: a 2-rank job with ``HOROVOD_METRICS=1`` whose elastic
driver's ``GET /metrics`` is scraped mid-run and validated. Budget: under
60 s on the CPU.

    python -m horovod_tpu_torch.tools.metrics_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.metrics_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/metrics_smoke.py`` (its job and its gates are
``tests/test_metrics.py``'s ``run_metrics_job`` and
``validate_exposition``): 2 ranks under the port's elastic driver, 80
named Sum allreduces of 256 floats each, 50 ms apart. The page must parse
as Prometheus text (``metrics/export.parse_prometheus``); the per-op
``hvd_op_execute_seconds`` histograms must be nonzero for both ranks with
their ``+Inf`` bucket at the series count; ``hvd_op_negotiate_seconds``,
the RPC retry counters, the driver's KV request counters and its elastic
gauges (``hvd_elastic_world_size{role="driver"} == 2``, at least one
generation) must be there; the job exits 0.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
import urllib.request

from .smoke_common import REPO, check, job_env, main_guard, need_ranks, parse_args

RANKS = 2

METRICS_WORKER = """
import os, time
import torch
import horovod_tpu_torch as hvd

hvd.init(device=os.environ.get("SMOKE_DEVICE") or None)
assert hvd.size() == 2
for i in range(80):
    out = hvd.allreduce(torch.ones(256, device=hvd.device()), name=f'metrics.step.{i}',
                        op=hvd.Sum)
    assert float(out[0]) == hvd.size()
    time.sleep(0.05)
print('METRICS_WORKER_DONE', hvd.rank(), flush=True)
hvd.shutdown()
"""


def validate_exposition(text: str) -> None:
    """The reference's ``validate_exposition``."""
    from horovod_tpu_torch.metrics import export as mexport

    parsed = mexport.parse_prometheus(text)
    hist = parsed["hvd_op_execute_seconds"]
    check(hist["type"] == "histogram", "hvd_op_execute_seconds is not a histogram")
    counts = {labels.get("rank"): v for name, labels, v in hist["samples"]
              if name.endswith("_count") and labels.get("op") == "ALLREDUCE"}
    check(counts.get("0", 0) > 0 and counts.get("1", 0) > 0, f"allreduce counts {counts}")
    for rank in ("0", "1"):
        inf = [v for name, labels, v in hist["samples"]
               if name.endswith("_bucket") and labels.get("rank") == rank
               and labels.get("op") == "ALLREDUCE" and labels.get("le") == "+Inf"]
        check(bool(inf) and inf[0] == counts[rank], f"rank {rank}: +Inf bucket {inf}")
    check(parsed["hvd_op_negotiate_seconds"]["type"] == "histogram",
          "hvd_op_negotiate_seconds is not a histogram")
    check(parsed["hvd_rpc_retries_total"]["type"] == "counter",
          "hvd_rpc_retries_total is not a counter")
    check(any(v > 0 for _, _, v in parsed["hvd_kv_server_requests_total"]["samples"]),
          "no KV server requests counted")
    world = {labels.get("role"): v for _, labels, v in parsed["hvd_elastic_world_size"]["samples"]}
    check(world.get("driver") == 2.0, f"hvd_elastic_world_size {world}")
    gens = parsed["hvd_elastic_generations_total"]["samples"]
    check(any(labels.get("role") == "driver" and v >= 1 for _, labels, v in gens),
          f"hvd_elastic_generations_total {gens}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def run_metrics_job(device, timeout: float = 50):
    """The job, scraped until a page validates: (exit code, page, output)."""
    port = _free_port()
    env = job_env(device, HOROVOD_METRICS="1", HOROVOD_METRICS_PORT=port,
                  HOROVOD_METRICS_PUSH_INTERVAL_S="0.25")
    with tempfile.TemporaryDirectory(prefix="hvd_smoke_") as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(textwrap.dedent(METRICS_WORKER))
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--min-np", "2",
             "--max-np", "2", "--output-dir", td, sys.executable, script],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        good, last_err = None, None
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline and proc.poll() is None:
                time.sleep(0.25)
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                                timeout=5) as resp:
                        text = resp.read().decode()
                    validate_exposition(text)
                    good = text
                    break
                except Exception as exc:  # noqa: BLE001 - until the pushers reported
                    last_err = exc
            out, _ = proc.communicate(timeout=max(5.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        text_out = out.decode(errors="replace")
        for fn in sorted(os.listdir(td)):
            if fn.startswith("worker.") and fn.endswith((".out", ".err")):
                with open(os.path.join(td, fn), errors="replace") as f:
                    text_out += f"\n--- {fn} ---\n" + f.read()
    check(good is not None,
          f"never scraped a valid exposition (last error: {last_err!r}); output:\n"
          f"{text_out[-4000:]}")
    return proc.returncode, good, text_out


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(RANKS, args.device, "metrics")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        rc, text, out = run_metrics_job(args.device)
        check(rc == 0, f"job failed rc={rc}\n{out[-4000:]}")
        check("METRICS_WORKER_DONE 0" in out and "METRICS_WORKER_DONE 1" in out,
              f"a worker did not finish:\n{out[-4000:]}")
        validate_exposition(text)
        n_series = sum(1 for line in text.splitlines() if not line.startswith("#"))
        print(f"metrics-smoke: scraped a valid 2-rank exposition ({n_series} series) off the "
              f"driver in {time.time() - t0:.1f}s")

    return main_guard("metrics", body)


if __name__ == "__main__":
    sys.exit(main())
