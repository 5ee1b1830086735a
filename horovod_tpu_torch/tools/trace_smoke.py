"""Fleet-tracing smoke: straggler attribution, the merged trace, the
flight recorder's postmortem and a byte-stable summary. Budget: ~2 x 15 s
on the CPU.

    python -m horovod_tpu_torch.tools.trace_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.trace_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/trace_smoke.py``: a 2-rank job under the port's
elastic driver with ``HOROVOD_TRACE=1`` and ``HOROVOD_METRICS=1``, the
reference's seeded plan (:data:`FAULT_PLAN`: rank 1 delayed 0.2 s at its
``step`` site for steps 4-9), and a guard abort at the end:

1. step spans and straggler attribution: each worker records 12 step spans
   through the ``trace.wrap_step`` tap (a local compute phase, where the
   plan delays rank 1, then a synchronizing allreduce outside the span); the
   driver's ``/metrics`` shows ``hvd_step_skew_seconds`` observed and
   ``hvd_straggler_total`` for rank 1, never rank 0;
2. merged fleet trace: ``tools/trace_merge`` over the driver-collected
   windows gives lanes ``driver``, ``rank 0``, ``rank 1``, the driver's lane
   carrying the generation publish and the straggler, with the clock
   offsets;
3. flight recorder: both ranks submit a NaN under
   ``HOROVOD_GUARD_NONFINITE=abort``; each dumps its ring, the driver
   bundles the dumps (``postmortem.json``) and ``trace_merge --postmortem``
   renders ``DEATH:`` markers;
4. determinism: the job runs twice and the normalized summary (lanes, steps
   a rank, straggler ranks, rank 1's delay events, death reasons) must be
   byte-identical.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time
import urllib.request

from .smoke_common import REPO, check, job_env, main_guard, need_ranks, parse_args

STEPS = 12
DELAY_S = 0.2
THRESHOLD_S = 0.05

FAULT_PLAN = {
    "seed": 4242,
    "faults": [
        {"kind": "delay", "rank": 1, "site": "step",
         "seconds": DELAY_S, "after": 3, "count": 6},
    ],
}

WORKER = f"""
import os, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import trace as hvd_trace
from horovod_tpu_torch.fault import injector as fault_injector

hvd.init(device=os.environ.get("SMOKE_DEVICE") or None)
dev = hvd.device()
assert hvd.size() == 2
assert hvd_trace.ACTIVE and hvd_trace.TAP is not hvd_trace.NULL_TAP


def train_step(i):
    # The local compute phase: the plan delays rank 1 here for steps 4-9.
    fault_injector.step(f'trace.step.{{i}}')
    time.sleep(0.02)


step = hvd_trace.wrap_step(train_step, wire_dtype='f32', op='SUM')
for i in range({STEPS}):
    step(i)
    # The synchronizing collective outside the span: each step's skew is the
    # delay, not a drift that accumulates.
    out = hvd.allreduce(torch.ones(1024, device=dev), name=f'trace.grad.{{i}}', op=hvd.Sum)
    assert float(out[0]) == hvd.size()
time.sleep(4.0)
bad = torch.ones(64, device=dev)
bad[3] = float('nan')
try:
    hvd.allreduce(bad, name='trace.poison')
    raise SystemExit('guard abort did not fire')
except hvd.HorovodInternalError:
    pass
print('TRACE_WORKER_DONE', hvd.rank(), flush=True)
hvd.shutdown()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _scrape(port: int):
    from horovod_tpu_torch.metrics import export as mexport

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
        return mexport.parse_prometheus(resp.read().decode())


def straggler_counts(parsed) -> dict:
    fam = parsed.get("hvd_straggler_total", {"samples": []})
    return {labels.get("rank"): v for _, labels, v in fam["samples"]
            if v > 0 and labels.get("rank") is not None}


def check_attribution(text: str, rc: int, skew_seen: bool, stragglers: dict) -> None:
    """Gate 1."""
    check(rc == 0, f"job failed rc={rc}\n{text[-4000:]}")
    check("TRACE_WORKER_DONE 0" in text and "TRACE_WORKER_DONE 1" in text,
          f"a worker did not finish\n{text[-4000:]}")
    check(skew_seen, f"hvd_step_skew_seconds never observed\n{text[-3000:]}")
    check("1" in stragglers, f"straggler counter never named rank 1 (saw {stragglers})")
    check("0" not in stragglers, f"rank 0 charged as straggler: {stragglers}")


def run_once(device, tag: str) -> str:
    """One pass; the normalized summary."""
    from horovod_tpu_torch.tools import trace_merge as trace_merge_cli
    from horovod_tpu_torch.trace import merge as tmerge

    port = _free_port()
    td = tempfile.mkdtemp(prefix=f"trace_smoke_{tag}_")
    try:
        trace_dir = os.path.join(td, "trace")
        env = job_env(device, HOROVOD_METRICS="1", HOROVOD_METRICS_PORT=port,
                      HOROVOD_METRICS_PUSH_INTERVAL_S="0.25", HOROVOD_TRACE="1",
                      HOROVOD_TRACE_DIR=trace_dir, HOROVOD_TRACE_PUSH_INTERVAL_S="0.25",
                      HOROVOD_TRACE_STRAGGLER_THRESHOLD_S=THRESHOLD_S,
                      HOROVOD_GUARD_NONFINITE="abort", HOROVOD_FAULT_PLAN=json.dumps(FAULT_PLAN))
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(textwrap.dedent(WORKER))
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--min-np", "2",
             "--max-np", "2", "--output-dir", td, sys.executable, script],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        skew_seen, stragglers = False, {}
        deadline = time.monotonic() + 90
        try:
            while time.monotonic() < deadline and proc.poll() is None:
                time.sleep(0.25)
                try:
                    parsed = _scrape(port)
                except Exception:  # noqa: BLE001 - the driver is not up yet
                    continue
                skew = parsed.get("hvd_step_skew_seconds")
                if skew and any(name.endswith("_count") and v > 0
                                for name, _, v in skew["samples"]):
                    skew_seen = True
                stragglers = straggler_counts(parsed) or stragglers
            out, _ = proc.communicate(timeout=max(5.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        text = out.decode(errors="replace")
        for fn in sorted(os.listdir(td)):
            if fn.startswith("worker.") and fn.endswith((".out", ".err")):
                with open(os.path.join(td, fn), errors="replace") as f:
                    text += f"\n--- {fn} ---\n" + f.read()
        check_attribution(text, proc.returncode, skew_seen, stragglers)

        check(trace_merge_cli.main([trace_dir]) == 0, "trace_merge failed")
        with open(os.path.join(trace_dir, "merged_trace.json")) as f:
            events = json.load(f)["traceEvents"]
        lanes = sorted({e["args"]["name"] for e in events if e.get("name") == "process_name"})
        check(lanes == ["driver", "rank 0", "rank 1"], f"lanes {lanes}")
        driver_names = {e["name"] for e in events if e.get("pid") == tmerge.DRIVER_PID}
        for want in ("hvd_generation_publish", "hvd_straggler"):
            check(want in driver_names, f"{want} not on the driver's lane: {driver_names}")
        clock_estimated = {str(e["pid"]): bool(e["args"].get("estimated")) for e in events
                           if e.get("name") == "hvd_clock_offset" and e["pid"] in (0, 1)}
        ranks, _ = tmerge.read_dir(trace_dir)
        steps_per_rank = {str(r): len(ranks[r].get("steps") or []) for r in sorted(ranks)}
        delay_events = sum(1 for line in ranks[1].get("event_log") or []
                           if line.get("action") == "delay")

        check(trace_merge_cli.main([trace_dir, "--postmortem"]) == 0,
              "trace_merge --postmortem failed")
        with open(os.path.join(trace_dir, "postmortem_trace.json")) as f:
            pm = json.load(f)
        deaths = pm["otherData"]["postmortem"]["reasons"]
        check(any(e["name"].startswith("DEATH:") for e in pm["traceEvents"]),
              "no death markers in the postmortem render")
        check(os.path.exists(os.path.join(trace_dir, "postmortem.json")),
              "the driver did not bundle the flight dumps")
        return json.dumps({
            "schema": 1, "lanes": lanes, "steps_per_rank": steps_per_rank,
            "clock_estimated": clock_estimated,
            "driver_events": sorted(driver_names & {"hvd_driver_start",
                                                    "hvd_generation_publish", "hvd_straggler"}),
            "straggler_ranks": sorted(stragglers), "delay_events_rank1": delay_events,
            "deaths": {r: deaths[r] for r in sorted(deaths)}}, sort_keys=True)
    finally:
        shutil.rmtree(td, ignore_errors=True)


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(2, args.device, "trace")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        log1, log2 = run_once(args.device, "a"), run_once(args.device, "b")
        check(log1 == log2, f"trace smoke is not byte-stable across runs:\n{log1}\n{log2}")
        doc = json.loads(log1)
        print(f"[trace-smoke] OK in {time.time() - t0:.1f}s: {len(doc['lanes'])} lanes, steps "
              f"{doc['steps_per_rank']}, straggler rank {doc['straggler_ranks']}, "
              f"{doc['delay_events_rank1']} seeded delays, deaths {doc['deaths']}, summary "
              "byte-stable")

    return main_guard("trace", body)


if __name__ == "__main__":
    sys.exit(main())
