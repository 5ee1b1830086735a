"""Driver-HA smoke: the seeded control-plane failure scenario, asserting
the driver's crash-restart resume, the workers' in-place reattach and
byte-reproducible event logs. Budget: under 90 s on the CPU.

    python -m horovod_tpu_torch.tools.driver_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.driver_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/driver_smoke.py``: two identical runs of the
reference's canonical driver-kill plan (:func:`driver_kill_plan`,
``tests/test_chaos.py:driver_kill_plan`` byte for byte) on a 2-rank elastic
job under the port's driver, each worker an ``elastic.TensorState`` of 4
floats, one Average allreduce of ones and a 0.4 s pause a step for 8 steps:

- ``kill_driver``: the driver exits 3 s into the job, mid-training. The
  workers survive, see the loss at their next commit probes
  (``HOROVOD_DRIVER_LOST_PROBES=2``) and park at the commit boundary;
- ``python -m horovod_tpu_torch.run --resume``, 4 s later: a successor
  driver replays the journal, bumps the epoch, republishes the same
  generation and adopts the parked workers, which reattach in place.

The job runs with ``HOROVOD_ELASTIC_REJOIN_MODE=respawn``. That is the mode
in which both drivers' ``_enter_adoption`` republish the same generation;
in the in-process mode, which a driver picks by default where the workers
can re-form in process, the resume publishes a fresh generation and the
survivors re-form through it. The reference smoke leaves the mode to that
default, so on a JAX that re-forms in process its own gate ("resumed at
generation 1") is red; the port holds the property the smoke states.

Gates (:func:`assert_driver_kill_recovery`, the reference's): the killed
driver exits with the driver-kill status and the resumed one with 0; it
says ``resumed at generation 1 (epoch 2)``; each rank started once (the pid
that reattached is the pid that started) and ends at step 8 with
parameters bitwise the uninterrupted run's; the log holds one kill, one
resume, two parks and two reattaches; the journal replays to the same state
twice; the two runs' normalized events are equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .smoke_common import REPO, check, job_env, main_guard, need_ranks, parse_args

DRIVER_SEED = 20260806
DRIVER_STEPS = 8
DRIVER_FINAL_HEX = np.full(4, float(DRIVER_STEPS), np.float32).tobytes().hex()

DRIVER_WORKER = """
import os, time
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic

hvd.init(device=os.environ.get("SMOKE_DEVICE") or None)
dev = hvd.device()
print('START', hvd.rank(), os.getpid(), flush=True)
state = elastic.TensorState(w=torch.zeros(4, device=dev), step=0)


@elastic.run
def train(state):
    while state.step < %d:
        g = hvd.allreduce(torch.ones(4, device=dev), op=hvd.Average, name='grad')
        state.w = g + state.w
        state.step += 1
        time.sleep(0.4)
        state.commit()
    return state.step


train(state)
print('FINAL', hvd.rank(), hvd.size(), state.step,
      state.w.cpu().numpy().astype(np.float32).tobytes().hex(), flush=True)
hvd.shutdown()
""" % DRIVER_STEPS


def driver_kill_plan() -> dict:
    """The reference's canonical driver-kill schedule."""
    return {
        "seed": DRIVER_SEED,
        "faults": [
            {"kind": "kill_driver", "after_s": 3.0},
        ],
    }


def normalized_driver_events(text: str):
    """(rank, seq, site, hit, action, detail), the driver's rank-less events
    first."""
    events = [json.loads(l) for l in text.splitlines() if l.strip()]
    return sorted((e.get("rank") if e.get("rank") is not None else -1, e["seq"], e["site"],
                   e["hit"], e["action"], e["detail"]) for e in events)


def run_driver_kill_job(device, outage_s: float = 4.0, timeout: float = 180):
    """The scenario: (first launcher, resumed launcher, outputs, events)."""
    from horovod_tpu_torch.run.journal import DriverJournal

    with tempfile.TemporaryDirectory(prefix="hvd_smoke_") as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(DRIVER_WORKER)
        env = job_env(device, HOROVOD_FAULT_PLAN=json.dumps(driver_kill_plan()),
                      HOROVOD_FAULT_SEED=DRIVER_SEED, HOROVOD_RPC_BACKOFF_BASE_S="0.02",
                      HOROVOD_DRIVER_LOST_PROBES="2", HOROVOD_ELASTIC_REJOIN_MODE="respawn",
                      HOROVOD_FAULT_EVENT_LOG=os.path.join(td, "fault_events.jsonl"))
        args = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--min-np", "2",
                "--max-np", "2", "--output-dir", td, sys.executable, script]
        first = subprocess.run(args, env=env, cwd=REPO, capture_output=True, text=True,
                               timeout=timeout)
        time.sleep(outage_s)
        resume = subprocess.run(args[:3] + ["--resume"] + args[3:], env=env, cwd=REPO,
                                capture_output=True, text=True, timeout=timeout)
        outs = {}
        for fn in os.listdir(td):
            if fn.startswith("worker.") and fn.endswith((".out", ".err")):
                with open(os.path.join(td, fn), errors="replace") as f:
                    outs[fn] = f.read()
        for fn in ("driver.log", "fault_events.jsonl", "fault_schedule.json",
                   "driver_journal.json"):
            p = os.path.join(td, fn)
            if os.path.exists(p):
                with open(p) as f:
                    outs[fn] = f.read()
        events = normalized_driver_events(outs.get("fault_events.jsonl", ""))
        jpath = os.path.join(td, "driver_journal.json")
        check(DriverJournal(jpath).replay() == DriverJournal(jpath).replay(),
              "two replays of the driver's journal differ")
    return first, resume, outs, events


def assert_driver_kill_recovery(first, resume, outs, events) -> None:
    """The reference's ``assert_driver_kill_recovery``."""
    from horovod_tpu_torch.fault.plan import DRIVER_KILL_EXIT_CODE

    first_err, resume_err = first.stderr, resume.stderr
    check(first.returncode == DRIVER_KILL_EXIT_CODE,
          f"the killed driver exited {first.returncode}: {first_err[-3000:]}")
    check(resume.returncode == 0, f"the resumed driver exited {resume.returncode}: "
          f"{resume_err[-3000:]} {outs}")
    check("resumed at generation 1 (epoch 2)" in resume_err, resume_err[-3000:])
    starts, fins = {}, {}
    for text in outs.values():
        for line in text.splitlines():
            if line.startswith("START"):
                _, rank, pid = line.split()
                check(rank not in starts, f"respawned worker: {outs}")
                starts[rank] = pid
            if line.startswith("FINAL"):
                fins[line.split()[1]] = line.split()
    check(set(starts) == {"0", "1"}, f"starts {starts}")
    for rank in ("0", "1"):
        check(rank in fins, f"rank {rank} has no FINAL: {resume_err[-2000:]}")
        _, _, size, step, whex = fins[rank]
        check(size == "2" and step == str(DRIVER_STEPS), f"finals {fins}")
        check(whex == DRIVER_FINAL_HEX, f"params {whex} != {DRIVER_FINAL_HEX}")
    check("reattached (pid " in resume_err, resume_err[-3000:])
    for pid in starts.values():
        check(f"(pid {pid}, epoch 2)" in resume_err, f"{starts} {resume_err[-3000:]}")
    actions = [e[4] for e in events]
    for action, count in (("kill_driver", 1), ("resume", 1), ("park", 2), ("reattach", 2)):
        check(actions.count(action) == count, f"{action} x{actions.count(action)}: {events}")


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(2, args.device, "driver")
    if code is not None:
        return code

    def body():
        from horovod_tpu_torch.fault.plan import FaultPlan

        t0 = time.time()
        text = json.dumps(driver_kill_plan())
        check(FaultPlan.from_json(text).canonical_schedule()
              == FaultPlan.from_json(text).canonical_schedule(),
              "driver fault schedule resolution is not deterministic")
        first_a, resume_a, outs_a, events_a = run_driver_kill_job(args.device)
        assert_driver_kill_recovery(first_a, resume_a, outs_a, events_a)
        first_b, resume_b, outs_b, events_b = run_driver_kill_job(args.device)
        assert_driver_kill_recovery(first_b, resume_b, outs_b, events_b)
        check(events_a == events_b, "two runs of the same seeded driver-kill plan produced "
              f"different event sequences:\n{events_a}\nvs\n{events_b}")
        print(f"driver-smoke: driver kill + journal resume + worker reattach recovered "
              f"(seed {DRIVER_SEED}) in {time.time() - t0:.1f}s; {len(events_a)} events "
              "byte-identical across runs")

    return main_guard("driver", body)


if __name__ == "__main__":
    sys.exit(main())
