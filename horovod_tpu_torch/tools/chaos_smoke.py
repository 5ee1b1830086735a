"""Chaos smoke: a seeded fault-injection run asserting end-to-end failure
recovery. Budget: under 120 s on the CPU.

    python -m horovod_tpu_torch.tools.chaos_smoke               # 3 cards
    python -m horovod_tpu_torch.tools.chaos_smoke --device cpu  # 3 gloo ranks

The counterpart of ``tools/chaos_smoke.py``: one elastic job under the
port's driver (``python -m horovod_tpu_torch.run -np 3 --min-np 3 --max-np
3``), each worker an ``elastic.TensorState`` of 4 floats and one Average
allreduce of ones a step for 8 steps, with the reference's canonical chaos
plan (:func:`chaos_plan`, ``tests/test_chaos.py:chaos_plan`` byte for byte):

- worker kill: worker ``localhost:2`` exits 43 at its 3rd commit, in
  generation 1 only;
- slow rank: rank 1's submissions are delayed 50 ms for 10 hits;
- dropped control-plane burst: 60% of the rendezvous KV requests vanish
  for a 10-request window; the bounded retry absorbs it.

Gates (:func:`assert_chaos_recovery`): the job exits 0 with every rank at
step 8 and w == 8; the driver saw exit code 43 and published generation 2;
kill, delay and drop are all in the event log; the driver's resolved
schedule (``fault_schedule.json``) is the plan's canonical schedule, which
resolves to the same bytes twice.
"""

from __future__ import annotations

import json
import sys
import time

from .smoke_common import check, finals, main_guard, need_ranks, parse_args, run_elastic_job

CHAOS_SEED = 20260804
RANKS = 3


def chaos_plan() -> dict:
    """The reference's canonical chaos-smoke schedule."""
    return {
        "seed": CHAOS_SEED,
        "faults": [
            {"kind": "kill", "worker": "localhost:2", "at_step": 3,
             "gen": 1, "exit_code": 43},
            {"kind": "delay", "rank": 1, "site": "enqueue",
             "seconds": 0.05, "after": 1, "count": 10},
            {"kind": "drop", "site": "kv", "frac": 0.6, "after": 3,
             "count": 10},
        ],
    }


CHAOS_WORKER = """
import os
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic

hvd.init(device=os.environ.get("SMOKE_DEVICE") or None)
dev = hvd.device()
state = elastic.TensorState(w=torch.zeros(4, device=dev), step=0)


@elastic.run
def train(state):
    while state.step < 8:
        g = hvd.allreduce(torch.ones(4, device=dev), op=hvd.Average, name='grad')
        state.w = g + state.w
        state.step += 1
        state.commit()
    return state.step


train(state)
print('FINAL', hvd.rank(), hvd.size(), state.step, float(state.w[0]), flush=True)
hvd.shutdown()
"""


def canonical_schedule(plan: dict) -> str:
    from horovod_tpu_torch.fault.plan import FaultPlan

    return FaultPlan.from_json(json.dumps(plan)).canonical_schedule()


def run_chaos_job(device, timeout: float = 110):
    return run_elastic_job(
        ["-np", str(RANKS), "--min-np", str(RANKS), "--max-np", str(RANKS)], CHAOS_WORKER,
        device=device, timeout=timeout,
        extra_env={"HOROVOD_FAULT_PLAN": json.dumps(chaos_plan()),
                   "HOROVOD_FAULT_SEED": str(CHAOS_SEED),
                   "HOROVOD_RPC_BACKOFF_BASE_S": "0.02"})


def assert_chaos_recovery(proc, outs) -> None:
    """The reference's ``assert_chaos_recovery``."""
    stderr = proc.stderr
    check(proc.returncode == 0, f"job exited {proc.returncode}: {stderr[-3000:]} {outs}")
    lines = finals(outs)
    check(len(lines) == RANKS, f"{len(lines)} FINAL lines: {lines} {stderr[-2000:]}")
    for line in lines:
        _, _, size, step, w0 = line.split()
        check(size == str(RANKS) and step == "8" and float(w0) == 8.0, f"bad final {lines}")
    check("failed with exit code 43" in stderr, f"no kill seen: {stderr[-3000:]}")
    check("generation 2" in stderr, f"no generation 2: {stderr[-3000:]}")
    sched = outs.get("fault_schedule.json")
    check(bool(sched), f"no fault_schedule.json among {sorted(outs)}")
    check(sched == canonical_schedule(chaos_plan()),
          "the driver's schedule is not the plan's canonical schedule")
    fired = {json.loads(l)["action"] for l in outs.get("fault_events.jsonl", "").splitlines()
             if l.strip()}
    check({"kill", "delay", "drop"} <= fired, f"fault classes fired: {sorted(fired)}")


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(RANKS, args.device, "chaos")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        check(canonical_schedule(chaos_plan()) == canonical_schedule(chaos_plan()),
              "fault schedule resolution is not deterministic")
        proc, outs = run_chaos_job(args.device)
        assert_chaos_recovery(proc, outs)
        print(f"chaos-smoke: recovered from worker-kill + slow-rank + dropped-message burst "
              f"(seed {CHAOS_SEED}) in {time.time() - t0:.1f}s; schedule log reproducible "
              f"byte-for-byte")

    return main_guard("chaos", body)


if __name__ == "__main__":
    sys.exit(main())
