"""Guard smoke: the seeded data-plane-integrity scenario, asserting
detection, self-healing and byte-reproducible event logs. Budget: under
15 s on the CPU.

    python -m horovod_tpu_torch.tools.guard_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.guard_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/guard_smoke.py``: two identical 2-rank
(non-elastic) runs of the reference's canonical guard plan
(:func:`guard_plan`, ``tests/test_chaos.py:guard_plan`` byte for byte), each
rank an ``elastic.TensorState`` of 8 floats and one Average allreduce of
``ones * (rank + 1)`` a step for 6 steps:

- nan: rank 0's ``grad`` payload is NaN-poisoned at its 2nd step; the
  non-finite sentinel (``HOROVOD_GUARD_NONFINITE=zero``) zeroes it before
  the wire;
- corrupt: rank 1's allreduce output gets bit 30 of element 1 flipped at
  its 3rd step; the parameter-digest guard (``HOROVOD_GUARD_DIGEST_STEPS=1``)
  sees the divergence at the next commit and heals by a broadcast from the
  sync root (``HOROVOD_GUARD_NO_QUORUM=root``: one against one has no
  majority).

Gates (:func:`assert_guard_recovery`): every rank finishes 6 steps with the
same state, equal to the analytic one (the zeroed NaN included); the log
holds nan, nonfinite-zero, corrupt and a digest-heal naming rank 1 the
outlier; the two runs' normalized event sequences are equal and the plan's
schedule resolves to the same bytes twice.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from .smoke_common import (check, finals, main_guard, need_ranks, normalized_events,
                           parse_args, run_workers)

GUARD_SEED = 604


def guard_plan() -> dict:
    """The reference's canonical data-plane-guard schedule."""
    return {
        "seed": GUARD_SEED,
        "faults": [
            {"kind": "nan", "rank": 0, "site": "payload",
             "tensor": "grad", "at_step": 2, "element": 0, "gen": 1},
            {"kind": "corrupt", "rank": 1, "site": "output",
             "tensor": "grad", "at_step": 3, "element": 1, "bit": 30,
             "gen": 1},
        ],
    }


GUARD_WORKER = """
import os
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic

hvd.init(device=os.environ.get("SMOKE_DEVICE") or None)
dev = hvd.device()
state = elastic.TensorState(w=torch.zeros(8, device=dev), step=0)
while state.step < 6:
    g = hvd.allreduce(torch.ones(8, device=dev) * float(hvd.rank() + 1), op=hvd.Average,
                      name='grad')
    state.w = g + state.w
    state.step += 1
    state.commit()
print('FINAL', hvd.rank(), state.step, ' '.join(f'{v:.4f}' for v in state.w.tolist()),
      flush=True)
hvd.shutdown()
"""


def run_guard_job(device, np_: int = 2, extra_env=None, timeout: float = 60):
    """The scenario on a plain launch: (each rank's output, normalized
    events)."""
    with tempfile.TemporaryDirectory(prefix="hvd_smoke_") as td:
        log = os.path.join(td, "events.jsonl")
        env = {"HOROVOD_FAULT_PLAN": json.dumps(guard_plan()), "HOROVOD_FAULT_EVENT_LOG": log,
               "HOROVOD_GUARD_NONFINITE": "zero", "HOROVOD_GUARD_DIGEST_STEPS": "1"}
        if np_ == 2:
            env["HOROVOD_GUARD_NO_QUORUM"] = "root"
        env.update(extra_env or {})
        outs = run_workers(GUARD_WORKER, np_, device=device, extra_env=env, timeout=timeout)
        events = normalized_events(log)
    return outs, events


def assert_guard_recovery(outs, events, np_: int = 2) -> None:
    """The reference's ``assert_guard_recovery``."""
    a = (np_ + 1) / 2.0
    expect = [a * 6] * 8
    expect[0] = a * 5 + (a - 1.0 / np_)      # rank 0's nan zeroed at step 2
    lines = finals(outs)
    check(len(lines) == np_, f"{len(lines)} FINAL lines: {lines} {outs}")
    for line in lines:
        parts = line.split()
        check(parts[2] == "6", f"not every step ran: {lines}")
        w = np.array([float(v) for v in parts[3:]])
        check(np.allclose(w, expect, rtol=1e-6, atol=0), f"state {w} != {expect}")
    actions = [e[4] for e in events]
    for want in ("nan", "nonfinite-zero", "corrupt", "digest-heal"):
        check(want in actions, f"{want!r} missing from the event log: {events}")
    heal = [e for e in events if e[4] == "digest-heal"][0]
    check("outliers=[1]" in heal[5], f"the heal names another outlier: {heal}")


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(2, args.device, "guard")
    if code is not None:
        return code

    def body():
        from horovod_tpu_torch.fault.plan import FaultPlan

        t0 = time.time()
        text = json.dumps(guard_plan())
        check(FaultPlan.from_json(text).canonical_schedule()
              == FaultPlan.from_json(text).canonical_schedule(),
              "guard fault schedule resolution is not deterministic")
        outs_a, events_a = run_guard_job(args.device)
        assert_guard_recovery(outs_a, events_a)
        outs_b, events_b = run_guard_job(args.device)
        assert_guard_recovery(outs_b, events_b)
        check(events_a == events_b, "two runs of the same seeded guard plan produced different "
              f"event sequences:\n{events_a}\nvs\n{events_b}")
        print(f"guard-smoke: nan sentinel + bit-flip digest heal recovered (seed {GUARD_SEED}) "
              f"in {time.time() - t0:.1f}s; {len(events_a)} guard/fault events byte-identical "
              "across runs")

    return main_guard("guard", body)


if __name__ == "__main__":
    sys.exit(main())
