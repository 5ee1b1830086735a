"""Self-driving-fleet smoke: the seeded quarantine -> re-plan -> promote ->
recover scenario, twice, with byte-identical decision logs and the
simulator-gated benefit. Budget: ~2 x 20 s on the CPU.

    python -m horovod_tpu_torch.tools.selfdrive_smoke               # 3 cards
    python -m horovod_tpu_torch.tools.selfdrive_smoke --device cpu  # gloo ranks

The counterpart of ``tools/selfdrive_smoke.py`` (its scenario is
``tests/test_selfdrive.py``'s, copied here: :data:`SELFDRIVE_WORKER`,
:func:`selfdrive_fault_plan`, :func:`write_drifted_calibration`). Each run:
2 ranks over two "hosts" (``localhost`` and ``127.0.0.1``, both local) plus
``--spares 1`` under the port's elastic driver, in the respawn rejoin mode;
the seeded chronic ``delay`` (``every``/``until``) makes rank 0's host the
straggler. The two names are one machine, so on the card a worker takes the
card of its slot's place in the host list (``localhost:0`` card 0,
``127.0.0.1:<i>`` card 1 + i), not its local rank. The driver's straggler policy quarantines ``localhost``
(``reason=slow``) at 3 strikes; the world re-forms without it and promotes
the parked spare; a drifted ``calibration.json`` trips the
``HOROVOD_REPLAN_DIVERGENCE`` trigger and the driver publishes a re-plan
(the int8 wire) that every rank adopts at a commit boundary and re-adopts
after the resize; training ends bitwise at the uninterrupted run's
parameters.

Gates (:func:`assert_selfdrive_recovery`, the reference's): one quarantine,
one re-plan, one promotion, two re-stamps, one spare adoption, four
adoptions; four starts; the journal's strikes, reasons and re-plan; the
re-plan's modeled exposed time below the incumbent's. Across the runs the
normalized decision logs are equal. Then the simulator gate: on the same
drifted calibration ``tools/fleet_sim`` prices the re-planned (int8)
configuration strictly below the incumbent (f32).
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

SELFDRIVE_SEED = 20260805
SELFDRIVE_STEPS = 14
SELFDRIVE_DELAY_S = 0.25

SELFDRIVE_WORKER = """
import os, time
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch import trace as hvd_trace
from horovod_tpu_torch.fault import injector as fault_injector

device = os.environ.get("SMOKE_DEVICE")
if not device:
    # -H localhost:1,127.0.0.1:2 names this machine twice, and each name's
    # slots count their local ranks from 0: give each slot a card of its own.
    host, slot = os.environ["HOROVOD_ELASTIC_WORKER_ID"].rsplit(":", 1)
    device = "cuda:%%d" %% ((0 if host == "localhost" else 1) + int(slot))
hvd.init(device=device)  # a spare parks here
dev = hvd.device()
print('START', hvd.rank(), os.getpid(), flush=True)
state = elastic.TensorState(w=torch.zeros(4, device=dev), step=0)


def local_phase(i):
    # The straggler surface: the seeded chronic delay (site step, every=2:
    # these explicit odd hits, not the commit tap's even ones) stretches
    # this span on the faulted rank only.
    fault_injector.step('selfdrive.step.%%d' %% i)
    time.sleep(0.05)


step_fn = hvd_trace.wrap_step(local_phase, wire_dtype='f32')


@elastic.run
def train(state):
    while state.step < %d:
        step_fn(state.step)
        g = hvd.allreduce(torch.ones(4, device=dev), op=hvd.Average, name='grad')
        state.w = g + state.w
        state.step += 1
        time.sleep(0.15)
        state.commit()
    return state.step


train(state)
kw = elastic.adopted_step_kwargs() or {}
print('FINAL', hvd.rank(), hvd.size(), state.step,
      state.w.cpu().numpy().astype(np.float32).tobytes().hex(),
      'quantized=%%s' %% int(bool(kw.get('quantized'))), flush=True)
hvd.shutdown()
""" % SELFDRIVE_STEPS


def selfdrive_fault_plan() -> dict:
    """The reference's chronic slowness on rank 0, generation 1."""
    return {
        "seed": SELFDRIVE_SEED,
        "faults": [
            {"kind": "delay", "rank": 0, "gen": 1, "site": "step",
             "seconds": SELFDRIVE_DELAY_S, "after": 0, "every": 2,
             "until": 4 * SELFDRIVE_STEPS},
        ],
    }


def write_drifted_calibration(path: str, generation: str = "generic") -> str:
    """A calibration whose ici constants drifted far from the defaults,
    signature-matched to the flat 2-rank model of ``generation`` the driver
    prices re-plans on (``run/selfdrive.model_for_world``: this machine's
    ``topo.model.detect_generation``, ``h100`` on the card)."""
    from horovod_tpu_torch.sim import Calibration, model_signature, save_calibration
    from horovod_tpu_torch.topo.model import synthetic_model

    calib = Calibration(signature=model_signature(synthetic_model(2, generation=generation)),
                        hops={"ici": {"calibrated": True, "latency_us": 4.0,
                                      "bandwidth_gbps": 0.05}},
                        source="selfdrive-smoke")
    save_calibration(calib, path)
    return path


DECISION_ACTIONS = ("quarantine", "replan", "replan-restamp", "replan-adopt", "promote",
                    "spare-adopt")


def normalized_decisions(text: str):
    """The decision ladder of a run's event log, sorted, seq dropped."""
    events = [json.loads(l) for l in text.splitlines() if l.strip()]
    return sorted((e.get("rank") if e.get("rank") is not None else -1, e["site"], e["hit"],
                   e["action"], e["detail"]) for e in events if e["action"] in DECISION_ACTIONS)


def run_selfdrive_job(device, timeout: float = 240):
    """One seeded run: (launcher, outputs, decisions)."""
    from horovod_tpu_torch.topo.model import detect_generation

    with tempfile.TemporaryDirectory(prefix="hvd_smoke_") as td:
        calib_path = write_drifted_calibration(os.path.join(td, "calibration.json"),
                                               detect_generation())
        env = job_env(
            device, HOROVOD_FAULT_PLAN=json.dumps(selfdrive_fault_plan()),
            HOROVOD_FAULT_SEED=SELFDRIVE_SEED,
            HOROVOD_FAULT_EVENT_LOG=os.path.join(td, "fault_events.jsonl"),
            HOROVOD_RPC_BACKOFF_BASE_S="0.02", HOROVOD_ELASTIC_REJOIN_MODE="respawn",
            HOROVOD_TRACE="1", HOROVOD_TRACE_PUSH_INTERVAL_S="0.25",
            HOROVOD_TRACE_STRAGGLER_THRESHOLD_S="0.08", HOROVOD_QUARANTINE_STRIKES="3",
            HOROVOD_QUARANTINE_WINDOW="6", HOROVOD_REPLAN_DIVERGENCE="0.2",
            HOROVOD_REPLAN_CHECK_S="1",
            HOROVOD_REPLAN_SPEC=json.dumps({"name": "selfdrive", "layers": [["grad", 1 << 20]]}),
            HOROVOD_CALIBRATION_FILE=calib_path)
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(SELFDRIVE_WORKER)
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "-H",
             "localhost:1,127.0.0.1:2", "--min-np", "2", "--max-np", "2", "--spares", "1",
             "--output-dir", td, sys.executable, script],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
        outs = {}
        for fn in os.listdir(td):
            if fn.startswith("worker.") and fn.endswith((".out", ".err")):
                with open(os.path.join(td, fn), errors="replace") as f:
                    outs[fn] = f.read()
        for fn in ("driver.log", "fault_events.jsonl", "driver_journal.json"):
            p = os.path.join(td, fn)
            if os.path.exists(p):
                with open(p, errors="replace") as f:
                    outs[fn] = f.read()
        decisions = normalized_decisions(outs.get("fault_events.jsonl", ""))
        check("driver_journal.json" in outs, f"no driver journal: {proc.stderr[-3000:]}")
        outs["_journal"] = json.loads(outs["driver_journal.json"])
    return proc, outs, decisions


def assert_selfdrive_recovery(proc, outs, decisions) -> None:
    """The reference's ``assert_selfdrive_recovery``."""
    stderr = proc.stderr
    check(proc.returncode == 0, f"job exited {proc.returncode}: {stderr[-3000:]}")
    actions = [d[3] for d in decisions]
    for action, count in (("quarantine", 1), ("replan", 1), ("promote", 1),
                          ("replan-restamp", 2), ("spare-adopt", 1), ("replan-adopt", 4)):
        check(actions.count(action) == count,
              f"{action} x{actions.count(action)}: {decisions}\n{stderr[-2000:]}")
    q = next(d for d in decisions if d[3] == "quarantine")
    check("host=localhost" in q[4] and "reason=slow" in q[4], f"quarantine {q}")
    p = next(d for d in decisions if d[3] == "promote")
    check("worker=127.0.0.1:1" in p[4] and p[2] == 3, f"promote {p}")
    s = next(d for d in decisions if d[3] == "spare-adopt")
    check(s[0] == 1 and s[2] == 3, f"spare-adopt {s}")
    final_hex = np.full(4, float(SELFDRIVE_STEPS), np.float32).tobytes().hex()
    texts = [o for o in outs.values() if isinstance(o, str)]
    fins = [l for o in texts for l in o.splitlines() if l.startswith("FINAL")]
    check(len(fins) == 2, f"finals {fins} {stderr[-2000:]}")
    for line in fins:
        _, _, size, step, whex, quant = line.split()
        check(size == "2" and step == str(SELFDRIVE_STEPS), f"finals {fins}")
        check(whex == final_hex, f"params {whex} != {final_hex}")
        check(quant == "quantized=1", f"the re-plan was not adopted: {fins}")
    starts = [l for o in texts for l in o.splitlines() if l.startswith("START")]
    check(len(starts) == 4, f"starts {starts} {stderr[-2000:]}")
    jdoc = outs["_journal"]
    check(jdoc["slow_strikes"] == {"localhost": 1}, f"journal strikes {jdoc['slow_strikes']}")
    check(jdoc["blacklist_reasons"].get("localhost") == "slow", "journal blacklist reasons "
          f"{jdoc['blacklist_reasons']}")
    check(jdoc["replan"]["config"]["wire_dtype"] == "int8", f"journal re-plan {jdoc['replan']}")
    modeled = jdoc["replan"]["modeled"]
    check(modeled["replanned_exposed_us"] < modeled["current_exposed_us"], f"modeled {modeled}")


def sim_gate() -> dict:
    """The re-planned (int8) configuration priced strictly below the
    incumbent (f32) by ``tools/fleet_sim`` on the drifted calibration."""
    from horovod_tpu_torch.topo.model import detect_generation

    out, gen = {}, detect_generation()
    with tempfile.TemporaryDirectory() as td:
        calib = write_drifted_calibration(os.path.join(td, "calibration.json"), gen)
        for wire in ("f32", "int8"):
            p = os.path.join(td, f"sim.{wire}.json")
            proc = subprocess.run(
                [sys.executable, "-m", "horovod_tpu_torch.tools.fleet_sim", "--ranks", "2",
                 "--local", "2", "--program", "layers", "--layer-bytes", str(1 << 20),
                 "--generation", gen, "--wire", wire, "--calibration", calib, "--steps", "2",
                 "-o", p],
                cwd=REPO, env=job_env(), capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, f"fleet_sim predict ({wire}) failed: {proc.stderr[-2000:]}")
            with open(p) as f:
                out[wire] = json.load(f)["results"][0]["step_time_us"]
    check(out["int8"] < out["f32"], f"sim gate: int8 {out['int8']}us not below f32 "
          f"{out['f32']}us on the drifted calibration")
    return out


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(3, args.device, "selfdrive")
    if code is not None:
        return code

    def body():
        from horovod_tpu_torch.fault.plan import FaultPlan

        t0 = time.time()
        text = json.dumps(selfdrive_fault_plan())
        check(FaultPlan.from_json(text).canonical_schedule()
              == FaultPlan.from_json(text).canonical_schedule(),
              "chronic-delay schedule resolution is not deterministic")
        proc_a, outs_a, dec_a = run_selfdrive_job(args.device)
        assert_selfdrive_recovery(proc_a, outs_a, dec_a)
        proc_b, outs_b, dec_b = run_selfdrive_job(args.device)
        assert_selfdrive_recovery(proc_b, outs_b, dec_b)
        check(dec_a == dec_b, "two runs of the same seeded self-driving scenario produced "
              f"different decision logs:\n{dec_a}\nvs\n{dec_b}")
        gate = sim_gate()
        print(f"[selfdrive-smoke] OK in {time.time() - t0:.1f}s (seed {SELFDRIVE_SEED}): "
              f"quarantine -> re-plan -> promote -> recover; {len(dec_a)} decision events "
              f"byte-identical across runs; sim gate int8 {gate['int8']}us < f32 "
              f"{gate['f32']}us on the drifted calibration")

    return main_guard("selfdrive", body)


if __name__ == "__main__":
    sys.exit(main())
