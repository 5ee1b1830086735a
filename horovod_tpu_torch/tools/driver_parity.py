"""The elastic driver live on the GPT step: its cases through the real CLI.

    python -m horovod_tpu_torch.tools.driver_parity --ranks 4          # a card per slot, NCCL
    python -m horovod_tpu_torch.tools.driver_parity --ranks 1          # one card (chip_smoke)
    python -m horovod_tpu_torch.tools.driver_parity --smoke            # gloo ranks on the CPU
    python -m horovod_tpu_torch.tools.driver_parity --smoke --ranks 1

Each case runs ``python -m horovod_tpu_torch.run`` with elastic flags
(``run/elastic_driver.py``, one host, a card a slot), its worker being
``tools/elastic_parity``'s GPT step under ``@elastic.run``: GPT-2-small at
8 x 1024 a rank, bf16, AdamW 3e-4 (weight decay 1e-4), a commit every step
(a 2-layer d-64 GPT at 2 x 32 in f32 with ``--smoke``), the batch of a step
drawn from (seed, step, rank, size). Faults come from a seeded
``HOROVOD_FAULT_PLAN``. The cases (:data:`CASES`):

- ``discovery``: a discovery script offering 4 slots, 3 once rank 0 passed
  step 2, then 4 again in generation 2: the world goes 4 -> 3 -> 4 with
  its state kept, the dropped slot draining, the returning one fresh on
  its own card;
- ``crash``: rank 3 killed at commit 3; the survivors roll back in
  process, and the driver respawns the slot (a failure on ``localhost``,
  below ``--blacklist-threshold``), so generation 2 has 4 ranks again;
- ``spare``: 3 ranks and ``--spares 1``; rank 2 killed at commit 3, the
  parked spare (slot 3, its own card) takes its rank in generation 2 and
  the dead slot comes back as the spare;
- ``driver``: ``kill_driver`` under ``--auto-resume`` at 4 ranks: the
  supervisor resumes the driver from its journal (epoch 2), and the
  parked workers re-form through a fresh generation with their committed
  state;
- ``respawn`` (one rank): ``HOROVOD_ELASTIC_REJOIN_MODE=respawn`` and a
  preemption at commit 3: the rank persists its commit and exits 79, the
  driver respawns the slot into the next generation (2, or 3 where it
  answered the rank's rejoin signal before its exit), which resumes from
  the snapshot on disk (a hard kill of the only rank would leave no snapshot:
  respawn snapshots are written on the way out);
- ``driver1`` (one rank): ``kill_driver`` under ``--auto-resume``;
- ``replan`` (4 ranks): the live re-plan. The worker is the post-hoc DP
  step (``make_train_step`` over AdamW, the workload ``replan``) and the
  driver runs with ``HOROVOD_REPLAN_DIVERGENCE=0.5``,
  ``HOROVOD_REPLAN_SPEC`` (the GPT's layers, ``tune.spec_from_params``) and
  ``HOROVOD_CALIBRATION_FILE``, a calibration of the driver's own model
  (``selfdrive.model_for_world``) whose NVLink (``ici``) bandwidth is the
  row's divided by ``REPLAN_FACTOR``; the file appears once rank 0 passed
  step 2, so the notice lands mid-run. The driver must publish one notice
  whose config equals ``selfdrive.propose_replan`` of the same spec, model
  and calibration in this process; every rank adopts it at the same commit
  and rebuilds its step from ``elastic.adopted_step_kwargs()``; every loss
  after the adoption equals, bitwise, a plain 4-rank job that resumes rank
  0's state at the adoption with those knobs by hand. Figures: the seconds
  from the notice's publication (the driver's log line, seen within 0.25 s)
  to the first rank's adoption and to the end of the first adopted step
  (rank 0 saves its state for the reference in between). After the
  rebuild the parameters carry one build's hooks: none post hoc;
- ``replan-overlap`` (4 ranks): the same with the ``overlap=True`` step,
  whose rebuild closes the step it replaces: after the adoption every
  parameter carries the hook of one streamed reduction, and only one.

Checks: the job exits 0; the last generation's ranks agree on their
parameters bitwise; every loss after a re-formation equals, as
``elastic_parity`` checks (bitwise in f32, within bf16's rounding on the
card), that of a reference run at the new size from the state the sync
root held right after it (on one rank: the same worker's uninterrupted
run, bitwise, and the final parameters bitwise the uninterrupted run's);
the driver's ``GET /metrics`` shows ``hvd_elastic_generation``,
``hvd_elastic_world_size`` and series for ranks 0 to n-1; two runs of the
``crash`` case give the same normalised event lines and the same
``fault_schedule.json``; on the card, 12 forward and 12 backward B1
launches a step in every generation. Times: a kill to the first step of
the next generation, a driver kill to the first step after the workers
re-formed, a spare's promotion. Prints one JSON line; exits nonzero on a
failed check.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from . import elastic_parity as ep

PLAN_SEED = 20261018
KILL_EXIT = 43
STEPS = 8
# Where the card's step is ~0.1 s, a pause a step keeps the job running
# past a driver kill scheduled a few seconds after the driver starts.
DRIVER_STEPS, DRIVER_PAUSE_S = 16, 1.0
# kill_driver's after_s: past the workers' start, inside their training.
DRIVER_KILL_AFTER_S = {"card1": 14.0, "card4": 20.0, "cpu1": 10.0, "cpu4": 12.0}
# The replan case: its steps, the pause a step (the driver checks on its
# one-second beat), the step after which the calibration appears, the
# factor its NVLink bandwidth is below the row's, and the driver's trigger.
REPLAN_STEPS, REPLAN_PAUSE_S, REPLAN_CALIBRATE_AT, REPLAN_FACTOR = 10, 1.0, 2, 4.0
REPLAN_DIVERGENCE = "0.5"


def _kill(rank: int, at_step: int = 3) -> dict:
    return {"kind": "kill", "site": "step", "rank": rank, "gen": 1, "at_step": at_step,
            "exit_code": KILL_EXIT}


# args: the CLI's elastic flags ({script} is the discovery script); faults:
# the plan's actions; kill: (rank, step) of a worker kill, logged by the
# worker; members: each generation's size.
CASES = {
    "discovery": dict(args=["--min-np", "3", "--max-np", "4", "--host-discovery-script",
                            "{script}", "--elastic-discovery-interval", "0.3"],
                      faults=[], members=[4, 3, 4], pause_s=0.5,
                      slots=[(1, 2, 3), (2, 5, 4)]),
    "crash": dict(args=["-H", "localhost:4", "--min-np", "4", "--max-np", "4"],
                  faults=[_kill(3)], kill=(3, 3), members=[4, 4]),
    "spare": dict(args=["-H", "localhost:4", "--min-np", "3", "--max-np", "3", "--spares", "1"],
                  faults=[_kill(2)], kill=(2, 3), members=[3, 3]),
    "driver": dict(args=["-H", "localhost:4", "--min-np", "4", "--max-np", "4", "--auto-resume"],
                   faults=[{"kind": "kill_driver", "after_s": None}], members=[4, 4],
                   steps=DRIVER_STEPS, pause_s=DRIVER_PAUSE_S),
    "respawn": dict(args=["-H", "localhost:1", "--min-np", "1", "--max-np", "1"],
                    faults=[{"kind": "preempt", "site": "step", "rank": 0, "gen": 1,
                             "at_step": 3}],
                    kill=(0, 3), members=[1, 1], mode="respawn", reference_in_worker=True),
    "driver1": dict(args=["-H", "localhost:1", "--min-np", "1", "--max-np", "1",
                          "--auto-resume"],
                    faults=[{"kind": "kill_driver", "after_s": None}], members=[1, 1],
                    steps=DRIVER_STEPS, pause_s=DRIVER_PAUSE_S, reference_in_worker=True),
    "replan": dict(args=["-H", "localhost:4", "--min-np", "4", "--max-np", "4"],
                   faults=[], members=[4], workload="replan", steps=REPLAN_STEPS,
                   pause_s=REPLAN_PAUSE_S, calibrate_at=REPLAN_CALIBRATE_AT),
}
CASES["replan-overlap"] = dict(CASES["replan"], overlap=True)
CARD_CASES = {1: ["respawn", "driver1"], 4: ["discovery", "crash", "spare", "driver"]}


# --- the worker ------------------------------------------------------------------


def worker(cfg_path: str) -> int:
    """One slot of the job (``--worker``): elastic_parity's GPT step, its
    records in ``<out>/slot.<n>.jsonl``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.fault import injector
    from horovod_tpu_torch.guard import digest
    from horovod_tpu_torch.ops import flash_attention as fa

    with open(cfg_path) as f:
        cfg = json.load(f)
    wid = os.environ["HOROVOD_ELASTIC_WORKER_ID"]
    out = os.path.join(cfg["out"], f"slot.{wid.rsplit(':', 1)[1]}.jsonl")
    had_snapshot = bool(elastic._persist_path() and os.path.exists(elastic._persist_path()))
    spare = os.environ.get("HOROVOD_ELASTIC_SPARE") == "1"
    hvd.init(device=cfg["device"])  # a spare parks in here until it is promoted
    job = ep._Job(cfg)
    steps = cfg["steps"]
    ep._emit(out, {"event": "start", "gen": int(os.environ.get("HOROVOD_ELASTIC_GEN", "1")),
                   "rank": hvd.rank(), "size": hvd.size(), "had_snapshot": had_snapshot,
                   "spare": spare, "pid": os.getpid(), "t": time.time(),
                   "card": str(job.dev)})
    reference: Dict[int, float] = {}
    earlier = [r for r in _slot_records(out) if r.get("event") == "reference"]
    if cfg.get("reference_in_worker") and earlier:
        # A respawned slot: its first incarnation ran the reference.
        reference = {int(k): v for k, v in earlier[0]["losses"].items()}
    elif cfg.get("reference_in_worker"):
        # The uninterrupted run: the same steps, no plan; then back to the
        # seed's weights and a fresh optimizer state.
        plan = injector.active_plan()
        injector.install_plan(None)
        init_model = {k: v.detach().clone() for k, v in job.model.state_dict().items()}
        init_opt = job.opt.state_dict()
        for s in range(1, steps + 1):
            reference[s] = job.one_step(s)
        ep._emit(out, {"event": "reference", "losses": reference,
                       "param_sha": ep._param_sha(job.model)})
        job.model.load_state_dict(init_model)
        job.opt.load_state_dict(init_opt)
        injector.install_plan(plan)
    state = elastic.TorchState(job.model, job.opt, step=0)

    def on_reset():
        gen = int(os.environ["HOROVOD_ELASTIC_GEN"])
        ep._emit(out, {"event": "reset", "gen": gen, "rank": hvd.rank(), "size": hvd.size(),
                       "step": state.step, "t": time.time(),
                       "reformation": dict(state.reformations[-1])})
        if hvd.rank() == 0:
            ep._dump_state(job, state, os.path.join(cfg["out"], f"reset.gen{gen}.rank0.pt"))

    state.register_reset_callbacks([on_reset])
    kill = cfg.get("kill")

    @elastic.run
    def train(state):
        adopted = elastic.adopted_step_kwargs()
        if cfg.get("workload") == "replan" and adopted is not None \
                and adopted != job.step_kwargs:
            # Re-entered after a live re-plan's adoption: rebuild the step
            # from the notice's knobs and keep the state it resumes from.
            job.rebuild(adopted)
            ep._emit(out, {"event": "adopt", "rank": hvd.rank(), "step": state.step,
                           "t": time.time(), "kwargs": adopted,
                           "notice": elastic.adopted_replan(), "hooks": job.hooks(),
                           "n_params": len(list(job.model.parameters()))})
            if hvd.rank() == 0:
                ep._dump_state(job, state, os.path.join(cfg["out"], "adopt.rank0.pt"))
        while state.step < steps:
            s = state.step + 1
            counts = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
            job.sync()
            t0 = time.perf_counter()
            loss = job.one_step(s)
            job.sync()
            rec = {"rank": hvd.rank(), "size": hvd.size(), "step": s, "loss": loss,
                   "ms": (time.perf_counter() - t0) * 1e3, "pid": os.getpid(),
                   "gen": int(os.environ.get("HOROVOD_ELASTIC_GEN", "1")), "t": time.time(),
                   "launches": [fa.FWD_LAUNCHES - counts[0], fa.BWD_LAUNCHES - counts[1]]}
            if s in reference:
                rec["reference_loss"] = reference[s]
            ep._emit(out, rec)
            state.step = s
            if kill and hvd.rank() == kill[0] and s == kill[1] and rec["gen"] == 1:
                ep._emit(out, {"event": "kill", "t": time.time()})
            time.sleep(cfg.get("pause_s", 0.0))
            state.commit()
        return state.step

    train(state)
    ep._emit(out, {"event": "end", "rank": hvd.rank(), "size": hvd.size(),
                   "gen": int(os.environ["HOROVOD_ELASTIC_GEN"]),
                   "param_sha": ep._param_sha(job.model),
                   "state_digest": digest.state_digest(state), "pid": os.getpid(),
                   "t": time.time()})
    hvd.shutdown()
    return 0


def _slot_records(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(l) for l in f]


# --- the replan case's inputs ---------------------------------------------------


def replan_inputs(work: str, dims: dict, seq: int, n: int) -> dict:
    """Write the replan case's program spec and calibration (the latter as
    ``calibration.pending``, moved into place mid-run) and compute the
    notice the driver must publish: ``selfdrive.propose_replan`` of the
    same spec, model (``model_for_world`` of the launcher's one-host world)
    and calibration. Returns the spec's extra keys (env, paths) and the
    expected proposal's notice fields."""
    from horovod_tpu_torch import tune as T
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.run import selfdrive as sd
    from horovod_tpu_torch.sim import calibrate as C
    from horovod_tpu_torch.tune.objective import calibrated_model

    program = T.spec_from_params("gpt", TransformerLM(**dims, max_len=seq, device="meta"),
                                 mesh={"data": n})
    world = {"assignments": {f"localhost:{i}": {"rank": i, "local_rank": i, "local_size": n,
                                                "cross_rank": 0, "cross_size": 1}
                             for i in range(n)}}
    model = sd.model_for_world(world)
    hop = model.hops[-1]
    calib = C.Calibration(
        signature=C.model_signature(model), source="driver_parity: the replan case",
        hops={hop.name: {"calibrated": True, "latency_us": hop.latency_us,
                         "bandwidth_gbps": hop.bandwidth_gbps / REPLAN_FACTOR}})
    ratios = sd.divergence_ratios(model, calibrated_model(model, calib)[0])
    drift = sd.max_divergence(ratios)
    prop = sd.propose_replan(program, model, None, calib, trigger="divergence",
                             per_hop=ratios, drift=drift)
    if prop is None:
        raise SystemExit("driver_parity: the replan case's calibration proposes no re-plan")
    spec_path = os.path.join(work, "replan_spec.json")
    with open(spec_path, "w") as f:
        json.dump({"name": program.name, "layers": [list(l) for l in program.layers]}, f)
    pending, path = (os.path.join(work, f) for f in ("calibration.pending", "calibration.json"))
    C.save_calibration(calib, pending)
    expect = {k: v for k, v in prop.to_notice(1, 1, 1).items() if k not in ("id", "gen", "epoch")}
    return {"env": {"HOROVOD_REPLAN_DIVERGENCE": REPLAN_DIVERGENCE,
                    "HOROVOD_REPLAN_CHECK_S": "0.5", "HOROVOD_REPLAN_SPEC": spec_path,
                    "HOROVOD_CALIBRATION_FILE": path},
            "calibration_pending": pending, "calibration": path, "expect": expect,
            "model": model.to_dict()}


def _replan_checks(work: str, cfg: dict, spec: dict, job: dict, steps_of: dict, recs: dict,
                   n: int, timeout: float, figures: dict, failures: List[str]) -> int:
    """The replan case's checks (the module docstring); returns the losses
    compared against the reference."""
    from horovod_tpu_torch import tune as T

    published = re.findall(r"re-plan #(\d+) published", job["log"])
    if published != ["1"]:
        failures.append(f"replan: the driver published notices {published}, not one")
    adopts = {slot: [r for r in rs if r.get("event") == "adopt"] for slot, rs in recs.items()}
    if sorted(adopts) != list(range(n)) or any(len(a) != 1 for a in adopts.values()):
        failures.append(f"replan: adoptions by slot {adopts}")
        return 0
    at = {a[0]["step"] for a in adopts.values()}
    notice = adopts[0][0]["notice"]
    got = {k: v for k, v in notice.items() if k not in ("id", "gen", "epoch", "calib")}
    want_kw = T.tuned_step_kwargs(T.TunedConfig(knobs=spec["expect"]["config"], signature={},
                                                objectives={}, baseline={}))
    figures.update(adopted_at_step=sorted(at), notice=notice, expected=spec["expect"],
                   adopted_step_kwargs=adopts[0][0]["kwargs"])
    if len(at) != 1:
        failures.append(f"replan: the ranks adopted at steps {sorted(at)}")
    if got != spec["expect"]:
        failures.append(f"replan: the notice {got} != propose_replan's {spec['expect']}")
    if any(a[0]["kwargs"] != want_kw for a in adopts.values()):
        failures.append(f"replan: adopted_step_kwargs {adopts[0][0]['kwargs']} != {want_kw}")
    # No hooks left behind on the rebuild: one build's, streamed or none.
    for slot, a in adopts.items():
        p = a[0]["n_params"]
        want_hooks = ({"calls": 1, "leaves": p, "hooks": p} if cfg.get("overlap")
                      else {"calls": 0, "leaves": 0, "hooks": 0})
        if a[0]["hooks"] != want_hooks:
            failures.append(f"replan: slot {slot} carries {a[0]['hooks']} after the rebuild, "
                            f"not one build's {want_hooks}")
    figures["hooks_after_rebuild"] = adopts[0][0]["hooks"]
    start = min(at)
    if start >= cfg["steps"]:
        failures.append(f"replan: adopted at step {start}, no step after it")
        return 0
    ref = ep._reference(work, dict(cfg, step_kwargs=want_kw), "adopt", n, timeout,
                        dump=os.path.join(work, "adopt.rank0.pt"))
    compared, worst = 0, 0.0
    for rs in steps_of.values():
        for r in rs:
            if r["step"] <= start:
                continue
            want = ref.get(r["rank"], {}).get(r["step"])
            if want is None or r["loss"] != want:
                failures.append(f"replan: rank {r['rank']} step {r['step']} loss {r['loss']!r} "
                                f"!= reference {want!r}")
            else:
                worst = max(worst, abs(r["loss"] - want))
            compared += 1
    first = min((r["t"] for rs in steps_of.values() for r in rs if r["step"] > start),
                default=None)
    if job.get("published_t") and first:
        # The adoption (the rebuilt step, before rank 0 saves the state the
        # reference resumes) and the end of the first step after it.
        figures["publication_to_adoption_s"] = (
            min(a[0]["t"] for a in adopts.values()) - job["published_t"])
        figures["publication_to_first_adopted_step_s"] = first - job["published_t"]
    return compared


# --- one job under the driver ------------------------------------------------------


def _job_env(spec: dict, work: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_", "TORCHELASTIC_"))}
    env["PYTHONPATH"] = os.pathsep.join([ep.REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    if spec.get("workload") != "replan":
        env.update(ep.REDUCE_ENV)
    env.update(spec.get("env", {}))
    env.update({"OMP_NUM_THREADS": "2", "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "60",
                "HOROVOD_FAULT_EVENT_LOG": os.path.join(work, "events.jsonl"),
                "HOROVOD_METRICS": "1", "HOROVOD_METRICS_PUSH_INTERVAL_S": "0.5"})
    if spec["faults"]:
        env["HOROVOD_FAULT_PLAN"] = json.dumps({"seed": PLAN_SEED, "faults": spec["faults"]},
                                               sort_keys=True)
    if spec.get("mode"):
        env["HOROVOD_ELASTIC_REJOIN_MODE"] = spec["mode"]
    return env


def _scrape(port: int) -> Optional[str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
            return r.read().decode()
    except Exception:  # noqa: BLE001 - the driver is between incarnations
        return None


def _metrics_port(od: str) -> Optional[int]:
    try:
        with open(os.path.join(od, "driver.log")) as f:
            found = re.findall(r"metrics: GET /metrics on port (\d+)", f.read())
    except OSError:
        return None
    return int(found[-1]) if found else None


class _Watch(threading.Thread):
    """While the job runs: rewrite the discovery script's slot count as
    rank 0 progresses (``slots``: (gen, step, slots) marks) and keep the
    driver's last ``GET /metrics`` page."""

    def __init__(self, work: str, od: str, spec: dict, slots_file: str):
        super().__init__(daemon=True)
        self.work, self.od, self.spec, self.slots_file = work, od, spec, slots_file
        self.done = threading.Event()
        self.page: Optional[str] = None
        self.marks = list(spec.get("slots", []))
        self.calibrate_at = spec.get("calibrate_at")
        self.published_t: Optional[float] = None

    def _replan_marks(self) -> None:
        """The replan case: the calibration file appears once rank 0 passed
        ``calibrate_at``; the notice's publication is the first sight of its
        line in the driver's log."""
        if self.calibrate_at is not None:
            try:
                recs = ep._records(self.work).get(0, [])
            except ValueError:  # a line half written
                return
            if any(r.get("step", 0) >= self.calibrate_at for r in recs):
                os.replace(self.spec["calibration_pending"], self.spec["calibration"])
                self.calibrate_at = None
        elif self.published_t is None:
            try:
                with open(os.path.join(self.od, "driver.log")) as f:
                    if "re-plan #1 published" in f.read():
                        self.published_t = time.time()
            except OSError:
                pass

    def run(self) -> None:
        while not self.done.wait(0.25):
            if "calibration" in self.spec:
                self._replan_marks()
            if self.marks:
                try:
                    recs = ep._records(self.work).get(0, [])
                except ValueError:  # a line half written
                    continue
                gen, step, slots = self.marks[0]
                if any(r.get("gen") == gen and r.get("step", 0) >= step for r in recs):
                    with open(self.slots_file, "w") as f:
                        f.write(f"localhost:{slots}\n")
                    self.marks.pop(0)
            port = _metrics_port(self.od)
            if port:
                page = _scrape(port)
                if page and "hvd_elastic_generation" in page:
                    self.page = page


def run_job(case: str, spec: dict, cfg: dict, work: str, timeout: float) -> dict:
    """The case's job through ``python -m horovod_tpu_torch.run``: its exit
    code, seconds, output and the driver's last metrics page."""
    od = os.path.join(work, "od")
    os.makedirs(od, exist_ok=True)
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    slots_file = os.path.join(work, "slots")
    script = os.path.join(work, "discover.sh")
    with open(slots_file, "w") as f:
        f.write(f"localhost:{spec['members'][0]}\n")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {slots_file}\n")
    os.chmod(script, 0o755)
    args = [a.replace("{script}", script) for a in spec["args"]]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", *args, "--output-dir", od,
           sys.executable, "-m", "horovod_tpu_torch.tools.driver_parity", "--worker", cfg_path]
    watch = _Watch(work, od, spec, slots_file)
    watch.start()
    t0 = time.perf_counter()
    log_path = os.path.join(work, "driver.out")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=_job_env(spec, work), cwd=ep.REPO, stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = None
        finally:
            watch.done.set()
            watch.join()
    seconds = time.perf_counter() - t0
    if rc != 0:
        _reap_workers(work)
    with open(log_path, errors="replace") as f:
        text = f.read()
    return {"rc": rc, "seconds": seconds, "log": text, "metrics": watch.page,
            "published_t": watch.published_t}


def _reap_workers(work: str) -> None:
    """Kill any worker of the job still alive (each slot logs its pid) and
    its store host (the journal holds its pid) after a job that did not
    end cleanly."""
    pids = {r["pid"] for recs in ep._records(work).values() for r in recs if "pid" in r}
    try:
        with open(os.path.join(work, "od", "driver_journal.json")) as f:
            pids.add(int(json.load(f)["kv"]["stores.host"]))
    except (OSError, ValueError, KeyError):
        pass
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            if b"driver_parity" not in cmd and b"store_host" not in cmd:
                continue  # its pid now another process's
            os.kill(pid, 9)
        except OSError:
            pass


def _logs(work: str, out: str) -> str:
    parts = [f"--- driver ---\n{out[-4000:]}"]
    od = os.path.join(work, "od")
    for fn in sorted(os.listdir(od)) if os.path.isdir(od) else []:
        if fn.startswith("worker.") and fn.endswith(".err"):
            with open(os.path.join(od, fn), errors="replace") as f:
                parts.append(f"--- {fn} ---\n{f.read()[-1500:]}")
    return "\n".join(parts)


def _events(work: str) -> List[str]:
    """The fault event lines, normalised: each process's own sequence in
    order, the processes sorted (a shared file interleaves them)."""
    path = os.path.join(work, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        evs = [json.loads(l) for l in f]
    evs.sort(key=lambda e: (e["rank"] is not None, e["rank"] or 0, e["seq"]))
    return [json.dumps({k: e[k] for k in ("rank", "site", "hit", "action", "detail")},
                       sort_keys=True) for e in evs]


def run_case(case: str, device: Optional[str], dims: dict, batch: int, seq: int, dtype: str,
             work: str, mode: str, references: bool = True) -> dict:
    """The job of ``case``, its reference runs and the checks; the figures
    with ``ok`` and ``failures``."""
    spec = dict(CASES[case])
    spec["faults"] = [dict(a, after_s=DRIVER_KILL_AFTER_S[mode]) if a["kind"] == "kill_driver"
                      else a for a in spec["faults"]]
    on_card = device != "cpu"
    steps = spec.get("steps", STEPS)
    os.makedirs(work, exist_ok=True)
    if spec.get("workload") == "replan":
        spec.update(replan_inputs(work, dims, seq, spec["members"][0]))
    cfg = {"dims": dims, "batch": batch, "seq": seq, "dtype": dtype, "device": device,
           "steps": steps, "out": work, "workload": spec.get("workload", "binding"),
           "kill": spec.get("kill"),
           "reference_in_worker": spec.get("reference_in_worker"),
           "pause_s": spec.get("pause_s", 0.0), "threshold": None,
           "overlap": bool(spec.get("overlap"))}
    timeout = 600.0 if on_card else 300.0
    exact = dtype == "f32"
    job = run_job(case, spec, cfg, work, timeout)
    failures: List[str] = []
    figures = {"case": case, "job_s": job["seconds"], "rc": job["rc"]}
    if job["rc"] != 0:
        return dict(figures, ok=False, failures=[f"{case}: the job exited {job['rc']}\n"
                                                 + _logs(work, job["log"])])
    recs = ep._records(work)
    log = job["log"]
    sizes = [int(m) for m in re.findall(r"\] generation \d+: size (\d+)", log)]
    figures["generations"] = sizes
    # In respawn mode the worker signals its rejoin before it persists its
    # snapshot and exits, and the driver may answer the signal with one more
    # generation (the JAX driver's behaviour) before it sees the exit.
    extra = case == "respawn" and sizes == spec["members"] + spec["members"][-1:]
    if sizes != spec["members"] and not extra:
        failures.append(f"{case}: generations of sizes {sizes}, not {spec['members']}")
    steps_of = {slot: [r for r in rs if "loss" in r] for slot, rs in recs.items()}
    ends = {slot: [r for r in rs if r.get("event") == "end"] for slot, rs in recs.items()}
    last_gen = max((r["gen"] for rs in steps_of.values() for r in rs), default=0)
    last = {slot for slot, rs in steps_of.items() if any(r["gen"] == last_gen for r in rs)}
    if len(last) != spec["members"][-1] or any(not ends.get(s) for s in last):
        failures.append(f"{case}: the last generation's slots {sorted(last)} did not all end")
        return dict(figures, ok=False, failures=failures + [_logs(work, log)])
    shas = {ends[s][-1]["param_sha"] for s in last}
    digests = {ends[s][-1]["state_digest"] for s in last}
    if len(shas) != 1 or len(digests) != 1:
        failures.append(f"{case}: the last generation's ranks disagree: {shas} {digests}")
    # Every loss after a re-formation against its reference.
    compared, worst = 0, 0.0
    for slot, rs in steps_of.items():
        for r in rs:
            if "reference_loss" in r and r["gen"] > 1:
                worst = max(worst, abs(r["loss"] - r["reference_loss"]))
                if r["loss"] != r["reference_loss"]:
                    failures.append(f"{case}: step {r['step']} (gen {r['gen']}) loss "
                                    f"{r['loss']!r} != uninterrupted {r['reference_loss']!r}")
                compared += 1
    if not spec.get("reference_in_worker") and references:
        for gen in range(2, last_gen + 1):
            if not os.path.exists(os.path.join(work, f"reset.gen{gen}.rank0.pt")):
                failures.append(f"{case}: no state dumped at generation {gen}")
                continue
            size = next(r["size"] for rs in steps_of.values() for r in rs if r["gen"] == gen)
            try:
                ref = ep._reference(work, cfg, gen, size, timeout)
            except Exception as exc:  # noqa: BLE001 - reported as a failure
                failures.append(f"{case}: {exc}")
                continue
            for rs in steps_of.values():
                for r in rs:
                    if r["gen"] != gen:
                        continue
                    want = ref.get(r["rank"], {}).get(r["step"])
                    if want is not None:
                        worst = max(worst, abs(r["loss"] - want))
                    if want is None or not ep._close(r["loss"], want, exact):
                        failures.append(f"{case}: gen {gen} rank {r['rank']} step {r['step']} "
                                        f"loss {r['loss']!r} != reference {want!r}")
                    compared += 1
    if spec.get("workload") == "replan":
        compared += _replan_checks(work, cfg, spec, job, steps_of, recs, spec["members"][0],
                                   timeout, figures, failures)
    figures["losses_compared"], figures["max_loss_diff"] = compared, worst
    if references and compared == 0:
        failures.append(f"{case}: no step after a re-formation was compared")
    if on_card:
        for rs in steps_of.values():
            for r in rs:
                if r["launches"] != [dims["n_layers"], dims["n_layers"]]:
                    failures.append(f"{case}: gen {r['gen']} step {r['step']} B1 launches "
                                    f"{r['launches']}")
    # The first step after generation 1.
    after = min((r["t"] for rs in steps_of.values() for r in rs if r["gen"] > 1), default=None)
    kills = [r["t"] for rs in recs.values() for r in rs if r.get("event") == "kill"]
    if spec.get("kill"):
        if not kills or after is None:
            failures.append(f"{case}: no kill record or no step after generation 1")
        else:
            figures["kill_to_first_step_s"] = after - kills[0]
    # Case-specific checks.
    if case in ("crash", "spare"):
        if f"failed with exit code {KILL_EXIT}" not in log:
            failures.append(f"{case}: the driver did not see the kill")
        replay = [r["step"] for r in steps_of.get(0, []) if r["gen"] == 2]
        if not replay or replay[0] != spec["kill"][1] + 1:
            failures.append(f"{case}: generation 2 starts at step {replay[:1]}, not "
                            f"{spec['kill'][1] + 1}")
    if case == "spare":
        starts = [r for r in recs.get(3, []) if r.get("event") == "start"]
        if not starts or not starts[0]["spare"] or starts[0]["gen"] != 2:
            failures.append(f"{case}: the spare's start {starts}")
        if "promoted spare localhost:3 into generation 2" not in log:
            failures.append(f"{case}: no promotion in the driver's log")
        if not re.search(r"spawned spare localhost:2 ", log):
            failures.append(f"{case}: the dead slot did not come back as the spare")
        promoted = [r["t"] for r in steps_of.get(3, []) if r["gen"] == 2]
        if kills and promoted:
            figures["kill_to_spare_first_step_s"] = promoted[0] - kills[0]
    if case == "discovery":
        if len({r["pid"] for r in recs.get(0, []) if "pid" in r}) != 1:
            failures.append(f"{case}: slot 0 changed process")
        starts3 = [r["gen"] for r in recs.get(3, []) if r.get("event") == "start"]
        if starts3 != [1, 3]:
            failures.append(f"{case}: slot 3 started in generations {starts3}, not [1, 3]")
    if case == "respawn":
        starts = [r for r in recs.get(0, []) if r.get("event") == "start"]
        figures["starts"] = [(r["gen"], r["had_snapshot"]) for r in starts]
        if figures["starts"] != [(1, False), (last_gen, True)]:
            failures.append(f"{case}: the slot's starts {figures['starts']}")
        if "exited requesting respawn" not in log:
            failures.append(f"{case}: the driver did not see the respawn request")
        resumed = [r["step"] for r in steps_of.get(0, []) if r["gen"] == last_gen]
        if not resumed or resumed[0] != spec["kill"][1] + 1:
            failures.append(f"{case}: the respawn resumed at step {resumed[:1]}, not "
                            f"{spec['kill'][1] + 1}")
    if case in ("driver", "driver1"):
        killed = re.findall(r"killing driver \(exit 67\) at unix ([0-9.]+)", log)
        if "driver died abnormally (exit 67)" not in log or not killed:
            failures.append(f"{case}: the driver was not killed and resumed")
        if "resumed at generation 2 (epoch 2)" not in log:
            failures.append(f"{case}: no adoption at generation 2, epoch 2")
        for slot, rs in steps_of.items():
            ss = [r["step"] for r in rs]
            if ss != sorted(set(ss)) or len({r["pid"] for r in rs}) != 1:
                failures.append(f"{case}: slot {slot} repeated a step or changed process")
        if killed and after is not None:
            figures["driver_kill_to_first_step_s"] = after - float(killed[0])
    if spec.get("reference_in_worker"):
        ref = [r for r in recs.get(0, []) if r.get("event") == "reference"]
        if not ref or ref[0]["param_sha"] != ends[0][-1]["param_sha"]:
            failures.append(f"{case}: the final parameters are not the uninterrupted run's")
    page = job["metrics"] or ""
    n = spec["members"][-1]
    missing = [k for k in ("hvd_elastic_generation", "hvd_elastic_world_size") if k not in page]
    missing += [f'rank="{r}"' for r in range(n) if f'rank="{r}"' not in page]
    if missing:
        failures.append(f"{case}: GET /metrics lacks {missing}")
    figures["events"] = _events(work)
    with open(os.path.join(work, "od", "fault_schedule.json")) if spec["faults"] else \
            open(os.devnull) as f:
        figures["fault_schedule"] = f.read()
    figures["step_ms"] = {slot: [round(r["ms"], 3) for r in rs] for slot, rs in steps_of.items()}
    if failures:
        failures.append(_logs(work, log))
    figures["ok"], figures["failures"] = not failures, failures
    return figures


def rehearse(n: int, device: Optional[str], dims: dict, batch: int, seq: int, dtype: str,
             work: str, cases: Optional[List[str]] = None, parallel: bool = False) -> dict:
    """The cases at ``n`` ranks, one after another, or all at once with
    ``parallel`` (they then share the host and the cards)."""
    cases = cases or CARD_CASES[n]
    mode = ("cpu" if device == "cpu" else "card") + str(n)
    out = {"ranks": n, "device": "cpu" if device == "cpu" else "cuda", "dims": dims,
           "batch_per_rank": batch, "seq": seq, "dtype": dtype, "parallel": parallel,
           "cases": {}}
    if device != "cpu":
        import torch

        from .topo_parity import _card

        out["card"] = _card(torch.device("cuda", 0))      # name, power limit

    def one(case):
        out["cases"][case] = run_case(case, device, dims, batch, seq, dtype,
                                      os.path.join(work, case), mode)

    threads = [threading.Thread(target=one, args=(c,)) for c in cases]
    for t in threads:
        t.start()
        if not parallel:
            t.join()
    for t in threads:
        t.join()
    out["cases"] = {c: out["cases"][c] for c in cases}
    if "crash" in cases:
        # The same seed again: the same normalised event lines and schedule.
        again = run_case("crash", device, dims, batch, seq, dtype,
                         os.path.join(work, "crash.again"), mode, references=False)
        first = out["cases"]["crash"]
        same = (again["ok"] and again["events"] == first["events"]
                and again["fault_schedule"] == first["fault_schedule"])
        out["repeat"] = {"ok": same, "events": again["events"], "job_s": again["job_s"],
                         "failures": [] if same else ["crash: a second run of the seed gave "
                                                      f"{again['events']} against "
                                                      f"{first['events']}"] + again["failures"]}
    out["failures"] = [f for c in out["cases"].values() for f in c["failures"]]
    out["failures"] += out.get("repeat", {}).get("failures", [])
    out["ok"] = not out["failures"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="1 or 4 (default 4)")
    ap.add_argument("--smoke", action="store_true",
                    help="gloo ranks on the CPU at a 2-layer d-64 GPT (f32)")
    ap.add_argument("--case", action="append", default=None,
                    help=f"run only these cases (of {sorted(CASES)}; replan and replan-overlap "
                         "run only when named, at 4 ranks)")
    ap.add_argument("--parallel", action="store_true",
                    help="run the cases at once (they share the host and the cards)")
    ap.add_argument("--out", default=None, help="working directory (default: a temporary one)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    n = args.ranks or 4
    if n not in CARD_CASES:
        print(f"driver_parity: --ranks must be one of {sorted(CARD_CASES)}", file=sys.stderr)
        return 2
    if args.smoke:
        device, dims, batch, seq, dtype = "cpu", ep.SMOKE_DIMS, ep.SMOKE_BATCH, ep.SMOKE_SEQ, "f32"
    else:
        import torch

        device, dims, batch, seq, dtype = None, ep.GPT2_SMALL, ep.BATCH, ep.SEQ, "bf16"
        if torch.cuda.device_count() < n:
            print(f"driver_parity: {n} ranks need {n} cards, {torch.cuda.device_count()} "
                  "visible", file=sys.stderr)
            return 2
    work = args.out or tempfile.mkdtemp(prefix="driver_parity_")
    try:
        out = rehearse(n, device, dims, batch, seq, dtype, work, args.case, args.parallel)
    finally:
        if not args.out:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
