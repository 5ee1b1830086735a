"""Elastic state live on the GPT step: a scripted driver and its cases.

    python -m horovod_tpu_torch.tools.elastic_parity --ranks 4      # a card per rank, NCCL
    python -m horovod_tpu_torch.tools.elastic_parity --ranks 1      # one card (chip_smoke [elastic])
    python -m horovod_tpu_torch.tools.elastic_parity --smoke        # gloo ranks on the CPU

The tool stands in for the elastic driver (``run/elastic_driver.py``,
held by ``tools/driver_parity``) with a FIXED script of generations: the
check of the worker's half alone. In its own process it hosts the port's
``KVStoreServer`` and, for each generation, a ``TCPStore`` on a port the
OS picks; it spawns one worker a slot with the elastic environment
(``HOROVOD_ELASTIC=1``, ``HOROVOD_ELASTIC_WORKER_ID``,
``HOROVOD_ELASTIC_KV_ADDR``/``PORT``, ``HOROVOD_ELASTIC_GEN``,
``HOROVOD_ELASTIC_SYNC_ROOT``, ``HOROVOD_DRIVER_EPOCH``), publishes
``elastic/world`` (ranks, ``master_addr``/``master_port``, ``sync_root``)
and ``elastic/driver``, writes ``promote.<wid>`` for a spare, and answers
a worker's ``rejoin.<wid>`` (or its exit, or a progress mark) by
publishing the next generation on its list. No discovery, no blacklist,
no autoscaling.

Each worker runs a GPT step under ``@elastic.run`` with
``TorchState(model, optimizer, step=...)`` and a commit every step:
GPT-2-small at 8 x 1024 a rank, bf16, AdamW 3e-4 (weight decay 1e-4) on the
cards; a 2-layer d-64 GPT at 2 x 32 in f32 with ``--smoke``. The batch of a
step is drawn from (seed, step, rank, size). Faults come from
``HOROVOD_FAULT_PLAN``. The cases (:data:`CASES`):

- ``crash``: 4 ranks, rank 3 killed inside step 3's commit (at its fault
  point, before its save); the survivors, whose commit 3 fails in its
  agreement, roll back to it, re-form at 3 in process and go on;
- ``preempt``: 4 ranks, rank 3 preempted at commit 3; the state is kept
  (no step repeats), rank 3 drains and leaves, the rest re-form at 3;
- ``respawn``: ``HOROVOD_ELASTIC_REJOIN_MODE=respawn``; rank 3 killed, the
  others persist their commit and exit 79; the driver respawns every slot
  and they resume from the persisted snapshots;
- ``spare``: 3 ranks and a spare (``HOROVOD_ELASTIC_SPARE=1``, on the
  fourth card); rank 2 killed, the spare is promoted into generation 2 at
  size 3 and receives the sync root's state;
- ``zero1``: the DP step (``make_train_step``) with ``zero1=True`` at 4
  ranks; the driver publishes a 2-rank world after step 2; the rows are
  gathered over the old world, resharded and kept by the new ranks (each
  checks that its rows are the reshard of the gathered ones);
- ``one`` (``--ranks 1``): the hook-driven binding at one rank through two
  re-formations: a ``preempt`` at commit 2 (state kept, no rollback), then
  a ``nan`` at ``payload`` in step 4 under ``HOROVOD_GUARD_NONFINITE=abort``
  (``HorovodInternalError`` out of ``backward()``: rollback to commit 3);
  the worker first runs the same steps uninterrupted and every later loss
  must equal them bitwise; the committed snapshot must be on the card.

Checks: the last generation's ranks agree on their parameters bitwise
(and on their state digests); every step after a re-formation gives the
loss, bitwise in f32 (within bf16's rounding on the card), of a reference
run at the new size started from the state the sync root held right after
the re-formation, with the same batches; on the card, 12 forward and 12
backward B1 launches a step in every generation. Times: the commit's cost
on the step (with and without a commit in turns), each re-formation (the
interrupt or failure caught to the first step of the next generation) and,
for a kill, the kill to the first step of the next generation. Prints one
JSON line; exits nonzero on any failed check.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
SMOKE_DIMS = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2)
BATCH, SEQ = 8, 1024
SMOKE_BATCH, SMOKE_SEQ = 2, 32
LR, WEIGHT_DECAY, EPS = 3e-4, 1e-4, 1e-8
PLAN_SEED = 20261018
KILL_EXIT = 43
STEPS = 6
# The nan's target: the first block's MLP-up bias (its gradient's name).
NAN_TENSOR = "DistributedOptimizer.block_0.mlp.up.bias"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The binding's eager allreduces fuse by timing, and the sum order of a
# fused buffer's element depends on the buffer (gloo's and NCCL's
# algorithms chunk by size): each gradient reduces alone in the job and in
# its reference, so the two sum alike.
REDUCE_ENV = {"HOROVOD_FUSION_THRESHOLD": "0"}

# slots: the worker slots spawned at the start; spares: slots spawned as
# spares; gens: each generation's members (slots, rank order); faults: the
# plan's actions; trigger: what makes the driver publish the next
# generation ("signal": a rejoin signal or a worker's exit; "respawn": every
# worker of the generation exited; "progress": rank 0 committed the step).
CASES = {
    "crash": dict(slots=[0, 1, 2, 3], gens=[[0, 1, 2, 3], [0, 1, 2]], trigger="signal",
                  faults=[{"kind": "kill", "site": "step", "rank": 3, "gen": 1, "at_step": 3,
                           "exit_code": KILL_EXIT}], kill=(3, 3)),
    "preempt": dict(slots=[0, 1, 2, 3], gens=[[0, 1, 2, 3], [0, 1, 2]], trigger="signal",
                    faults=[{"kind": "preempt", "site": "step", "rank": 3, "gen": 1,
                             "at_step": 3}]),
    "respawn": dict(slots=[0, 1, 2, 3], gens=[[0, 1, 2, 3], [0, 1, 2, 3]], trigger="respawn",
                    mode="respawn",
                    faults=[{"kind": "kill", "site": "step", "rank": 3, "gen": 1, "at_step": 3,
                             "exit_code": KILL_EXIT}], kill=(3, 3)),
    "spare": dict(slots=[0, 1, 2], spares=[3], gens=[[0, 1, 2], [0, 1, 3]], trigger="signal",
                  faults=[{"kind": "kill", "site": "step", "rank": 2, "gen": 1, "at_step": 3,
                           "exit_code": KILL_EXIT}], kill=(2, 3)),
    "zero1": dict(slots=[0, 1, 2, 3], gens=[[0, 1, 2, 3], [0, 1]], trigger="progress",
                  progress=2, workload="zero1", faults=[]),
    "one": dict(slots=[0], gens=[[0], [0], [0]], trigger="signal", steps=7,
                guard="abort", reference_in_worker=True,
                faults=[{"kind": "preempt", "site": "step", "rank": 0, "at_step": 2},
                        {"kind": "nan", "site": "payload", "rank": 0, "tensor": NAN_TENSOR,
                         "at_step": 4}]),
}
CARD_CASES = {1: ["one"], 4: ["crash", "preempt", "respawn", "spare", "zero1"]}


def batch_for(dims: dict, batch: int, seq: int, step: int, rank: int, size: int):
    """The (tokens, labels) of ``rank`` at ``step`` in a world of ``size``."""
    import numpy as np

    rng = np.random.RandomState((PLAN_SEED + 7919 * step + 104729 * size + rank) % (2 ** 31))
    return (rng.randint(0, dims["vocab_size"], (batch, seq)),
            rng.randint(0, dims["vocab_size"], (batch, seq)))


# --- the worker ----------------------------------------------------------------


class _Job:
    """One worker's model, optimizer and step: the binding, the DP step with
    ZeRO-1, or (workload ``replan``) the DP step, post hoc or with
    ``cfg["overlap"]`` streamed, built with ``cfg["step_kwargs"]`` and
    rebuilt by :meth:`rebuild` when a live re-plan is adopted."""

    def __init__(self, cfg: dict):
        import torch

        import horovod_tpu_torch as hvd
        import horovod_tpu_torch.torch as bhvd
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

        self.cfg = cfg
        self.dims, self.batch, self.seq = cfg["dims"], cfg["batch"], cfg["seq"]
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["dtype"]]
        self.dev = basics.device()
        self.model = TransformerLM(**self.dims, max_len=self.seq, dtype=dtype, device=self.dev,
                                   seed=0)
        inner = torch.optim.AdamW(self.model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY,
                                  eps=EPS)
        self.zero1 = cfg.get("workload") == "zero1"
        self.step_fn = None
        self.lm_loss = lm_loss
        if cfg.get("workload") == "replan":
            self.opt = inner
            self.rebuild(cfg.get("step_kwargs") or {})
        elif self.zero1:
            self.opt = hvd.DistributedOptimizer(
                inner, named_parameters=self.model.named_parameters(), zero1=True,
                fusion_threshold_bytes=cfg.get("threshold"))
            self.step_fn = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), self.opt)
        else:
            self.opt = bhvd.DistributedOptimizer(
                inner, named_parameters=self.model.named_parameters())

    def rebuild(self, step_kwargs: dict) -> None:
        """The DP step over the same inner optimizer, with ``step_kwargs``
        by hand; the step it replaces is closed first, so the parameters
        carry one build's hooks (:meth:`hooks`)."""
        import horovod_tpu_torch as hvd

        if self.step_fn is not None:
            self.step_fn.close()
        self.step_kwargs = dict(step_kwargs)
        self.step_fn = hvd.make_train_step(lambda m, b: self.lm_loss(m(b[0]), b[1]), self.opt,
                                           tuned=False, overlap=bool(self.cfg.get("overlap")),
                                           **self.step_kwargs)

    def hooks(self) -> dict:
        """The streamed registrations and hooks on the model's parameters
        (``ops/fusion.stream_registrations``)."""
        from horovod_tpu_torch.ops.fusion import stream_registrations

        return stream_registrations(self.model.parameters())

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def one_step(self, s: int) -> float:
        import torch

        from horovod_tpu_torch.common import basics

        tokens, labels = (torch.from_numpy(a).to(self.dev) for a in batch_for(
            self.dims, self.batch, self.seq, s, basics.rank(), basics.size()))
        if self.step_fn is not None:
            return float(self.step_fn(self.model, (tokens, labels)))
        self.opt.zero_grad()
        loss = self.lm_loss(self.model(tokens), labels)
        loss.backward()
        self.opt.step()
        return float(loss)


def _emit(path: str, rec: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")


def _param_sha(model) -> str:
    from horovod_tpu_torch.guard.digest import tree_digest

    return tree_digest(dict(model.state_dict()))


def _dump_state(job: _Job, state, path: str) -> None:
    """The state a reference run starts from: the model, the optimizer
    (its ZeRO-1 rows for the DP step), the step; CPU tensors."""
    import torch

    from horovod_tpu_torch.elastic import _Zero1Snapshot, _to_host

    doc = {"model": _to_host(job.model.state_dict()), "step": state.step}
    if job.zero1:
        doc["zero1"] = _to_host(_Zero1Snapshot.of(job.opt.zero1_state))
    else:
        doc["opt"] = _to_host(job.opt.state_dict())
    torch.save(doc, path)


def _load_state(job: _Job, path: str) -> int:
    import torch

    doc = torch.load(path, map_location="cpu", weights_only=False)
    job.model.load_state_dict(doc["model"])
    if job.zero1:
        doc["zero1"].write(job.opt.zero1_state)
    else:
        job.opt.load_state_dict(doc["opt"])
    return int(doc["step"])


def worker(cfg_path: str) -> int:
    """One slot of the elastic job (``--worker``)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.fault import injector
    from horovod_tpu_torch.guard import digest
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import reshard

    with open(cfg_path) as f:
        cfg = json.load(f)
    wid = os.environ["HOROVOD_ELASTIC_WORKER_ID"]
    out = os.path.join(cfg["out"], f"slot.{wid.rsplit(':', 1)[1]}.jsonl")
    had_snapshot = bool(elastic._persist_path() and os.path.exists(elastic._persist_path()))
    spawned_gen = int(os.environ.get("HOROVOD_ELASTIC_GEN", "1"))
    hvd.init(device=cfg["device"])
    job = _Job(cfg)
    steps = cfg["steps"]
    _emit(out, {"event": "start", "gen": spawned_gen, "rank": hvd.rank(), "size": hvd.size(),
                "had_snapshot": had_snapshot, "spare": cfg.get("spare_slot") == wid,
                "card": torch.cuda.get_device_name(job.dev) if job.dev.type == "cuda" else "cpu"})
    reference: Dict[int, float] = {}
    if cfg.get("reference_in_worker"):
        # The uninterrupted run: the same steps, no plan, no commits; then
        # back to the seed's weights and a fresh optimizer state.
        plan = injector.active_plan()
        injector.install_plan(None)
        init_model = {k: v.detach().clone() for k, v in job.model.state_dict().items()}
        init_opt = job.opt.state_dict()
        for s in range(1, steps + 1):
            reference[s] = job.one_step(s)
        job.model.load_state_dict(init_model)
        job.opt.load_state_dict(init_opt)
        injector.install_plan(plan)
        _emit(out, {"event": "reference", "losses": reference})
    state = elastic.TorchState(job.model, job.opt, step=0)
    if job.zero1:
        elastic.note_zero1_layout(state, "optimizer", reshard.zero1_layout_from_params(
            job.opt._tree, hvd.size(), threshold_bytes=job.opt._threshold,
            first_bucket_bytes=job.opt._first_bucket))

    def on_reset():
        rec = {"event": "reset", "gen": int(os.environ["HOROVOD_ELASTIC_GEN"]),
               "rank": hvd.rank(), "size": hvd.size(), "step": state.step,
               "t": time.time(), "reformation": dict(state.reformations[-1])}
        if job.zero1:
            # The rows this rank now holds are the reshard of the rows
            # gathered over the old world, bitwise.
            gathered = state.zero1_gathered.get("optimizer")
            mine = reshard.gather_zero1_state(job.opt.zero1_state)
            want, _ = reshard.reshard_zero1_state(gathered, hvd.size(),
                                                  layout=state.zero1_layout["optimizer"]
                                                  .relayout(gathered.n_shards))
            rec["zero1_rows_equal"] = all(
                torch.equal(a.cpu(), b.cpu()) for a, b in zip(
                    digest.tree_leaves([want.state, want.ef]),
                    digest.tree_leaves([mine.state, mine.ef])))
            rec["zero1_n"] = [gathered.n_shards, mine.n_shards]
        if job.zero1 or hvd.rank() == 0:
            # The reference's start: the sync root's state (each rank's
            # own rows under ZeRO-1).
            _dump_state(job, state, os.path.join(
                cfg["out"], f"reset.gen{rec['gen']}.rank{hvd.rank()}.pt"))
        _emit(out, rec)

    state.register_reset_callbacks([on_reset])
    kill = cfg.get("kill")

    @elastic.run
    def train(state):
        while state.step < steps:
            s = state.step + 1
            counts = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
            job.sync()
            t0 = time.perf_counter()
            loss = job.one_step(s)
            job.sync()
            ms = (time.perf_counter() - t0) * 1e3
            rec = {"rank": hvd.rank(), "size": hvd.size(), "step": s, "loss": loss, "ms": ms,
                   "gen": int(os.environ.get("HOROVOD_ELASTIC_GEN", "1")), "t": time.time(),
                   "launches": [fa.FWD_LAUNCHES - counts[0], fa.BWD_LAUNCHES - counts[1]]}
            if s in reference:
                rec["reference_loss"] = reference[s]
            _emit(out, rec)
            state.step = s
            if kill and hvd.rank() == kill[0] and s == kill[1] and rec["gen"] == 1:
                _emit(out, {"event": "kill", "t": time.time()})
            if cfg.get("progress") and hvd.rank() == 0:
                elastic._ctx()._kv.put("elastic", "progress", str(s).encode())
            state.commit()
        return state.step

    train(state)
    rec = {"event": "end", "rank": hvd.rank(), "size": hvd.size(),
           "gen": int(os.environ["HOROVOD_ELASTIC_GEN"]), "param_sha": _param_sha(job.model),
           "state_digest": digest.state_digest(state),
           "snapshot_device": str(next(iter(state._saved_model.values())).device)}
    if cfg.get("commit_ab"):
        # The commit's cost: the step with a commit after it against the step
        # alone, in turns (off, on, on, off).
        on_ms, off_ms, commit_ms = [], [], []
        s = steps
        for _ in range(cfg["commit_ab"]):
            for with_commit in (False, True, True, False):
                s += 1
                job.sync()
                t0 = time.perf_counter()
                job.one_step(s)
                if with_commit:
                    t1 = time.perf_counter()
                    state.commit()
                    job.sync()
                    commit_ms.append((time.perf_counter() - t1) * 1e3)
                job.sync()
                (on_ms if with_commit else off_ms).append((time.perf_counter() - t0) * 1e3)
        rec.update(commit_on_ms=on_ms, commit_off_ms=off_ms, commit_ms=commit_ms)
    _emit(out, rec)
    hvd.shutdown()
    return 0


def reference_worker(cfg_path: str) -> int:
    """A plain (not elastic) rank of the reference run (``--reference``):
    the state a sync root dumped right after a re-formation, then the same
    steps at the new size."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.tools.launch import store_url

    with open(cfg_path) as f:
        cfg = json.load(f)
    hvd.init(device=cfg["device"], init_method=store_url() if cfg["ref_size"] > 1 else None)
    job = _Job(cfg)
    start = _load_state(job, cfg["dump"].format(rank=hvd.rank()))
    for s in range(start + 1, cfg["steps"] + 1):
        _emit(os.path.join(cfg["out"], f"ref.{hvd.rank()}.jsonl"),
              {"rank": hvd.rank(), "step": s, "loss": job.one_step(s)})
    hvd.shutdown()
    return 0


# --- the scripted driver -----------------------------------------------------


class ScriptedDriver:
    """The fixed list of generations of one case (the module docstring)."""

    def __init__(self, case: str, spec: dict, cfg: dict, work: str, env_extra: dict,
                 timeout: float):
        from horovod_tpu_torch.run.http_server import KVStoreServer

        self.case, self.spec, self.cfg, self.work = case, spec, cfg, work
        self.env_extra, self.timeout = env_extra, timeout
        self.kv = KVStoreServer(port=0)
        self.kv_port = self.kv.start()
        self.stores = []
        self.procs: Dict[int, subprocess.Popen] = {}
        self.exits: Dict[int, List[int]] = {}
        self.gen = 0
        self.epoch = 1
        self.host_slots = len(spec["slots"]) + len(spec.get("spares", []))
        self.published: List[dict] = []
        self.cfg_path = os.path.join(work, "cfg.json")
        with open(self.cfg_path, "w") as f:
            json.dump(cfg, f)

    def _world(self, gen: int) -> dict:
        from horovod_tpu_torch.run.launcher import host_store

        members = self.spec["gens"][gen - 1]
        store = host_store("127.0.0.1")
        self.stores.append(store)
        prev = self.spec["gens"][gen - 2] if gen > 1 else members
        survivors = [m for m in members if m in prev]
        return {"gen": gen, "size": len(members), "epoch": self.epoch,
                "sync_root": members.index(survivors[0]) if survivors else 0,
                "master_addr": "127.0.0.1", "master_port": store.port,
                "controller_addr": "", "controller_port": 0,
                # A slot keeps its card: local rank = slot, over every slot
                # of the host (the spares' too).
                "assignments": {f"localhost:{m}": {
                    "rank": r, "local_rank": m, "local_size": self.host_slots, "cross_rank": 0,
                    "cross_size": 1} for r, m in enumerate(members)}}

    def publish(self) -> dict:
        self.gen += 1
        world = self._world(self.gen)
        self.kv.put("elastic", "world", json.dumps(world).encode())
        self.kv.put("elastic", "driver", json.dumps({"epoch": self.epoch,
                                                      "gen": self.gen}).encode())
        world["t"] = time.time()
        self.published.append(world)
        for m in self.spec["gens"][self.gen - 1]:
            if m in self.spec.get("spares", []) and m not in self.spec["gens"][0]:
                self.kv.put("elastic", f"promote.localhost:{m}", str(self.gen).encode())
        return world

    def spawn(self, slot: int, world: Optional[dict], spare: bool = False) -> None:
        from horovod_tpu_torch.elastic import _world_env

        env = dict(os.environ)
        for k in ("HOROVOD_FAULT_PLAN", "HOROVOD_FAULT_EVENT_LOG", "HOROVOD_RANK",
                  "HOROVOD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        env.update({"HOROVOD_ELASTIC": "1", "HOROVOD_ELASTIC_WORKER_ID": f"localhost:{slot}",
                    "HOROVOD_ELASTIC_KV_ADDR": "127.0.0.1",
                    "HOROVOD_ELASTIC_KV_PORT": str(self.kv_port),
                    "HOROVOD_DRIVER_EPOCH": str(self.epoch),
                    "HOROVOD_ELASTIC_TIMEOUT": str(int(self.timeout)),
                    "HOROVOD_ELASTIC_STATE_DIR": os.path.join(self.work, "state"),
                    "OMP_NUM_THREADS": "2"})
        env.update(self.env_extra)
        if spare:
            env["HOROVOD_ELASTIC_SPARE"] = "1"
            env["HOROVOD_LOCAL_RANK"] = str(slot)
        else:
            env.update(_world_env(world, world["assignments"][f"localhost:{slot}"]))
            env["HOROVOD_ELASTIC_SYNC_ROOT"] = str(world["sync_root"])
        log = open(os.path.join(self.work, f"log.{slot}.{len(self.exits.get(slot, []))}"), "w")
        self.procs[slot] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.tools.elastic_parity", "--worker",
             self.cfg_path], env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)

    def run(self) -> dict:
        t0 = time.perf_counter()
        world = self.publish()
        for slot in self.spec["slots"]:
            self.spawn(slot, world)
        for slot in self.spec.get("spares", []):
            self.spawn(slot, None, spare=True)
        deadline = time.monotonic() + self.timeout
        try:
            while time.monotonic() < deadline:
                for slot, p in list(self.procs.items()):
                    rc = p.poll()
                    if rc is not None:
                        self.exits.setdefault(slot, []).append(rc)
                        del self.procs[slot]
                if not self.procs and (self.spec["trigger"] != "respawn"
                                       or self.gen == len(self.spec["gens"])):
                    break
                if self.gen < len(self.spec["gens"]) and self._triggered():
                    world = self.publish()
                    if self.spec["trigger"] == "respawn":
                        for slot in world["assignments"]:
                            self.spawn(int(slot.rsplit(":", 1)[1]), world)
                time.sleep(0.02)
            else:
                raise TimeoutError(f"{self.case}: the job did not end in {self.timeout:.0f} s")
        finally:
            for p in self.procs.values():
                p.kill()
                p.wait()
            self.kv.stop()
        return {"seconds": time.perf_counter() - t0, "exits": self.exits,
                "published": self.published}

    def _triggered(self) -> bool:
        trig = self.spec["trigger"]
        signals = self.kv.snapshot("elastic")
        if trig == "progress":
            return int(signals.get("progress", b"0")) >= self.spec["progress"]
        if trig == "respawn":
            return not self.procs
        return (any(k.startswith("rejoin.") and int(v) == self.gen for k, v in signals.items())
                or any(rc != 0 for codes in self.exits.values() for rc in codes[-1:]))


# --- one case: the job, the reference run, the checks --------------------------


def _records(work: str) -> Dict[int, list]:
    out = {}
    for fn in sorted(os.listdir(work)):
        if fn.startswith("slot.") and fn.endswith(".jsonl"):
            with open(os.path.join(work, fn)) as f:
                out[int(fn.split(".")[1])] = [json.loads(l) for l in f]
    return out


def _logs(work: str) -> str:
    parts = []
    for fn in sorted(os.listdir(work)):
        if fn.startswith("log."):
            with open(os.path.join(work, fn), errors="replace") as f:
                parts.append(f"--- {fn} ---\n{f.read()[-1500:]}")
    return "\n".join(parts)


def _reference(work: str, cfg: dict, gen, size: int, timeout: float,
               dump: Optional[str] = None) -> Dict[int, dict]:
    """The plain job at ``size`` from the sync root's post-re-formation
    state (the ZeRO-1 rows from each rank's own dump), or from ``dump``:
    ``{rank: {step: loss}}``."""
    ref_dir = os.path.join(work, f"ref{gen}")
    os.makedirs(ref_dir, exist_ok=True)
    dump = dump or os.path.join(work, f"reset.gen{gen}.rank" + (
        "{rank}" if cfg.get("workload") == "zero1" else "0") + ".pt")
    rcfg = dict(cfg, out=ref_dir, dump=dump, ref_size=size)
    path = os.path.join(ref_dir, "cfg.json")
    with open(path, "w") as f:
        json.dump(rcfg, f)
    env = dict(os.environ)
    for k in [k for k in env if k.startswith(("HOROVOD_ELASTIC", "HOROVOD_FAULT", "MASTER_"))]:
        env.pop(k)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "2"
    env.update(REDUCE_ENV)
    store = tempfile.mkdtemp(prefix="elastic_ref_")
    procs = []
    try:
        for r in range(size):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.tools.elastic_parity", "--reference",
                 path], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(size),
                         HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(size),
                         HVD_TORCH_STORE_DIR=store)))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(store, ignore_errors=True)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"reference run at {size}: " + "\n".join(o[-1500:] for o in outs))
    out = {}
    for r in range(size):
        with open(os.path.join(ref_dir, f"ref.{r}.jsonl")) as f:
            out[r] = {int(x["step"]): x["loss"] for x in map(json.loads, f)}
    return out


def _close(a: float, b: float, exact: bool) -> bool:
    return a == b if exact else abs(a - b) <= 1e-2 * max(1.0, abs(b))


def run_case(case: str, n_ranks: int, device: Optional[str], dims: dict, batch: int, seq: int,
             dtype: str, work: str, commit_ab: int = 0, quick: bool = False) -> dict:
    """The job of ``case``, its reference runs and the checks; the figures
    with ``ok`` and ``failures``."""
    spec = CASES[case]
    on_card = device != "cpu"
    steps = spec.get("steps", STEPS)
    os.makedirs(work, exist_ok=True)
    cfg = {"dims": dims, "batch": batch, "seq": seq, "dtype": dtype, "device": device,
           "steps": steps, "out": work, "workload": spec.get("workload", "binding"),
           "kill": spec.get("kill"), "reference_in_worker": spec.get("reference_in_worker"),
           "progress": spec.get("progress"), "commit_ab": commit_ab,
           "threshold": None if on_card else 1 << 14,
           "spare_slot": f"localhost:{spec['spares'][0]}" if spec.get("spares") else None}
    plan = json.dumps({"seed": PLAN_SEED, "faults": spec["faults"]}, sort_keys=True)
    env = {"HOROVOD_FAULT_PLAN": plan} if spec["faults"] else {}
    env["HOROVOD_FAULT_EVENT_LOG"] = os.path.join(work, "events.jsonl")
    # The group's timeout: a killed peer surfaces at once (its sockets
    # close); this bounds a peer that hangs, and the rendezvous of ranks
    # that start unevenly on a loaded host.
    env["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = "60"
    env.update(REDUCE_ENV)
    if spec.get("mode"):
        env["HOROVOD_ELASTIC_REJOIN_MODE"] = spec["mode"]
    if spec.get("guard"):
        env["HOROVOD_GUARD_NONFINITE"] = spec["guard"]
    timeout = 900.0 if on_card else 240.0
    # Bitwise in f32, and where the reference is the same worker's own
    # uninterrupted run (the same kernels on the same inputs).
    exact = dtype == "f32" or bool(spec.get("reference_in_worker"))
    failures: List[str] = []
    driver = ScriptedDriver(case, spec, cfg, work, env, timeout)
    try:
        job = driver.run()
    except TimeoutError as exc:
        return {"case": case, "ok": False, "failures": [f"{exc}\n{_logs(work)}"]}
    recs = _records(work)
    ends = {slot: [r for r in rs if r.get("event") == "end"] for slot, rs in recs.items()}
    last_members = spec["gens"][-1]
    for slot in last_members:
        if not ends.get(slot):
            failures.append(f"{case}: slot {slot} of the last generation did not end: "
                            f"exits {job['exits']}\n{_logs(work)}")
    if failures:
        return {"case": case, "ok": False, "failures": failures}
    shas = {ends[s][-1]["param_sha"] for s in last_members}
    digests = {ends[s][-1]["state_digest"] for s in last_members}
    if len(shas) != 1 or len(digests) != 1:
        failures.append(f"{case}: the last generation's ranks disagree: {shas} {digests}")
    steps_of = {slot: [r for r in rs if "step" in r and "loss" in r] for slot, rs in recs.items()}
    resets = {slot: [r for r in rs if r.get("event") == "reset"] for slot, rs in recs.items()}
    figures = {"case": case, "job_s": job["seconds"], "exits": job["exits"],
               "gens": [w["size"] for w in job["published"]]}
    # The reference runs: one a re-formation, from the sync root's dump.
    n_gens = len(spec["gens"])
    compared, worst = 0, 0.0
    for gen in range(2, n_gens + 1):
        size = len(spec["gens"][gen - 1])
        if spec.get("reference_in_worker"):
            continue
        if spec.get("mode") == "respawn" or (quick and case != "crash"):
            continue
        try:
            ref = _reference(work, cfg, gen, size, timeout)
        except Exception as exc:  # noqa: BLE001 - reported as a failure
            failures.append(f"{case}: {exc}")
            continue
        for slot in spec["gens"][gen - 1]:
            for r in steps_of.get(slot, []):
                if r["gen"] != gen:
                    continue
                want = ref.get(r["rank"], {}).get(r["step"])
                if want is not None:
                    worst = max(worst, abs(r["loss"] - want))
                if want is None or not _close(r["loss"], want, exact):
                    failures.append(f"{case}: gen {gen} rank {r['rank']} step {r['step']} loss "
                                    f"{r['loss']!r} != reference {want!r}")
                compared += 1
    for slot, rs in steps_of.items():
        for r in rs:
            if "reference_loss" in r and r["gen"] > 1:
                worst = max(worst, abs(r["loss"] - r["reference_loss"]))
                if not _close(r["loss"], r["reference_loss"], exact):
                    failures.append(f"{case}: step {r['step']} (gen {r['gen']}) loss "
                                    f"{r['loss']!r} != uninterrupted {r['reference_loss']!r}")
                compared += 1
            if on_card and r["launches"] != [dims["n_layers"], dims["n_layers"]]:
                failures.append(f"{case}: gen {r['gen']} step {r['step']} B1 launches "
                                f"{r['launches']}")
    figures["losses_compared"] = compared
    figures["max_loss_diff"] = worst
    if compared == 0 and case != "respawn" and not (quick and case != "crash"):
        failures.append(f"{case}: no step after a re-formation was compared")
    # Each re-formation: caught to the first step of the next generation.
    reform = []
    for slot, rs in resets.items():
        for r in rs:
            first = next((x for x in steps_of[slot] if x["gen"] == r["gen"]), None)
            ref_t = r["reformation"]
            reform.append({"slot": slot, "gen": r["gen"], "kind": ref_t["kind"],
                           "caught_to_rejoined_s": ref_t["rejoined_t"] - ref_t["caught_t"],
                           "caught_to_first_step_s": (first["t"] - ref_t["caught_t"]) if first
                           else None, "step_after": r["step"]})
    figures["reformations"] = reform
    kill = spec.get("kill")
    if kill:
        killed = [r for rs in recs.values() for r in rs if r.get("event") == "kill"]
        firsts = [x["t"] for rs in steps_of.values() for x in rs if x["gen"] == 2]
        if killed and firsts:
            figures["kill_to_first_step_s"] = min(firsts) - killed[0]["t"]
            caught = [x["reformation"]["caught_t"] for rs in resets.values() for x in rs
                      if x["gen"] == 2]
            if caught:
                figures["kill_to_exception_s"] = max(caught) - killed[0]["t"]
        elif case != "respawn":
            failures.append(f"{case}: no kill record or no step in generation 2")
    # Case-specific checks.
    kinds = sorted({x["kind"] for x in reform})
    if case == "crash" and kinds != ["rollback"]:
        failures.append(f"{case}: re-formation kinds {kinds}")
    if case == "crash":
        # The kill fires at commit kill[1]'s fault point: the survivors
        # commit that step, fail in its agreement, and roll back to it.
        replay = [x["step"] for x in steps_of[0] if x["gen"] == 2]
        if not replay or replay[0] != kill[1] + 1:
            failures.append(f"{case}: generation 2 starts at step {replay[:1]}, not the step "
                            f"after the commit rolled back to ({kill[1] + 1})")
    if case in ("preempt", "zero1"):
        for slot in last_members:
            ss = [x["step"] for x in steps_of[slot]]
            if len(ss) != len(set(ss)):
                failures.append(f"{case}: slot {slot} repeated a step ({ss}): the state was "
                                f"not kept")
    if case == "preempt":
        if job["exits"].get(3) != [0]:
            failures.append(f"{case}: the preempted slot exited {job['exits'].get(3)}")
        if kinds != ["hosts", "preempt"] and kinds != ["hosts"]:
            failures.append(f"{case}: re-formation kinds {kinds}")
    if case == "respawn":
        starts = {slot: [r for r in rs if r.get("event") == "start"] for slot, rs in recs.items()}
        gen2 = {slot: s[-1] for slot, s in starts.items() if s and s[-1]["gen"] == 2}
        figures["respawned_with_snapshot"] = sorted(s for s, r in gen2.items()
                                                    if r["had_snapshot"])
        if sorted(gen2) != [0, 1, 2, 3] or figures["respawned_with_snapshot"] != [0, 1, 2]:
            failures.append(f"{case}: generation 2's starts {gen2}")
        exits1 = {slot: codes[0] for slot, codes in job["exits"].items()}
        if exits1 != {0: 79, 1: 79, 2: 79, 3: KILL_EXIT}:
            failures.append(f"{case}: generation 1 exits {exits1}")
        resumed = [x["step"] for x in steps_of[0] if x["gen"] == 2]
        if not resumed or resumed[0] != kill[1] + 1:
            failures.append(f"{case}: the respawned slot resumed at step {resumed[:1]}, not "
                            f"{kill[1] + 1} (its snapshot's commit + 1)")
        # Every respawned slot agrees, and the steps after the resume agree
        # across the slots' ranks with the uninterrupted 4-rank history
        # up to the commit.
        before = {(x["rank"], x["step"]): x["loss"] for x in steps_of[0] + steps_of[1]
                  + steps_of[2] if x["gen"] == 1}
        for slot in (0, 1, 2):
            for x in steps_of[slot]:
                if x["gen"] == 2 and (x["rank"], x["step"]) in before and x["step"] <= kill[1]:
                    failures.append(f"{case}: step {x['step']} ran again after the resume")
        compared = 1
    if case == "spare":
        promoted = [r for r in recs.get(3, []) if r.get("event") == "start"]
        if not promoted or not promoted[0]["spare"] or promoted[0]["gen"] != 1:
            failures.append(f"{case}: the spare's start {promoted}")
        if not any(x["gen"] == 2 for x in steps_of.get(3, [])):
            failures.append(f"{case}: the spare took no step in generation 2")
    if case == "zero1":
        rows = [r.get("zero1_rows_equal") for rs in resets.values() for r in rs]
        figures["zero1_rows_equal"] = rows
        figures["zero1_n"] = [r.get("zero1_n") for rs in resets.values() for r in rs]
        if not rows or not all(rows):
            failures.append(f"{case}: the kept rows are not the reshard of the gathered: {rows}")
    if case == "one":
        if kinds != ["preempt", "rollback"]:
            failures.append(f"{case}: re-formation kinds {kinds}")
        end = ends[0][-1]
        figures["snapshot_device"] = end["snapshot_device"]
        if on_card and not end["snapshot_device"].startswith("cuda"):
            failures.append(f"{case}: the committed snapshot is on {end['snapshot_device']}")
        if commit_ab:
            figures["commit_on_ms"] = end["commit_on_ms"]
            figures["commit_off_ms"] = end["commit_off_ms"]
            figures["commit_ms"] = end["commit_ms"]
            figures["commit_cost_ms"] = (statistics.median(end["commit_on_ms"])
                                         - statistics.median(end["commit_off_ms"]))
    events = []
    if os.path.exists(env["HOROVOD_FAULT_EVENT_LOG"]):
        with open(env["HOROVOD_FAULT_EVENT_LOG"]) as f:
            events = [json.loads(l) for l in f]
    figures["events"] = [f"{e['rank']}:{e['site']}/{e['action']}" for e in events]
    fired = [e for e in events if e["site"] in ("step", "payload")]
    if len(fired) != len(spec["faults"]):
        failures.append(f"{case}: {len(fired)} faults fired, not {len(spec['faults'])}: "
                        f"{figures['events']}")
    figures["step_ms"] = {slot: [round(x["ms"], 3) for x in rs] for slot, rs in steps_of.items()}
    if failures:
        failures.append(_logs(work))
    figures["ok"], figures["failures"] = not failures, failures
    return figures


def rehearse(n: int, device: Optional[str], dims: dict, batch: int, seq: int, dtype: str,
             work: str, cases: Optional[List[str]] = None, commit_ab: int = 0,
             quick: bool = False, parallel: bool = False) -> dict:
    """The cases at ``n`` ranks (one after another, or all at once with
    ``parallel``: they share nothing but the host); ``quick`` runs the
    reference run of the crash case only."""
    cases = cases or CARD_CASES[n]
    out = {"ranks": n, "device": "cpu" if device == "cpu" else "cuda", "dims": dims,
           "batch_per_rank": batch, "seq": seq, "dtype": dtype, "cases": {}}
    if device != "cpu":
        import torch

        out["card"] = torch.cuda.get_device_name(0)
    def one(case):
        out["cases"][case] = run_case(case, n, device, dims, batch, seq, dtype,
                                      os.path.join(work, case), commit_ab=commit_ab,
                                      quick=quick)

    if parallel:
        import threading

        threads = [threading.Thread(target=one, args=(c,)) for c in cases]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for case in cases:
            one(case)
    out["cases"] = {c: out["cases"][c] for c in cases}
    out["failures"] = [f for c in out["cases"].values() for f in c["failures"]]
    out["ok"] = not out["failures"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="1 or 4 (default 4)")
    ap.add_argument("--device", default=None, help="cpu for gloo ranks; default: the cards")
    ap.add_argument("--smoke", action="store_true",
                    help="gloo ranks on the CPU at a 2-layer d-64 GPT (f32)")
    ap.add_argument("--case", action="append", default=None,
                    help=f"run only these cases (of {sorted(CASES)})")
    ap.add_argument("--commit-ab", type=int, default=None,
                    help="rounds of the commit / no-commit A/B of the one-rank case "
                         "(default 3 on the card, 0 with --smoke)")
    ap.add_argument("--quick", action="store_true",
                    help="the reference run of the crash case only")
    ap.add_argument("--parallel", action="store_true",
                    help="run the cases at once (the CPU: they share only the host)")
    ap.add_argument("--out", default=None, help="working directory (default: a temporary one)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--reference", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    if args.reference:
        return reference_worker(args.reference)
    n = args.ranks or 4
    if n not in CARD_CASES:
        print(f"elastic_parity: --ranks must be one of {sorted(CARD_CASES)}", file=sys.stderr)
        return 2
    if args.smoke:
        args.device = "cpu"
        dims, batch, seq, dtype = SMOKE_DIMS, SMOKE_BATCH, SMOKE_SEQ, "f32"
    else:
        dims, batch, seq = GPT2_SMALL, BATCH, SEQ
        dtype = "f32" if args.device == "cpu" else "bf16"
    if args.device != "cpu":
        import torch

        if torch.cuda.device_count() < n:
            print(f"elastic_parity: {n} ranks need {n} cards, {torch.cuda.device_count()} "
                  f"visible", file=sys.stderr)
            return 2
    commit_ab = args.commit_ab if args.commit_ab is not None else (
        0 if args.device == "cpu" else 3)
    work = args.out or tempfile.mkdtemp(prefix="elastic_parity_")
    out = rehearse(n, args.device, dims, batch, seq, dtype, work, args.case, commit_ab,
                   quick=args.quick, parallel=args.parallel)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
