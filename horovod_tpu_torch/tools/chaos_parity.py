"""Fault plans live on the torch binding's GPT step: the chaos rehearsal.

    python -m horovod_tpu_torch.tools.chaos_parity --ranks 4      # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.chaos_parity --ranks 1      # one card (chip_smoke [chaos])
    python -m horovod_tpu_torch.tools.chaos_parity --smoke        # 2 gloo ranks, the CPU

The job is the one a Horovod user runs to rehearse failure: ``python -m
horovod_tpu_torch.run -np N`` launches :func:`worker` on every rank, the
hook-driven torch binding (``horovod_tpu_torch.torch.DistributedOptimizer``
over AdamW 3e-4, weight decay 1e-4) on GPT-2-small at 8 x 1024 a rank, with
``HOROVOD_GUARD_NONFINITE=zero`` and a seeded ``HOROVOD_FAULT_PLAN``
(:func:`fault_plan`) of four faults, each on its own rank and step
(:data:`ROLES`):

- ``delay`` at ``enqueue``: ``DELAY_HITS`` hits of ``DELAY_S`` in the middle
  of step 3's backward; that step grows by about their sum;
- ``nan`` at ``payload`` on one named gradient at its step 2; the guard
  zeroes it before the wire, the loss stays finite, and the log holds the
  ``nan`` line followed by the guard's ``nonfinite-zero``;
- ``corrupt`` at ``output`` on one named gradient with its element and an
  exponent bit pinned: at one rank the returned gradient differs from the
  rank's own (the unfaulted result of an average over one rank) in exactly
  that bit; at several, after that step the rank's parameters differ from
  the others' at exactly that element, and the others agree bitwise;
- ``kill`` at ``step`` (the loop calls ``fault.step()`` after each step)
  with exit code 43: the launcher returns 43 within ``KILL_LIMIT_S`` of the
  kill, its peers terminated.

The job runs twice: each rank's event-log lines must be equal across the
runs, and hold every fault. Then a run without a plan under
``HOROVOD_PROFILER_DIR`` (``--no-profile`` skips it), whose chrome trace must
load and hold ``hvd_plan_`` ranges (and, on the card, B1's kernels);
(``--ab-rounds``) the step with no plan against the same plan armed to fire
nowhere (every action on rank 99), in turns, with the guard off; and the
ring NIC probe over ``--ranks`` local tasks (at least 2), timed. ``--smoke`` is a 2-layer d-64 GPT at 2 x 32 a rank in
f32 on 2 gloo ranks (the kill on rank 1; ``--ranks 1`` or ``4`` rehearse
those plans), without the A/B run unless ``--ab-rounds`` asks for it.
Prints one JSON line; exits nonzero on any failed check.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
SMOKE_DIMS = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2)
BATCH, SEQ = 8, 1024
SMOKE_BATCH, SMOKE_SEQ = 2, 32
LR, WEIGHT_DECAY, EPS = 3e-4, 1e-4, 1e-8
PLAN_SEED = 20261018
DELAY_S, DELAY_HITS, DELAY_STEP = 0.05, 8, 3
NAN_STEP = 2
KILL_EXIT = 43
# From the kill to the launcher's return: the poll loop sees the death
# within 50 ms, then each peer gets SIGTERM and, after 5 s, SIGKILL.
KILL_LIMIT_S = 30.0
CORRUPT_ELEMENT = 5
# Which rank takes which fault, and at which step the corrupt and the kill
# fire, by rank count. One fault a rank and step, so each rank's event
# lines come from one thread at a time and keep their order run to run.
ROLES = {
    1: dict(slow=0, nan=0, corrupt=0, kill=0, corrupt_step=4, kill_step=5),
    2: dict(slow=0, nan=1, corrupt=0, kill=1, corrupt_step=4, kill_step=5),
    4: dict(slow=1, nan=2, corrupt=3, kill=0, corrupt_step=3, kill_step=4),
}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _grad_name(param: str) -> str:
    """The binding's collective name for a parameter's gradient."""
    return f"DistributedOptimizer.{param}"


def targets(dims: dict) -> dict:
    """The named gradients the payload faults hit: the first block's MLP-up
    bias (nan) and the last block's second LayerNorm bias (corrupt)."""
    return {"nan": "block_0.mlp.up.bias",
            "corrupt": f"block_{dims['n_layers'] - 1}.ln_2.bias"}


def enqueue_counts(dims: dict, seq: int) -> tuple:
    """(enqueues before the first step, enqueues a step): one broadcast a
    ``state_dict`` entry, one allreduce a trainable parameter. The counts do
    not depend on the width, so a model of width 8 gives them."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    m = TransformerLM(**dict(dims, vocab_size=8, d_model=8, n_heads=1), max_len=seq,
                      device="cpu")
    return len(m.state_dict()), sum(1 for p in m.parameters() if p.requires_grad)


def fault_plan(n: int, dims: dict, seq: int, bit: int, rank_override: Optional[int] = None) -> str:
    """The seeded plan of the module docstring for ``n`` ranks (every
    action on ``rank_override`` when given: the plan that fires nowhere)."""
    roles = ROLES[n]
    before, per_step = enqueue_counts(dims, seq)
    names = targets(dims)

    def rank(role):
        return roles[role] if rank_override is None else rank_override

    faults = [
        {"kind": "delay", "site": "enqueue", "rank": rank("slow"), "seconds": DELAY_S,
         "after": before + per_step * (DELAY_STEP - 1) + per_step // 2, "count": DELAY_HITS},
        {"kind": "nan", "site": "payload", "rank": rank("nan"),
         "tensor": _grad_name(names["nan"]), "at_step": NAN_STEP},
        {"kind": "corrupt", "site": "output", "rank": rank("corrupt"),
         "tensor": _grad_name(names["corrupt"]), "at_step": roles["corrupt_step"],
         "element": CORRUPT_ELEMENT, "bit": bit},
        {"kind": "kill", "site": "step", "rank": rank("kill"), "at_step": roles["kill_step"],
         "exit_code": KILL_EXIT},
    ]
    return json.dumps({"seed": PLAN_SEED, "faults": faults}, sort_keys=True)


def _bytes(t) -> bytes:
    import torch

    return t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def worker(cfg_path: str) -> int:
    """One rank of the launched job (``--worker``): the binding's GPT step
    in a loop, ``fault.step()`` after each, one JSON record a step appended
    to ``<out>/rank.<r>.jsonl`` (so a killed rank keeps its records)."""
    import numpy as np
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import fault
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.fault import injector
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa

    with open(cfg_path) as f:
        cfg = json.load(f)
    dims, batch, seq = cfg["dims"], cfg["batch"], cfg["seq"]
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["dtype"]]
    hvd.init(device=cfg["device"])
    r, n, dev = hvd.rank(), hvd.size(), basics.device()
    out_path = os.path.join(cfg["out"], f"rank.{r}.jsonl")

    def emit(rec: dict) -> None:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model = TransformerLM(**dims, max_len=seq, dtype=dtype, device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY, eps=EPS),
        named_parameters=model.named_parameters())
    rng = np.random.RandomState(1000 + r)
    tokens, labels = (torch.from_numpy(rng.randint(0, dims["vocab_size"], (batch, seq))).to(dev)
                      for _ in range(2))
    params = dict(model.named_parameters())
    target = params[targets(dims)["corrupt"]]
    roles = cfg.get("roles") or {}

    def one_step():
        opt.zero_grad()
        loss = lm_loss(model(tokens), labels)
        loss.backward()
        return loss

    emit({"rank": r, "size": n, "event": "start", "card": torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "cpu"})
    for s in range(1, cfg["steps"] + 1):
        launches = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
        sync()
        t0 = time.perf_counter()
        loss = one_step()
        local = target.grad.detach().clone() if s == roles.get("corrupt_step") else None
        opt.step()
        loss = float(loss)
        sync()
        rec = {"rank": r, "step": s, "ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
               "launches": [fa.FWD_LAUNCHES - launches[0], fa.BWD_LAUNCHES - launches[1]],
               "enqueue_hits": injector._counters.get("enqueue", 0)}
        if local is not None:
            # The reduced gradient's bytes against this rank's own.
            diff = (target.grad.detach().contiguous().view(-1).view(torch.uint8)
                    ^ local.contiguous().view(-1).view(torch.uint8))
            where = torch.nonzero(diff).view(-1)
            rec["grad_diff"] = [[int(i), int(diff[i])] for i in where[:8].cpu()]
            rec["param_sha"] = {name: hashlib.sha256(_bytes(p)).hexdigest()
                                for name, p in params.items()}
            rec["target_bytes"] = _bytes(target).hex()
        emit(rec)
        if s == roles.get("kill_step") and r == roles.get("kill"):
            with open(os.path.join(cfg["out"], "killed_at"), "w") as f:
                f.write(repr(time.time()))
        fault.step()
    if cfg.get("ab_rounds"):
        # The tap cost: the step with no plan against the plan armed to
        # fire nowhere, in turns (off, on, on, off); and, in the armed
        # steps, the host time inside the taps themselves (the call sites
        # look the tap functions up on the module at each call).
        armed = fault.FaultPlan.from_json(cfg["nowhere_plan"])
        on_ms, off_ms, tap_ms, calls, fired = [], [], [], [], 0
        spent, lock = [0.0, 0], threading.Lock()

        def timed(fn):
            def tap(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    with lock:
                        spent[0] += time.perf_counter() - t0
                        spent[1] += 1
            return tap

        plain = (injector.fault_point, injector.payload_fault)
        for _ in range(cfg["ab_rounds"]):
            for armed_now in (False, True, True, False):
                injector.install_plan(armed if armed_now else None)
                injector.fault_point, injector.payload_fault = (
                    tuple(map(timed, plain)) if armed_now else plain)
                spent[:] = [0.0, 0]
                sync()
                t0 = time.perf_counter()
                one_step()
                opt.step()
                sync()
                (on_ms if armed_now else off_ms).append((time.perf_counter() - t0) * 1e3)
                if armed_now:
                    tap_ms.append(spent[0] * 1e3)
                    calls.append(spent[1])
                fired += len(fault.events())
        injector.fault_point, injector.payload_fault = plain
        injector.reset()
        emit({"rank": r, "event": "ab", "armed_ms": on_ms, "none_ms": off_ms,
              "tap_host_ms": tap_ms, "tap_calls": calls, "events_fired": fired})
    emit({"rank": r, "event": "end"})
    hvd.shutdown()
    return 0


def _launch(n: int, cfg: dict, env_extra: dict, work: str, name: str, timeout: float) -> dict:
    """``python -m horovod_tpu_torch.run -np n`` of :func:`worker`; returns
    the exit code, the seconds, the ranks' records and the event lines."""
    out = os.path.join(work, name)
    os.makedirs(out, exist_ok=True)
    cfg = dict(cfg, out=out)
    cfg_path = os.path.join(out, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ)
    for k in ("HOROVOD_FAULT_PLAN", "HOROVOD_FAULT_EVENT_LOG", "HOROVOD_PROFILER_DIR",
              "HOROVOD_RANK", "HOROVOD_SIZE"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["HOROVOD_GUARD_NONFINITE"] = "zero"
    env.update(env_extra)
    log = os.path.join(out, "events.jsonl")
    if "HOROVOD_FAULT_PLAN" in env_extra:
        env["HOROVOD_FAULT_EVENT_LOG"] = log
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(n), "--output-dir",
         os.path.join(out, "logs"), sys.executable, "-m", "horovod_tpu_torch.tools.chaos_parity",
         "--worker", cfg_path],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    ended = time.time()
    seconds = time.perf_counter() - t0
    records = {}
    for rank in range(n):
        path = os.path.join(out, f"rank.{rank}.jsonl")
        records[rank] = ([json.loads(l) for l in open(path)] if os.path.exists(path) else [])
    events = [json.loads(l) for l in open(log)] if os.path.exists(log) else []
    killed_at = None
    if os.path.exists(os.path.join(out, "killed_at")):
        with open(os.path.join(out, "killed_at")) as f:
            killed_at = float(f.read())
    logs = {}
    for fn in sorted(os.listdir(os.path.join(out, "logs"))) if os.path.isdir(
            os.path.join(out, "logs")) else []:
        with open(os.path.join(out, "logs", fn), errors="replace") as f:
            logs[fn] = f.read()[-2000:]
    return {"rc": proc.returncode, "seconds": seconds, "records": records, "events": events,
            "kill_to_end_s": None if killed_at is None else ended - killed_at,
            "stderr": proc.stderr[-3000:], "logs": logs, "dir": out}


def _by_rank(events: list) -> dict:
    out = {}
    for e in events:
        out.setdefault(e["rank"], []).append(
            {k: e[k] for k in ("seq", "site", "hit", "action", "detail", "rank")})
    return out


def check_chaos(run: dict, n: int, dims: dict, roles: dict, bit: int, itemsize: int,
                failures: list) -> dict:
    """The §4 checks on one run; appends to ``failures``; returns the
    figures."""
    tag = run["dir"].rsplit(os.sep, 1)[-1]
    names = targets(dims)
    if run["rc"] != KILL_EXIT:
        failures.append(f"{tag}: the launcher returned {run['rc']}, not {KILL_EXIT}: "
                        f"{run['stderr'][-800:]} {run['logs']}")
    if run["kill_to_end_s"] is None or run["kill_to_end_s"] > KILL_LIMIT_S:
        failures.append(f"{tag}: kill to job end {run['kill_to_end_s']} s (limit {KILL_LIMIT_S})")
    if n > 1 and "terminating remaining ranks" not in run["stderr"]:
        failures.append(f"{tag}: the launcher did not terminate the peers: {run['stderr'][-800:]}")
    ev = _by_rank(run["events"])
    want = {r: [] for r in range(n)}
    want[roles["nan"]] += ["payload/nan", "guard/nonfinite-zero"]
    want[roles["slow"]] += ["enqueue/delay"] * DELAY_HITS
    want[roles["corrupt"]] += ["output/corrupt"]
    want[roles["kill"]] += ["step/kill"]
    for r in range(n):
        got = sorted(f"{e['site']}/{e['action']}" for e in ev.get(r, []))
        if got != sorted(want[r]):
            failures.append(f"{tag}: rank {r} events {got} != {sorted(want[r])}")
    nan_lines = [e for e in ev.get(roles["nan"], []) if e["action"] in ("nan", "nonfinite-zero")]
    if [e["action"] for e in nan_lines] != ["nan", "nonfinite-zero"] or not all(
            _grad_name(names["nan"]) in e["detail"] for e in nan_lines):
        failures.append(f"{tag}: the nan and the guard's answer: {nan_lines}")
    corrupt = [e for e in ev.get(roles["corrupt"], []) if e["action"] == "corrupt"]
    if corrupt and corrupt[0]["detail"] != f"{_grad_name(names['corrupt'])}[{CORRUPT_ELEMENT}] " \
                                           f"bit {bit}":
        failures.append(f"{tag}: corrupt line {corrupt}")
    steps = {r: [x for x in recs if "step" in x] for r, recs in run["records"].items()}
    for r in range(n):
        if any(not (x["loss"] == x["loss"] and abs(x["loss"]) < 1e30) for x in steps[r]):
            failures.append(f"{tag}: rank {r} non-finite loss {[x['loss'] for x in steps[r]]}")
        if any(x.get("event") == "end" for x in run["records"][r]):
            failures.append(f"{tag}: rank {r} ran to its end past the kill")
        if len(steps[r]) < roles["kill_step"] - (0 if r == roles["kill"] else 1):
            failures.append(f"{tag}: rank {r} has {len(steps[r])} steps")
    # The delay: its hits inside step DELAY_STEP, which grows by about their sum.
    slow = steps[roles["slow"]]
    figures = {"step_ms": [x["ms"] for x in slow], "launches": [x["launches"] for x in slow]}
    if len(slow) >= DELAY_STEP + 1:
        hits = [e["hit"] for e in ev.get(roles["slow"], []) if e["action"] == "delay"]
        lo, hi = slow[DELAY_STEP - 2]["enqueue_hits"], slow[DELAY_STEP - 1]["enqueue_hits"]
        if not all(lo < h <= hi for h in hits):
            failures.append(f"{tag}: delay hits {hits} outside step {DELAY_STEP} ({lo}, {hi}]")
        calm = [x["ms"] for x in slow[1:] if x["step"] != DELAY_STEP]
        figures["delayed_step_ms"] = slow[DELAY_STEP - 1]["ms"]
        figures["calm_step_ms_median"] = statistics.median(calm)
        figures["delay_growth_ms"] = figures["delayed_step_ms"] - figures["calm_step_ms_median"]
        figures["delay_sum_ms"] = DELAY_S * DELAY_HITS * 1e3
    # The corrupt: one bit of one element.
    rec = next((x for x in steps[roles["corrupt"]] if "grad_diff" in x), None)
    if rec is None:
        failures.append(f"{tag}: no record of the corrupt step")
    elif n == 1:
        want_diff = [[CORRUPT_ELEMENT * itemsize + bit // 8, 1 << (bit % 8)]]
        if rec["grad_diff"] != want_diff:
            failures.append(f"{tag}: gradient bytes differ at {rec['grad_diff']}, not {want_diff}")
        figures["grad_diff"] = rec["grad_diff"]
    else:
        others = [r for r in range(n) if r != roles["corrupt"]]
        recs = {r: next(x for x in steps[r] if x["step"] == roles["corrupt_step"])
                for r in range(n) if len(steps[r]) >= roles["corrupt_step"]}
        ref = recs.get(others[0])
        if ref is None or any(recs.get(r, {}).get("param_sha") != ref["param_sha"]
                              for r in others):
            failures.append(f"{tag}: ranks {others} disagree after step {roles['corrupt_step']}")
        elif rec["param_sha"] != ref["param_sha"]:
            differ = sorted(k for k, v in rec["param_sha"].items() if v != ref["param_sha"][k])
            a, b = bytes.fromhex(rec["target_bytes"]), bytes.fromhex(ref["target_bytes"])
            elems = sorted({i // itemsize for i in range(len(a)) if a[i] != b[i]})
            figures["corrupt_param_diff"] = {"tensors": differ, "elements": elems}
            if differ != [names["corrupt"]] or elems != [CORRUPT_ELEMENT]:
                failures.append(f"{tag}: rank {roles['corrupt']} differs at {differ} {elems}, "
                                f"not {names['corrupt']}[{CORRUPT_ELEMENT}]")
        else:
            failures.append(f"{tag}: rank {roles['corrupt']}'s parameters equal the others'")
    figures["kill_to_end_s"] = run["kill_to_end_s"]
    figures["job_s"] = run["seconds"]
    return figures


def profile_check(run: dict, on_card: bool, failures: list) -> dict:
    prof_dir = os.path.join(run["dir"], "profile")
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    if run["rc"] != 0 or not traces:
        failures.append(f"profile run: rc {run['rc']}, traces {traces}: {run['stderr'][-800:]}")
        return {}
    with open(os.path.join(prof_dir, traces[0])) as f:
        names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
    plans = sorted(n for n in names if n.startswith("hvd_plan_"))
    # B1's kernels by their base names ("void (anonymous namespace)::
    # flash_fwd_mma_kernel<64, ...>(...)"), and its dispatcher ops.
    flash = sorted({n.split("<")[0].split("::")[-1] for n in names if "flash_" in n})
    if not plans:
        failures.append("profile run: no hvd_plan_ range in the trace")
    if on_card:
        for k in ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel"):
            if k not in flash:
                failures.append(f"profile run: no {k} in the trace: {flash[:8]}")
    return {"traces": traces, "hvd_plan_ranges": len(plans), "flash_names": flash}


def rehearse(n: int, device: Optional[str], dims: dict, batch: int, seq: int, dtype: str,
             ab_rounds: int, profile: bool, work: str) -> dict:
    """The checks of the module docstring at ``n`` ranks; returns the
    figures with ``ok`` and ``failures``."""
    from horovod_tpu_torch.fault.plan import FaultPlan
    from horovod_tpu_torch.run import network

    on_card = device != "cpu"
    card = "cpu"
    if on_card:
        import torch

        card = torch.cuda.get_device_name(0)
    roles = ROLES[n]
    # The parameters, and so the gradients, are f32 masters at either
    # compute dtype; the corrupt flips the exponent's top bit.
    itemsize = 4
    bit = 8 * itemsize - 2
    plan = fault_plan(n, dims, seq, bit)
    base = {"dims": dims, "batch": batch, "seq": seq, "dtype": dtype, "device": device,
            "roles": roles}
    timeout = 900 if on_card else 240
    failures = []
    runs = [_launch(n, dict(base, steps=roles["kill_step"] + 1), {"HOROVOD_FAULT_PLAN": plan},
                    work, f"chaos{i}", timeout) for i in (1, 2)]
    figures = [check_chaos(run, n, dims, roles, bit, itemsize, failures) for run in runs]
    logs = [_by_rank(run["events"]) for run in runs]
    if logs[0] != logs[1]:
        failures.append(f"the two runs' event logs differ: {logs}")
    out = {"ranks": n, "device": "cuda" if on_card else "cpu", "card": card, "dims": dims,
           "batch_per_rank": batch, "seq": seq, "dtype": dtype, "plan": json.loads(plan),
           "canonical_schedule": FaultPlan.from_json(plan).canonical_schedule(),
           "chaos_runs": figures, "event_lines_by_rank": logs[0]}
    if profile:
        prof = _launch(n, dict(base, steps=3), {"HOROVOD_PROFILER_DIR": os.path.join(
            work, "profiled", "profile")}, work, "profiled", timeout)
        out["profile"] = profile_check(prof, on_card, failures)
    if ab_rounds:
        nowhere = fault_plan(n, dims, seq, bit, rank_override=99)
        # The guard's host sync a gradient would only add noise here.
        ab = _launch(n, dict(base, steps=2, ab_rounds=ab_rounds, nowhere_plan=nowhere),
                     {"HOROVOD_GUARD_NONFINITE": ""}, work, "ab", timeout)
        rows = [x for x in ab["records"].get(0, []) if x.get("event") == "ab"]
        if ab["rc"] != 0 or not rows:
            failures.append(f"A/B run: rc {ab['rc']}: {ab['stderr'][-800:]}")
        else:
            armed, none = rows[0]["armed_ms"], rows[0]["none_ms"]
            if rows[0]["events_fired"]:
                failures.append(f"A/B run: the plan on rank 99 fired {rows[0]['events_fired']}")
            out["tap_ab"] = {"armed_ms": armed, "none_ms": none,
                             "armed_median_ms": statistics.median(armed),
                             "none_median_ms": statistics.median(none),
                             "rel": statistics.median(armed) / statistics.median(none) - 1,
                             "tap_host_ms": rows[0]["tap_host_ms"],
                             "tap_calls": rows[0]["tap_calls"]}
    t0 = time.perf_counter()
    try:
        common = network.discover_common_interfaces(["localhost"] * max(n, 2))
    except Exception as exc:  # noqa: BLE001 - reported as a failure
        common = []
        failures.append(f"probe: {type(exc).__name__}: {exc}")
    out["probe"] = {"tasks": max(n, 2), "interfaces": common,
                    "seconds": time.perf_counter() - t0}
    if not common:
        failures.append("probe: no common interface")
    out["ok"], out["failures"] = not failures, failures
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="1, 2 or 4; default 4; 2 with --smoke")
    ap.add_argument("--device", default=None, help="cpu for gloo ranks; default: the cards")
    ap.add_argument("--smoke", action="store_true",
                    help="2 gloo ranks on the CPU at a 2-layer d-64 GPT")
    ap.add_argument("--ab-rounds", type=int, default=None,
                    help="rounds of the no-plan / armed-plan A/B (default 3; 0 with --smoke)")
    ap.add_argument("--no-profile", action="store_true", help="skip the profiler run")
    ap.add_argument("--out", default=None, help="working directory (default: a temporary one)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    if args.smoke:
        args.ranks, args.device = args.ranks or 2, "cpu"
        dims, batch, seq, dtype = SMOKE_DIMS, SMOKE_BATCH, SMOKE_SEQ, "f32"
        ab_rounds = args.ab_rounds or 0
    else:
        args.ranks = args.ranks or 4
        dims, batch, seq = GPT2_SMALL, BATCH, SEQ
        dtype = "f32" if args.device == "cpu" else "bf16"
        ab_rounds = 3 if args.ab_rounds is None else args.ab_rounds
    if args.ranks not in ROLES:
        print(f"chaos_parity: --ranks must be one of {sorted(ROLES)}", file=sys.stderr)
        return 2
    if args.device != "cpu":
        import torch

        if torch.cuda.device_count() < args.ranks:
            print(f"chaos_parity: {args.ranks} ranks need {args.ranks} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    out = rehearse(args.ranks, args.device, dims, batch, seq, dtype, ab_rounds, not args.no_profile,
                   args.out or tempfile.mkdtemp(prefix="chaos_parity_"))
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
