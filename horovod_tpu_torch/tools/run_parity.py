"""The launcher and the observability taps, end to end on the DP GPT step.

    python -m horovod_tpu_torch.tools.run_parity --ranks 4            # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.run_parity --smoke              # 2 gloo ranks, the CPU
    python -m horovod_tpu_torch.tools.run_parity --smoke --ranks 4    # its 4-rank rehearsal

The job is launched by the port's own launcher (``run.run``, which
``launch_job``s ``python -m horovod_tpu_torch.run.task_runner`` on every
rank) with ``HOROVOD_METRICS=1``, ``HOROVOD_TRACE=1`` and
``HOROVOD_TIMELINE`` set. Each rank runs :func:`gpt_steps`: ``init``, one
eager allreduce (the executor's series), then the data-parallel GPT step
(``DistributedOptimizer`` over AdamW 3e-4, weight decay 1e-4) on its shard
of one global batch drawn from a numpy seed. The launching process then
trains the same initial weights on the whole batch with plain AdamW, no
collective, and checks:

- every rank's loss at every step within 1e-6 relative of the whole-batch
  loss (f32 with TF32 off, as ``tools/dp_parity.py``);
- B1's launches a step: one forward, one dQ and one dK/dV a layer (on the
  card; the CPU runs the plain versions);
- the same ``hvd_fusion_buckets`` and ``hvd_axis_wire_bytes_total`` on
  every rank, the wire bytes equal to the ring formula of
  ``horovod_tpu/ops/fusion.py:132-163`` for n ranks over the gradients'
  bytes, recorded once for the run, not once a step;
- one step span a step, and a timeline file that loads;
- a second job whose last rank kills itself (SIGKILL) after its first step
  ends nonzero within ``KILL_LIMIT_S`` of the kill, its peers terminated.

At GPT-2-small (``--ranks``) the batch is 8 x 1024 a rank; ``--smoke`` is
a 2-layer d-64 GPT at 2 x 32 a rank. Prints one JSON line; exits nonzero
on any failed check. :func:`gpt_steps` is also what ``chip_smoke.py``'s
``[hvdrun]`` phase ships with ``run()``; it lives in this importable module
because ``run()`` ships functions by reference where cloudpickle is
missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
SMOKE_DIMS = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2)
BATCH, SEQ, STEPS = 8, 1024, 5
SMOKE_BATCH, SMOKE_SEQ, SMOKE_STEPS = 2, 32, 3
LR, WEIGHT_DECAY, EPS = 3e-4, 1e-4, 1e-8
LOSS_REL = 1e-6
# From the victim's SIGKILL to the launcher's return: the poll loop sees the
# death within 50 ms, then each peer gets SIGTERM and, after the launcher's
# 5 s grace, SIGKILL.
KILL_LIMIT_S = 30.0
TAP_ENV = {"HOROVOD_METRICS": "1", "HOROVOD_TRACE": "1"}


def global_batch(dims: dict, n: int, batch: int, seq: int, seed: int):
    """The tokens and labels of all n ranks, ``(n * batch, seq)`` each, from
    one numpy seed (at n 1 the draws of ``chip_smoke.py``'s ``[slice]``)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, dims["vocab_size"], (n * batch, seq)))
    labels = torch.from_numpy(rng.randint(0, dims["vocab_size"], (n * batch, seq)))
    return tokens, labels


def _dtype(name: str):
    import torch

    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


def _taps(on: bool, saved: Optional[tuple] = None) -> tuple:
    """Switch both taps off (returns the live ones) or back on."""
    from horovod_tpu_torch import metrics, trace

    if on:
        metrics.TAP, trace.TAP = saved
        metrics.ACTIVE = trace.ACTIVE = True
        return saved
    live = (metrics.TAP, trace.TAP)
    metrics.ACTIVE = trace.ACTIVE = False
    metrics.TAP, trace.TAP = metrics.NULL_TAP, trace.NULL_TAP
    return live


def _syncs(run) -> int:
    """Host synchronizations ``run()`` makes, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def gpt_steps(dims: Optional[dict] = None, batch: int = BATCH, seq: int = SEQ,
              steps: int = STEPS, dtype: str = "bf16", device: Optional[str] = None,
              seed: int = 0, out_dir: Optional[str] = None, ab_rounds: int = 0,
              sync_check: bool = False) -> dict:
    """One rank of the launched job (the module docstring). ``ab_rounds``
    more rounds time the step with both taps off and on in turns (off, on,
    on, off); ``sync_check`` counts one step's host synchronizations with
    the taps on and off (on the card). Returns this rank's record."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, trace
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa

    dims = dict(dims or GPT2_SMALL)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=device)
    init_done = time.time()
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        # One eager op, so the executor's series (hvd_plans_total, ...) exist.
        hvd.allreduce(np.ones(4, np.float32), name="run_parity.eager")
        model = TransformerLM(**dims, max_len=seq, dtype=_dtype(dtype), device=dev, seed=seed)
        hvd.broadcast_parameters(model.state_dict())
        tokens, labels = global_batch(dims, n, batch, seq, seed)
        rows = slice(r * batch, (r + 1) * batch)
        data = (tokens[rows].to(dev), labels[rows].to(dev))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY, eps=EPS),
            named_parameters=model.named_parameters())
        step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
        losses, launches, times = [], [], []
        for _ in range(steps):
            before = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(float(step(model, data)))
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append([fa.FWD_LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1]])
        window = trace.TAP.window()
        snapshot = metrics.snapshot()
        out = {
            "rank": r, "size": n, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "init_done": init_done, "losses": losses, "launches": launches,
            "step_ms": times, "metrics": snapshot,
            "step_spans": len(window.get("steps", [])), "plan": window.get("plan", {}),
            "gradient_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
        }
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"rank.{r}.json"), "w") as f:
                json.dump(window, f)
        inner = getattr(step, "__wrapped__", step)    # the step without its span tap
        if ab_rounds:
            on_ms, off_ms = [], []
            for _ in range(ab_rounds):
                for taps_on in (False, True, True, False):
                    saved = None if taps_on else _taps(False)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    float((step if taps_on else inner)(model, data))
                    (on_ms if taps_on else off_ms).append((time.perf_counter() - t0) * 1e3)
                    if saved is not None:
                        _taps(True, saved)
            out["taps_on_ms"], out["taps_off_ms"] = on_ms, off_ms
        if sync_check and dev.type == "cuda":
            _syncs(lambda: step(model, data))   # one-time syncs stay out of the count
            counts = {"taps_off": [], "taps_on": []}
            for taps_on in (False, True, True, False):
                saved = None if taps_on else _taps(False)
                counts["taps_on" if taps_on else "taps_off"].append(
                    _syncs(lambda: (step if taps_on else inner)(model, data)))
                if saved is not None:
                    _taps(True, saved)
            out["syncs"] = counts
        return out
    finally:
        hvd.shutdown()


def killed_rank(dims: dict, batch: int, seq: int, dtype: str, device: Optional[str],
                kill_file: str) -> None:
    """A rank of the failure job: the DP step in a loop; the last rank
    writes the time and SIGKILLs itself after its first step, so its peers
    block in the next step's collectives until the launcher ends them."""
    import signal

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    hvd.init(device=device)
    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    model = TransformerLM(**dims, max_len=seq, dtype=_dtype(dtype), device=dev, seed=0)
    tokens, labels = global_batch(dims, n, batch, seq, 0)
    data = (tokens[r * batch:(r + 1) * batch].to(dev), labels[r * batch:(r + 1) * batch].to(dev))
    step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]),
                               torch.optim.AdamW(model.parameters(), lr=LR))
    for i in range(10_000):
        float(step(model, data))
        if r == n - 1 and i == 0:
            with open(kill_file, "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)


def whole_batch_losses(dims: dict, n: int, batch: int, seq: int, steps: int, dtype: str,
                       device: str, seed: int = 0) -> list:
    """The same initial weights trained on all n shards at once in this
    process: plain AdamW, no collective."""
    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(**dims, max_len=seq, dtype=_dtype(dtype), device=device, seed=seed)
    tokens, labels = global_batch(dims, n, batch, seq, seed)
    tokens, labels = tokens.to(device), labels.to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY, eps=EPS)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def ring_wire_bytes(payload: int, n: int) -> int:
    """One ring allreduce's bytes on the wire a rank
    (``horovod_tpu/ops/fusion.py:158``)."""
    return 2 * (n - 1) * payload // n


def _series(snapshot: dict, name: str) -> list:
    return [(tuple(sorted(s["labels"].items())), s.get("value", s.get("count")))
            for s in snapshot.get(name, {}).get("series", [])]


def check(results: list, reference: list, dims: dict, steps: int, on_card: bool) -> dict:
    """The checks of the module docstring over the ranks' records; returns
    the verdict's fields (``ok`` False when any failed)."""
    from horovod_tpu_torch.metrics import export

    n = len(results)
    failures = []
    rel = max(abs(a - b) / abs(b) for res in results for a, b in zip(res["losses"], reference))
    if rel > LOSS_REL:
        failures.append(f"loss rel err {rel:.3e} > {LOSS_REL}")
    if on_card:
        want = [[dims["n_layers"], dims["n_layers"]]] * steps
        for res in results:
            if res["launches"] != want:
                failures.append(f"rank {res['rank']} B1 launches {res['launches']} != {want}")
    buckets = [_series(res["metrics"], "hvd_fusion_buckets") for res in results]
    wire = [_series(res["metrics"], "hvd_axis_wire_bytes_total") for res in results]
    expected = ring_wire_bytes(results[0]["gradient_bytes"], n) if n > 1 else None
    if not buckets[0] or any(b != buckets[0] for b in buckets):
        failures.append(f"hvd_fusion_buckets differ or are missing: {buckets}")
    if n > 1:
        want_wire = [((("axis", "data"), ("collective", "allreduce")), float(expected))]
        if any(w != want_wire for w in wire):
            failures.append(f"hvd_axis_wire_bytes_total {wire} != {want_wire}")
    elif any(wire):
        failures.append(f"hvd_axis_wire_bytes_total at one rank: {wire} (the JAX step "
                        "records none for a group of one)")
    for res in results:
        snap = res["metrics"]
        for name in ("hvd_plans_total", "hvd_op_execute_seconds", "hvd_ops_submitted_total"):
            if name not in snap:
                failures.append(f"rank {res['rank']}: no {name} in the registry")
        if res["step_spans"] != steps:
            failures.append(f"rank {res['rank']}: {res['step_spans']} step spans, not {steps}")
        # Rendered and parsed back: the exposition a scrape would see.
        if not export.parse_prometheus(export.render_prometheus([({}, snap)])):
            failures.append(f"rank {res['rank']}: empty exposition")
    return {"ok": not failures, "failures": failures, "max_loss_rel_err": rel,
            "fusion_buckets": buckets[0], "axis_wire_bytes": wire[0],
            "ring_formula_bytes": expected}


def kill_check(dims: dict, n: int, batch: int, seq: int, dtype: str, device: Optional[str],
               work: str) -> dict:
    """The failure job (:func:`killed_rank`): its error and the seconds from
    the victim's SIGKILL to the launcher's return."""
    from horovod_tpu_torch.run import run

    kill_file = os.path.join(work, "killed_at")
    try:
        run(killed_rank, kwargs=dict(dims=dims, batch=batch, seq=seq, dtype=dtype,
                                     device=device, kill_file=kill_file), np=n)
        return {"ok": False, "error": "the job with a killed rank returned"}
    except RuntimeError as exc:
        ended = time.time()
        with open(kill_file) as f:
            killed_at = float(f.read())
        seconds = ended - killed_at
        return {"ok": seconds <= KILL_LIMIT_S and "exit code" in str(exc),
                "error": str(exc), "seconds_to_end": seconds, "limit_s": KILL_LIMIT_S}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="default 4; 2 with --smoke")
    ap.add_argument("--device", default=None, help="cpu for gloo ranks; default: the cards")
    ap.add_argument("--smoke", action="store_true",
                    help="2 gloo ranks on the CPU at a 2-layer d-64 GPT")
    ap.add_argument("--out", default=None, help="directory for the timeline and the windows")
    args = ap.parse_args(argv)
    if args.smoke:
        args.ranks, args.device = args.ranks or 2, "cpu"
        dims, batch, seq, steps = SMOKE_DIMS, SMOKE_BATCH, SMOKE_SEQ, SMOKE_STEPS
    else:
        args.ranks = args.ranks or 4
        dims, batch, seq, steps = GPT2_SMALL, BATCH, SEQ, STEPS
    on_card = args.device != "cpu"
    if on_card:
        import torch

        if torch.cuda.device_count() < args.ranks:
            print(f"run_parity: {args.ranks} ranks need {args.ranks} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    from horovod_tpu_torch.run import run
    from horovod_tpu_torch.trace import merge

    work = args.out or tempfile.mkdtemp(prefix="run_parity_")
    os.makedirs(work, exist_ok=True)
    timeline = os.path.join(work, "timeline.json")
    env = dict(TAP_ENV, HOROVOD_TIMELINE=timeline)
    t0 = time.time()
    results = run(gpt_steps, kwargs=dict(dims=dims, batch=batch, seq=seq, steps=steps,
                                         dtype="f32", device=args.device, out_dir=work),
                  np=args.ranks, env=env)
    launch_s = [res["init_done"] - t0 for res in results]
    reference = whole_batch_losses(dims, args.ranks, batch, seq, steps, "f32",
                                   "cuda" if on_card else "cpu")
    verdict = check(results, reference, dims, steps, on_card)
    try:
        events = merge.load_chrome_trace(timeline)
    except (OSError, ValueError) as exc:
        events = []
        verdict["failures"].append(f"the timeline does not load: {exc}")
    merged = merge.merge_windows(merge.read_dir(work)[0])
    kill = kill_check(dims, args.ranks, batch, seq, "f32", args.device, work)
    if not kill["ok"]:
        verdict["failures"].append(f"the killed-rank job: {kill}")
    out = {
        "ranks": args.ranks, "device": "cuda" if on_card else "cpu",
        "card": results[0]["card"], "dims": dims, "batch_per_rank": batch, "seq": seq,
        "losses_by_rank": [res["losses"] for res in results],
        "whole_batch_losses": reference, "max_loss_rel_err": verdict["max_loss_rel_err"],
        "b1_launches_by_rank": [res["launches"] for res in results],
        "fusion_buckets": verdict["fusion_buckets"],
        "axis_wire_bytes": verdict["axis_wire_bytes"],
        "ring_formula_bytes": verdict["ring_formula_bytes"],
        "step_spans_by_rank": [res["step_spans"] for res in results],
        "step_ms_by_rank": [res["step_ms"] for res in results],
        "launch_to_init_s_by_rank": launch_s, "timeline_events": len(events),
        "merged_trace_events": len(merged["traceEvents"]), "killed_rank": kill,
        "ok": not verdict["failures"], "failures": verdict["failures"],
    }
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
