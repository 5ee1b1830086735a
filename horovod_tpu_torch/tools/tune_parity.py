"""The compiled-path tuner on a live job: its pins tuned, applied and timed.

    python -m horovod_tpu_torch.tools.tune_parity --ranks 4                # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.tune_parity --ranks 4 --device cpu   # gloo on the CPU

Each rank keeps its own card. The job:

1. Takes the live step's program: ``tune.spec_from_params`` of GPT-2-small
   (d_model 768, 12 heads, 12 layers, vocab 32768, max_len 1024; the port's
   f32 parameters) on the flat ``{"data": n}`` mesh, the key ``make_train_step``
   matches a pin against.
2. Fits the NVLink hop as ``tools/topo_parity`` does: its NCCL sweep
   (``torch.distributed.all_reduce`` alone, 1 KiB to 64 MiB in powers of 4,
   CUDA events around 20 calls after 3 warm-up calls), each call's mean a
   sample of the ``ici`` hop at 2(n-1) rounds and the ring's wire bytes a
   rank, every rank's samples through ``sim.calibrate.fit_calibration`` on
   the flat ``h100`` model of n ranks (the fit is keyed on that ladder, so it
   applies to the tuner's model).
3. Tunes four times, on every rank, each run deterministic: on the ``h100``
   row and on the fitted constants, each with the wire dim searched
   (``--wire auto``: f32, bf16, int8) and without int8 (``--wire f32``),
   16 samples, seed 0 (``python -m horovod_tpu_torch.tools.autotune_compiled``'s
   defaults). Every rank must pin the same bytes.
4. Applies each distinct pin to the DP step (``overlap=True``, AdamW 3e-4,
   weight decay 1e-4, f32 with TF32 off, 2 x 256 tokens a rank, 3 steps from
   one seed): ``make_train_step(tuned=cfg)`` against the same knobs by hand
   (``tune.tuned_step_kwargs``): losses and final parameters bitwise equal on
   every rank, and the losses within ``dp_parity``'s gates of one
   whole-batch process on rank 0 (1e-6 relative, 1e-3 on the int8 wire).
5. Times the untuned step and each pin's at the bench's shape (bf16, 8 x 1024
   a rank), in turns (untuned, pins..., pins reversed, untuned), 10 steps a
   turn after 3 warm-up steps, each rank's median a turn: a finding, no
   gain claimed.

With ``--device cpu`` the program is dp_parity's small GPT and the times
are the CPU's. Rank 0 prints one JSON line (with the card's name and power
limit) and writes the pins and the calibration into ``--out``; any
disagreement exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .launch import launch_ranks, store_url
from .topo_parity import _card, _nccl_sweep

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
SMALL = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, max_len=256)
PARITY_BATCH, PARITY_SEQ, PARITY_STEPS, LR = 2, 256, 3, 3e-4
BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP, BENCH_STEPS = 8, 1024, 3, 10
GENERATION = "h100"
SAMPLES, SEED = 16, 0
WIRES = ("auto", "f32")


def fit_nvlink(dev, n: int, model):
    """topo_parity's NCCL sweep on every rank, fitted on ``model`` (the flat
    n-rank model) from all ranks' samples."""
    import torch.distributed as dist

    from ..sim import calibrate

    rounds = 2 * (n - 1)
    mine = [{"name": "hvd_collective_stage:all_reduce-ring", "dur_s": sec, "hop": "ici",
             "rounds": rounds, "nbytes": int(nb * rounds / n)}
            for nb, sec in _nccl_sweep(dev)]
    every = [None] * n
    dist.all_gather_object(every, mine)
    stats = {"schema_version": 1, "world_size": n,
             "ranks": {str(r): {"collectives": c} for r, c in enumerate(every)}}
    return calibrate.fit_calibration(stats, model,
                                     source="tune_parity: NCCL all_reduce (topo_parity's sweep)")


def tunings(spec, model, calib) -> dict:
    """The four pins: {(row, wire): TunedConfig}."""
    from .. import tune as T

    out = {}
    for row, c in (("h100", None), ("fitted", calib)):
        for wire in WIRES:
            space = T.space_for_model(model, allow_int8=wire != "f32")
            out[(row, wire)] = T.tune(spec, model, samples=SAMPLES, seed=SEED, space=space,
                                      calibration=c)
    return out


def _batch(dims, n, batch, seq, dev, seed=0):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randint(0, dims["vocab_size"], (n * batch, seq))).to(dev)
                 for _ in range(2))


def _parity_run(hvd, dims, dev, tokens, labels, **kw):
    """3 f32 steps of the DP step built with ``kw``: (losses, final flat
    parameters, the optimizer's threshold, first bucket and wire)."""
    import torch

    from ..models.transformer import TransformerLM, lm_loss

    r, n = hvd.rank(), hvd.size()
    model = TransformerLM(**dims, dtype=torch.float32, device=dev, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
    step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt, overlap=True, **kw)
    shard = slice(r * PARITY_BATCH, (r + 1) * PARITY_BATCH)
    losses = [float(step(model, (tokens[shard], labels[shard]))) for _ in range(PARITY_STEPS)]
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    o = step.optimizer
    return losses, flat, (o._threshold, o._first_bucket, bool(o._quantized))


def _whole_batch(dims, dev, tokens, labels):
    import torch

    from ..models.transformer import TransformerLM, lm_loss

    model = TransformerLM(**dims, dtype=torch.float32, device=dev, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
    out = []
    for _ in range(PARITY_STEPS):
        opt.zero_grad()
        loss = lm_loss(model(tokens), labels)
        loss.backward()
        opt.step()
        out.append(loss.item())
    return out


def _timed(hvd, dims, dev, variants: dict, batch: int, seq: int, warmup: int, steps: int):
    """Each variant's step (bf16, its own model) in turns: {name: [each
    turn's median ms on this rank]}."""
    import time

    import numpy as np
    import torch

    from ..models.transformer import TransformerLM, lm_loss

    r = hvd.rank()
    tokens, labels = _batch(dims, 1, batch, seq, dev, seed=r)
    built = {}
    for name, kw in variants.items():
        model = TransformerLM(**dims, dtype=torch.bfloat16, device=dev, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
        built[name] = (model, hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt,
                                                  overlap=True, **kw))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    names = list(variants)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for i, name in enumerate(order):
        model, step = built[name]
        for _ in range(warmup if i < len(names) else 0):
            float(step(model, (tokens, labels)))
        ts = []
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            float(step(model, (tokens, labels)))
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[name].append(float(np.median(ts)))
    return times


def _worker(device: str, out_dir) -> None:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import tune as T
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.topo.model import synthetic_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    on_card = dev.type == "cuda"
    dims = GPT2_SMALL if on_card else SMALL
    failures = []
    spec = T.spec_from_params("transformer", TransformerLM(**dims, device="meta"),
                              mesh={"data": n})
    model = synthetic_model(n, generation=GENERATION)
    calib = fit_nvlink(dev, n, model)
    pins = tunings(spec, model, calib)
    blobs = [None] * n
    torch.distributed.all_gather_object(blobs, {f"{k[0]}/{k[1]}": c.to_json()
                                                for k, c in pins.items()})
    if any(b != blobs[0] for b in blobs):
        failures.append("the ranks pinned different tunings")
    # The distinct pins, in the order tuned.
    distinct = {}
    for (row, wire), cfg in pins.items():
        distinct.setdefault(json.dumps(cfg.knobs, sort_keys=True), []).append(f"{row}/{wire}")

    tokens, labels = _batch(dims, n, PARITY_BATCH, PARITY_SEQ, dev)
    ref = _whole_batch(dims, dev, tokens, labels) if r == 0 else None
    untuned = _parity_run(hvd, dims, dev, tokens, labels, tuned=False)
    parity = {}
    for knobs, names in distinct.items():
        cfg = pins[tuple(names[0].split("/"))]
        tuned = _parity_run(hvd, dims, dev, tokens, labels, tuned=cfg)
        info = T.applied_tuned_info()
        hand = _parity_run(hvd, dims, dev, tokens, labels, tuned=False,
                           **T.tuned_step_kwargs(cfg))
        bitwise = tuned[0] == hand[0] and bool(torch.equal(tuned[1], hand[1]))
        gathered = hvd.allgather(tuned[1][None])
        same = bool((gathered == gathered[0]).all())
        int8 = cfg.knobs["wire_dtype"] == "int8"
        row = {"pins": names, "knobs": json.loads(knobs), "built": list(tuned[2]),
               "matched": bool(info and info["matched"]), "losses": tuned[0],
               "bitwise_hand_set": bitwise, "ranks_identical": same}
        if r == 0:
            rel = max(abs(a - b) / abs(b) for a, b in zip(tuned[0], ref))
            row["max_loss_rel_err_whole_batch"] = rel
            if rel > (1e-3 if int8 else 1e-6):
                failures.append(f"{names}: loss rel err {rel} against the whole batch")
        if not (bitwise and same and row["matched"]):
            failures.append(f"{names}: bitwise {bitwise}, ranks identical {same}, "
                            f"matched {row['matched']}")
        parity[",".join(names)] = row
        del tuned, hand, gathered
    untuned_rel = (max(abs(a - b) / abs(b) for a, b in zip(untuned[0], ref))
                   if r == 0 else None)

    variants = {"untuned": dict(tuned=False)}
    for knobs, names in distinct.items():
        variants[",".join(names)] = dict(tuned=pins[tuple(names[0].split("/"))])
    if on_card:
        times = _timed(hvd, GPT2_SMALL, dev, variants, BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP,
                       BENCH_STEPS)
    else:
        times = _timed(hvd, dims, dev, variants, PARITY_BATCH, PARITY_SEQ, 1, 2)
    every = [None] * n
    torch.distributed.all_gather_object(every, times)
    bad = [None] * n
    torch.distributed.all_gather_object(bad, failures)
    if r == 0:
        failures = [f"rank {i}: {f}" for i, fs in enumerate(bad) for f in fs]
        by_variant = {name: [rank_times[name] for rank_times in every] for name in variants}
        slowest = {name: max(max(t) for t in rows) for name, rows in by_variant.items()}
        result = {
            "ranks": n, "device": str(dev), "card": _card(dev),
            "program": {"dims": dims, "signature": spec.signature["hash"],
                        "layers": len(spec.layers), "bytes": spec.total_bytes},
            "calibration": calib.to_dict(),
            "pins": {f"{k[0]}/{k[1]}": {"knobs": c.knobs,
                                       "exposed_us": c.objectives["exposed_us"],
                                       "baseline_exposed_us": c.baseline["exposed_us"],
                                       "n_groups": c.objectives["n_groups"]}
                     for k, c in pins.items()},
            "parity": parity, "untuned_loss_rel_err_whole_batch": untuned_rel,
            "whole_batch_losses": ref,
            "step_ms_median_by_turn_and_rank": by_variant,
            "step_ms_slowest_rank_worst_turn": slowest,
            "ratio_to_untuned": {k: v / slowest["untuned"] for k, v in slowest.items()},
            "timed": {"batch_per_rank": BENCH_BATCH if on_card else PARITY_BATCH,
                      "seq": BENCH_SEQ if on_card else PARITY_SEQ,
                      "dtype": "bf16", "turns": 2},
            "failures": failures, "ok": not failures,
        }
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for k, c in pins.items():
                T.save_tuned(c, os.path.join(out_dir, f"tuned.{k[0]}.{k[1]}.json"))
            with open(os.path.join(out_dir, "calibration.json"), "w") as f:
                f.write(calib.to_json())
        print(json.dumps(result), flush=True)
        if failures:
            raise SystemExit("tune_parity: " + "; ".join(failures))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--out", default=None,
                    help="directory for the pins and the calibration (rank 0)")
    args = ap.parse_args()
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.tune_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda"]
                            + (["--out", args.out] if args.out else []), args.ranks)
    import horovod_tpu_torch as hvd

    hvd.init(args.device, init_method=store_url())
    try:
        _worker(args.device, args.out)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
