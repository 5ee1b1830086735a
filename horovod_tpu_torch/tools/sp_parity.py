"""Sequence-parallel parity: a DP×SP mesh of n ranks against one process.

    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 2               # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 4
    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 2 --device cpu  # gloo on the CPU
    python -m horovod_tpu_torch.tools.sp_parity --ranks 4 --seq 4 --bench       # GPT-2-small, timed

The ranks form a ``{"data": ranks / seq, "seq": seq}`` mesh and train a
small f32 GPT whose attention is ``ring_attention`` over the ``seq`` group
(kernel B2 on the card), for 3 steps of ``make_sp_train_step`` under SGD
0.1 on one global batch: each rank takes its ``[B/data, T/seq]`` shard.
Rank 0 then trains a copy of the same initial weights on the whole batch in
one process, with dense attention (``reference_attention``) and plain SGD.
The mean of the shards' mean losses is the whole batch's, so both runs must
agree, at the tolerances of tests/test_sp_training.py: losses rtol 1e-4,
parameters rtol 2e-3 / atol 2e-5; and every rank must hold the same
parameters. Prints one JSON line from rank 0; exits non-zero on any
disagreement.

``--bench`` times the sequence-parallel step at GPT-2-small's width (d_model
768, 12 heads, 12 layers, vocab 32768) on a global batch of 2 sequences of
4096 tokens, ``remat=True``, AdamW 3e-4 (weight decay 1e-4), the
configuration of ``chip_smoke.py``'s one-card ``[sp]`` phase spread over the
mesh: each rank's step ms (median of 5 after 2), tokens/s, B2's launches a
step, peak memory and one profiled step (``utils.profile``): device busy
ms and device ms by kernel family (B1/B2, cuBLAS, NCCL, the rest).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial

from .launch import launch_ranks, store_url

# The head dim (32) and the local lengths (256 / seq) are ones the kernels take.
DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=256)
BATCH, SEQ, STEPS, LR = 4, 256, 3, 0.1
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP, BENCH_STEPS = 2, 4096, 2, 5
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-3, 2e-5


def _worker(device, seq: int) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention, reference_attention
    from horovod_tpu_torch.parallel.sp import make_sp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        r, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        mesh = build_mesh({"data": n // seq, "seq": seq})
        model = TransformerLM(
            **DIMS, dtype=torch.float32, device=dev, seed=0,
            attn_fn=partial(ring_attention, group=mesh.get_group("seq"), causal=True))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        rng = np.random.RandomState(0)
        tokens = torch.from_numpy(rng.randint(0, DIMS["vocab_size"], (BATCH, SEQ))).to(dev)
        labels = torch.roll(tokens, -1, dims=1)
        step = make_sp_train_step(
            lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
            torch.optim.SGD(model.parameters(), lr=LR), mesh)
        fa.BLOCK_LAUNCHES = fa.BLOCK_BWD_LAUNCHES = 0
        losses = [float(step(model, tokens, labels)) for _ in range(STEPS)]
        launches = fa.BLOCK_LAUNCHES
        bwd_launches = fa.BLOCK_BWD_LAUNCHES

        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        gathered = hvd.allgather(flat[None])
        same = bool((gathered == gathered[0]).all())
        if r != 0:
            if not same:
                raise SystemExit("ranks hold different parameters")
            return

        ref = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0,
                            attn_fn=partial(reference_attention, causal=True))
        ref.load_state_dict(initial)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=LR)
        ref_losses = []
        for _ in range(STEPS):
            ref_opt.zero_grad()
            loss = lm_loss(ref(tokens), labels)
            loss.backward()
            ref_opt.step()
            ref_losses.append(loss.item())
        ref_flat = torch.cat([p.detach().reshape(-1) for p in ref.parameters()])
        diff = (flat - ref_flat).abs()
        excess = diff - (PARAM_ATOL + PARAM_RTOL * ref_flat.abs())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        result = {
            "ranks": n, "mesh": {"data": n // seq, "seq": seq}, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "losses": losses, "whole_batch_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
            "params_beyond_tolerance": int((excess > 0).sum()),
            "ranks_identical": same, "block_launches_rank0": launches,
            "block_bwd_launches_rank0": bwd_launches,
        }
        print(json.dumps(result), flush=True)
        if not (same and loss_rel <= LOSS_RTOL and result["params_beyond_tolerance"] == 0):
            raise SystemExit("sequence-parallel run disagrees with the whole-batch run")
    finally:
        hvd.shutdown()


def _bench(device, seq: int) -> None:
    import statistics
    import time

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    from horovod_tpu_torch.parallel.sp import make_sp_train_step
    from horovod_tpu_torch.utils.profile import profile_step

    from .tp_parity import _family

    hvd.init(device, init_method=store_url())
    try:
        r, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        mesh = build_mesh({"data": n // seq, "seq": seq})
        model = TransformerLM(
            **GPT2_SMALL, max_len=BENCH_SEQ, dtype=torch.bfloat16, device=dev, seed=0,
            remat=True,
            attn_fn=partial(ring_attention, group=mesh.get_group("seq"), causal=True))
        rng = np.random.RandomState(0)
        shape = (BENCH_BATCH * (n // seq), BENCH_SEQ)
        tokens = torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"], shape)).to(dev)
        labels = torch.roll(tokens, -1, dims=1)
        step = make_sp_train_step(
            lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
            torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8), mesh)
        losses, times = [], []
        for i in range(BENCH_WARMUP + BENCH_STEPS):
            if i == BENCH_WARMUP:
                torch.cuda.reset_peak_memory_stats(dev)
                fa.BLOCK_LAUNCHES = fa.BLOCK_BWD_LAUNCHES = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(float(step(model, tokens, labels)))
            if i >= BENCH_WARMUP:
                times.append(time.perf_counter() - t0)
        launches = (fa.BLOCK_LAUNCHES // BENCH_STEPS, fa.BLOCK_BWD_LAUNCHES // BENCH_STEPS)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        torch.cuda.synchronize(dev)
        profiled = profile_step(lambda: float(step(model, tokens, labels)), _family)
        med = statistics.median(times) * 1e3
        result = {"rank": r, "step_ms": med, "tokens_per_s": shape[0] * BENCH_SEQ / (med / 1e3),
                  "block_launches_a_step": launches, "peak_gib": peak,
                  "profiled_step": profiled,
                  "losses_first_last": (losses[0], losses[-1]),
                  "all_ms": [round(t * 1e3, 2) for t in times]}
        results = hvd.allgather_object(result)
        if r == 0:
            print(json.dumps({"ranks": n, "mesh": {"data": n // seq, "seq": seq},
                              "batch": list(shape), "card": torch.cuda.get_device_name(dev),
                              "by_rank": results}), flush=True)
        if not all(np.isfinite(x["losses_first_last"]).all() for x in results):
            raise SystemExit("non-finite loss")
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2, help="size of the seq axis; data = ranks / seq")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--bench", action="store_true",
                    help="time GPT-2-small's SP step at T 4096 (the card only)")
    args = ap.parse_args()
    if args.ranks % args.seq:
        ap.error(f"--seq {args.seq} does not divide --ranks {args.ranks}")
    if args.bench and args.device == "cpu":
        ap.error("--bench times the card; it has no CPU form")
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.sp_parity",
                            ["--ranks", str(args.ranks), "--seq", str(args.seq),
                             "--device", args.device or "cuda"]
                            + (["--bench"] if args.bench else []), args.ranks)
    if args.bench:
        _bench(args.device, args.seq)
    else:
        _worker(args.device, args.seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
