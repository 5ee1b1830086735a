"""Tensor-parallel serving parity: the server at ``model n`` against one card's dense server.

    python -m horovod_tpu_torch.tools.serve_parity --ranks 4                  # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.serve_parity --ranks 2 --device cpu     # gloo on the CPU
    python -m horovod_tpu_torch.tools.serve_parity --ranks 4 --bench          # GPT-2-small bench

The ranks form a ``{"model": n}`` mesh, and each cuts the same seeded f32
GPT (``DIMS``) to its shards by the ``"gpt"`` rules
(``local_params_from_flax``). Two checks, TF32 off:

- teacher-forced logits: ``BATCH`` slots over ``T`` positions, each slot
  with its own shuffled page list, through ``tp_decode_apply`` on the
  shards over the model group and, on rank 0, through the dense
  ``tp_decode_apply`` on the whole weights: every step's logits within
  relative L2 ``LOGITS_REL`` of the dense ones, and the same next tokens;
- the server: ``serve(mesh=..., rules="gpt")`` on every rank (rank 0 the
  engine, the others followers) at 1 and at 2 replicas answers the seeded
  prompts token for token as rank 0's dense ``serve`` on one card, and
  every follower replays exactly the steps the leader issued.

Prints one JSON line from rank 0; exits non-zero on any disagreement.

``--bench`` instead times ``bench --serve``'s closed loop (GPT-2-small at
max_len 1024, f32, 8 clients, 64 requests of 16 new tokens, page size 8)
at ``model 1`` (``serve()`` on rank 0's whole weights, the other ranks
idle) and at ``model n`` (the tensor-parallel server), in turns (1, n, n,
1). Both engines take one configuration, ``bench --serve``'s ``max(64, 8 x
max batch)`` pages, so both gather the same context (504 of the 1024
positions). Each run prints tokens/s, p50/p99 latency, batch occupancy,
the steps of the timed window and their mean ms; then the step alone at a
full batch (``bench.time_decode_step``: the median host ms of 20 steps
with their read-back, and rank 0's profile of one: device busy ms,
kernels, device ms by family, NCCL apart). One JSON line per run from
rank 0. ``--smoke`` takes the bench's smoke widths at the same max_len
(a CPU rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .launch import launch_ranks, store_url

DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=256)
BATCH, T, PAGE_SIZE, NUM_PAGES = 4, 32, 8, 64
PROMPTS, MAX_TOKENS = 8, 8
LOGITS_REL = 1e-5
BENCH_MAX_LEN = 1024


def _config(**kw):
    from horovod_tpu_torch.common.env import Config

    cfg = Config()
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _prompts(n: int, vocab: int, seed: int = 0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, vocab, size=1 + rng.randint(8))] for _ in range(n)]


def _setup(device):
    """``init`` and the ``{"model": every rank}`` mesh."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    return hvd, build_mesh({"model": hvd.size()})


def _serve_tokens(handle, prompts):
    """Rank 0's completions of ``prompts`` (None on a follower), then the
    handle stopped."""
    try:
        if handle.engine is None:
            return None
        rids = [handle.submit(p, max_tokens=MAX_TOKENS) for p in prompts]
        handle.drain(timeout=300.0)
        return [list(handle.result(r).tokens) for r in rids]
    finally:
        handle.stop()


def _parity(hvd, mesh) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models.transformer import TransformerLM, tp_decode_apply
    from horovod_tpu_torch.serve import make_decode_state, serve
    from horovod_tpu_torch.utils.convert import (
        local_params_from_flax, params_from_flax, params_to_numpy)

    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    group = mesh.get_group("model")
    flat0 = params_to_numpy(TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0))
    local = local_params_from_flax(flat0, "gpt", mesh, device=dev)
    head_dim = DIMS["d_model"] // DIMS["n_heads"]
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, DIMS["vocab_size"], (BATCH, T))).to(dev)
    pages = rng.permutation(np.arange(1, NUM_PAGES))[:BATCH * (T // PAGE_SIZE)]
    table = torch.from_numpy(pages.reshape(BATCH, T // PAGE_SIZE)).to(dev)

    def decode(params, model_axis, heads):
        cache = make_decode_state(DIMS["n_layers"], num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                                  n_heads=heads, head_dim=head_dim, dtype=torch.float32,
                                  device=dev)
        out = []
        for t in range(T):
            pos = torch.full((BATCH,), t, device=dev)
            logits, cache = tp_decode_apply(params, tokens[:, t], pos, cache, table,
                                            n_heads=DIMS["n_heads"], model_axis=model_axis,
                                            dtype=torch.float32)
            out.append(logits)
        return torch.stack(out, 1)                       # [B, T, vocab]

    tp_logits = decode(local, group, DIMS["n_heads"] // n)
    prompts = _prompts(PROMPTS, DIMS["vocab_size"])
    served = {}
    for replicas in (1, 2):
        cfg = _config(serve_kv_pages=NUM_PAGES, serve_page_size=PAGE_SIZE, serve_max_batch=BATCH,
                      serve_max_wait_us=500, serve_replicas=replicas)
        handle = serve(local, n_heads=DIMS["n_heads"], mesh=mesh, rules="gpt", config=cfg,
                       dtype=torch.float32, device=dev)
        got = _serve_tokens(handle, prompts)
        steps = handle.follower_steps if handle.leader is None else handle.leader.steps
        served[replicas] = (got, steps)
    steps = torch.tensor([[s[1] for s in served.values()]], device=dev)
    every = [torch.zeros_like(steps) for _ in range(n)]
    dist.all_gather(every, steps)
    if r == 0:
        whole = params_from_flax(flat0, device=dev)
        dense_logits = decode(whole, None, DIMS["n_heads"])
        rel = ((tp_logits - dense_logits).norm(dim=-1) / dense_logits.norm(dim=-1)).max().item()
        same_argmax = bool((tp_logits.argmax(-1) == dense_logits.argmax(-1)).all())
        dense = _serve_tokens(serve(whole, n_heads=DIMS["n_heads"], config=_config(
            serve_kv_pages=NUM_PAGES, serve_page_size=PAGE_SIZE, serve_max_batch=BATCH,
            serve_max_wait_us=500), dtype=torch.float32, device=dev), prompts)
        steps_by_rank = [e[0].tolist() for e in every]
        result = {
            "ranks": n, "mesh": {"model": n}, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "dims": DIMS, "teacher_forced": {"slots": BATCH, "positions": T,
                                             "max_logits_rel_l2": rel,
                                             "argmax_identical": same_argmax},
            "prompts": len(prompts), "max_tokens": MAX_TOKENS,
            "tokens_identical": {str(k): v[0] == dense for k, v in served.items()},
            "steps_by_rank_and_replicas": steps_by_rank,
        }
        print(json.dumps(result), flush=True)
        ok = (rel <= LOGITS_REL and same_argmax and all(result["tokens_identical"].values())
              and all(row == steps_by_rank[0] for row in steps_by_rank))
    dist.barrier()
    if r == 0 and not ok:
        raise SystemExit("the tensor-parallel server disagrees with the dense one")


def _bench(hvd, mesh, smoke: bool) -> None:
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serve import serve
    from horovod_tpu_torch.utils.convert import (
        local_params_from_flax, param_tree, params_to_numpy)

    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    args = bench.parse_args(["--serve", "--device", dev.type] + ["--smoke"] * smoke)
    dims = dict(bench.SERVE_SMOKE if smoke else bench.GPT2_SMALL, max_len=BENCH_MAX_LEN)
    whole = param_tree(TransformerLM(**dims, dtype=torch.float32, device=dev, seed=args.seed))
    local = local_params_from_flax(params_to_numpy(whole), "gpt", mesh, device=dev)
    # One configuration for both engines: bench --serve's pages, so the
    # pool bounds the context (and the gathered T) alike at model 1 and n.
    cfg = _config(serve_kv_pages=max(64, 8 * args.serve_max_batch), serve_page_size=8,
                  serve_max_batch=args.serve_max_batch,
                  serve_max_wait_us=args.serve_max_wait_us, serve_replicas=1)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(dev.index)], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    for model in (1, n, n, 1):
        dist.barrier()
        if model == 1:
            if r != 0:
                continue
            handle = serve(whole, n_heads=dims["n_heads"], config=cfg, dtype=torch.float32,
                           device=dev)
        else:
            handle = serve(local, n_heads=dims["n_heads"], mesh=mesh, rules="gpt", config=cfg,
                           dtype=torch.float32, device=dev)
            if handle.engine is None:
                continue
        engine = handle.engine
        try:
            loop = bench.closed_loop(engine, args, dims["vocab_size"])
            engine.stop()
            # The followers replay these steps on their replica's cache.
            alone = bench.time_decode_step(engine)
        finally:
            handle.stop()
        out = bench.serve_report(args, dims, loop, dev)
        det = out["detail"]
        print(json.dumps({
            "mesh": {"model": model}, "card": card, "tokens_per_s": out["value"],
            "requests": det["requests"], "latency_ms": det["latency_ms"], "requests_per_sec": det["requests_per_sec"],
            "batch_occupancy_mean": det["batch_occupancy_mean"], "batches": det["batches"],
            "steps": loop["steps"],
            "ms_per_step_timed_window": loop["wall_s"] * 1e3 / loop["steps"],
            "max_context": engine.max_context, "table_width": engine.table_width,
            "step_alone": alone, "model": det["model"], "dtype": det["dtype"],
        }), flush=True)
    dist.barrier()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4, help="ranks of the model axis")
    ap.add_argument("--bench", action="store_true",
                    help="time the closed loop at model 1 and model n, in turns")
    ap.add_argument("--smoke", action="store_true", help="--bench at the smoke geometry")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    args = ap.parse_args()
    if args.smoke and not args.bench:
        ap.error("--smoke applies to --bench")
    if "HOROVOD_RANK" not in os.environ:
        argv = ["--ranks", str(args.ranks), "--device", args.device or "cuda"]
        argv += ["--bench"] * args.bench + ["--smoke"] * args.smoke
        return launch_ranks("horovod_tpu_torch.tools.serve_parity", argv, args.ranks)
    hvd, mesh = _setup(args.device)
    t0 = time.perf_counter()
    try:
        if args.bench:
            _bench(hvd, mesh, args.smoke)
        else:
            _parity(hvd, mesh)
    finally:
        if hvd.rank() == 0:
            print(f"[serve_parity] {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
