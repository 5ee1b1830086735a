"""Pipeline-parallel parity: a STAGE×DATA mesh of n ranks against one process.

    python -m horovod_tpu_torch.tools.pp_parity --ranks 4 --stage 4               # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.pp_parity --ranks 4 --stage 2               # stage 2 x data 2
    python -m horovod_tpu_torch.tools.pp_parity --ranks 4 --stage 4 --device cpu  # gloo on the CPU
    python -m horovod_tpu_torch.tools.pp_parity --ranks 4 --stage 4 --bench       # GPT-2-small, timed

The ranks form a ``{"stage": stage, "data": ranks / stage}`` mesh and train
a small f32 GPT (4 blocks, split evenly over the stages) for 3 steps of
``parallel.pp.make_pp_lm_train_step`` under SGD 0.1 with ``remat=True``, on
one global batch of 4 microbatches of 2 sequences of 64 tokens (each rank takes its data
rows). The embedding runs on stage 0, ``ln_f`` + ``lm_head`` + ``lm_loss``
on the last stage, and the blocks are the port's ``_apply_block`` with flash
attention (kernel B1 on the card, TF32 off). Every rank then trains a copy
of the same initial weights on the whole batch in one process (the
``TransformerLM`` module, plain SGD) and holds its own parts to it: losses
rtol 1e-5, parameters rtol 1e-4 / atol 1e-5, the tolerances of
tests/test_torch_pp.py. Prints one JSON line from rank 0; exits non-zero on
any disagreement.

``--bench`` times GPT-2-small (d_model 768, 12 heads, 12 blocks, vocab
32768) at a global batch of 8 x 1024 under AdamW 3e-4 (weight decay 1e-4):
the pipeline step (8 / data microbatches of one sequence a data rank,
``remat=True``) against the
data-parallel step over all the ranks (``make_train_step``, 8 / ranks
sequences a rank), in turns, and prints each rank's step ms, tokens/s, the
bubble share ``(stages - 1) / (n_micro + stages - 1)``, B1's launches a
step, peak memory and one profiled pipeline step (``utils.profile``): its
device busy ms and device ms by kernel family, the NCCL point-to-point
kernels' a tick among them (a kernel that waits for its peer counts its
wait).

The stage, embed and head functions below are this tool's: the pipeline
API takes the caller's, as the JAX API does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from functools import partial

from .launch import launch_ranks, store_url

DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=4, max_len=128)
N_MICRO, MB, SEQ, STEPS, LR = 4, 2, 64, 3, 0.1
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
BENCH_MICRO, BENCH_SEQ, BENCH_TURNS, BENCH_STEPS = 8, 1024, 2, 5


def gpt_embed_fn(dtype):
    """``embed_fn`` of a GPT pipeline: token and position tables added in
    f32 and cast once, as ``models.transformer.tp_apply`` does."""
    import torch
    import torch.nn.functional as F

    def embed(p, tok):
        pos = torch.arange(tok.shape[1], device=tok.device).expand(tok.shape)
        return (F.embedding(tok, p["embeddings"]["embedding"])
                + F.embedding(pos, p["pos_embeddings"]["embedding"])).to(dtype)

    return embed


def gpt_stage_fn(n_heads: int, dtype):
    """``stage_fn`` of a GPT pipeline: this stage's blocks (``block_0..``)
    in order, each the port's ``_apply_block`` with causal flash attention."""
    from horovod_tpu_torch.models.transformer import _apply_block, transformer_n_layers
    from horovod_tpu_torch.ops.flash_attention import flash_attention_bthd

    attn = partial(flash_attention_bthd, causal=True)

    def stage(p, h, s):
        head_dim = h.shape[-1] // n_heads
        for j in range(transformer_n_layers(p)):
            h = _apply_block(p[f"block_{j}"], h, head_dim=head_dim, dtype=dtype, attn=attn)
        return h

    return stage


def gpt_head_loss_fn(dtype):
    """``head_loss_fn`` of a GPT pipeline: ``ln_f``, the f32 ``lm_head`` and
    the mean next-token cross entropy."""
    from horovod_tpu_torch.models.transformer import _head, lm_loss

    return lambda p, h, lab: lm_loss(_head(p, h, dtype), lab)


def _gpt_step(mesh, params, dtype, n_heads, make_optimizer, remat=True):
    from horovod_tpu_torch.parallel.pp import init_pp_lm_state, make_pp_lm_train_step

    return make_pp_lm_train_step(gpt_embed_fn(dtype), gpt_stage_fn(n_heads, dtype),
                                 gpt_head_loss_fn(dtype),
                                 init_pp_lm_state(make_optimizer, params), mesh, remat=remat)


def _parity(dev, stage: int) -> dict:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.utils.convert import (params_to_numpy, pp_params_from_flax,
                                                 pp_params_to_flax)

    r, n = hvd.rank(), hvd.size()
    mesh = build_mesh({"stage": stage, "data": n // stage})
    s = mesh.get_local_rank("stage")
    ref = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0)
    flat = params_to_numpy(ref)
    params = pp_params_from_flax(flat, stage, s, device=dev)
    rng = np.random.RandomState(0)
    shape = (N_MICRO, MB, SEQ)
    tokens, labels = (torch.from_numpy(rng.randint(0, DIMS["vocab_size"], shape)).to(dev)
                      for _ in range(2))
    step = _gpt_step(mesh, params, torch.float32, DIMS["n_heads"],
                     lambda ps: torch.optim.SGD(ps, lr=LR))
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    losses = [float(step(params, tokens, labels)) for _ in range(STEPS)]
    launches = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)

    opt = torch.optim.SGD(ref.parameters(), lr=LR)
    ref_losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = lm_loss(ref(tokens.reshape(-1, SEQ)), labels.reshape(-1, SEQ))
        loss.backward()
        opt.step()
        ref_losses.append(loss.item())
    want = params_to_numpy(ref)
    got = pp_params_to_flax(params, stage, s, DIMS["n_layers"])
    worst, beyond = 0.0, 0
    for name, g in got.items():
        diff = np.abs(g - want[name])
        worst = max(worst, float(diff.max()))
        beyond += int((diff > PARAM_ATOL + PARAM_RTOL * np.abs(want[name])).sum())
        if np.array_equal(g, flat[name]):
            beyond += 1         # a parameter that never moved
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    ok = loss_rel <= LOSS_RTOL and beyond == 0
    return {"rank": r, "stage": s, "losses": losses, "whole_batch_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": worst,
            "params_beyond_tolerance": beyond, "params_checked": len(got),
            "flash_launches_fwd_bwd": launches, "ok": ok}


def _bench(dev, stage: int) -> dict:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.utils.convert import params_to_numpy, pp_params_from_flax
    from horovod_tpu_torch.utils.profile import profile_step

    r, n = hvd.rank(), hvd.size()
    mesh = build_mesh({"stage": stage, "data": n // stage})
    s = mesh.get_local_rank("stage")
    adamw = partial(torch.optim.AdamW, lr=3e-4, weight_decay=1e-4, eps=1e-8)
    model = TransformerLM(**GPT2_SMALL, max_len=BENCH_SEQ, dtype=torch.bfloat16, device=dev,
                          seed=0)
    params = pp_params_from_flax(params_to_numpy(model), stage, s, device=dev)
    pp_step = _gpt_step(mesh, params, torch.bfloat16, GPT2_SMALL["n_heads"], adamw)
    rng = np.random.RandomState(0)
    n_micro = BENCH_MICRO // (n // stage)       # one sequence a data rank a microbatch
    shape = (n_micro, n // stage, BENCH_SEQ)
    tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"], shape))
                      .to(dev) for _ in range(2))
    per = BENCH_MICRO // n
    rows = slice(r * per, (r + 1) * per)
    dp_batch = (tokens.reshape(-1, BENCH_SEQ)[rows], labels.reshape(-1, BENCH_SEQ)[rows])
    opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                   named_parameters=model.named_parameters())
    dp_step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
    runs = {"pp": lambda: pp_step(params, tokens, labels), "dp": lambda: dp_step(model, dp_batch)}
    times = {"pp": [], "dp": []}
    losses = {"pp": [], "dp": []}
    for name in ("pp", "dp"):       # warmup
        losses[name].append(float(runs[name]()))
    peak, launches = {}, {}
    for name in ["pp", "dp", "dp", "pp"] * BENCH_TURNS:
        torch.cuda.reset_peak_memory_stats(dev)
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        for _ in range(BENCH_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses[name].append(float(runs[name]()))
            times[name].append(time.perf_counter() - t0)
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches[name] = (fa.FWD_LAUNCHES // BENCH_STEPS, fa.BWD_LAUNCHES // BENCH_STEPS)
    ticks = n_micro + stage - 1
    profiled = profile_step(runs["pp"], _family)
    p2p_ms = profiled.get("family_ms", {}).get("p2p", 0.0)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    tokens_a_step = BENCH_MICRO * BENCH_SEQ
    return {"rank": r, "stage": s, "mesh": {"stage": stage, "data": n // stage},
            "card": torch.cuda.get_device_name(dev),
            "step_ms": med, "tokens_per_s": {k: tokens_a_step / (v / 1e3) for k, v in med.items()},
            "pp_over_dp": med["pp"] / med["dp"],
            "bubble_share": (stage - 1) / ticks, "ticks": ticks,
            "profiled_pp_step": profiled, "p2p_kernel_ms_a_tick": p2p_ms / (2 * ticks),
            "flash_launches_a_step": launches,
            "peak_gib": peak, "losses_first_last": {k: (v[0], v[-1]) for k, v in losses.items()},
            "all_ms": {k: [round(t * 1e3, 2) for t in v] for k, v in times.items()}}


def _family(name: str) -> str:
    """The PP step's kernel families: the NCCL point-to-point kernels of the
    ticks, other NCCL (the gradient sums), B1, cuBLAS, the rest."""
    if "nccl" in name:
        return "p2p" if ("sendrecv" in name or "send" in name or "recv" in name) else "nccl"
    if "flash_" in name:
        return "flash"
    return "gemm" if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")) else "other"


def _worker(device, stage: int, bench: bool) -> int:
    import torch

    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        dev = hvd.device()
        result = _bench(dev, stage) if bench else _parity(dev, stage)
        results = hvd.allgather_object(result)
        if hvd.rank() == 0:
            out = {"ranks": hvd.size(), "mesh": {"stage": stage, "data": hvd.size() // stage},
                   "device": str(dev),
                   "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "by_rank": results}
            if not bench:
                out["ok"] = all(x["ok"] for x in results)
            print(json.dumps(out), flush=True)
        if not bench and not all(x["ok"] for x in results):
            return 1
        return 0
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--stage", type=int, default=4,
                    help="size of the stage axis; data = ranks / stage")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--bench", action="store_true",
                    help="time GPT-2-small's pipeline step against the DP step (the card only)")
    args = ap.parse_args()
    if args.ranks % args.stage:
        ap.error(f"--stage {args.stage} does not divide --ranks {args.ranks}")
    if args.bench and args.device == "cpu":
        ap.error("--bench times the card; it has no CPU form")
    if "HOROVOD_RANK" not in os.environ:
        argv = ["--ranks", str(args.ranks), "--stage", str(args.stage),
                "--device", args.device or "cuda"] + (["--bench"] if args.bench else [])
        return launch_ranks("horovod_tpu_torch.tools.pp_parity", argv, args.ranks)
    return _worker(args.device, args.stage, args.bench)


if __name__ == "__main__":
    sys.exit(main())
