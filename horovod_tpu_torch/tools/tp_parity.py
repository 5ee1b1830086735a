"""Tensor-parallel parity: a composed DP×TP mesh of n ranks against one process.

    python -m horovod_tpu_torch.tools.tp_parity --ranks 4 --model 2            # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.tp_parity --ranks 4 --model 4 --fused
    python -m horovod_tpu_torch.tools.tp_parity --ranks 4 --model 2 --device cpu   # gloo on the CPU
    python -m horovod_tpu_torch.tools.tp_parity --ranks 4 --model 4 --bench    # GPT-2-small step times
    python -m horovod_tpu_torch.tools.tp_parity --ranks 4 --model 4 --primitives
    python -m horovod_tpu_torch.tools.tp_parity --ranks 4 --model 2 --variant overlap,zero1,skip

The ranks form a ``{"data": ranks / model, "model": model}`` mesh. Each cuts
the same initial weights of a small f32 GPT to its shards by the ``"gpt"``
rules (``local_params_from_flax``) and trains them for 3 steps of the
composed ``make_train_step(rules="gpt")`` under SGD 0.1 on one global batch,
in the classic form (one all-reduce per half-block) or with ``--fused`` (the
collective-matmul ring, kernels B3 and B4 on the card). Rank 0 then trains
the whole weights on the whole batch in one process with the dense
``tp_apply``. The runs must agree: losses within rel 1e-6 and the gathered
parameters within 1e-5, and the ranks of one model coordinate (the data
ranks) must hold bitwise the same shards. Prints one JSON line from rank 0,
with the B3/B4 launches rank 0 made; exits non-zero on any disagreement.

``--variant`` (a comma list, one init for all) runs the check once for each
data-axis variant of the composed step: ``posthoc`` (the default above),
``overlap`` (the data-group reduction streamed from the backward, small
groups), ``quantized`` (the flat int8 ring over the data group, error
feedback off: the loss within 1e-3 and the parameters within 1e-3, the int8
wire's noise at SGD 0.1), ``zero1`` (the optimizer state sharded over the
data group), ``skip`` (the non-finite guard: rank 1's gradient of a
model-sharded leaf made NaN at the second step, which every rank of the
mesh must skip and the whole-batch run leaves out) and ``two-level-dp``
(the data scope an axis tuple, ``{"cross": 2, "local": data / 2, "model":
model}`` with ``data_axis=("cross", "local")``, under zero1, whose
reduce-scatter and all-gather then run two-level).

``--bench`` instead times the GPT-2-small step (d_model 768, 12 heads, 12
layers, vocab 32768, bf16, AdamW 3e-4 with weight decay 1e-4) at ``data
ranks / model x model``, batch 8 x 1024, classic and fused in one run: the
median step over steps 2-5, tokens/s, B3/B4 launches a step, and one
profiled step's device time by kernel family (B3/B4, flash, GEMM, NCCL,
other). One JSON line per form from rank 0.

``--primitives`` times one call of each primitive on the model group at the
GPT-2-small shapes (B3: q/k/v, x [8, 1024/model, 768]; B4: MLP down, y [8,
1024, 3072/model]), forward only, beside the same function from NCCL
collectives and ``torch.matmul`` (all-gather then matmul; matmul then
reduce-scatter) and beside one ring hop alone (both directions' chunks in
the ring's one ``batch_isend_irecv``, as B3 and B4 send them), with CUDA
events over 20 calls after a barrier. The hop is also timed in other forms:
in one direction only, on a side stream ordered by events, as one
``all_to_all_single`` with empty chunks for the other ranks, and as an
all-gather of the chunk; and the host's time a call of the ring's hop. Also
whether the cards can reach each other's memory directly. One JSON line from
rank 0 with every rank's times.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from .launch import launch_ranks, store_url

# The head dim (32) and the length (256) are ones the flash kernels take.
DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=256)
BATCH, SEQ, STEPS, LR = 4, 256, 3, 0.1
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
BENCH_BATCH, BENCH_SEQ, BENCH_STEPS = 8, 1024, 5
SMALL_BUCKETS = dict(fusion_threshold_bytes=1 << 18)
VARIANTS = {
    "posthoc": {},
    "overlap": dict(overlap=True, first_bucket_bytes=1 << 16, **SMALL_BUCKETS),
    "quantized": dict(quantized=True),
    "zero1": dict(zero1=True, **SMALL_BUCKETS),
    "skip": dict(nonfinite="skip"),
    "two-level-dp": dict(zero1=True, **SMALL_BUCKETS),
}
INT8_RTOL = 1e-3        # the quantized variant's loss and parameter bound
SKIPPED, POISONED_RANK, POISONED_LEAF = 1, 1, "block_1/mlp/up/kernel"


def _setup(device, model: int):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    n = hvd.size()
    return hvd, build_mesh({"data": n // model, "model": model})


def _two_level_mesh(hvd, model: int):
    """``{"cross": 2, "local": data / 2, "model": model}``."""
    from horovod_tpu_torch.parallel.mesh import build_mesh

    n_data = hvd.size() // model
    if n_data % 2:
        raise SystemExit(f"--variant two-level-dp needs an even data size, got {n_data}")
    return build_mesh({"cross": 2, "local": n_data // 2, "model": model})


def _named(tree):
    from horovod_tpu_torch.parallel.rules import named_tree_paths

    return named_tree_paths(tree)


def _flat(tree):
    import torch

    return torch.cat([t.detach().reshape(-1) for _, t in _named(tree)])


def _parity(hvd, mesh, model: int, fused: bool, variant: str) -> None:
    import numpy as np
    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, make_gpt_loss_fn
    from horovod_tpu_torch.ops import collective_matmul as cm
    from horovod_tpu_torch.ops.collectives import allgather, flat_group
    from horovod_tpu_torch.parallel.mesh import axis_groups
    from horovod_tpu_torch.utils.convert import (
        gather_params, local_params_from_flax, params_from_flax, params_to_numpy)

    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    data_axis = ("cross", "local") if variant == "two-level-dp" else "data"
    data_group = (axis_groups(mesh, data_axis) if variant == "two-level-dp"
                  else mesh.get_group("data"))
    # Every rank draws the same weights from the seed.
    flat0 = params_to_numpy(TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0))
    params = local_params_from_flax(flat0, "gpt", mesh, device=dev)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, DIMS["vocab_size"], (BATCH, SEQ))).to(dev)
    labels = torch.roll(tokens, -1, dims=1)
    step = hvd.make_train_step(
        make_gpt_loss_fn(DIMS["n_heads"], model_axis="model", dtype=torch.float32),
        torch.optim.SGD([t for _, t in _named(params)], lr=LR),
        mesh=mesh, rules="gpt", tp_overlap=fused, data_axis=data_axis, **VARIANTS[variant])
    poison = {"on": False}
    if variant == "skip" and r == POISONED_RANK:
        dict(_named(params))[POISONED_LEAF].register_hook(
            lambda g: g * float("nan") if poison["on"] else g)
    cm.AGMM_LAUNCHES = cm.MRS_LAUNCHES = 0
    losses, unchanged = [], []
    for s in range(STEPS):
        poison["on"] = variant == "skip" and s == SKIPPED
        before = _flat(params)
        losses.append(float(step(params, (tokens, labels))))
        unchanged.append(bool(torch.equal(before, _flat(params))))
    launches = {"b3": cm.AGMM_LAUNCHES, "b4": cm.MRS_LAUNCHES}

    mine = _flat(params)
    over_data = allgather(mine[None], group=flat_group(data_group))
    same = bool((over_data == over_data[0]).all())
    skips = allgather(torch.tensor([unchanged], device=dev))
    whole = _flat(gather_params(params, "gpt", mesh))
    if r != 0:
        return

    ref = params_from_flax(flat0, device=dev)
    ref_opt = torch.optim.SGD([t.requires_grad_() for _, t in _named(ref)], lr=LR)
    ref_loss_fn = make_gpt_loss_fn(DIMS["n_heads"], dtype=torch.float32)
    ref_losses = []
    for s in range(STEPS):
        ref_opt.zero_grad()
        loss = ref_loss_fn(ref, (tokens, labels))
        ref_losses.append(loss.item())
        if variant == "skip" and s == SKIPPED:
            continue                            # every rank skips this step
        loss.backward()
        ref_opt.step()
    diff = (whole - _flat(ref)).abs()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    result = {
        "ranks": n, "mesh": axes, "fused": fused, "variant": variant, "device": str(dev),
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "losses": losses, "whole_batch_losses": ref_losses,
        "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
        "data_ranks_identical": same, "launches_rank0": launches,
        "streamed_groups": list(step.optimizer.streamed_groups),
    }
    ok = same
    if variant == "skip":
        want = [s == SKIPPED for s in range(STEPS)]
        result["skipped_by_rank"] = skips.tolist()
        ok = ok and all(row.tolist() == want for row in skips)
    print(json.dumps(result), flush=True)
    tol = (INT8_RTOL, INT8_RTOL) if variant == "quantized" else (LOSS_RTOL, PARAM_ATOL)
    ok = ok and loss_rel <= tol[0] and result["max_param_abs_err"] <= tol[1]
    if fused and dev.type == "cuda":
        ok = ok and launches["b3"] > 0 and launches["b4"] > 0
    if variant == "overlap":
        launched, _, groups = result["streamed_groups"]
        ok = ok and launched == groups > 1
    if not ok:
        raise SystemExit(f"tensor-parallel run ({variant}) disagrees with the whole-batch run")


def _family(name: str) -> str:
    name = name.lower()
    if any(k in name for k in ("gemm_tma_wgmma_kernel", "gemm_wmma_kernel", "gemm_fma_kernel",
                               "mrs_epilogue")):
        return "b3b4"
    if "flash_" in name:
        return "flash"
    if any(k in name for k in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "gemm"
    return "nccl" if "nccl" in name else "other"


def _profile(run_step) -> dict:
    """One step under torch.profiler: host ms, device busy ms and device ms
    by kernel family."""
    from ..utils.profile import profile_step

    return profile_step(run_step, _family)


def _bench(device, model: int) -> None:
    import numpy as np
    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, make_gpt_loss_fn
    from horovod_tpu_torch.ops import collective_matmul as cm
    from horovod_tpu_torch.utils.convert import local_params_from_flax, params_to_numpy

    hvd, mesh = _setup(device, model)
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        if dev.type != "cuda":
            raise SystemExit("--bench measures the card; it has no CPU form")
        card = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        flat0 = params_to_numpy(TransformerLM(**GPT2_SMALL, dtype=torch.bfloat16, device=dev,
                                              seed=0))
        rng = np.random.RandomState(0)
        tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                       (BENCH_BATCH, BENCH_SEQ))).to(dev)
                          for _ in range(2))
        for fused in (False, True):
            params = local_params_from_flax(flat0, "gpt", mesh, device=dev)
            step = hvd.make_train_step(
                make_gpt_loss_fn(GPT2_SMALL["n_heads"], model_axis="model"),
                torch.optim.AdamW([t for _, t in _named(params)], lr=3e-4,
                                  weight_decay=1e-4, eps=1e-8),
                mesh=mesh, rules="gpt", tp_overlap=fused)
            cm.AGMM_LAUNCHES = cm.MRS_LAUNCHES = 0
            losses, times = [], []
            for _ in range(BENCH_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(params, (tokens, labels))))
                times.append(time.perf_counter() - t0)
            launches = {"b3": cm.AGMM_LAUNCHES / BENCH_STEPS, "b4": cm.MRS_LAUNCHES / BENCH_STEPS}
            profile = _profile(lambda: float(step(params, (tokens, labels))))
            med = statistics.median(times[1:])
            if r == 0:
                print(json.dumps({
                    "form": "fused" if fused else "classic",
                    "mesh": {"data": n // model, "model": model}, "card": card,
                    "batch": [BENCH_BATCH, BENCH_SEQ], "losses": losses,
                    "step_ms_median_2_5": med * 1e3, "first_step_ms": times[0] * 1e3,
                    "tokens_per_s": BENCH_BATCH * BENCH_SEQ * (n // model) / med,
                    "launches_per_step_rank0": launches, "profile_rank0": profile,
                    "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                }), flush=True)
            if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
                raise SystemExit(f"GPT-2-small did not train: {losses}")
            del params, step
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()


def _primitives(device, model: int) -> None:
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import collective_matmul as cm
    from horovod_tpu_torch.ops.collectives import allgather, reducescatter

    hvd, mesh = _setup(device, model)
    try:
        r, dev = hvd.rank(), hvd.device()
        if dev.type != "cuda":
            raise SystemExit("--primitives measures the card; it has no CPU form")
        group = mesh.get_group("model")
        d, bsz, seq = GPT2_SMALL["d_model"], BENCH_BATCH, BENCH_SEQ
        tc = seq // model
        g = torch.Generator(device=dev).manual_seed(r)
        rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)
        x, wq = rnd(bsz, tc, d), rnd(d, 3 * d // model)
        y, wd = rnd(bsz, seq, 4 * d // model), rnd(4 * d // model, d)
        ring = cm._Ring(group)
        acc = torch.zeros(bsz, tc, d, device=dev)
        n, gr = dist.get_world_size(group), dist.get_rank(group)
        side = torch.cuda.Stream(dev)

        def hop_variant(t, both=True, side_stream=False):
            """The hop as the ring posts it, in one direction only or on a
            side stream ordered by events."""
            sends = [(t, 1), (t, -1)] if both else [(t, 1)]
            if not side_stream:
                ring.wait(ring.post(sends))
                return
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                recvs = ring.wait(ring.post(sends))
            for b in [t, *recvs]:
                b.record_stream(side)
            torch.cuda.current_stream(dev).wait_stream(side)

        sizes = [x.numel() if j in ((gr + 1) % n, (gr - 1) % n) else 0 for j in range(n)]
        flat_in = torch.cat([x.reshape(-1)] * sum(1 for k in sizes if k))
        flat_out = torch.empty_like(flat_in)

        cases = {
            "b3_fused": lambda: cm.all_gather_matmul(x, wq, group=group),
            "b3_allgather_then_matmul": lambda: torch.matmul(allgather(x, group=group, dim=1), wq),
            "b4_fused": lambda: cm.matmul_reduce_scatter(y, wd, group=group),
            "b4_matmul_then_reducescatter": lambda: reducescatter(torch.matmul(y, wd),
                                                                  group=group, dim=1),
            "ring_hop_b3_bf16_chunk": lambda: ring.wait(ring.post([(x, 1), (x, -1)])),
            "ring_hop_b4_f32_accumulator": lambda: ring.wait(ring.post([(acc, 1), (acc, -1)])),
            "hop_b3_one_direction": lambda: hop_variant(x, both=False),
            "hop_b3_side_stream": lambda: hop_variant(x, side_stream=True),
            "hop_b3_all_to_all_single": lambda: dist.all_to_all_single(
                flat_out, flat_in, sizes, sizes, group=group),
            "allgather_b3_chunk": lambda: allgather(x, group=group, dim=1),
        }
        ms = {}
        with torch.no_grad():
            for name, fn in cases.items():
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                dist.barrier()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                end.synchronize()
                ms[name] = start.elapsed_time(end) / 20
            t0 = time.perf_counter()
            for _ in range(20):
                ring.wait(ring.post([(x, 1), (x, -1)]))
            host_ms = (time.perf_counter() - t0) * 1e3 / 20
            torch.cuda.synchronize()
        times = torch.tensor([ms[k] for k in cases], device=dev)
        every = allgather(times[None], dim=0).tolist()
        peers = {i: torch.cuda.can_device_access_peer(dev, i)
                 for i in range(torch.cuda.device_count()) if i != dev.index}
        if r == 0:
            print(json.dumps({
                "mesh": {"data": hvd.size() // model, "model": model},
                "card": torch.cuda.get_device_name(dev), "reps": 20,
                "ms_rank0": ms, "ms_every_rank": {k: [row[i] for row in every]
                                                  for i, k in enumerate(cases)},
                "peer_access_rank0": peers, "ring_hop_b3_host_ms_per_call_rank0": host_ms,
            }), flush=True)
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--model", type=int, default=2, help="size of the model axis; data = ranks / model")
    ap.add_argument("--fused", action="store_true", help="the collective-matmul (B3/B4) path")
    ap.add_argument("--bench", action="store_true", help="time GPT-2-small, classic and fused")
    ap.add_argument("--primitives", action="store_true",
                    help="time one call of each primitive against NCCL collectives")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--variant", default="posthoc",
                    help=f"comma list of {', '.join(VARIANTS)} (the parity check)")
    args = ap.parse_args()
    if args.ranks % args.model:
        ap.error(f"--model {args.model} does not divide --ranks {args.ranks}")
    variants = args.variant.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown --variant {unknown}; choose from {list(VARIANTS)}")
    if (args.bench or args.primitives) and variants != ["posthoc"]:
        ap.error("--variant applies to the parity check")
    if "HOROVOD_RANK" not in os.environ:
        argv = ["--ranks", str(args.ranks), "--model", str(args.model),
                "--device", args.device or "cuda", "--variant", args.variant]
        argv += ["--fused"] * args.fused + ["--bench"] * args.bench
        argv += ["--primitives"] * args.primitives
        return launch_ranks("horovod_tpu_torch.tools.tp_parity", argv, args.ranks)
    if args.bench:
        _bench(args.device, args.model)
    elif args.primitives:
        _primitives(args.device, args.model)
    else:
        hvd, mesh = _setup(args.device, args.model)
        try:
            two_level = _two_level_mesh(hvd, args.model) if "two-level-dp" in variants else None
            for variant in variants:
                _parity(hvd, two_level if variant == "two-level-dp" else mesh, args.model,
                        args.fused, variant)
        finally:
            hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
