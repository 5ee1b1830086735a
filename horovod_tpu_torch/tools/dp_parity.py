"""Data-parallel parity: n ranks against one process that replays them.

    python -m horovod_tpu_torch.tools.dp_parity --ranks 4                # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --device cpu   # gloo on the CPU
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --model resnet18
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --variant overlap,zero1
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --bench --variant posthoc,overlap
    python -m horovod_tpu_torch.tools.dp_parity --ranks 4 --variant hierarchical,hierarchical-zero1

Every rank starts from its own random weights, and ``broadcast_parameters``
gives them rank 0's. The ranks then train a small GPT in f32 for a few
steps of ``make_train_step`` (``DistributedOptimizer`` over AdamW, a 1 MiB
fusion threshold so the gradients travel in several buckets), each on its
shard of one global batch. Rank 0 then trains a copy of its initial weights
on the whole batch in one process, with plain AdamW and no collective: the
average over equal shards of the mean-loss gradient is the whole-batch
gradient, so both runs must agree, and every rank must hold the same
parameters. Prints one JSON line from rank 0; exits non-zero on any
disagreement. The ranks rendezvous through a FileStore in a temporary
directory.

``--model resnet18`` holds the CNN step with BatchNorm state: a narrow
ResNet-18 (8 filters) in f32 at 32 px, SGD 0.01 with momentum 0.9. Each
rank also starts from its own running statistics, which
``broadcast_parameters`` must replace with rank 0's. BatchNorm normalises
each rank's shard with that shard's statistics, so n ranks are not one
whole-batch process: rank 0's reference replays the n shards one by one
from the same parameters and statistics, averages their gradients and
their new running statistics, and takes the SGD step. Every rank must
match it at the same tolerances, its running statistics within a hundredth
of the learning rate.

``--variant`` (a comma list) runs the GPT check once for each variant of
the DP step: ``posthoc`` (the default above), ``overlap`` (the streamed
reduction, 256 KiB first group), ``quantized`` (the int8 wire, error
feedback on), ``zero1``, ``zero1-quantized-overlap`` and ``skip`` (the
non-finite guard, with the last rank's gradients made NaN at the second
step, which every rank must skip and the whole-batch process leaves out),
and on a ``(cross 2, local n/2)`` mesh (``build_hierarchical_mesh``) through
``make_train_step(mesh=..., hierarchical=True)``: ``hierarchical`` (every
bucket two-level), ``hierarchical-quantized`` (int8 on the cross level
only), ``hierarchical-overlap``, ``hierarchical-zero1`` (the reduce-scatter
and all-gather two-level) and ``hierarchical-adasum``. Adasum combines the
node SUMS adaptively, which no whole-batch step computes: its reference
replays the n shards' gradients and combines each bucket by
``hierarchical_adasum_reference`` (float64) before the AdamW step.
Each prints its JSON line with the step time and
``torch.cuda.max_memory_allocated`` of every rank. posthoc, overlap, zero1
and skip hold the loss to 1e-6 relative and the parameters to the test's
tolerance; the int8 variants hold the loss to 1e-3 relative and the
parameters to what Adam can move in the steps run. Every variant's ranks
must hold identical parameters.

``--bench`` times the variants instead, at GPT-2-small (bf16, 8 x 1024 a
rank, AdamW): the median step of 20 after 3 warmup steps, then one step
under ``torch.profiler`` for its NCCL kernel time and the part of it no
other kernel overlapped (the exposed NCCL time), and the peak memory of
every rank above what was allocated when the variant began, beside the
card's name and power limit. A variant named twice runs twice, so
``posthoc,overlap,overlap,posthoc`` times two in turns. The profiled step's
device busy time (any kernel running) stands beside the step time: where
the step is much longer, the host sets it, and a rank's NCCL kernels then
also count the time they wait for the slowest rank's host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .launch import launch_ranks, store_url

DIMS = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, max_len=256)
PER_RANK_BATCH, SEQ, STEPS, LR = 2, 256, 3, 3e-4
VARIANTS = {
    "posthoc": {},
    "overlap": dict(overlap=True, first_bucket_bytes=1 << 18),
    "quantized": dict(quantized=True),
    "zero1": dict(zero1=True),
    "zero1-quantized-overlap": dict(zero1=True, quantized=True, overlap=True,
                                    first_bucket_bytes=1 << 18),
    "skip": dict(nonfinite="skip"),
    "hierarchical": dict(hierarchical=True),
    "hierarchical-quantized": dict(hierarchical=True, quantized=True),
    "hierarchical-overlap": dict(hierarchical=True, overlap=True, first_bucket_bytes=1 << 18),
    "hierarchical-zero1": dict(hierarchical=True, zero1=True),
    "hierarchical-adasum": dict(hierarchical=True, op="Adasum"),
}
INT8 = ("quantized", "zero1-quantized-overlap", "hierarchical-quantized")
THRESHOLD = 1 << 20
SKIPPED = 1         # the step the skip variant poisons
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP, BENCH_STEPS = 8, 1024, 3, 20
CNN_BATCH, CNN_SIDE, CNN_CLASSES, CNN_LR = 4, 32, 10, 0.01


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _judge(result, same, loss_rel, param_err, share, lr, extra_ok=True,
           loss_limit=1e-5, share_limit=1e-4) -> None:
    """Print rank 0's JSON line and fail on any disagreement (the tolerance
    of tests/test_torch_train.py, with its reasons)."""
    print(json.dumps(result), flush=True)
    ok = (same and loss_rel <= loss_limit and param_err <= 2 * lr * STEPS
          and share <= share_limit and extra_ok)
    if not ok:
        raise SystemExit("data-parallel run disagrees with its one-process reference")


def _cnn_worker(device) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet18

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        r, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        model = ResNet18(num_classes=CNN_CLASSES, num_filters=8, dtype=torch.float32,
                         device=dev, seed=r)
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.fill_(0.1 * r if name.endswith("mean") else 1.0 + 0.1 * r)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=CNN_LR, momentum=0.9),
            named_parameters=model.named_parameters(), fusion_threshold_bytes=1 << 18)
        rng = np.random.RandomState(0)
        images = torch.from_numpy(rng.randn(n * CNN_BATCH, CNN_SIDE, CNN_SIDE, 3)
                                  .astype(np.float32)).to(dev)
        labels = torch.from_numpy(rng.randint(0, CNN_CLASSES, n * CNN_BATCH)).to(dev)
        shards = [slice(s * CNN_BATCH, (s + 1) * CNN_BATCH) for s in range(n)]
        step = hvd.make_train_step(lambda m, b: F.cross_entropy(m(b[0]), b[1]), opt)
        losses = [float(step(model, (images[shards[r]], labels[shards[r]])))
                  for _ in range(STEPS)]

        flat = _flat(model.state_dict().values())
        gathered = hvd.allgather(flat[None])
        same = bool((gathered == gathered[0]).all())
        if r != 0:
            if not same:
                raise SystemExit("ranks hold different parameters or statistics")
            return

        ref = ResNet18(num_classes=CNN_CLASSES, num_filters=8, dtype=torch.float32,
                       device=dev, seed=0)
        ref.load_state_dict(initial)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=CNN_LR, momentum=0.9)
        buffers = dict(ref.named_buffers())
        ref_losses = []
        for _ in range(STEPS):
            ref_opt.zero_grad()
            start = {k: v.clone() for k, v in buffers.items()}
            new = {k: torch.zeros_like(v) for k, v in buffers.items()}
            shard_losses = []
            for sl in shards:
                for k, v in buffers.items():
                    v.copy_(start[k])
                loss = F.cross_entropy(ref(images[sl]), labels[sl])
                (loss / n).backward()
                shard_losses.append(loss.item())
                for k, v in buffers.items():
                    new[k] += v / n
            for k, v in buffers.items():
                v.copy_(new[k])
            ref_opt.step()
            ref_losses.append(sum(shard_losses) / n)
        params = [p for _, p in sorted(model.named_parameters())]
        ref_params = [p for _, p in sorted(ref.named_parameters())]
        diff = (_flat(params) - _flat(ref_params)).abs()
        stats_err = float((_flat(b for _, b in sorted(model.named_buffers()))
                           - _flat(b for _, b in sorted(ref.named_buffers()))).abs().max())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        result = {
            "model": "resnet18", "ranks": n, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "losses": losses, "replayed_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
            "share_beyond_1pct_step": float((diff > CNN_LR / 100).float().mean()),
            "max_stats_abs_err": stats_err,
            "stats_moved": bool(any((b - initial[k]).abs().max() > 0
                                    for k, b in model.named_buffers())),
            "ranks_identical": same,
        }
        _judge(result, same, loss_rel, result["max_param_abs_err"],
               result["share_beyond_1pct_step"], CNN_LR,
               extra_ok=stats_err <= CNN_LR / 100 and result["stats_moved"])
    finally:
        hvd.shutdown()


def _peaks(hvd, dev, base: int):
    """Every rank's peak memory in GiB over this variant: its
    ``max_memory_allocated`` less ``base``, what was allocated when the
    variant began (0 on the CPU)."""
    import torch

    peak = ((torch.cuda.max_memory_allocated(dev) - base) / 2**30 if dev.type == "cuda"
            else 0.0)
    return [round(float(v), 3) for v in hvd.allgather(torch.tensor([peak], device=dev))]


def _worker(variant: str) -> None:
    import time

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    r, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    base = _fresh_peak(dev)
    model = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=r)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    step = _make_step(hvd, model, variant, THRESHOLD)
    opt = step.optimizer
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    rng = np.random.RandomState(0)
    tokens, labels = (torch.from_numpy(rng.randint(0, DIMS["vocab_size"],
                                                   (n * PER_RANK_BATCH, SEQ))).to(dev)
                      for _ in range(2))
    shard = slice(r * PER_RANK_BATCH, (r + 1) * PER_RANK_BATCH)
    losses, times, skipped = [], [], []
    for s in range(STEPS):
        poison = float("nan") if variant == "skip" and s == SKIPPED and r == n - 1 else 1.0
        before = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(model, (tokens[shard], labels[shard],
                                         torch.tensor(poison, device=dev)))))
        times.append((time.perf_counter() - t0) * 1e3)
        after = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        skipped.append(bool(torch.equal(before, after)))

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    gathered = hvd.allgather(flat[None])
    same = bool((gathered == gathered[0]).all())
    skips = hvd.allgather(torch.tensor([skipped], device=dev))
    step_ms = [float(v) for v in hvd.allgather(torch.tensor([float(np.median(times))],
                                                            device=dev))]
    peaks = _peaks(hvd, dev, base)
    if r != 0:
        if not same:
            raise SystemExit("ranks hold different parameters")
        return

    ref = TransformerLM(**DIMS, dtype=torch.float32, device=dev, seed=0)
    ref.load_state_dict(initial)
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
    ref_losses = []
    for s in range(STEPS):
        ref_opt.zero_grad()
        if variant == "hierarchical-adasum":
            ref_losses.append(_adasum_replay(ref, tokens, labels, n))
            ref_opt.step()
            continue
        loss = lm_loss(ref(tokens), labels)
        if variant == "skip" and s == SKIPPED:
            ref_losses.append(float("nan"))     # every rank skips this step
            continue
        loss.backward()
        ref_opt.step()
        ref_losses.append(loss.item())
    ref_flat = torch.cat([p.detach().reshape(-1) for p in ref.parameters()])
    diff = (flat - ref_flat).abs()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)
                   if not np.isnan(b))
    skip_ok = True
    if variant == "skip":
        want = [s == SKIPPED for s in range(STEPS)]
        skip_ok = bool(all(row.tolist() == want for row in skips)
                       and np.isnan(losses[SKIPPED]))
    result = {
        "ranks": n, "device": str(dev), "variant": variant,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "losses": losses, "whole_batch_losses": ref_losses,
        "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
        "share_beyond_1pct_step": float((diff > LR / 100).float().mean()),
        "ranks_identical": same, "step_ms_median_by_rank": step_ms,
        "peak_memory_gib_by_rank": peaks,
        "streamed_groups": list(opt.streamed_groups),
        **({"skipped_by_rank": skips.tolist(), "skip_agreed": skip_ok}
           if variant == "skip" else {}),
    }
    int8 = variant in INT8
    _judge(result, same, loss_rel, result["max_param_abs_err"],
           result["share_beyond_1pct_step"], LR, extra_ok=skip_ok,
           loss_limit=1e-3 if int8 else 1e-6, share_limit=1.0 if int8 else 1e-4)


def _make_step(hvd, model, variant: str, threshold=None):
    """The DP step of ``variant``: a ``DistributedOptimizer`` over AdamW
    with its options, or for a hierarchical variant ``make_train_step`` on a
    ``(cross 2, local n/2)`` mesh with a plain AdamW. The step's
    ``optimizer`` is the ``DistributedOptimizer``."""
    import torch

    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh

    kw = dict(VARIANTS[variant])
    if "op" in kw:
        kw["op"] = getattr(hvd, kw["op"])
    adamw = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8)
    loss_fn = lambda m, b: lm_loss(m(b[0]), b[1]) * b[2]   # noqa: E731 - b[2]: 1 or NaN
    if kw.get("hierarchical"):
        n = hvd.size()
        if n % 2:
            raise SystemExit(f"--variant {variant} needs an even number of ranks")
        step = hvd.make_train_step(loss_fn, adamw, mesh=build_hierarchical_mesh(n // 2),
                                   fusion_threshold_bytes=threshold, **kw)
        step.optimizer.bind_module(model)
        return step
    opt = hvd.DistributedOptimizer(adamw, named_parameters=model.named_parameters(),
                                   fusion_threshold_bytes=threshold, **kw)
    return hvd.make_train_step(loss_fn, opt)


def _adasum_replay(ref, tokens, labels, n: int) -> float:
    """One hierarchical-Adasum step's gradients in one process: each of the
    n shards' gradients, combined bucket by bucket (the fusion plan of the
    step, in the JAX package's leaf order) as node sums of n/2 ranks by
    ``hierarchical_adasum_reference`` in float64, written into ``.grad``.
    Returns the mean of the shards' losses."""
    import torch

    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.adasum import hierarchical_adasum_reference

    tree = fusion.named_tree(list(ref.named_parameters()))
    leaves = fusion.tree_leaves(tree)
    grads, losses = [], []
    for r in range(n):
        rows = slice(r * PER_RANK_BATCH, (r + 1) * PER_RANK_BATCH)
        loss = lm_loss(ref(tokens[rows]), labels[rows])
        grads.append(torch.autograd.grad(loss, leaves))
        losses.append(loss.item())
    for bucket in fusion.plan_buckets(leaves, THRESHOLD):
        packed = [fusion.pack_bucket([g[i] for i in bucket]).double().cpu().numpy()
                  for g in grads]
        combined = torch.from_numpy(hierarchical_adasum_reference(packed, n // 2))
        for i, g in zip(bucket, fusion.unpack_bucket(combined.float().to(leaves[0].device),
                                                     [leaves[i].shape for i in bucket])):
            leaves[i].grad = g.clone()
    return sum(losses) / n


def _exposed_ms(prof) -> tuple:
    """(NCCL kernel ms, exposed NCCL ms, device busy ms) of a profiled step:
    the NCCL kernels' time, the part of it during which no other kernel
    ran, and the time any kernel ran."""
    import torch

    kernels = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower())
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    nccl = sorted((a, b) for a, b, is_nccl in kernels if is_nccl)
    other = sorted((a, b) for a, b, is_nccl in kernels if not is_nccl)
    total = sum(b - a for a, b in nccl)

    def merged(spans):
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    busy = merged(other)
    covered = 0.0
    for a, b in merged(nccl):
        covered += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    exposed = sum(b - a for a, b in merged(nccl)) - covered
    busy = sum(b - a for a, b in merged(sorted(nccl + other)))
    return total / 1e3, exposed / 1e3, busy / 1e3


def _fresh_peak(dev) -> int:
    """Free what an earlier variant left (its optimizer and hooks form
    reference cycles), restart the peak-memory count and return the bytes
    still allocated, which the variant's peak is counted above."""
    import gc

    import torch

    gc.collect()
    if dev.type != "cuda":
        return 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _bench_worker(variant: str) -> None:
    """Time one variant of the DP step at GPT-2-small on every rank."""
    import subprocess
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    r, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    base = _fresh_peak(dev)
    dims = GPT2_SMALL if dev.type == "cuda" else dict(DIMS)
    batch, seq = (BENCH_BATCH, BENCH_SEQ) if dev.type == "cuda" else (PER_RANK_BATCH, SEQ)
    model = TransformerLM(**dims, dtype=torch.bfloat16, device=dev, seed=0)
    step = _make_step(hvd, model, variant)
    opt = step.optimizer
    rng = np.random.RandomState(r)
    tokens, labels = (torch.from_numpy(rng.randint(0, dims["vocab_size"], (batch, seq)))
                      .to(dev) for _ in range(2))
    one = torch.tensor(1.0, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, times = [], []
    for i in range(BENCH_WARMUP + BENCH_STEPS):
        sync()
        t0 = time.perf_counter()
        losses.append(float(step(model, (tokens, labels, one))))
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(model, (tokens, labels, one)))
        sync()
    nccl_ms, exposed_ms, busy_ms = _exposed_ms(prof)
    row = torch.tensor([float(np.median(times[BENCH_WARMUP:])), nccl_ms, exposed_ms, busy_ms],
                       device=dev)
    rows = hvd.allgather(row[None]).tolist()
    peaks = _peaks(hvd, dev, base)
    if r == 0:
        card = "cpu"
        if dev.type == "cuda":
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                 "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
        print(json.dumps({
            "bench": variant, "ranks": n, "card": card,
            "model": "GPT-2-small" if dev.type == "cuda" else "parity GPT",
            "batch_per_rank": batch, "seq": seq, "dtype": "bf16",
            "step_ms_median_by_rank": [x[0] for x in rows],
            "nccl_ms_by_rank": [x[1] for x in rows],
            "exposed_nccl_ms_by_rank": [x[2] for x in rows],
            "device_busy_ms_by_rank": [x[3] for x in rows],
            "peak_memory_gib_by_rank": peaks,
            "streamed_groups": list(opt.streamed_groups),
            "losses_first_last": [losses[0], losses[-1]],
        }), flush=True)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{variant}: non-finite loss {losses}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--model", default="gpt", choices=["gpt", "resnet18"])
    ap.add_argument("--variant", default="posthoc",
                    help=f"comma list of {', '.join(VARIANTS)} (the GPT only)")
    ap.add_argument("--bench", action="store_true",
                    help="time the variants at GPT-2-small instead of checking parity")
    args = ap.parse_args()
    variants = args.variant.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown --variant {unknown}; choose from {list(VARIANTS)}")
    if args.model == "resnet18" and (args.bench or variants != ["posthoc"]):
        ap.error("--variant and --bench apply to the GPT")
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.dp_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda",
                             "--model", args.model, "--variant", args.variant]
                            + (["--bench"] if args.bench else []),
                            args.ranks)
    if args.model == "resnet18":
        _cnn_worker(args.device)
        return 0
    import horovod_tpu_torch as hvd

    hvd.init(args.device, init_method=store_url())
    try:
        for variant in variants:
            (_bench_worker if args.bench else _worker)(variant)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
