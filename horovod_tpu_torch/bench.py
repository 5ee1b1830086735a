"""Synthetic benchmark of the port: the counterpart of ``bench.py``'s
default paths (the data-parallel CNN step, ``--model transformer`` and
``--model moe``).

    python -m horovod_tpu_torch.bench                        # ResNet-50, 32 x 224² a card
    python -m horovod_tpu_torch.bench --model transformer    # GPT-2-small, 8 x 1024 a card
    python -m horovod_tpu_torch.bench --model moe            # Switch MoE, 32 x 1024 tokens a card
    python -m horovod_tpu_torch.bench --ranks 4              # one process per card, NCCL
    python -m horovod_tpu_torch.bench --smoke --device cpu   # tiny shapes, gloo on the CPU

Prints ONE JSON line from rank 0, with ``bench.py``'s metric names and
``detail`` keys: ``<model>_synthetic_images_per_sec_per_chip`` (img/s per
card, the mean over ``--num-iters`` timed iterations of
``--num-batches-per-iter`` steps each, after ``--num-warmup-batches``
steps), ``transformer_synthetic_tokens_per_sec_per_chip`` or
``moe_synthetic_tokens_per_sec_per_chip``.

The CNN step is ``bench.py``'s: ``get_model(name)`` in bf16 with f32
parameters and statistics, SGD 0.01 with momentum 0.9 through
``DistributedOptimizer`` (the fusion-bucketed allreduce), the mean softmax
cross-entropy, BatchNorm on each rank's shard with the running statistics
averaged over ranks after the update (``make_train_step``). The
transformer step is the DP GPT step of ``chip_smoke.py``'s ``[slice]``:
AdamW 3e-4, weight decay 1e-4. Images and tokens are drawn from
``--seed`` with numpy, the whole global batch on every rank, each rank
training on its rows.

``mfu`` is the step's FLOPs (``torch.utils.flop_counter.FlopCounterMode``
over one step: the matrix products and convolutions PyTorch dispatches,
forward and backward, 2 FLOPs a multiply-add, and flash attention by its
ops' formula, ``ops/flash_attention.flash_fwd_flops``, the same on the card
and on the CPU) times the steps of the fastest iteration over its time and
the dense bf16 peak of the detected card; null on the CPU and whenever the
share reads over 1.
The card's power limit stands beside it.

``--model moe`` is ``bench.py``'s ``run_moe_benchmark`` (``build_moe``):
d_model 512, d_hidden 2048, 4 Switch layers of 16 experts, vocab 32768,
``--batch-size`` x ``--seq-len`` tokens a card (32 x 1024), bf16 compute over
f32 master weights, AdamW 3e-4, on a ``{"data": n / ep, "expert": ep}`` mesh
with ep 4 where 4 divides the card count, else 2, else 1; ``detail`` carries
``mesh`` and the first step's loss as ``initial_loss``, and MFU falls back to
``_analytic_flops_moe`` where the flop counter undercounts.

``--overlap``, ``--zero1`` and ``--quantized`` are ``bench.py``'s: the
streamed reduction (``DistributedOptimizer(overlap=True)``), ZeRO-1 (the
transformer only: the streamed per-bucket form with ``--overlap``, else the
whole-vector ``parallel/zero.make_zero1_train_step``, as ``bench.py`` runs
``zero1_update``) and the int8 wire (the transformer only), error feedback
off as in ``bench.py``. ``detail`` reports them as ``optimizer_state``,
``gradient_wire`` and ``reduction_mode`` with ``bench.py``'s values.

``--micro`` is ``bench.py``'s: the eager-against-floor allreduce sweep of
``utils/micro_bench.py`` runs first, at ``--ranks`` ranks (default 2) one
card each, and its rows go into ``detail["micro_allreduce"]``.

``--serve`` is ``bench.py``'s ``run_serve_benchmark``: ``--serve-clients``
closed-loop client threads each keep one request in flight against a live
``serve.ServeEngine`` (f32 compute and cache, page size 8, ``max(64, 8 x
max batch)`` pages), after one warmup request outside the timed window;
one JSON line ``serve_decode_tokens_per_sec`` with the latency percentiles,
requests/s and the mean batch occupancy. The model is GPT-2-small at
``max_len`` 1024 (the reference's 256-wide 2-layer model would time only
the host); ``--smoke`` keeps the reference's smoke geometry. It runs on one
card, or tensor-parallel with ``--tp`` (below).

``--tp N`` is ``bench.py``'s composed DP x TP mode (the transformer only):
the ranks form a ``{"data": ranks / N, "model": N}`` mesh, each cuts the
seeded GPT to its shards by ``--rules`` (default ``gpt``;
``utils/convert.local_params_from_flax``) and trains them with
``make_train_step(rules=...)``, one all-reduce per Megatron half-block on the
model group, or with ``--tp-overlap`` the collective-matmul rings (kernels B3
and B4 on the card); ``--overlap``, ``--quantized`` and ``--zero1`` act on
the data group only. Every rank takes its data rows of one global batch of
``--batch-size`` x data ranks sequences. ``detail`` gains ``mesh`` and
``rules``, and the mode ``+tp<N>``. ``--serve --tp N`` serves
tensor-parallel over N ranks, one card each (``serve(mesh=..., rules=...)``:
rank 0 the engine, the others followers), as ``tools/serve_parity --bench``
does at model N.

The transformer's ``detail`` carries ``bench.py``'s three blocks:

- ``wire``: the gradient bytes a card reduces and what one step puts on the
  wire a card by the ring accounting of ``ops/fusion.ring_wire_bytes`` (the
  formula of the ``hvd_axis_wire_bytes_total`` tap): the full-precision
  bytes, the savings of the int8 wire, ZeRO-1's reduce-scatter and
  all-gather apart, and under ``--tp`` the ``per_axis`` split, ``data``
  (the local shards' ring) and ``model`` (the activation all-reduces, bf16,
  four a layer, priced the same way);
- ``step_skew``: the step spans (the trace tap's when it is armed, else
  the timed iterations') and, over ``--ranks``, the real cross-rank skew:
  the spread of the ranks' host times at each timed step's end, its p50 and
  p99, and the rank most often last (``bench.py``'s single controller
  reports zeros there);
- ``sim``: the port's fleet simulator (``sim/``) priced on the detected
  card's row of the interconnect model (``h100`` on an H100), or on the
  ``--calibration`` file (``tools/fleet_sim --calibrate``), predicting this
  program's step at this data size beside the measured one, with the
  tensor-parallel term under ``--tp``.

On the card the transformer's ``detail`` also counts this rank's launches
of the hand-written kernels a timed step (``kernel_launches_per_step``: B1's
forwards and backward pairs, B3 and B4).

``--tuned <tuned.json>`` is ``bench.py``'s: a pin whose signature matches
the live step (the module's parameter names, shapes and dtypes on the flat
``{"data": ranks}`` mesh) gives its fusion threshold, first bucket and wire
(``--quantized`` wins), the mode gains ``+tuned`` and ``detail["tuned"]``
names the file, signature and knobs; a stale pin warns and runs untuned,
and ``--quantized`` refuses a pin made on another mesh.

``--scan`` (on by default, as in ``bench.py``; ``--no-scan`` turns it
off) is ``bench.py``'s on-device loop: each timed iteration is one call of
``utils/step_graph.capture_step`` over ``--num-batches-per-iter`` steps. On
the card that call replays one captured CUDA graph of the DP step that
many times, with no host round-trip between the steps; AdamW is built
``capturable=True`` for it. The first warm-up step (the FLOP count) runs
eagerly, the other warm-up steps on a side stream before the capture; on
the CPU the call runs the same steps eagerly, so ``--scan`` and
``--no-scan`` end on the same loss there. ``--tp`` turns it off with
``bench.py``'s stderr line; ``--model moe`` and ``--serve`` report
``"scan": false``. ``detail`` reports ``scan`` and, under it,
``scan_form`` (what a call runs); ``kernel_launches_per_step`` is then the
capture's, the launches every replay repeats.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from typing import Optional

import numpy as np

# The reference's published tf_cnn_benchmarks ResNet figure, 1656.82 img/s
# on 16 GPUs (docs/benchmarks.rst:29-43), as bench.py:40-46 has it.
BASELINE_IMG_PER_SEC_PER_CHIP = {
    "resnet18": 1656.82 / 16.0,
    "resnet34": 1656.82 / 16.0,
    "resnet50": 1656.82 / 16.0,
    "resnet101": 1656.82 / 16.0,
    "resnet152": 1656.82 / 16.0,
}

# Dense bf16 tensor-core peak per card, by substring of the device name
# (NVIDIA's data sheets, at each part's full power limit), most specific
# first.
PEAK_BF16_FLOPS = [
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),    # SXM ("NVIDIA H100 80GB HBM3")
    ("H200", 989e12),
]

# Analytic forward FLOPs per image at each model's native side (bench.py:64-93).
ANALYTIC_FWD_FLOPS_PER_IMAGE = {
    "resnet18": (3.6e9, 224),
    "resnet34": (7.3e9, 224),
    "resnet50": (8.2e9, 224),
    "resnet101": (15.2e9, 224),
    "resnet152": (22.6e9, 224),
    "vgg16": (31.0e9, 224),
    "inception3": (11.4e9, 299),
}

CNN_MODELS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "vgg16",
              "inception3"]
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
GPT_SMOKE = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2)

# bench.py:1361-1364: the serving benchmark's smoke geometry.
SERVE_SMOKE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, max_len=64)
# bench.py:1206-1214: the Switch MoE stack and its smoke dims.
MOE_DIMS = dict(d_model=512, d_hidden=2048, n_layers=4, experts=16, vocab=32768)
MOE_SMOKE = dict(d_model=64, d_hidden=128, n_layers=2, experts=8, vocab=512)
# The file of the micro-benchmark's record, for the bench's rank 0 (--micro).
MICRO_ROWS_VAR = "HVD_BENCH_MICRO_ROWS"


def _analytic_flops_cnn(model, image_size, batch_per_chip):
    """Per-card training-step FLOPs from the public per-model tables:
    backward ~= 2x forward, so train = 3x forward."""
    entry = ANALYTIC_FWD_FLOPS_PER_IMAGE.get(model)
    if entry is None:
        return None
    fwd_native, native_side = entry
    return 3.0 * fwd_native * (image_size / native_side) ** 2 * batch_per_chip


def _analytic_flops_lm(n_params, n_layers, d_model, batch_per_chip, seq_len):
    """Per-card training-step FLOPs: 6 N tokens plus the quadratic
    attention term (4 L T^2 d forward, x3 for train)."""
    return (6.0 * n_params * batch_per_chip * seq_len
            + 12.0 * n_layers * batch_per_chip * seq_len ** 2 * d_model)


def _reconcile_flops(measured, analytic, platform):
    """Pick the per-step FLOPs MFU is computed from (bench.py's rule): the
    measurement, unless off the CPU it undercounts the analytic table by
    more than 2x; disagreements are logged. Returns (flops, source)."""
    if measured is None and analytic is None:
        return None, None
    if measured is None:
        return analytic, "analytic"
    if analytic is None:
        return measured, "flop-counter"
    ratio = measured / analytic
    if platform == "cpu" or ratio >= 0.5:
        if not 0.5 <= ratio <= 2.0:
            print(f"[bench] flop-counter FLOPs ({measured:.3g}) vs analytic table "
                  f"({analytic:.3g}): {ratio:.2g}x apart — keeping the flop counter",
                  file=sys.stderr, flush=True)
        return measured, "flop-counter"
    print(f"[bench] flop-counter FLOPs ({measured:.3g}) undercounts the analytic table "
          f"({analytic:.3g}) by {1 / ratio:.2g}x — using analytic",
          file=sys.stderr, flush=True)
    return analytic, f"analytic (flop-counter undercounts {1 / ratio:.2g}x)"


def _peak_flops(device_name: str):
    for key, peak in PEAK_BF16_FLOPS:
        if key in device_name:
            return peak
    return None


def _mfu(flops_per_step, steps, best_dt, device_name):
    """Model-FLOPs utilization of the fastest iteration against the card's
    dense bf16 peak; None without a known peak, and None (logged) when it
    reads over 1, which only a wrong count or clock can give."""
    peak = _peak_flops(device_name)
    if flops_per_step is None or peak is None:
        return None
    mfu = flops_per_step * steps / best_dt / peak
    if mfu > 1.0:
        print(f"[bench] computed mfu {mfu:.3f} > 1.0 — FLOPs accounting inconsistent with "
              "throughput; publishing null", file=sys.stderr, flush=True)
        return None
    return round(mfu, 4)


def _power_limit(device) -> str:
    """``nvidia-smi``'s power limit of the card, or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip() or "not measured"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50",
                    choices=CNN_MODELS + ["transformer", "moe"])
    ap.add_argument("--batch-size", type=int, default=32, help="per-card batch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seq-len", type=int, default=1024, help="transformer: sequence length")
    ap.add_argument("--num-warmup-batches", type=int, default=5)
    ap.add_argument("--num-batches-per-iter", type=int, default=50)
    ap.add_argument("--num-iters", type=int, default=3)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--smoke", action="store_true", help="tiny shapes for CPU sanity runs")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the data")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo on the CPU; default: the card (one per rank)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to launch on this host, one per card (bench.py's --devices); "
                         "default 1, and 2 for the --micro sweep")
    ap.add_argument("--overlap", action="store_true",
                    help="streamed reduction: each layer group's buckets reduce inside the "
                         "backward")
    ap.add_argument("--zero1", action="store_true",
                    help="transformer: shard the optimizer state over the ranks (ZeRO-1)")
    ap.add_argument("--quantized", action="store_true",
                    help="transformer: int8 gradient wire (the ring allreduce; the ring "
                         "reduce-scatter with --zero1)")
    ap.add_argument("--micro", action="store_true",
                    help="also run the eager-against-floor allreduce micro-benchmark at "
                         "--ranks ranks (default 2), one card each (detail.micro_allreduce)")
    ap.add_argument("--serve", action="store_true",
                    help="closed-loop benchmark of the serving engine: N clients each keep "
                         "one request in flight; tokens/s, p50/p99 latency, batch occupancy")
    ap.add_argument("--serve-clients", type=int, default=8,
                    help="--serve: concurrent closed-loop clients")
    ap.add_argument("--serve-requests", type=int, default=64,
                    help="--serve: total requests across clients")
    ap.add_argument("--serve-max-batch", type=int, default=8,
                    help="--serve: engine max batch size")
    ap.add_argument("--serve-max-wait-us", type=int, default=2000,
                    help="--serve: batcher head deadline")
    ap.add_argument("--serve-max-tokens", type=int, default=16,
                    help="--serve: tokens generated per request")
    ap.add_argument("--serve-replicas", type=int, default=1,
                    help="--serve: DP serving replicas")
    ap.add_argument("--scan", action=argparse.BooleanOptionalAction, default=True,
                    help="fold each iteration's batches into one call: a captured CUDA graph "
                         "of the step replayed --num-batches-per-iter times (utils/step_graph)")
    ap.add_argument("--tp", type=int, default=0,
                    help="transformer: composed DP x TP, the model sharded N ways over a "
                         "'model' mesh axis by the sharding rules (make_train_step(rules=...)); "
                         "--overlap/--quantized/--zero1 act on the data axis only; with "
                         "--serve, the tensor-parallel server on N ranks")
    ap.add_argument("--tp-overlap", action="store_true",
                    help="with --tp N: the collective-matmul rings (kernels B3/B4) in place of "
                         "the tensor-parallel all-reduces")
    ap.add_argument("--rules", default="", choices=["", "gpt"],
                    help="sharding-rules table for --tp (default: gpt)")
    ap.add_argument("--calibration", default="",
                    help="transformer: a calibration.json (tools/fleet_sim --calibrate) pricing "
                         "the report's sim block; default: the detected card's row")
    ap.add_argument("--tuned", default="",
                    help="a tuned.json (python -m horovod_tpu_torch.tools.autotune_compiled): "
                         "its knobs apply when its signature matches this run's step; "
                         "explicit flags win")
    args = ap.parse_args(argv)
    if args.serve:
        # bench.py's refusals: serving has no optimizer, backward or gradients.
        for flag in ("zero1", "overlap", "quantized"):
            if getattr(args, flag):
                ap.error(f"--serve benchmarks the inference decode path: --{flag} acts on "
                         f"the gradients of training, which serving has none of — drop "
                         f"--{flag}")
        if args.micro:
            ap.error("--serve runs the serving engine; --micro does not apply")
        if args.tp:
            args.ranks = args.ranks or args.tp
            if args.ranks != args.tp:
                ap.error(f"--serve --tp {args.tp} serves on {args.tp} ranks, one card each "
                         f"(the model axis); --ranks {args.ranks} does not match")
        elif (args.ranks or 1) > 1:
            ap.error("--serve runs one engine on one card, or tensor-parallel with --tp N "
                     "on N ranks")
        args.model = "transformer"
    if args.zero1 and args.model != "transformer":
        ap.error("--zero1 is implemented for --model transformer only")
    if args.quantized and args.model != "transformer":
        ap.error("--quantized applies to --model transformer only")
    if args.tp and args.model != "transformer":
        ap.error("--tp applies to --model transformer only")
    if args.rules and not args.tp:
        ap.error("--rules needs --tp N (the composed DP x TP mode)")
    if args.tp and args.tp < 2:
        ap.error("--tp needs a model-axis degree >= 2")
    if args.tp_overlap and not args.tp:
        ap.error("--tp-overlap fuses the TENSOR-PARALLEL psums into chunked "
                 "collective-matmul rings — without --tp N there is no "
                 "model axis and no TP psum to fuse; add --tp N (N >= 2)")
    if args.tp and not args.rules:
        args.rules = "gpt"
    if args.model == "moe" and (args.overlap or args.micro):
        ap.error("--model moe runs the DP x EP step; --overlap and --micro do not apply")
    if args.micro and args.ranks == 1:
        ap.error("--micro needs at least 2 ranks, one card each")
    args.micro_ranks = (args.ranks or 2) if args.micro else 0
    args.ranks = args.ranks or 1
    if args.ranks < 1:
        ap.error("--ranks must be at least 1")
    if args.tp and args.ranks % args.tp:
        ap.error(f"--tp {args.tp} does not divide --ranks {args.ranks}")
    if args.smoke and args.serve:
        args.serve_clients = min(args.serve_clients, 4)
        args.serve_requests = min(args.serve_requests, 16)
    if args.smoke:
        if args.model == "transformer":
            args.batch_size, args.seq_len = 2, 128
        elif args.model == "moe":
            args.batch_size, args.seq_len = 2, 64
        else:
            args.batch_size, args.image_size, args.num_classes = 4, 64, 100
            if args.model == "inception3":
                args.image_size = 96   # the stem's VALID convolutions need >= 75 px
        args.num_batches_per_iter, args.num_iters = 2, 2
    return args


def reduction_mode(args, quantized: Optional[bool] = None, tuned: bool = False) -> str:
    """``bench.py``'s ``reduction_mode`` for these flags (``quantized``: the
    wire in effect, where a pin turned it on; ``tuned``: a pin applied)."""
    q = args.quantized if quantized is None else quantized
    mode = (("overlap+" if args.overlap else "")
            + ("quantized" if q else ("streamed" if args.overlap else "posthoc")))
    return (mode + ("+zero1" if args.zero1 else "") + (f"+tp{args.tp}" if args.tp else "")
            + ("+tuned" if tuned else ""))


def _resolve_tuned(args, model, n: int):
    """Resolve ``--tuned`` against the live step (the module's parameters on
    the flat ``{"data": n}`` mesh), as ``bench.py:_resolve_tuned``: returns
    ``(step_kwargs or None, detail block or None)``. The block lands in the
    report matched or not, so a capture names the knobs that produced it; a
    ``--quantized`` run refuses a pin made on another mesh."""
    if not args.tuned:
        return None, None
    from . import tune as T

    cfg = T.load_tuned(args.tuned)
    live = T.step_signature(model, mesh={"data": n})
    matched = T.signatures_match(cfg.signature, live)
    if not matched:
        tuned_mesh, live_mesh = T.mesh_axes_hash(cfg.signature), T.mesh_axes_hash(live)
        if args.quantized and tuned_mesh != live_mesh:
            # The int8 wire's verdict is a function of the mesh's hop
            # ladder: a pin made on another mesh cannot vouch for it.
            raise SystemExit(
                f"bench: refusing --quantized with --tuned {args.tuned}: the tuning was "
                f"pinned on mesh-axes hash {tuned_mesh} but this run's mesh axes hash to "
                f"{live_mesh} — re-run horovod_tpu_torch.tools.autotune_compiled on THIS "
                f"mesh (or drop --quantized/--tuned)")
        why = (f"mesh-axes hash {tuned_mesh} (pinned) vs {live_mesh} (live)"
               + ("; params half matches" if T.params_match(cfg.signature, live)
                  else "; params half differs too"))
        print(f"[bench] tuned signature mismatch: {why}", file=sys.stderr, flush=True)
        T.warn_signature_mismatch(cfg, live.get("hash", "?"), "bench")
    T.note_applied("file", cfg.signature_hash, matched, "bench")
    detail = {"path": args.tuned, "program": cfg.program, "signature": cfg.signature_hash,
              "matched": bool(matched), "knobs": dict(cfg.knobs) if matched else None}
    return (T.tuned_step_kwargs(cfg) if matched else None), detail


def _build_cnn(args, dev, rank, n):
    """The CNN, its global batch's rows for this rank and the loss."""
    import torch
    import torch.nn.functional as F

    from .models import get_model

    kw = {"image_size": args.image_size} if args.model.startswith("vgg") else {}
    model = get_model(args.model, num_classes=args.num_classes, device=dev, seed=args.seed,
                      **kw)
    rows = slice(rank * args.batch_size, (rank + 1) * args.batch_size)
    images = np.random.RandomState(args.seed).randn(
        n * args.batch_size, args.image_size, args.image_size, 3).astype(np.float32)[rows]
    labels = np.random.RandomState(args.seed + 1).randint(
        0, args.num_classes, (n * args.batch_size,))[rows]
    batch = (torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev))
    return model, batch, lambda m, b: F.cross_entropy(m(b[0]), b[1])


def _build_transformer(args, dev, rank, n):
    import torch

    from .models.transformer import TransformerLM, lm_loss

    dims = GPT_SMOKE if args.smoke else GPT2_SMALL
    model = TransformerLM(**dims, max_len=args.seq_len, dtype=torch.bfloat16, device=dev,
                          seed=args.seed)
    rng = np.random.RandomState(args.seed)
    rows = slice(rank * args.batch_size, (rank + 1) * args.batch_size)
    tokens, labels = (torch.from_numpy(rng.randint(0, dims["vocab_size"],
                                                   (n * args.batch_size, args.seq_len))[rows])
                      .to(dev) for _ in range(2))
    return model, (tokens, labels), lambda m, b: lm_loss(m(b[0]), b[1])


def _launch_counts(reset: bool = False) -> dict:
    """This rank's launches of the hand-written kernels (B1's forward and
    backward pairs, B3, B4) since the last reset."""
    from .ops import collective_matmul as cm
    from .ops import flash_attention as fa
    from .utils.step_graph import kernel_launches

    if reset:
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = cm.AGMM_LAUNCHES = cm.MRS_LAUNCHES = 0
    return kernel_launches()


def build_dp_step(args, model, loss_fn, tk: dict, quantized: bool):
    """The bench's DP step over ``model``: AdamW 3e-4 (weight decay 1e-4)
    for the transformer, SGD 0.01 with momentum 0.9 for a CNN, through
    ``DistributedOptimizer`` with the data-axis flags and the pin's knobs
    ``tk`` (the whole-vector ZeRO-1 step for ``--zero1`` without
    ``--overlap``). Under ``--scan`` on the card AdamW is built
    ``capturable=True``, with its step count on the card, so that a CUDA
    graph replays it; SGD is capturable as it is."""
    import torch

    import horovod_tpu_torch as hvd

    on_card = next(model.parameters()).device.type == "cuda"
    if args.model == "transformer":
        inner = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8,
                                  capturable=bool(args.scan and on_card))
    else:
        inner = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    if args.zero1 and not args.overlap:
        from .parallel.zero import make_zero1_train_step

        return make_zero1_train_step(loss_fn, inner, quantized=quantized)
    opt = hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(), overlap=args.overlap,
        zero1=args.zero1, quantized=quantized, error_feedback=False if quantized else None,
        fusion_threshold_bytes=tk.get("fusion_threshold_bytes"),
        first_bucket_bytes=tk.get("first_bucket_bytes"), tuned=False)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    return hvd.make_train_step(loss_fn, opt)


def _build_composed(args, model, dev, tk: dict, quantized: bool):
    """The composed DP x TP step over ``model``'s weights (the same on every
    rank): ``(step, this rank's shards, the global batch)``, as
    ``tools/tp_parity --bench`` builds it."""
    import torch

    from .models.transformer import make_gpt_loss_fn
    from .ops.fusion import tree_leaves
    from .parallel.mesh import build_mesh
    from .train import make_train_step
    from .utils.convert import local_params_from_flax, params_to_numpy

    n = torch.distributed.get_world_size()
    mesh = build_mesh({"data": n // args.tp, "model": args.tp})
    params = local_params_from_flax(params_to_numpy(model), args.rules, mesh, device=dev)
    dims = GPT_SMOKE if args.smoke else GPT2_SMALL
    step = make_train_step(
        make_gpt_loss_fn(dims["n_heads"], model_axis="model"),
        torch.optim.AdamW(tree_leaves(params), lr=3e-4, weight_decay=1e-4, eps=1e-8),
        mesh=mesh, rules=args.rules, overlap=args.overlap, quantized=quantized,
        zero1=args.zero1, tp_overlap=True if args.tp_overlap else None,
        fusion_threshold_bytes=tk.get("fusion_threshold_bytes"),
        first_bucket_bytes=tk.get("first_bucket_bytes"))
    rng = np.random.RandomState(args.seed)
    rows = (n // args.tp) * args.batch_size
    batch = tuple(torch.from_numpy(rng.randint(0, dims["vocab_size"], (rows, args.seq_len)))
                  .to(dev) for _ in range(2))
    return step, params, batch


def wire_block(args, reduced, dp: int, quantized: bool, dims: dict):
    """``bench.py``'s ``wire`` block by the ring accounting of
    ``ops/fusion.ring_wire_bytes``, over the leaves a card reduces over the
    data group (its shards under ``--tp``); returns it and, under ``--tp``,
    the model axis's block."""
    from .ops.fusion import ring_wire_bytes

    grad_bytes = int(sum(t.numel() * t.element_size() for t in reduced))
    wire_dtype = "int8" if quantized else "f32"
    full = ring_wire_bytes(grad_bytes, dp, "allreduce")
    tp_block = None
    if args.tp:
        payload = args.batch_size * args.seq_len * dims["d_model"] * 2     # bf16
        psums = 4 * dims["n_layers"]                 # forward psums and their conjugates
        tp_block = {
            "psum_payload_bytes": int(payload),
            "psums_per_step": int(psums),
            "bytes_on_wire_per_step_per_chip": psums * ring_wire_bytes(payload, args.tp),
            "wire_dtype": "bf16 (never quantized, never re-planned)",
            # The fused pair moves the same bytes, inside the products.
            "path": "collective_matmul (fused)" if args.tp_overlap else "psum (classic)",
        }
    rs = ag = None
    if args.zero1:
        rs = ring_wire_bytes(grad_bytes, dp, "reduce_scatter", wire_dtype)
        ag = ring_wire_bytes(grad_bytes, dp, "all_gather")
        wire = rs + ag
    else:
        wire = ring_wire_bytes(grad_bytes, dp, "allreduce", wire_dtype)
    block = {
        "gradient_bytes": grad_bytes,
        "bytes_on_wire_per_step_per_chip": wire,
        "full_precision_bytes_on_wire_per_step_per_chip": full,
        "savings_ratio": round(1.0 - wire / full, 4) if full else 0.0,
    }
    if args.zero1:
        block.update({
            "reduce_scatter_bytes_per_step_per_chip": rs,
            "all_gather_bytes_per_step_per_chip": ag,
            "gradient_reduction_savings_ratio": round(1.0 - rs / (full / 2), 4) if full else 0.0,
        })
    if tp_block:
        block["per_axis"] = {
            "data": {"bytes_on_wire_per_step_per_chip": wire,
                     "local_gradient_bytes": grad_bytes, "dp_degree": dp},
            "model": dict(tp_block, tp_degree=args.tp),
        }
    return block, tp_block


def step_skew_block(args, iter_times, step_ends, rank: int, n: int,
                    steps_per_span: int = 1) -> dict:
    """``bench.py``'s ``step_skew`` block. The step spans are the trace
    tap's when it is armed (one span a timed call, ``steps_per_span`` steps:
    a graph's replays under ``--scan`` on the card), else the timed
    iterations'. Over ``n > 1``
    ranks (a collective: every rank calls it) the skew is real: for each
    timed call, the spread of the ranks' host clocks at its end, with the
    rank most often last."""
    import collections

    import torch.distributed as dist

    from . import trace as _trace

    steps = args.num_batches_per_iter
    spans = _trace.step_summary()
    if not spans.get("steps"):
        per_step = sorted(dt / steps for dt in iter_times)
        spans = {"steps": steps * args.num_iters, "p50_s": round(per_step[len(per_step) // 2], 6),
                 "p99_s": round(per_step[-1], 6), "source": "iter-timing"}
    else:
        spans.update(source="trace-step-tap", steps_per_span=steps_per_span)
    if n == 1:
        return {"step_spans": spans, "p50_skew_s": 0.0, "p99_skew_s": 0.0, "worst_rank": None,
                "ranks_observed": 1, "note": "one rank: no cross-rank skew"}
    ends = [None] * n
    dist.all_gather_object(ends, list(step_ends))
    skews = sorted(max(e[k] for e in ends) - min(e[k] for e in ends)
                   for k in range(len(step_ends)))
    last = collections.Counter(max(range(n), key=lambda r: ends[r][k])
                               for k in range(len(step_ends)))
    return {
        "step_spans": spans,
        "p50_skew_s": round(skews[len(skews) // 2], 6),
        "p99_skew_s": round(skews[min(int(0.99 * (len(skews) - 1)), len(skews) - 1)], 6),
        "worst_rank": last.most_common(1)[0][0],
        "ranks_observed": n,
        "note": (f"{n} processes: the spread of the ranks' host clocks at each timed step's "
                 "end (one host's wall clock), and the rank most often last"),
    }


def sim_block(args, params, dp: int, measured_step_s: float, quantized: bool, tk: dict,
              tp_block) -> dict:
    """``bench.py``'s ``sim`` block: the port's fleet simulator's predicted
    step for this program at ``dp`` data ranks beside the measured one,
    priced on the detected card's row (``topo/model.detect_generation``) or
    on ``--calibration`` / HOROVOD_CALIBRATION_FILE. Without a calibration
    the divergence ratio is 0.0 with a note. Never raises: a failing
    simulation costs the block, not the capture."""
    try:
        from . import metrics as _metrics
        from . import sim as hvdsim
        from . import tune as T
        from .topo.model import detect_generation, synthetic_model

        spec = T.spec_from_params("bench-transformer", params, mesh={"data": dp})
        config = ({"fusion_threshold_bytes": tk["fusion_threshold_bytes"],
                   "first_bucket_bytes": tk["first_bucket_bytes"]} if tk else {})
        calib = hvdsim.resolve_calibration(args.calibration or None)
        model = hvdsim.apply_calibration(synthetic_model(dp, generation=detect_generation()),
                                         calib, where="bench")
        fixed_us, overlap_block = 0.0, None
        if tp_block:
            kw = dict(psums_per_step=tp_block["psums_per_step"])
            fixed_us = hvdsim.tp_fixed_comm_us(model, tp_block["psum_payload_bytes"], args.tp,
                                               **kw)
            if args.tp_overlap:
                from .ops.collective_matmul import resolve_chunks

                chunks = resolve_chunks(max(args.batch_size * args.seq_len // args.tp, 1))
                fused_us = hvdsim.tp_fixed_comm_us(model, tp_block["psum_payload_bytes"],
                                                   args.tp, overlap=True, chunks=chunks, **kw)
                overlap_block = {"chunks": int(chunks),
                                 "fixed_comm_us": round(float(fused_us), 4),
                                 "classic_fixed_comm_us": round(float(fixed_us), 4),
                                 "compute_hidden_us": 0.0}
                fixed_us = fused_us
        program = hvdsim.program_from_spec(spec, config, fixed_comm_us=fixed_us)
        res = hvdsim.simulate(model, program, hvdsim.SimConfig(
            wire_dtype="int8" if quantized else "f32", zero1=bool(args.zero1),
            overlap=bool(args.overlap)), steps=2)
        predicted_s = res.mean_step_us / 1e6
        calibrated = calib is not None and model.source.endswith("+calibrated")
        block = {
            "predicted_step_time_s": round(predicted_s, 6),
            "measured_step_time_s": round(float(measured_step_s), 6),
            "scaling_efficiency": round(res.scaling_efficiency, 6),
            "ranks": int(dp),
            "calibrated": bool(calibrated),
            **({"tp": {"degree": int(args.tp), "fixed_comm_us": round(float(fixed_us), 4),
                       **({"overlap": overlap_block} if overlap_block else {})}}
               if tp_block else {}),
        }
        if calibrated and measured_step_s > 0:
            block["divergence_ratio"] = round(predicted_s / float(measured_step_s), 6)
            if _metrics.ACTIVE:
                _metrics.TAP.set("hvd_sim_divergence_ratio", block["divergence_ratio"],
                                 hop="step")
        else:
            block["divergence_ratio"] = 0.0
            block["note"] = (f"no calibration applied — the prediction uses the "
                             f"{model.generation} row's defaults; fit constants with python -m "
                             "horovod_tpu_torch.tools.fleet_sim --calibrate and pass "
                             "--calibration / HOROVOD_CALIBRATION_FILE")
        return block
    except Exception as e:  # noqa: BLE001 - an advisory block only
        return {"error": repr(e)}


def run(args) -> int:
    """One rank of the benchmark; rank 0 prints the JSON line."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import horovod_tpu_torch as hvd

    from . import trace as _trace
    from .common.basics import resolve_device
    from .tools.launch import STORE_DIR_VAR, store_url
    from .utils.step_graph import capture_step

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    hvd.init(device, init_method=store_url() if STORE_DIR_VAR in os.environ else None)
    init_s = time.perf_counter() - t0
    try:
        if args.model == "moe":
            return _run_moe(args, init_s)
        rank, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        on_card = dev.type == "cuda"
        if on_card:
            torch.backends.cudnn.benchmark = True
        transformer = args.model == "transformer"
        model, batch, loss_fn = (_build_transformer if transformer else _build_cnn)(
            args, dev, rank, n)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        # A pinned tuning gives the threshold, the first bucket and the wire,
        # as bench.py applies one; --quantized wins over the pin's wire.
        tuned_kw, tuned_detail = _resolve_tuned(args, model, n)
        tk = tuned_kw or {}
        quantized = bool(args.quantized) or bool(tk.get("quantized"))
        dp, params = n, model
        if args.tp and args.scan:
            print("[bench] --tp: on-device scan disabled (the composed "
                  "step builds on first call)", file=sys.stderr)
            args.scan = False
        if args.tp:
            dp = n // args.tp
            step, params, batch = _build_composed(args, model, dev, tk, quantized)
        else:
            step = build_dp_step(args, model, loss_fn, tk, quantized)

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        # Warmup; its first step, a plain one, also counts the step's FLOPs.
        with FlopCounterMode(display=False) as counter:
            loss = step(params, batch)
        measured = counter.get_total_flops() or None
        scanned = None
        if args.scan:
            # bench.py's scan_steps: the other warm-up steps and the capture
            # (one call, untimed), then one call an iteration.
            scanned = capture_step(step, params, batch, length=args.num_batches_per_iter,
                                   warmup=max(args.num_warmup_batches - 1, 0))
            warm = scanned.capture()
            loss = loss if warm is None else warm
            # The step tap over a replaying call, as bench.py wraps its scan
            # (the DP step's own tap fired at the capture); on the CPU the
            # call's eager steps carry their own.
            fn = (_trace.wrap_step(scanned, overlap=bool(args.overlap), quantized=quantized,
                                   wire_dtype="int8" if quantized else "f32")
                  if scanned.on_card else scanned)
        else:
            for _ in range(args.num_warmup_batches - 1):
                loss = step(params, batch)
            fn = lambda: step(params, batch)  # noqa: E731
        float(loss)
        _launch_counts(reset=True)
        # The tap's spans are the timed calls', as bench.py wraps its step
        # after the warmup (the DP step's own tap saw the warm-up steps).
        _trace.TAP.reset_steps()
        calls = 1 if scanned else args.num_batches_per_iter
        iter_times, step_ends = [], []
        for _ in range(args.num_iters):
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                loss = fn()
                step_ends.append(time.time())
            sync()
            iter_times.append(time.perf_counter() - t0)
        loss = float(loss)
        # Replays move no wrapper's count: a scanned step's launches are
        # the capture's.
        launch_counts = (dict(scanned.launches) if scanned and scanned.on_card else
                         {k: v / (args.num_iters * args.num_batches_per_iter)
                          for k, v in _launch_counts().items()})

        platform = "gpu" if on_card else "cpu"
        kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
        steps = args.num_batches_per_iter
        per_step_items = dp * args.batch_size * (args.seq_len if transformer else 1)
        total = float(np.mean([per_step_items * steps / dt for dt in iter_times]))
        per_chip = total / n
        if transformer:
            dims = GPT_SMOKE if args.smoke else GPT2_SMALL
            n_params = sum(p.numel() for p in model.parameters())
            analytic = _analytic_flops_lm(n_params, dims["n_layers"], dims["d_model"],
                                          args.batch_size, args.seq_len) / max(args.tp, 1)
        else:
            analytic = _analytic_flops_cnn(args.model, args.image_size, args.batch_size)
        flops, source = _reconcile_flops(measured, analytic, platform)
        common = {
            "loss": loss,
            "platform": platform,
            "device_kind": kind,
            "power_limit": _power_limit(dev) if on_card else "not measured",
            "scan": bool(scanned),
            **({"scan_form": scanned.form} if scanned else {}),
            "tuned": tuned_detail,
            "mfu": _mfu(flops, steps, min(iter_times), kind) if on_card else None,
            "flops_per_step_per_chip": round(flops) if flops else None,
            "flops_source": source,
            "backend_init_s": round(init_s, 1),
            "backend_init_attempts": 1,
        }
        if transformer:
            from .ops.fusion import tree_leaves

            measured_step_s = float(np.mean(iter_times)) / steps
            reduced = (tree_leaves(params) if args.tp else list(model.parameters()))
            wire, tp_block = wire_block(args, reduced, dp, quantized, dims)
            skew = step_skew_block(
                args, iter_times, step_ends, rank, n,
                steps_per_span=args.num_batches_per_iter if scanned and scanned.on_card else 1)
            out = {
                "metric": "transformer_synthetic_tokens_per_sec_per_chip",
                "value": round(per_chip, 1),
                "unit": "tokens/s/chip",
                "vs_baseline": None,
                "detail": {
                    "total_tokens_per_sec": round(total, 1),
                    "n_chips": n,
                    **({"mesh": {"data": dp, "model": args.tp}, "rules": args.rules}
                       if args.tp else {}),
                    "batch_per_chip": args.batch_size,
                    "seq_len": args.seq_len,
                    "n_params": n_params,
                    "attention": ("flash (CUDA kernels B1)" if on_card
                                  else "flash (plain PyTorch versions on the CPU)"),
                    "optimizer_state": "zero1-sharded" if args.zero1 else "replicated",
                    "gradient_wire": ("int8-quantized" if quantized
                                      else "full-precision"),
                    "reduction_mode": reduction_mode(args, quantized, bool(tuned_kw)),
                    "step_time_s": round(measured_step_s, 6),
                    "wire": wire,
                    "step_skew": skew,
                    "sim": sim_block(args, params, dp, measured_step_s, quantized, tk,
                                     tp_block),
                    "kernel_launches_per_step": launch_counts if on_card else None,
                    **common,
                },
            }
        else:
            base = BASELINE_IMG_PER_SEC_PER_CHIP.get(args.model)
            out = {
                "metric": f"{args.model}_synthetic_images_per_sec_per_chip",
                "value": round(per_chip, 2),
                "unit": "img/s/chip",
                "vs_baseline": round(per_chip / base, 3) if base else None,
                "detail": {
                    "total_img_per_sec": round(total, 2),
                    "n_chips": n,
                    "batch_per_chip": args.batch_size,
                    "image_size": args.image_size,
                    "dtype": "bf16 compute / f32 params",
                    **common,
                },
            }
        if args.micro and rank == 0:
            with open(os.environ[MICRO_ROWS_VAR]) as f:
                out["detail"]["micro_allreduce"] = json.load(f)["rows"]
        if rank == 0:
            print(json.dumps(out), flush=True)
        return 0
    finally:
        hvd.shutdown()


def moe_mesh_axes(n: int):
    """``bench.py``'s MoE mesh for n cards: expert 4, else 2, else 1."""
    ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return {"data": n // ep, "expert": ep}


def _analytic_flops_moe(d_model, d_hidden, vocab, n_layers, tokens_per_chip):
    """Per-card step FLOPs of the top-1 Switch stack (``bench.py:1188``):
    each token runs ONE expert's two products a layer plus the head
    projection (2 FLOPs a multiply-add, x3 for train)."""
    per_token_fwd = n_layers * 2 * (2 * d_model * d_hidden) + 2 * d_model * vocab
    return 3.0 * per_token_fwd * tokens_per_chip


def build_moe(dims: dict, tokens_per_chip: int, seed: int = 0):
    """``bench.py``'s MoE model on this job's mesh (``moe_mesh_axes``):
    ``(step, params, batch, mesh)``. The embedding and head are normal x 0.02,
    each layer ``init_moe_params`` (drawn on the CPU from ``seed``, this
    rank's expert rows kept), all f32 master weights on this rank's device;
    the forward computes in bf16 (embedding rows, each layer's weights and
    the head cast), the logits in f32, the loss ``lm_loss`` plus 0.01 x the
    layers' summed aux loss; AdamW 3e-4 (weight decay 1e-4) through
    ``make_ep_train_step``. ``batch`` is the global token stream (every
    rank's ``tokens_per_chip`` tokens), which the step shards over (data,
    expert)."""
    import torch

    import horovod_tpu_torch as hvd

    from .models.transformer import lm_loss
    from .ops.fusion import tree_leaves
    from .parallel.ep import MoEParams, init_moe_params, make_ep_train_step, moe_ffn
    from .parallel.mesh import build_mesh
    from .utils.convert import moe_params_from_numpy

    dev, n = hvd.device(), hvd.size()
    axes = moe_mesh_axes(n)
    mesh = build_mesh(axes)
    e = mesh.get_local_rank("expert")
    g = torch.Generator().manual_seed(seed)
    d, v = dims["d_model"], dims["vocab"]

    def leaf(t):
        return t.to(dev).requires_grad_()

    params = {
        "embed": leaf(torch.randn(v, d, generator=g) * 0.02),
        "layers": [moe_params_from_numpy(
            init_moe_params(g, d_model=d, d_hidden=dims["d_hidden"],
                            num_experts=dims["experts"], num_expert_shards=axes["expert"],
                            device="cpu"), n_shards=axes["expert"], index=e, device=dev)
            for _ in range(dims["n_layers"])],
        "head": leaf(torch.randn(d, v, generator=g) * 0.02),
    }
    rng = np.random.RandomState(seed)
    total = tokens_per_chip * n
    batch = tuple(torch.from_numpy(rng.randint(0, v, (total,))).to(dev) for _ in range(2))

    def loss_fn(p, b):
        tok, lab = b
        h = p["embed"][tok].to(torch.bfloat16)
        aux_total = 0.0
        for layer in p["layers"]:
            out, aux = moe_ffn(MoEParams(*(t.to(torch.bfloat16) for t in layer)), h)
            h = h + out
            aux_total = aux_total + aux
        return lm_loss((h @ p["head"].to(torch.bfloat16)).float(), lab), aux_total

    opt = torch.optim.AdamW(tree_leaves(params), lr=3e-4, weight_decay=1e-4, eps=1e-8)
    return make_ep_train_step(loss_fn, opt, mesh), params, batch, mesh


def _run_moe(args, init_s: float) -> int:
    """The DP x EP MoE benchmark (``bench.py``'s ``run_moe_benchmark``):
    tokens/s a card, MFU from the flop counter or ``_analytic_flops_moe``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import horovod_tpu_torch as hvd

    dims = MOE_SMOKE if args.smoke else MOE_DIMS
    rank, n, dev = hvd.rank(), hvd.size(), hvd.device()
    on_card = dev.type == "cuda"
    tokens_per_chip = args.batch_size * args.seq_len
    step, params, batch, _ = build_moe(dims, tokens_per_chip, args.seed)
    d, e = dims["d_model"], dims["experts"]
    n_params = 2 * dims["vocab"] * d + dims["n_layers"] * (d * e + 2 * e * d * dims["d_hidden"])

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    with FlopCounterMode(display=False) as counter:
        loss = step(params, batch)
    measured = counter.get_total_flops() or None
    initial_loss = float(loss)
    for _ in range(args.num_warmup_batches - 1):
        loss = step(params, batch)
    float(loss)
    iter_times = []
    for _ in range(args.num_iters):
        sync()
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = step(params, batch)
        sync()
        iter_times.append(time.perf_counter() - t0)
    loss = float(loss)
    platform = "gpu" if on_card else "cpu"
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    steps = args.num_batches_per_iter
    total = float(np.mean([tokens_per_chip * n * steps / dt for dt in iter_times]))
    flops, source = _reconcile_flops(
        measured, _analytic_flops_moe(dims["d_model"], dims["d_hidden"], dims["vocab"],
                                      dims["n_layers"], tokens_per_chip), platform)
    out = {
        "metric": "moe_synthetic_tokens_per_sec_per_chip",
        "value": round(total / n, 1),
        "unit": "tokens/s/chip",
        "vs_baseline": None,
        "detail": {
            "total_tokens_per_sec": round(total, 1),
            "n_chips": n,
            "mesh": moe_mesh_axes(n),
            "tokens_per_chip_per_step": tokens_per_chip,
            "n_params": n_params,
            "n_experts": dims["experts"],
            "loss": loss,
            "initial_loss": initial_loss,
            "platform": platform,
            "device_kind": kind,
            "power_limit": _power_limit(dev) if on_card else "not measured",
            "routing": "switch-top1 (static capacity, all_to_all)",
            "step_time_s": round(float(np.mean(iter_times)) / steps, 6),
            "scan": False,
            "mfu": _mfu(flops, steps, min(iter_times), kind) if on_card else None,
            "flops_per_step_per_chip": round(flops) if flops else None,
            "flops_source": source,
            "backend_init_s": round(init_s, 1),
            "backend_init_attempts": 1,
        },
    }
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def serve_model(args, device):
    """The served model's dims and its parameter tree (f32, from
    ``--seed``): GPT-2-small at max_len 1024, or ``SERVE_SMOKE``."""
    import torch

    from .models.transformer import TransformerLM
    from .utils.convert import param_tree

    dims = dict(SERVE_SMOKE) if args.smoke else dict(GPT2_SMALL, max_len=1024)
    model = TransformerLM(**dims, dtype=torch.float32, device=device, seed=args.seed)
    return dims, param_tree(model)


def serve_engine(args, dims, params, device):
    """``bench.py``'s serving engine over ``params``: f32 compute and
    cache, page size 8, ``max(64, 8 x max batch)`` pages."""
    import torch

    from .serve import ServeEngine
    from .train import make_decode_step

    step = make_decode_step(n_heads=dims["n_heads"], dtype=torch.float32)
    return ServeEngine(
        params, step, n_layers=dims["n_layers"], n_heads=dims["n_heads"],
        head_dim=dims["d_model"] // dims["n_heads"],
        num_pages=max(64, 8 * args.serve_max_batch), page_size=8,
        max_batch_size=args.serve_max_batch, max_wait_us=args.serve_max_wait_us,
        max_context=dims["max_len"], replicas=args.serve_replicas,
        cache_dtype=torch.float32, device=device)


def closed_loop(engine, args, vocab: int) -> dict:
    """``--serve-clients`` threads, each keeping one request in flight
    (``--serve-requests`` in all, prompts of 1-8 tokens drawn from ``1000 +
    client``), after one warmup request outside the timed window. Returns
    the wall time, the completions, the batches and the decode steps of
    the timed window."""
    import threading

    n_clients = max(1, args.serve_clients)
    per_client = max(1, args.serve_requests // n_clients)
    results, lock = [], threading.Lock()

    def client(cid):
        rng = np.random.RandomState(1000 + cid)
        for j in range(per_client):
            prompt = [int(t) for t in rng.randint(0, vocab, size=1 + rng.randint(8))]
            rid = engine.submit(prompt, max_tokens=args.serve_max_tokens,
                                request_id=f"c{cid}.{j}")
            comp = engine.result(rid, timeout=300.0)
            with lock:
                results.append(comp)

    warm = engine.submit([1, 2, 3], max_tokens=2, request_id="warmup")
    engine.result(warm, timeout=300.0)
    batches0, batched0, steps0 = engine.batches, engine.batched_requests, engine.steps
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), name=f"bench-client-{c}")
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batches = engine.batches - batches0
    return {"wall_s": wall, "completions": results, "clients": n_clients,
            "batches": batches, "steps": engine.steps - steps0,
            "occupancy": (engine.batched_requests - batched0) / batches if batches else 0.0}


def decode_family(name: str) -> str:
    """The decode step's kernel families by lower-case kernel name: cuBLAS
    products (q/k/v, out, MLP, head, the attention's batched products),
    NCCL, the page gather and the cache write (index kernels), the softmax
    and the norms' reductions, and elementwise work (casts, adds, gelu, the
    mask)."""
    return ("gemm" if any(s in name for s in ("gemm", "cutlass", "cublas", "nvjet", "xmma"))
            else "nccl" if "nccl" in name
            else "index" if any(s in name for s in ("index", "gather", "scatter"))
            else "reduce" if any(s in name for s in ("reduce", "softmax", "norm"))
            else "elementwise" if any(s in name for s in ("elementwise", "copy", "fill", "cat"))
            else "other")


def time_decode_step(engine, *, steps: int = 20) -> dict:
    """The engine's decode step alone at a full batch of live slots
    (positions 8-15, two pages each), at the engine's own geometry (batch,
    page-table width) on its first replica's cache, with the engine idle:
    the median host ms of ``steps`` steps, each ending in its read-back,
    after 5, and one step under ``torch.profiler``
    (``utils/profile.profile_step``: host ms, device busy ms, kernels,
    device ms by :func:`decode_family`). On the card every step runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a step that synchronizes
    the host before its read-back fails."""
    import statistics

    import torch

    from .utils.profile import profile_step

    B, cache = engine.max_batch_size, engine.replica_caches()[0]
    table = np.zeros((B, engine.table_width), np.int32)
    table[:, :2] = np.arange(1, 2 * B + 1).reshape(B, 2)
    tokens = np.arange(B, dtype=np.int32)
    checked = engine.device.type == "cuda"

    def one(i):
        positions = np.full(B, 8 + i % 8, np.int32)
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            nxt, _ = engine.decode_step(engine.params, cache, tokens, positions, table)
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode("default")
        return nxt.cpu()

    times = []
    for i in range(steps + 5):
        t0 = time.perf_counter()
        one(i)
        times.append(time.perf_counter() - t0)
    prof = profile_step(lambda: one(0), decode_family)
    return {"step_ms": statistics.median(times[5:]) * 1e3, **prof}


def serve_report(args, dims, loop: dict, device) -> dict:
    """``bench.py``'s serving JSON from a :func:`closed_loop` run (with
    ``mesh`` and ``rules`` under ``--tp``)."""
    import torch

    ok = [c for c in loop["completions"] if c.outcome == "ok"]
    if not ok:
        raise RuntimeError("the serving benchmark completed no requests")
    wall = loop["wall_s"]
    lat_ms = np.sort([c.latency_s * 1e3 for c in ok])
    tokens = int(sum(len(c.tokens) for c in ok))
    on_card = device.type == "cuda"
    return {
        "metric": "serve_decode_tokens_per_sec",
        "value": round(tokens / wall, 1),
        "unit": "tokens/s",
        "vs_baseline": None,
        "detail": {
            "requests": len(ok),
            "clients": loop["clients"],
            "replicas": args.serve_replicas,
            "latency_ms": {
                "p50": round(float(np.percentile(lat_ms, 50)), 3),
                "p99": round(float(np.percentile(lat_ms, 99)), 3),
                "mean": round(float(np.mean(lat_ms)), 3),
                "max": round(float(lat_ms[-1]), 3),
            },
            "requests_per_sec": round(len(ok) / wall, 2),
            "batch_occupancy_mean": round(float(loop["occupancy"]), 3),
            "batches": loop["batches"],
            "max_batch_size": args.serve_max_batch,
            "max_wait_us": args.serve_max_wait_us,
            "max_tokens": args.serve_max_tokens,
            "model": {"vocab": dims["vocab_size"], "d_model": dims["d_model"],
                      "n_heads": dims["n_heads"], "n_layers": dims["n_layers"],
                      "max_len": dims["max_len"]},
            **({"mesh": {"model": args.tp}, "rules": args.rules} if args.tp else {}),
            "dtype": "float32 compute and cache",
            "platform": "gpu" if on_card else "cpu",
            "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "power_limit": _power_limit(device) if on_card else "not measured",
        },
    }


def run_serve(args) -> int:
    """The closed-loop serving benchmark on one device; prints one JSON
    line."""
    from .common.basics import resolve_device

    if args.tp:
        return run_serve_tp(args)
    device = resolve_device(args.device)
    dims, params = serve_model(args, device)
    with serve_engine(args, dims, params, device) as engine:
        loop = closed_loop(engine, args, dims["vocab_size"])
    print(json.dumps(serve_report(args, dims, loop, device)), flush=True)
    return 0


def run_serve_tp(args) -> int:
    """One rank of the tensor-parallel server (``--serve --tp N``): the
    seeded weights cut to this rank's shards on a ``{"model": N}`` mesh,
    ``serve(mesh=..., rules=...)`` with the engine's configuration of
    :func:`serve_engine`; rank 0 drives the closed loop and prints the JSON
    line, the others follow its steps."""
    import torch

    import horovod_tpu_torch as hvd

    from .common.basics import resolve_device
    from .common.env import Config
    from .parallel.mesh import build_mesh
    from .serve import serve
    from .tools.launch import store_url
    from .utils.convert import local_params_from_flax, params_to_numpy

    hvd.init(resolve_device(args.device), init_method=store_url())
    try:
        dev = hvd.device()
        mesh = build_mesh({"model": hvd.size()})
        dims, whole = serve_model(args, dev)
        local = local_params_from_flax(params_to_numpy(whole), args.rules, mesh, device=dev)
        del whole
        cfg = Config()
        cfg.serve_kv_pages, cfg.serve_page_size = max(64, 8 * args.serve_max_batch), 8
        cfg.serve_max_batch, cfg.serve_max_wait_us = args.serve_max_batch, args.serve_max_wait_us
        cfg.serve_replicas = args.serve_replicas
        handle = serve(local, n_heads=dims["n_heads"], mesh=mesh, rules=args.rules, config=cfg,
                       dtype=torch.float32, device=dev)
        if handle.engine is None:
            return 0                     # a follower: it replayed the leader's steps
        try:
            loop = closed_loop(handle.engine, args, dims["vocab_size"])
        finally:
            handle.stop()
        print(json.dumps(serve_report(args, dims, loop, dev)), flush=True)
        return 0
    finally:
        hvd.shutdown()


def run_micro(args, out_dir: str) -> None:
    """The micro-benchmark (``utils/micro_bench.py``) at ``args.micro_ranks``
    ranks, before the bench's own ranks start; rank 0's record goes to a
    file that the bench's rank 0 reads (``MICRO_ROWS_VAR``)."""
    from .utils import micro_bench

    path = os.path.join(out_dir, "micro.json")
    code = micro_bench.run(args.micro_ranks, args.device, out=path)
    if code != 0 or not os.path.exists(path):
        raise RuntimeError(f"the micro-benchmark's ranks exited {code}")
    os.environ[MICRO_ROWS_VAR] = path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.serve and (not args.tp or "HOROVOD_RANK" in os.environ):
        return run_serve(args)
    if "HOROVOD_RANK" in os.environ:
        return run(args)
    with tempfile.TemporaryDirectory(prefix="hvd_bench_") as out_dir:
        if args.micro:
            run_micro(args, out_dir)
        if args.ranks > 1:
            from .tools.launch import launch_ranks

            return launch_ranks("horovod_tpu_torch.bench", argv, args.ranks)
        return run(args)


if __name__ == "__main__":
    sys.exit(main())
