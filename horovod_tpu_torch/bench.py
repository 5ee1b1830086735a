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

Options of ``bench.py`` that the port has not ported exit non-zero and
name the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

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

# bench.py's options the port does not have yet, and the ROADMAP item
# that brings each.
UNPORTED = {
    "tp": "A6, the bench's composed DP x TP mode (the A9 step is timed by "
          "horovod_tpu_torch.tools.tp_parity --bench)",
    "serve": "A11 (serving)",
    "scan": "'Next' 3, a CUDA graph of the step (the counterpart of the on-device scan)",
    "tuned": "A13 (tune/)",
}
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
    for flag in ("serve", "scan"):
        ap.add_argument(f"--{flag}", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tp", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tuned", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet: ROADMAP {item}")
    if args.zero1 and args.model != "transformer":
        ap.error("--zero1 is implemented for --model transformer only")
    if args.quantized and args.model != "transformer":
        ap.error("--quantized applies to --model transformer only")
    if args.model == "moe" and (args.overlap or args.micro):
        ap.error("--model moe runs the DP x EP step; --overlap and --micro do not apply")
    if args.micro and args.ranks == 1:
        ap.error("--micro needs at least 2 ranks, one card each")
    args.micro_ranks = (args.ranks or 2) if args.micro else 0
    args.ranks = args.ranks or 1
    if args.ranks < 1:
        ap.error("--ranks must be at least 1")
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


def reduction_mode(args) -> str:
    """``bench.py``'s ``reduction_mode`` for these flags."""
    mode = (("overlap+" if args.overlap else "")
            + ("quantized" if args.quantized else ("streamed" if args.overlap else "posthoc")))
    return mode + ("+zero1" if args.zero1 else "")


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


def run(args) -> int:
    """One rank of the benchmark; rank 0 prints the JSON line."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import horovod_tpu_torch as hvd

    from .common.basics import resolve_device
    from .tools.launch import STORE_DIR_VAR, store_url

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
        if transformer:
            inner = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8)
        else:
            inner = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        if args.zero1 and not args.overlap:
            from .parallel.zero import make_zero1_train_step

            step = make_zero1_train_step(loss_fn, inner, quantized=args.quantized)
        else:
            opt = hvd.DistributedOptimizer(
                inner, named_parameters=model.named_parameters(), overlap=args.overlap,
                zero1=args.zero1, quantized=args.quantized,
                error_feedback=False if args.quantized else None)
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            step = hvd.make_train_step(loss_fn, opt)

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        # Warmup; its first step also counts the step's FLOPs.
        with FlopCounterMode(display=False) as counter:
            loss = step(model, batch)
        measured = counter.get_total_flops() or None
        for _ in range(args.num_warmup_batches - 1):
            loss = step(model, batch)
        float(loss)
        iter_times = []
        for _ in range(args.num_iters):
            sync()
            t0 = time.perf_counter()
            for _ in range(args.num_batches_per_iter):
                loss = step(model, batch)
            sync()
            iter_times.append(time.perf_counter() - t0)
        loss = float(loss)

        platform = "gpu" if on_card else "cpu"
        kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
        steps = args.num_batches_per_iter
        per_step_items = n * args.batch_size * (args.seq_len if transformer else 1)
        total = float(np.mean([per_step_items * steps / dt for dt in iter_times]))
        per_chip = total / n
        if transformer:
            dims = GPT_SMOKE if args.smoke else GPT2_SMALL
            n_params = sum(p.numel() for p in model.parameters())
            analytic = _analytic_flops_lm(n_params, dims["n_layers"], dims["d_model"],
                                          args.batch_size, args.seq_len)
        else:
            analytic = _analytic_flops_cnn(args.model, args.image_size, args.batch_size)
        flops, source = _reconcile_flops(measured, analytic, platform)
        common = {
            "loss": loss,
            "platform": platform,
            "device_kind": kind,
            "power_limit": _power_limit(dev) if on_card else "not measured",
            "scan": False,
            "tuned": None,
            "mfu": _mfu(flops, steps, min(iter_times), kind) if on_card else None,
            "flops_per_step_per_chip": round(flops) if flops else None,
            "flops_source": source,
            "backend_init_s": round(init_s, 1),
            "backend_init_attempts": 1,
        }
        if transformer:
            out = {
                "metric": "transformer_synthetic_tokens_per_sec_per_chip",
                "value": round(per_chip, 1),
                "unit": "tokens/s/chip",
                "vs_baseline": None,
                "detail": {
                    "total_tokens_per_sec": round(total, 1),
                    "n_chips": n,
                    "batch_per_chip": args.batch_size,
                    "seq_len": args.seq_len,
                    "n_params": n_params,
                    "attention": ("flash (CUDA kernels B1)" if on_card
                                  else "flash (plain PyTorch versions on the CPU)"),
                    "optimizer_state": "zero1-sharded" if args.zero1 else "replicated",
                    "gradient_wire": ("int8-quantized" if args.quantized
                                      else "full-precision"),
                    "reduction_mode": reduction_mode(args),
                    "step_time_s": round(float(np.mean(iter_times)) / steps, 6),
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
