#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends:

1. the card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. the build: nvcc compiles ``horovod_tpu_torch/csrc/*.cu`` (sm_90a);
   ptxas's registers and spills per kernel; a spill in the flash
   tensor-core kernels, in any ring-block (mode 1) instantiation of the
   backward kernels or in B3/B4's TMA + wgmma kernel fails the run;
3. each flash-attention kernel (B1) against its plain PyTorch version: in
   f32 (the CUDA-core kernels) with TF32 off at small shapes and at the
   GPT-2-small shape (rtol 2e-4 / atol 2e-5 forward, 1e-3 / 1e-4
   gradients, the tolerances of tests/test_flash_attention.py), and in bf16
   (the tensor-core kernels) at the same small shapes, at T_q != T_k and at
   the GPT-2-small shape, each output through two gates: (a) two bf16 ulps
   (``BF16_RTOL``) of the plain version that rounds P and dS to bf16 where
   the kernels do, past which an element may go only by what P or dS on a
   bf16 rounding midpoint explains (counted and printed), and (b) the reference's bf16 tolerance (``REF_RTOL``)
   against the f32-internal plain version (lse at the f32 forward
   tolerance); with each kernel's time, its plain version's time, its bound
   and, where one exists, the time of the library call that computes the
   same function (``scaled_dot_product_attention``, timed only as a
   yardstick);
4. the ring block (B2): its forward (the forward kernels in block mode)
   and its backward (the dQ and dK/dV kernels in block mode: the VJP of
   (O, m, l) through all three cotangents) against their plain versions. In
   f32 with TF32 off at the small shapes, causal and not, at delta -T, 0,
   +T/2 and +T: O, m, l at 2e-4 / 2e-5 and dQ, dK, dV at 1e-3 / 1e-4, past
   which an element may go only by a row max the scores leave unclear; at
   delta >= T exactly m = -1e30, l = 0, O = 0 and zero gradients. In bf16
   at the long-context shape (BH 2 x 12, T 4096, D 64) at delta -T, 0 and
   +T/2, through gates (a) and (b) as B1's: O / l at two bf16 ulps of the
   plain version that rounds P as the tensor cores do (m and l at the f32
   tolerance), the gradients at two ulps of the plain version that rounds
   P, dS and dO, past which only a rounding tie may carry an element, and
   both at the reference's 5e-2 against the f32-internal plain versions; at
   delta +T exact; one case with duplicated keys and dm = 1, whose rows tie
   at their max, so that a tie the dK/dV kernel misses shows. Then, in
   turns in one run, the forward against the CUDA-core kernel it replaces
   and the backward kernels against the dense recompute (PyTorch) they
   replace, with the plain versions' times and the bounds;
5. the ring's merge on one card: one bf16 GPT-2-small attention input at T
   4096 cut into 4 sequence pieces; each piece merges its 4 ring blocks in
   the order a ring rank sees them, held as B1's forward is: (a) two bf16
   ulps of the same merge over the rounding plain blocks, (b) the
   reference's bf16 tolerance against the f32-internal plain forward over
   the whole sequence, and B1's forward at the same tolerance;
6. the data-parallel slice: a small f32 model on the card (kernels) against
   the same model on the CPU (plain versions), then ``init()`` over NCCL,
   GPT-2-small width (d_model 768, 12 heads, 12 layers, vocab 32768, T
   1024), ``broadcast_parameters``, ``DistributedOptimizer(AdamW)`` and 5
   steps of ``make_train_step`` on one seeded batch: the loss must be finite
   and fall, and both flash launch counters must have moved; then one more
   step under ``torch.profiler`` for the device time by kernel family and
   the device's busy share (host time there includes the profiler's own
   cost);
   Then ``[head-dims]``: GPT-2-small's width with 48 heads (D 16) and with 8
   heads (D 96), head dims the kernels are not built for, 2 layers, 3 AdamW
   steps each: the adapter zero-pads D to the kernels' next head dim, so
   the loss must be finite and fall and the flash counters must have moved;
   Then ``[dp-variants]``: the int8 ring allreduce and reduce-scatter
   (``ops/quantized.py``) at 4 virtual ranks on the card over GPT-2-small's
   f32 gradient buckets (64 MiB, from ``plan_buckets``), bitwise against the
   same code on the CPU (the first and last bucket) and within 3% relative
   L2 of the f32 sum (every bucket), with the ms and the kernel launches a
   hop; then the GPT-2-small DP step at 8 x 1024 with ``overlap``,
   ``zero1`` (post hoc and streamed), ``quantized`` and ``nonfinite="skip"``, in turns
   with the plain step, 10 steps each: finite, falling loss, B1's launches
   counted, the streamed hooks launching every group inside the backward
   (no post-hoc fallback), and one non-finite batch under skip leaving the
   parameters bitwise unchanged;
7. the sequence-parallel slice: ``init()`` over NCCL, ``build_mesh({"data":
   1, "seq": 1})``, GPT-2-small width at T 4096 with ``ring_attention`` over
   the seq group and ``remat=True``, 5 AdamW steps of ``make_sp_train_step``
   at batch 2 x 4096: the loss must be finite and fall and the ring block's
   forward and backward kernels must have run (24 forward launches and 12
   backward pairs a step); then one profiled step, with the block's
   backward (the span ``flash_block_backward``) as a family of its own;
8. ``[tp-kernels]``: the collective-matmul kernels B3 (chunk product) and B4
   (partial product and epilogue) against their plain versions: at small
   ragged shapes (batch > 1, sub-chunks 1 and 2, row offsets) in f32 with
   TF32 off at 2e-4 / 2e-5 and in bf16 (the TMA + wgmma kernel where
   ``_tma_ok`` takes the operands, the WMMA kernel where it does not, each
   case naming its kernel), and in bf16 at the GPT-2-small tp-4 per-rank
   shapes (B3: q/k/v and MLP up; B4: attention out and MLP down) on both
   the TMA and the WMMA kernel, B3's bf16 output at two bf16 ulps and B4's
   f32 accumulator at 2e-4 / 2e-5; one rank's call (4 chunk products; 4
   partial products and the epilogue) timed on both kernels in turns
   (WMMA, TMA, TMA, WMMA), by CUDA events over the call loop and by the
   device time of its kernels (``torch.profiler``), beside the card's name
   and power limit, the plain versions' time, the bound and
   ``torch.matmul`` over the same product (timed only as a yardstick);
9. ``[tp-ring]``: a 4-rank bidirectional ring played on one card by four
   threads, one per virtual rank, through the port's own schedule
   (``_ag_matmul``, ``_mrs`` and their dual-primitive backwards), the hops
   being device copies between the virtual ranks' buffers: B3's output
   bitwise equal to the kernel over the gathered input, and through an
   identity weight bitwise equal to the gathered x; B4's outputs, gathered,
   equal to the sum over ranks of y_r @ w_r (the psum identity) within two
   bf16 ulps; the backwards against their dense forms. The B3/B4 launch
   counts of the kernels line come from this phase;
10. ``[tp]``: the composed DP×TP step, ``make_train_step(rules="gpt")`` on a
   ``data 1 x model 1`` mesh, GPT-2-small at batch 8 x 1024, 5 AdamW steps:
   the loss must be finite and fall. (With one model rank the all-reduces
   are no-ops and the fused path is not taken, as in the reference; the
   fused path runs across cards in ``tools/tp_parity.py``.)
   Then ``[hier]``: the two-level schedules of ``topo/compositor.py``
   (allreduce SUM/AVERAGE/MIN/MAX, reduce-scatter, allgather, broadcast
   two-level and two-level-sa, alltoall, the int8 two-level allreduce,
   hierarchical Adasum) over a (cross 2, local 2) grid of 4 virtual ranks
   played by threads on the card (``VirtualHop``), at GPT-2-small's f32
   buckets in f32 and bf16: data movement bitwise the flat result,
   MIN/MAX bitwise, sums within n roundings of the dtype times sum_r
   |x_r|, int8 within 3e-2 relative L2 of the f32 sum, Adasum within 1e-5
   of the float64 reference, with ms and kernel launches a virtual hop;
   then the GPT-2-small DP step with ``hierarchical=True`` on a (cross 1,
   local 1) mesh and the composed step at data 1 x model 1 with overlap,
   zero1, quantized and nonfinite="skip", in turns with the plain steps, 6
   steps each: finite, falling losses, B1 launched for every step, every
   streamed group launched in the backward, the poisoned step's
   parameters bitwise unchanged.

11. ``[cnn]``: the image-classification path, which reaches no TPU kernel
   (cuDNN convolutions and BatchNorm, cuBLAS for the head): a narrow f32
   ResNet (8 filters, 32 px) on the card against the CPU with TF32 off
   (logits, loss, gradients and the new running statistics at 1e-3 /
   1e-4); ResNet-50 at bench.py's default (batch 32 x 224², 1000 classes),
   then at batch 256, each through ``init()`` over NCCL, ``broadcast_parameters``,
   ``DistributedOptimizer(SGD 0.01, momentum 0.9)`` and 5 steps of
   ``make_train_step`` on one seeded batch: the loss finite and falling,
   every running statistic moved; img/s (median of steps 2-5), MFU (the
   flop counter over one more step, against the dense bf16 peak) and one
   profiled step's busy share by kernel family (conv, bn, elementwise,
   optimizer, gemm, nccl); then VGG-16, Inception-v3 (299 px), ResNet-18 and
   MnistCNN, 3 steps each at batch 8: finite, falling loss;
12. ``[bench]``: ``python -m horovod_tpu_torch.bench`` for resnet50 and
   transformer (at ``[slice]``'s batch of 8) at reduced iterations, each in
   its own process: one JSON line with bench.py's metric name, a positive
   value and 0 < mfu <= 1; the transformer's tokens/s beside ``[slice]``'s.
13. ``[eager]``: the eager Horovod API (``horovod_tpu_torch.eager``) through
   ``init()``: the native core (built from ``cpp/src`` into
   ``horovod_tpu_torch/build/`` alongside the nvcc builds) and the NCCL plan
   executor on its own CUDA stream, at one rank. Every eager op on CUDA
   tensors of f32, bf16, f16, i32, i64 and u8 (allreduce with every op,
   allgather, broadcast, alltoall with and without splits, reducescatter,
   the grouped forms): each output on the card, data movement and the sum
   over one rank bitwise the input, the scaled sum within one rounding of
   the dtype; the grouped allreduce of GPT-2-small's whole parameter set
   (every tensor, f32 and bf16) bitwise, in one plan, with the core's plan
   count and fused bytes, its ms against ``ops/fusion.fused_allreduce`` on
   the same tensors in turns, and the NCCL kernels a plan from
   ``torch.profiler``; ``broadcast_object``/``allgather_object``, a size-1
   process set, ``join`` and ``barrier``; stream safety (a spin kernel and
   a chain of adds write the input on a side stream just before the
   enqueue, and the result must hold the final values); the median latency
   of a 4-byte allreduce from enqueue to ``synchronize`` at the default
   ``HOROVOD_CYCLE_TIME`` and at 1 ms.

14. ``[torch-binding]``: the hook-driven binding (``horovod_tpu_torch.torch``)
   at one rank. Its op surface on CUDA tensors of f32, bf16 and f16
   (outputs on the card and bitwise the input; ``allreduce_``,
   ``broadcast_`` and ``allreduce_async_`` returning the caller's tensor at
   its own ``data_ptr``; an in-place allreduce enqueued from a side stream
   behind a spin kernel); gradients produced on a side stream, whose hooks
   must run on that stream and reduce to the plain backward's gradients;
   the hook-driven ``DistributedOptimizer`` on GPT-2-small (8 x 1024, AdamW
   3e-4, weight decay 1e-4, after ``broadcast_parameters`` and
   ``broadcast_optimizer_state``, whose AdamW step counts must stay on the
   CPU) against ``make_train_step``, in turns, 5 steps each: the loss
   finite and falling, 149 hooks fired and 149 handles pending every step,
   B1's launches counted, the hooks' thread printed beside the caller's,
   the median step split into forward + backward (with the enqueues in the
   hooks), ``step()`` (with its synchronize) and the device drain, and the
   core's plans a step; one step each with ``backward_passes_per_step=2``,
   ``Compression.fp16`` and ``op=Adasum`` (within two f32 ulps of the local
   AdamW step); ResNet-50 at 32 x 224² through the binding against
   ``make_train_step``, in turns (img/s), and with all 53 BatchNorms a
   ``SyncBatchNorm`` forced onto its sync path against plain BatchNorm;
   ``SyncBatchNorm``'s sync path against ``nn.BatchNorm2d`` at one rank in
   f32 with TF32 off and with a bf16 input (output, dx, dweight, dbias and
   the running statistics); then ``[micro]``, the micro-benchmark at one
   rank (``--one-rank``: no peer, only the control plane costs anything),
   and ``[examples]``, the three example copies, each in its own process.

15. ``[pp]``: pipeline parallelism (``parallel/pp.py``), which runs B1 in
   every block: GPT-2-small through ``make_pp_lm_train_step`` on a ``stage 1
   x data 1`` mesh, 8 microbatches of 1 x 1024, ``remat=True``, 5 AdamW steps
   (3e-4, weight decay 1e-4): the loss finite and falling, B1's forward and
   backward launches counted every step (printed a step), and the first loss
   within ``PP_LOSS_RTOL`` of ``make_train_step``'s on the same weights and
   batch; step ms and tokens/s beside the card's name and power limit. Then
   the 4-stage schedule at the same width played on the card by four
   threads, one per stage (``VirtualLine``: the stage axis's seam, which
   also fails a receive with no matching send, a send nobody takes, or a
   shape or dtype that differs): its loss and every parameter's gradient
   (zero where another stage owns the parameter) against the one-stage
   run's at the initial weights, within two bf16 ulps of each tensor's
   largest element.
16. ``[ep]``: expert parallelism (``parallel/ep.py``; no TPU kernel): the
   MoE layer's index dispatch against its dense one-hot form
   (``_moe_ffn_dense``) at 4096 tokens, 16 experts, d 512 / 2048, bitwise in
   f32 with TF32 off and in bf16, and the bf16 output within 2e-2 of the
   largest f32 output over the tokens both route alike; both forwards timed;
   the forward at 4 virtual expert ranks played by threads through
   ``VirtualHop``'s ``all_to_all`` bitwise the one-rank forward over each
   rank's shard in f32; then ``python -m horovod_tpu_torch.bench --model
   moe`` at the reference's dims on one card (expert 1), 5 timed steps: its
   JSON line, a finite loss below the first step's, tokens/s and MFU.

The line before the last is a JSON object with one entry per kernel (the
B3/B4 rows also carry ``device_ms``, the TMA kernel's device time); the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before that line is printed. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import types

BATCH = 8           # per-card batch of the training phase
SEQ = 1024
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12)
STEPS = 5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense tensor cores
SP_BATCH, SP_SEQ = 2, 4096   # the sequence-parallel slice: 8192 tokens a step, as above
F32_RTOL, F32_ATOL = 2e-4, 2e-5
KERNEL_SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
REPLACED = "horovod_tpu/ops/pallas_attention.py"
CM_SOURCE = "horovod_tpu_torch/csrc/collective_matmul.cu"
CM_REPLACED = "horovod_tpu/ops/collective_matmul.py"
TP = 4              # the model axis the tp phases play: GPT-2-small on 4 cards
# Gate (a) for a bf16 kernel: the plain version fed the same inputs and doing
# the kernel's arithmetic (f32 accumulation; for B1, P and dS rounded to bf16
# where the tensor cores take them, p_dtype=torch.bfloat16) differs from the
# kernel by at most one bf16 ulp (2^-7 of the value) plus f32 summation
# noise. The limit is two ulps and an absolute floor far below the outputs'
# size (0.05-1), so a dropped or repeated tile fails it.
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-4
# Gate (b) for B1 in bf16: against the f32-internal plain version (the JAX
# reference's arithmetic), the reference's own bf16 tolerance
# (tests/test_flash_attention.py), which bounds the drift that rounding P and
# dS to bf16 brings.
REF_RTOL, REF_ATOL = 5e-2, 5e-2
# Where the f32 P or dS sits within this relative band of a bf16 rounding
# midpoint, the kernel and the plain version (whose f32 values differ by a
# few f32 ulps) may round it to neighbouring bf16 values. In a
# row that sees few keys one such P weighs as much as the whole output, so
# gate (a) lets an element past two ulps only by what such ties can explain
# (``rounding_tie_bounds``), and counts those elements.
TIE_REL = 2.0 ** -16
# B1's and B2's bf16 kernels, which must spill nothing at any head dim.
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel")
# The backward kernels whose last template argument is the mode (1: the ring
# block); every block-mode instantiation must spill nothing either.
BLOCK_MODE_KERNELS = MMA_KERNELS + ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
# B3/B4's TMA + wgmma kernel, which must spill nothing at any built tile.
CM_TMA_KERNEL = "gemm_tma_wgmma_kernel"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _catch(fn):
    """fn()'s result, or the exception it raised (for a thread's caller to check)."""
    try:
        return fn()
    except BaseException as exc:  # noqa: BLE001 - handed to check() by the caller
        return exc


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(out, ref, rtol: float, atol: float, what: str) -> float:
    """Largest |out - ref|; fails when any element is beyond atol + rtol |ref|."""
    import torch

    out, ref = out.detach().float(), ref.detach().float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite values")
    diff = (out - ref).abs()
    bad = diff > atol + rtol * ref.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements beyond rtol {rtol} / atol {atol}, "
          f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def rel_err(out, ref, what: str, limit: float = 2e-2) -> float:
    """max |out - ref| over max |ref|. For the bf16 weight gradients: the
    ring adds its n per-source terms in bf16, as the reference's
    ``_ring_grad_w`` does, so elements where the terms cancel carry errors
    of the terms' size; a missing or repeated term moves it by ~1/n."""
    import torch

    out, ref = out.detach().float(), ref.detach().float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite values")
    rel = float((out - ref).abs().max() / ref.abs().max())
    check(rel <= limit, f"{what}: max error {rel:.3e} of the largest value, limit {limit}")
    return rel


def bound(nbytes: float, flops: float):
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 peak, whichever is larger (ms, and which)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    import threading

    from horovod_tpu_torch.common import native
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # The eager plane's native core (g++) builds beside the kernels (nvcc).
    core = {}
    core_build = threading.Thread(target=lambda: core.update(
        path=_catch(native.ensure_built)))
    core_build.start()
    reports = _build.build(["flash_attention", "collective_matmul"])
    core_build.join()
    check(not isinstance(core["path"], BaseException),
          f"the native core did not build: {core['path']}")
    print(f"[build] native core {core['path']}", flush=True)
    secs = time.perf_counter() - t0
    spills, missing = [], []
    gated = {"flash_attention": set(MMA_KERNELS), "collective_matmul": {CM_TMA_KERNEL}}
    for name, report in reports.items():
        names = set()
        for kern in _build.ptxas_kernels(report):
            print(f"[ptxas {name}] {kern['name']}: {kern['registers']} registers, spill "
                  f"stores {kern['spill_stores']} B, loads {kern['spill_loads']} B")
            base = kern["name"].split("<")[0]
            block_mode = base in BLOCK_MODE_KERNELS and kern["name"].endswith(",1>")
            names.add(base + " (block mode)" if block_mode else base)
            if ((base in gated[name] or block_mode)
                    and (kern["spill_stores"] or kern["spill_loads"])):
                spills.append(kern["name"])
        want = gated[name] | ({k + " (block mode)" for k in BLOCK_MODE_KERNELS}
                              if name == "flash_attention" else set())
        missing += sorted(want - names)
    print(f"[build] {', '.join(reports) or 'nothing'} built in {secs:.1f} s "
          f"(one nvcc each, in parallel)", flush=True)
    check(not spills, f"ptxas reports spills in the gated kernels {spills}")
    check(not missing, f"ptxas reported no {missing}: the spill check cannot see them")


def _attention_inputs(bh, t, d, dtype, seed, tk=None):
    """q, k, v, dO: q and dO [bh, t, d], k and v [bh, tk (default t), d]."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, t if i in (0, 3) else (tk or t), d, device="cuda",
                        generator=g).to(dtype) for i in range(4)]


# The f32 phase's cases (bh, t, d, causal): every head dim, ragged lengths.
SMALL_CASES = [(bh, t, d, causal) for (bh, t, d) in ((3, 200, 32), (4, 256, 64), (2, 136, 128))
               for causal in (True, False)]


def _tie_span(x, band):
    """How far apart the bf16 roundings of x - band and x + band lie: not 0
    only where x is within band of a bf16 rounding midpoint."""
    import torch

    return ((x + band).to(torch.bfloat16).float() - (x - band).to(torch.bfloat16).float()).abs()


def _probs(qf, kf, k0, block_k, shift, causal, scale, delta):
    """Masked scores and P = exp(s - shift) of one K block (mask shifted by delta)."""
    import torch

    s = qf @ kf[:, k0:k0 + block_k].transpose(1, 2) * scale
    if not causal:
        return s, torch.exp(s - shift), None
    q_pos = torch.arange(qf.shape[1], device=qf.device)[:, None]
    mask = q_pos >= torch.arange(k0, k0 + s.shape[-1], device=qf.device)[None, :] + delta
    s = torch.where(mask, s, -1e30)
    return s, torch.where(mask, torch.exp(s - shift), 0.0), mask


def fwd_tie_span(q, k, v, causal, scale, block_k, delta=0):
    """Per element of the unnormalised O, the most that P rounding to the
    other bf16 neighbour at a midpoint can move it, over the forward's K
    tiles (against the running max); and the row sum l, [BH, T, 1]."""
    import torch

    qf, kf, vf = (x.float() for x in (q, k, v))
    bh, t_q, d = q.shape
    m = torch.full((bh, t_q, 1), -1e30, device=q.device)
    l = torch.zeros(bh, t_q, 1, device=q.device)
    span_o = torch.zeros(bh, t_q, d, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        s, _, _ = _probs(qf, kf, k0, block_k, 0.0, causal, scale, delta)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        _, p, _ = _probs(qf, kf, k0, block_k, m_new, causal, scale, delta)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        span_o = span_o * alpha + _tie_span(p, TIE_REL * p) @ vf[:, k0:k0 + block_k].abs()
        m = m_new
    return span_o, l


def rounding_tie_bounds(q, k, v, o, lse, do, causal, scale, block_k):
    """Per element of O, dQ, dK and dV, the most that P and dS rounding to
    the other neighbour at a bf16 midpoint can move it: the plain versions'
    loops with each product's left operand replaced by the tie spans of P
    (forward: per K tile, against the running max; backward: from lse) and
    dS, and the right operand by its absolute value."""
    import torch

    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    span_o, l = fwd_tie_span(q, k, v, causal, scale, block_k)
    bounds = {"O": span_o / torch.where(l == 0, 1.0, l)}

    dsum = (dof * of).sum(-1, keepdim=True)
    dsum_abs = (dof * of).abs().sum(-1, keepdim=True)
    span_dq, span_dk, span_dv = torch.zeros_like(qf), [], []
    for k0 in range(0, k.shape[1], block_k):
        _, p, _ = _probs(qf, kf, k0, block_k, lse[..., None], causal, scale, 0)
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        ds = p * (dof @ vb.transpose(1, 2) - dsum) * scale
        # dP - Dsum cancels: its f32 error scales with the sums of |terms|.
        ds_band = TIE_REL * (ds.abs() + p * scale * (dof.abs() @ vb.abs().transpose(1, 2)
                                                     + dsum_abs))
        tie_p, tie_ds = _tie_span(p, TIE_REL * p), _tie_span(ds, ds_band)
        span_dq += tie_ds @ kb.abs()
        span_dk.append(tie_ds.transpose(1, 2) @ qf.abs())
        span_dv.append(tie_p.transpose(1, 2) @ dof.abs())
    bounds.update(dQ=span_dq, dK=torch.cat(span_dk, 1), dV=torch.cat(span_dv, 1))
    return bounds


def block_bwd_tie_bounds(q, k, v, o, l, do, dm, dl, delta, causal, scale, rounded,
                         block_k=64):
    """Per element of the block backward's dQ, dK and dV, the most that a
    rounding tie can move it, and the rows where the max is not clear. Two
    kinds: (1) with ``rounded``, P and dS (which the tensor cores take
    without the tie term) on a bf16 rounding midpoint, as
    ``rounding_tie_bounds``; (2) a row whose max is
    within the f32 error of s (TIE_REL of scale |q| . |k|) of another visible
    score that the plain version does not count as tied: there the kernel,
    whose scores differ from the plain version's in the last bits, may find
    another set of ties and give the row's whole tie term (dm - D) to other
    keys, which moves dQ_i by up to 2 scale |dm - D| |k_j| and dK_j by
    scale |dm - D| |q_i| for each such key j."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    qf, kf, vf = (x.float() for x in (q, k, v))
    dof = do.float()
    dor = dof.to(torch.bfloat16).float() if rounded else dof
    m, c = fa._block_row_max(q, k, delta, causal, scale, block_k)
    m3 = m[..., None]
    d_row = (dof * o).sum(-1) + dl * l
    t_all = dm - d_row

    def near(k0):
        s, _, mask = _probs(qf, kf, k0, block_k, 0.0, causal, scale, delta)
        band = TIE_REL * scale * (qf.abs() @ kf[:, k0:k0 + block_k].abs().transpose(1, 2))
        close = m3 - s <= band
        return s, close if mask is None else close & mask

    n_near = sum(near(k0)[1].sum(-1) for k0 in range(0, k.shape[1], block_k))
    unclear = (n_near > c) & (c > 0)
    w_row = torch.where(unclear, t_all.abs() * scale, 0.0)[..., None]
    span_dq, span_dk, span_dv = torch.zeros_like(qf), [], []
    for k0 in range(0, k.shape[1], block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s, close = near(k0)
        _, p, mask = _probs(qf, kf, k0, block_k, m3, causal, scale, delta)
        w = torch.where(close, w_row, 0.0)
        span_dq += 2 * (w @ kb.abs())
        dk = w.transpose(1, 2) @ qf.abs()
        dv = torch.zeros_like(vb)
        if rounded:
            # dS as the tensor cores take it: without the tie term, which the
            # kernels add in f32.
            ds = p * (dor @ vb.transpose(1, 2) + dl[..., None]) * scale
            ds_band = TIE_REL * (ds.abs() + scale * p * (
                dor.abs() @ vb.abs().transpose(1, 2) + dl.abs()[..., None]))
            tie_p, tie_ds = _tie_span(p, TIE_REL * p), _tie_span(ds, ds_band)
            span_dq += tie_ds @ kb.abs()
            dk = dk + tie_ds.transpose(1, 2) @ qf.abs()
            dv = tie_p.transpose(1, 2) @ dor.abs()
        span_dk.append(dk)
        span_dv.append(dv)
    return ({"dQ": span_dq, "dK": torch.cat(span_dk, 1), "dV": torch.cat(span_dv, 1)},
            int(unclear.sum()))


def gate_a(out, ref, tie, what, rtol=BF16_RTOL, atol=BF16_ATOL):
    """Gate (a): two bf16 ulps of the plain version that rounds as the kernel
    does. An element past them passes only where its excess is within the
    tie bound; returns the max abs error and the count of such elements.
    (With f32 ``rtol``/``atol``, the f32 check with the block backward's
    tie bound for a row max that is not clear.)"""
    import torch

    out, ref = out.detach().float(), ref.detach().float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite values")
    diff = (out - ref).abs()
    limit = atol + rtol * ref.abs()
    beyond = diff > limit
    unexplained = beyond & (diff > limit + tie)
    check(not bool(unexplained.any()),
          f"{what}: {int(unexplained.sum())} elements beyond rtol {rtol} / atol "
          f"{atol} that no rounding tie explains, max abs err {float(diff.max()):.3e}")
    return float(diff.max()), int(beyond.sum())


def b1_bf16_gates(q, k, v, do, causal, scale, tag):
    """B1's bf16 kernels against both plain versions: gate (a), two bf16
    ulps of the plain version that rounds P and dS as the kernels do, past
    which only midpoint ties may carry an element (lse at the f32 forward
    tolerance), and gate (b), the reference's bf16 tolerance against the
    f32-internal plain version. The backward kernels and the plain backwards
    take the same inputs: the kernel's O and lse. Returns the kernel's
    outputs and each output's (error (a), error (b), elements past two ulps
    at ties)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    block_k = fa.kernel_tiles(q.shape[-1])["fwd"][1]
    o, lse = fa._launch_fwd(q, k, v, causal, scale)
    o_a, lse_a = fa._flash_fwd_plain(q, k, v, causal, scale, block_k=block_k, p_dtype=bf)
    o_b, _ = fa._flash_fwd_plain(q, k, v, causal, scale)
    dq, dsum = fa._launch_bwd_dq(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa._launch_bwd_dkdv(q, k, v, do, lse, dsum, causal, scale)
    refs_a = fa._flash_bwd_plain(q, k, v, o, lse, do, causal, scale, p_dtype=bf)
    refs_b = fa._flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
    ties = rounding_tie_bounds(q, k, v, o, lse, do, causal, scale, block_k)
    lse_err = max_err(lse, lse_a, F32_RTOL, F32_ATOL, f"{tag} lse")
    errs = {"lse": (lse_err, lse_err, 0)}
    for name, out, a, b in zip(("O", "dQ", "dK", "dV"), (o, dq, dk, dv), (o_a, *refs_a),
                               (o_b, *refs_b)):
        err_a, n_ties = gate_a(out, a, ties[name], f"{tag} {name} (a)")
        errs[name] = (err_a, max_err(out, b, REF_RTOL, REF_ATOL, f"{tag} {name} (b)"), n_ties)
    print(f"[kernels] {tag}: max abs err (a) vs rounding plain [elements past two ulps at "
          f"bf16 midpoints] / (b) vs f32 plain: "
          + ", ".join(f"{n} {a:.2e} [{c}] / {b:.2e}" for n, (a, b, c) in errs.items()),
          flush=True)
    return (o, lse, dq, dk, dv, dsum), errs


def phase_kernels_f32():
    """f32 with TF32 off: small shapes with every head dim and ragged
    lengths, causal and not, then the GPT-2-small shape (causal, as the
    main path runs it), all at the reference tests' tolerances."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    for (bh, t, d, causal) in SMALL_CASES + [(BATCH * H, SEQ, D, True)]:
        q, k, v, do = _attention_inputs(bh, t, d, torch.float32, seed=t + d)
        scale = d ** -0.5
        o, lse = fa._launch_fwd(q, k, v, causal, scale)
        o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal, scale)
        tag = f"f32 bh={bh} t={t} d={d} causal={causal}"
        e = [max_err(o, o_ref, 2e-4, 2e-5, f"{tag} O"),
             max_err(lse, lse_ref, 2e-4, 2e-5, f"{tag} lse")]
        grads = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
        refs = fa._flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
        for name, a, b in zip(("dQ", "dK", "dV"), grads, refs):
            e.append(max_err(a, b, 1e-3, 1e-4, f"{tag} {name}"))
        print(f"[kernels] {tag}: max abs err {max(e):.2e}", flush=True)


def phase_kernels_bf16():
    """B1's tensor-core kernels at the f32 phase's small cases (every head
    dim, ragged lengths, causal and not) and one non-causal case with
    T_q != T_k, forward and all three gradients through gates (a) and (b)."""
    import torch

    cases = [(bh, t, None, d, causal) for (bh, t, d, causal) in SMALL_CASES]
    for (bh, t, tk, d, causal) in cases + [(2, 136, 200, 64, False)]:
        q, k, v, do = _attention_inputs(bh, t, d, torch.bfloat16, seed=t + d + 2, tk=tk)
        b1_bf16_gates(q, k, v, do, causal, d ** -0.5,
                      f"bf16 bh={bh} tq={t} tk={tk or t} d={d} causal={causal}")


def phase_kernels_bench():
    """The GPT-2-small attention shape in bf16: parity and times."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    bh, t = BATCH * H, SEQ
    q, k, v, do = _attention_inputs(bh, t, D, torch.bfloat16, seed=0)
    scale = D ** -0.5
    (o, lse, _, _, _, dsum), errs = b1_bf16_gates(q, k, v, do, True, scale,
                                                 f"bf16 bh={bh} t={t} d={D} causal")
    # The JSON's error is gate (a)'s, against the plain version that rounds
    # as the kernel does.
    err_fwd = max(errs["O"][0], errs["lse"][0])
    err_dq = errs["dQ"][0]
    err_dkdv = max(errs["dK"][0], errs["dV"][0])

    ms_fwd = time_ms(lambda: fa._launch_fwd(q, k, v, True, scale), reps=20)
    ms_dq = time_ms(lambda: fa._launch_bwd_dq(q, k, v, o, lse, do, True, scale), reps=20)
    ms_dkdv = time_ms(lambda: fa._launch_bwd_dkdv(q, k, v, do, lse, dsum, True, scale),
                      reps=20)
    plain_fwd = time_ms(lambda: fa._flash_fwd_plain(q, k, v, True, scale), reps=5)
    plain_bwd = time_ms(lambda: fa._flash_bwd_plain(q, k, v, o, lse, do, True, scale),
                        reps=5)
    # The library yardstick, on the same inputs in [B, H, T, D].
    q4, k4, v4, do4 = (x.view(BATCH, H, t, D) for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                      reps=20)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                  retain_graph=True), reps=20)

    # Bounds: each input read once, each output written once, against the
    # operations on the causal entries (T(T+1)/2 per row block), bf16 peak.
    el, rows = bh * t * D, bh * t
    entries = bh * t * (t + 1) / 2
    b_fwd = bound(2 * 4 * el + 4 * rows, 4 * D * entries)
    b_dq = bound(2 * 6 * el + 4 * 2 * rows, 6 * D * entries)
    b_dkdv = bound(2 * 6 * el + 4 * 2 * rows, 8 * D * entries)
    print(f"[kernels] ms: fwd {ms_fwd:.4f} (plain {plain_fwd:.4f}, sdpa {lib_fwd:.4f}, "
          f"bound {b_fwd[0]:.4f} by {b_fwd[1]}); bwd dQ {ms_dq:.4f} + dK/dV {ms_dkdv:.4f} "
          f"(plain {plain_bwd:.4f}, sdpa backward dQ+dK+dV {lib_bwd:.4f}, bounds "
          f"{b_dq[0]:.4f} by {b_dq[1]} + {b_dkdv[0]:.4f} by {b_dkdv[1]})", flush=True)
    replaced = REPLACED
    return {
        "flash_fwd": dict(replaces=f"{replaced}:98", max_abs_err=err_fwd, ms=ms_fwd,
                          plain_ms=plain_fwd, bound=b_fwd, library_ms=lib_fwd),
        # The plain backward computes dQ, dK and dV together; no one library
        # call computes dQ alone or dK/dV alone.
        "flash_bwd_dq": dict(replaces=f"{replaced}:237", max_abs_err=err_dq, ms=ms_dq,
                             plain_ms=plain_bwd, bound=b_dq, library_ms=None),
        "flash_bwd_dkdv": dict(replaces=f"{replaced}:237", max_abs_err=err_dkdv,
                               ms=ms_dkdv, plain_ms=plain_bwd, bound=b_dkdv,
                               library_ms=None),
    }


def _block_cotangents(o, m, l, seed, merge_scale=False):
    """Random f32 cotangents (dO, dm, dl) of a block's (O, m, l). With
    ``merge_scale``, dO and dl are divided by the row's l, as the ring's
    merge hands them to a block (it divides the unnormalised O and l by the
    merged row sum), so that the gradients have the size of an attention
    output's, and the reference's absolute bf16 floor (5e-2) means what it
    means for B1; without, they are of unit size, and the gradients of an
    unnormalised block at T 4096 reach hundreds."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    do, dm, dl = (torch.randn(x.shape, device="cuda", generator=g) for x in (o, m, l))
    if merge_scale:
        l_div = torch.where(l == 0, 1.0, l)
        do, dl = do / l_div[..., None], dl / l_div
    return do, dm, dl


def _visible(t, delta, causal):
    """The (query, key) pairs a block of T queries and T keys computes."""
    if not causal:
        return t * t
    return sum(max(0, min(t, i - delta + 1)) for i in range(t))


def phase_block_f32():
    """B2 in f32 with TF32 off at the small shapes (ragged lengths
    included), causal and not, at delta -T, 0, +T/2 (cutting through tiles)
    and +T (no key visible): the forward (O, m, l) at 2e-4 / 2e-5, and the
    block backward (the dQ and dK/dV kernels in block mode) at 1e-3 / 1e-4
    against the plain version, both fed the kernel forward's O and l and
    random cotangents; past the tolerance an element may go only by a row
    max the f32 scores leave unclear (``block_bwd_tie_bounds``). At delta >=
    T the forward is exactly m = -1e30, l = 0, O = 0 and the gradients
    exactly 0."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    for (bh, t, d) in ((3, 200, 32), (4, 256, 64), (2, 136, 128)):
        q, k, v, _ = _attention_inputs(bh, t, d, torch.float32, seed=t + d + 1)
        scale = d ** -0.5
        errs, grad_errs, unclear = [], [], 0
        for causal in (True, False):
            for delta in (-t, 0, t // 2, t):
                o, m, l = fa._launch_block_fwd(q, k, v, delta, causal, scale)
                refs = fa._flash_block_plain(q, k, v, delta, causal, scale)
                tag = f"block f32 bh={bh} t={t} d={d} causal={causal} delta={delta}"
                for name, a, b in zip(("O", "m", "l"), (o, m, l), refs):
                    errs.append(max_err(a, b, F32_RTOL, F32_ATOL, f"{tag} {name}"))
                do, dm, dl = _block_cotangents(o, m, l, seed=t + d + 2)
                grads = fa._launch_block_bwd(q, k, v, o, l, do, dm, dl, delta, causal, scale)
                want = fa._flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, delta, causal,
                                                 scale)
                ties, n_unclear = block_bwd_tie_bounds(q, k, v, o, l, do, dm, dl, delta, causal,
                                                       scale, rounded=False)
                unclear += n_unclear
                for name, a, b in zip(("dQ", "dK", "dV"), grads, want):
                    grad_errs.append(gate_a(a, b, ties[name], f"{tag} {name}", 1e-3, 1e-4)[0])
                if causal and delta >= t:
                    check(bool((m == -1e30).all() and (l == 0).all() and (o == 0).all()),
                          f"{tag}: a block with no visible key must give m = -1e30, "
                          f"l = 0, O = 0 exactly")
                    check(all(bool((g == 0).all()) for g in grads),
                          f"{tag}: a block with no visible key must give zero gradients")
        print(f"[block] f32 bh={bh} t={t} d={d}, causal and not, delta -T/0/+T/2/+T: "
              f"forward max abs err {max(errs):.2e}, backward {max(grad_errs):.2e} (rows "
              f"with an unclear max {unclear}); delta >= T exact", flush=True)


def _block_fwd_gates(q, k, v, delta, scale, tag):
    """bf16 B2 forward through gates (a) and (b): O / l (the attention output
    it scales, with the rounding plain version's l for both) at two bf16
    ulps of the plain version that rounds P as the kernel does, past which
    only P on a midpoint may carry an element, and at the reference's bf16
    tolerance of the f32-internal one; m and l at the f32 forward tolerance
    of the rounding one (l sums the unrounded P). Returns the kernel's
    (O, m, l) and the largest error of gate (a)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    block_k = fa.kernel_tiles(q.shape[-1])["fwd"][1]
    o, m, l = fa._launch_block_fwd(q, k, v, delta, True, scale)
    o_a, m_a, l_a = fa._flash_block_plain(q, k, v, delta, True, scale, block_k=block_k,
                                          p_dtype=torch.bfloat16)
    o_b, _, l_b = fa._flash_block_plain(q, k, v, delta, True, scale)
    span, _ = fwd_tie_span(q, k, v, True, scale, block_k, delta)
    div_a = torch.where(l_a == 0, 1.0, l_a)[..., None]
    div_b = torch.where(l_b == 0, 1.0, l_b)[..., None]
    err_a, n_ties = gate_a(o / div_a, o_a / div_a, span / div_a, f"{tag} O / l (a)")
    err_b = max_err(o / div_b, o_b / div_b, REF_RTOL, REF_ATOL, f"{tag} O / l (b)")
    err_m = max_err(m, m_a, F32_RTOL, F32_ATOL, f"{tag} m")
    err_l = max_err(l, l_a, F32_RTOL, F32_ATOL, f"{tag} l")
    print(f"[block] {tag} forward: O / l (a) {err_a:.2e} [{n_ties} past two ulps at bf16 "
          f"midpoints] / (b) {err_b:.2e}; m {err_m:.2e}, l {err_l:.2e}", flush=True)
    return (o, m, l), max(err_a, err_m, err_l)


def _block_bwd_gates(q, k, v, o, l, do, dm, dl, delta, scale, tag, gate_b=True):
    """The bf16 block backward kernels through gates (a) and (b): two bf16
    ulps of the plain version that rounds P, dS and dO as the kernels do,
    past which only a rounding tie may carry an element (P or dS on a bf16
    midpoint, or a row max the scores leave unclear), and the reference's
    bf16 tolerance against the f32-internal plain version. Both plain
    versions take the kernel forward's O and l. Returns the kernels'
    gradients and the largest error of gate (a) for dQ and for dK/dV."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    grads = fa._launch_block_bwd(q, k, v, o, l, do, dm, dl, delta, True, scale)
    refs_a = fa._flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, delta, True, scale,
                                       block_k=64, p_dtype=torch.bfloat16)
    refs_b = (fa._flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, delta, True, scale,
                                        block_k=64) if gate_b else (None,) * 3)
    ties, unclear = block_bwd_tie_bounds(q, k, v, o, l, do, dm, dl, delta, True, scale,
                                         rounded=True)
    errs = {}
    for name, out, a, b in zip(("dQ", "dK", "dV"), grads, refs_a, refs_b):
        err_a, n_ties = gate_a(out, a, ties[name], f"{tag} {name} (a)")
        err_b = (max_err(out, b, REF_RTOL, REF_ATOL, f"{tag} {name} (b)") if gate_b
                 else float("nan"))
        errs[name] = (err_a, err_b, n_ties)
    print(f"[block] {tag} backward: max abs err (a) [past two ulps at ties] / (b): "
          + ", ".join(f"{n} {a:.2e} [{c}] / {b:.2e}" for n, (a, b, c) in errs.items())
          + f"; largest |dQ| {float(grads[0].float().abs().max()):.3g}; rows with an "
          f"unclear max {unclear}", flush=True)
    return grads, errs["dQ"][0], max(errs["dK"][0], errs["dV"][0])


def phase_block_bench(card):
    """B2 in bf16 at the long-context slice's shape (BH 2 x 12, T 4096, D
    64): the forward on the tensor cores and the block backward (dQ and
    dK/dV kernels) through gates (a) and (b) at delta -T (a block from an
    earlier rank: every key visible), 0 (the one-rank ring's only block) and
    +T/2; at delta +T exact (m = -1e30, l = 0, O = 0; zero gradients); one
    case with duplicated keys (every even key repeated) and unit dm, whose
    rows tie at their max, so that the dQ and dK/dV kernels must find the
    same ties; then times, in turns and in this run: the forward against the
    CUDA-core kernel it replaces, and the backward kernels against the dense
    recompute (PyTorch) they replace, with the plain versions and bounds."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    bh, t = SP_BATCH * H, SP_SEQ
    q, k, v, _ = _attention_inputs(bh, t, D, torch.bfloat16, seed=4)
    scale = D ** -0.5
    tag = f"bf16 bh={bh} t={t} d={D} causal"
    errs = {"fwd": [], "dq": [], "dkdv": []}
    cases = {}
    for delta in (-t, 0, t // 2):
        (o, m, l), e = _block_fwd_gates(q, k, v, delta, scale, f"{tag} delta={delta}")
        errs["fwd"].append(e)
        do, dm, dl = _block_cotangents(o, m, l, seed=5, merge_scale=True)
        _, e_dq, e_dkdv = _block_bwd_gates(q, k, v, o, l, do, dm, dl, delta, scale,
                                           f"{tag} delta={delta}")
        errs["dq"].append(e_dq)
        errs["dkdv"].append(e_dkdv)
        cases[delta] = (o, l, do, dm, dl)
        if delta == 0:
            # Unit cotangents: dm - D in the hundreds, which the kernels' tie
            # term carries in f32. Gate (a) alone: at that size the
            # reference's absolute floor is below bf16's resolution. Its
            # errors, on gradients of hundreds, are printed, not put in the
            # kernel table beside the others'.
            _block_bwd_gates(q, k, v, o, l, *_block_cotangents(o, m, l, 7), delta, scale,
                             f"{tag} delta={delta}, unit cotangents", gate_b=False)
    o, m, l = fa._launch_block_fwd(q, k, v, t, True, scale)
    do, dm, dl = _block_cotangents(o, m, l, seed=5)
    grads = fa._launch_block_bwd(q, k, v, o, l, do, dm, dl, t, True, scale)
    check(bool((m == -1e30).all() and (l == 0).all() and (o == 0).all())
          and all(bool((g == 0).all()) for g in grads),
          f"{tag} delta={t}: a block with no visible key must give m = -1e30, l = 0, O = 0 "
          f"and zero gradients exactly")
    print(f"[block] {tag} delta={t}: m = -1e30, l = 0, O = 0 and zero gradients, exactly",
          flush=True)

    k_dup = k.clone()
    k_dup[:, 1::2] = k_dup[:, 0::2]
    o, m, l = fa._launch_block_fwd(q, k_dup, v, 0, True, scale)
    do, _, dl = _block_cotangents(o, m, l, seed=6, merge_scale=True)
    dm = torch.ones_like(m)
    _, c = fa._block_row_max(q, k_dup, 0, True, scale, 64)
    n_tied = int((c >= 2).sum())
    check(n_tied > 0, "duplicated keys: no row ties at its max")
    _, e_dq, e_dkdv = _block_bwd_gates(q, k_dup, v, o, l, do, dm, dl, 0, scale,
                                       f"{tag} delta=0, duplicated keys ({n_tied} rows tied "
                                       f"at their max), dm = 1")
    errs["dq"].append(e_dq)
    errs["dkdv"].append(e_dkdv)

    # Times at delta 0 and -T, in turns: the replaced version, the kernel,
    # the kernel, the replaced version.
    o, l, do, dm, dl = cases[0]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def dense_bwd():
        out = fa._dense_block(qg, kg, vg, 0, scale, True)
        return torch.autograd.grad(out, (qg, kg, vg), (do, dm, dl))

    times = {"fwd": [], "legacy": [], "bwd": [], "dense": []}
    for delta in (0, -t):
        for legacy in (True, False, False, True):
            times["legacy" if legacy else "fwd"].append(time_ms(
                lambda: fa._launch_block_fwd(q, k, v, delta, True, scale, legacy=legacy), reps=10))
    fwd_ms = {0: statistics.mean(times["fwd"][:2]), -t: statistics.mean(times["fwd"][2:])}
    legacy_ms = {0: statistics.mean(times["legacy"][:2]), -t: statistics.mean(times["legacy"][2:])}
    torch.cuda.reset_peak_memory_stats()
    for dense in (True, False, False, True):
        if dense:
            times["dense"].append(time_ms(dense_bwd, reps=3, warmup=1))
        else:
            times["bwd"].append(time_ms(
                lambda: fa._launch_block_bwd(q, k, v, o, l, do, dm, dl, 0, True, scale), reps=10))
    dense_peak = torch.cuda.max_memory_allocated() / 2**30
    # The pair's parts, each timed alone on the same inputs.
    _, do_k, rows = fa._launch_block_bwd_dq(q, k, v, o, l, do, dm, dl, 0, True, scale)
    ms_dq = time_ms(lambda: fa._launch_block_bwd_dq(q, k, v, o, l, do, dm, dl, 0, True, scale),
                    reps=10)
    ms_dkdv = time_ms(lambda: fa._launch_block_bwd_dkdv(q, k, v, do_k, rows, 0, True, scale),
                      reps=10)
    o_m1, l_m1 = cases[-t][0], cases[-t][1]
    do_m1, dm_m1, dl_m1 = cases[-t][2:]
    bwd_m1 = time_ms(lambda: fa._launch_block_bwd(q, k, v, o_m1, l_m1, do_m1, dm_m1, dl_m1, -t,
                                                  True, scale), reps=10)
    bk = fa.kernel_tiles(D)["fwd"][1]
    plain_fwd = time_ms(lambda: fa._flash_block_plain(q, k, v, 0, True, scale, block_k=bk,
                                                      p_dtype=torch.bfloat16), reps=2, warmup=1)
    plain_bwd = time_ms(lambda: fa._flash_block_bwd_plain(q, k, v, o, l, do, dm, dl, 0, True,
                                                          scale, block_k=64,
                                                          p_dtype=torch.bfloat16),
                        reps=2, warmup=1)

    # Bounds: each input read once, each output written once; operations on
    # the visible (query, key) pairs at the bf16 peak.
    el, rows_n = bh * t * D, bh * t
    vis = {dl_: bh * _visible(t, dl_, True) for dl_ in (0, -t)}
    b_fwd = {dl_: bound(2 * 3 * el + 4 * el + 4 * 2 * rows_n, 4 * D * vis[dl_]) for dl_ in vis}
    # dQ: q, k, v (bf16), O and dO (f32), l, dm, dl in; dQ (bf16), m, Dsum and
    # the tie coefficient out; S, dP and dQ. dK/dV: q, k, v, dO (bf16) and the
    # three row terms in, dK and dV out; S, dP, dV and dK.
    b_dq = bound(2 * 3 * el + 4 * 2 * el + 4 * 3 * rows_n + 2 * el + 4 * 3 * rows_n,
                 6 * D * vis[0])
    b_dkdv = bound(2 * 4 * el + 4 * 3 * rows_n + 2 * 2 * el, 8 * D * vis[0])
    # The whole backward's work: five products, q, k, v, O, dO, l, dm, dl in,
    # dq, dk, dv out.
    b_bwd = {dl_: bound(2 * 3 * el + 4 * 2 * el + 4 * 3 * rows_n + 2 * 3 * el,
                        10 * D * vis[dl_]) for dl_ in vis}
    dense = statistics.mean(times["dense"])
    bwd = statistics.mean(times["bwd"])
    for dl_ in (0, -t):
        print(f"[block] {tag} delta={dl_} on {card}: forward ms tensor cores "
              f"{fwd_ms[dl_]:.4f} vs CUDA cores {legacy_ms[dl_]:.4f} (runs "
              f"{[round(x, 4) for x in times['fwd'][(0 if dl_ == 0 else 2):][:2]]} / "
              f"{[round(x, 4) for x in times['legacy'][(0 if dl_ == 0 else 2):][:2]]}), bound "
              f"{b_fwd[dl_][0]:.4f} by {b_fwd[dl_][1]} ({fwd_ms[dl_] / b_fwd[dl_][0]:.1f}x)",
              flush=True)
    print(f"[block] {tag} backward on {card}: kernels dQ + dK/dV {bwd:.4f} ms at delta 0 (runs "
          f"{[round(x, 4) for x in times['bwd']]}; alone dQ {ms_dq:.4f} + dK/dV "
          f"{ms_dkdv:.4f}), {bwd_m1:.4f} at delta -T; dense recompute (PyTorch) {dense:.4f} "
          f"(runs {[round(x, 4) for x in times['dense']]}, peak memory {dense_peak:.2f} GiB); "
          f"bounds: the work {b_bwd[0][0]:.4f} by {b_bwd[0][1]} at delta 0 "
          f"({bwd / b_bwd[0][0]:.1f}x), {b_bwd[-t][0]:.4f} at -T; dQ {b_dq[0]:.4f}, dK/dV "
          f"{b_dkdv[0]:.4f}; plain forward {plain_fwd:.4f}, plain backward {plain_bwd:.4f}",
          flush=True)
    # No PyTorch call returns the unnormalised O with the row max and sum
    # (scaled_dot_product_attention normalises), nor this VJP.
    return {
        "flash_block_fwd": dict(max_abs_err=max(errs["fwd"]), ms=fwd_ms[0], plain_ms=plain_fwd,
                                bound=b_fwd[0], library_ms=None),
        "flash_block_bwd_dq": dict(max_abs_err=max(errs["dq"]), ms=ms_dq, plain_ms=plain_bwd,
                                   bound=b_dq, library_ms=None),
        "flash_block_bwd_dkdv": dict(max_abs_err=max(errs["dkdv"]), ms=ms_dkdv,
                                     plain_ms=plain_bwd, bound=b_dkdv, library_ms=None),
    }


def phase_ring_merge():
    """One card plays a 4-rank ring: each sequence piece of a bf16
    GPT-2-small attention input at T 4096 merges its 4 B2 blocks in the
    order ring rank r sees them (source (r - s) mod 4 at step s). B2 takes P
    in bf16 on the tensor cores, so the merge is held as B1's forward is:
    gate (a), two bf16 ulps of the same merge over the plain blocks that
    round P as the kernel does, past which only P on a bf16 midpoint may
    carry an element; gate (b), the reference's bf16 tolerance against the
    f32-internal plain forward over the whole sequence; and B1's forward
    over the whole sequence at the same tolerance."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    bh, t, n = SP_BATCH * H, SP_SEQ, 4
    tl = t // n
    q, k, v, _ = _attention_inputs(bh, t, D, torch.bfloat16, seed=6)
    scale = D ** -0.5
    block_k = fa.kernel_tiles(D)["fwd"][1]
    full, _ = fa._launch_fwd(q, k, v, True, scale)
    plain, _ = fa._flash_fwd_plain(q, k, v, True, scale)
    piece = lambda x, i: x[:, i * tl:(i + 1) * tl].contiguous()

    def merged(block):
        """The ring's merge over ``block(q, k, v, delta)``'s (O, m, l, span)."""
        outs, spans = [], []
        for r in range(n):
            m = torch.full((bh, tl), -1e30, device=q.device)
            l = torch.zeros(bh, tl, device=q.device)
            o = torch.zeros(bh, tl, D, device=q.device)
            span = torch.zeros_like(o)
            for s in range(n):
                src = (r - s) % n
                o_s, m_s, l_s, span_s = block(piece(q, r), piece(k, src), piece(v, src),
                                              (src - r) * tl)
                m_new = torch.maximum(m, m_s)
                c, c_s = torch.exp(m - m_new), torch.exp(m_s - m_new)
                o = o * c[..., None] + o_s * c_s[..., None]
                span = span * c[..., None] + span_s * c_s[..., None]
                l = l * c + l_s * c_s
                m = m_new
            div = torch.where(l == 0, 1.0, l)[..., None]
            outs.append((o / div).to(torch.bfloat16))
            spans.append(span / div)
        return torch.cat(outs, dim=1), torch.cat(spans, dim=1)

    def kernel_block(qp, kp, vp, delta):
        return (*fa._launch_block_fwd(qp, kp, vp, delta, True, scale), 0.0)

    def plain_block(qp, kp, vp, delta):
        o, m, l = fa._flash_block_plain(qp, kp, vp, delta, True, scale, block_k=block_k,
                                        p_dtype=torch.bfloat16)
        return o, m, l, fwd_tie_span(qp, kp, vp, True, scale, block_k, delta)[0]

    out, _ = merged(kernel_block)
    want, span = merged(plain_block)
    err_a, n_ties = gate_a(out, want, span, "ring merge (a) vs the merged rounding plain blocks")
    err_b = max_err(out, plain, REF_RTOL, REF_ATOL, "ring merge (b) vs the f32 plain forward")
    err_b1 = max_err(out, full, REF_RTOL, REF_ATOL, "ring merge vs B1")
    print(f"[ring] 4 pieces x 4 blocks merged on one card over T {t} (bh={bh}, d={D}, "
          f"causal, bf16): max abs err (a) {err_a:.2e} vs the merged rounding plain blocks "
          f"[{n_ties} past two ulps at bf16 midpoints], (b) {err_b:.2e} vs the f32-internal "
          f"plain forward, {err_b1:.2e} vs B1", flush=True)


def phase_small_model():
    """A small f32 model on the card (kernels) against the same weights on
    the CPU (plain versions): logits, loss and every gradient."""
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    dims = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=128)
    cpu = TransformerLM(**dims, dtype=torch.float32, device="cpu", seed=1)
    gpu = TransformerLM(**dims, dtype=torch.float32, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 512, (2, 128), generator=g)
    labels = torch.randint(0, 512, (2, 128), generator=g)
    results = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        logits = model(tokens.to(dev))
        loss = lm_loss(logits, labels.to(dev))
        loss.backward()
        results.append((logits, loss, {n: p.grad for n, p in model.named_parameters()}))
    (lc, sc, gc), (lg, sg, gg) = results
    check(lg.shape == (2, 128, 512), f"logits shape {tuple(lg.shape)}")
    # f32 everywhere; the kernels and the plain versions sum in other
    # orders, so the tolerance is the gradient one of the flash tests.
    err = max_err(lg.cpu(), lc, 1e-3, 1e-4, "small model logits")
    err = max(err, max_err(sg.cpu(), sc, 1e-3, 1e-4, "small model loss"))
    for n in gc:
        err = max(err, max_err(gg[n].cpu(), gc[n], 1e-3, 1e-4, f"small model grad {n}"))
    print(f"[slice] small f32 model, card vs CPU: max abs err {err:.2e} over logits, "
          f"loss and {len(gc)} gradients", flush=True)


def phase_train():
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa

    hvd.init()
    try:
        check(hvd.size() == 1, f"expected one rank, got {hvd.size()}")
        model = TransformerLM(**GPT2_SMALL, max_len=SEQ, dtype=torch.bfloat16, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        rng = np.random.RandomState(0)
        tokens = torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"], (BATCH, SEQ))).cuda()
        labels = torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"], (BATCH, SEQ))).cuda()
        hvd.broadcast_parameters(model.state_dict())
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8),
            named_parameters=model.named_parameters(),
        )
        step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
        fa.FWD_LAUNCHES = 0
        fa.BWD_LAUNCHES = 0
        losses, times = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(model, (tokens, labels)))
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        launches = {"fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
        print(f"[slice] GPT-2-small, {n_params} params, batch {BATCH} x {SEQ} tokens, "
              f"NCCL world size {hvd.size()}: losses {losses}", flush=True)
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(launches["fwd"] > 0 and launches["bwd"] > 0, f"flash launches {launches}")
        med = statistics.median(times[1:])
        print(f"[slice] step ms median {med * 1e3:.2f} (steps 2-{STEPS}; first "
              f"{times[0] * 1e3:.1f}), tokens/s {BATCH * SEQ / med:.0f}, flash launches "
              f"{launches}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        profile_step(lambda: float(step(model, (tokens, labels))))
        return launches, BATCH * SEQ / med
    finally:
        hvd.shutdown()


def phase_head_dims():
    """Head dims the flash kernels are not built for: GPT-2-small's width
    with 48 heads (D 16, padded to 32) and with 8 heads (D 96, padded to
    128), 2 layers, batch 8 x 1024, 3 AdamW steps each on the card: the
    loss must be finite and fall, and the flash forward and backward must
    have launched (the adapter pads; it does not fall back)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(3)
    tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                   (BATCH, SEQ))).cuda() for _ in range(2))
    for heads in (48, 8):
        dims = dict(GPT2_SMALL, n_heads=heads, n_layers=2)
        model = TransformerLM(**dims, max_len=SEQ, dtype=torch.bfloat16, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8)
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        losses = []
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = lm_loss(model(tokens), labels)
            loss.backward()
            opt.step()
            losses.append(float(loss))
        launches = {"fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
        d = dims["d_model"] // heads
        print(f"[head-dims] GPT-2-small width, {heads} heads (D {d}, the kernels' "
              f"{fa._padded(d)}), 2 layers, batch {BATCH} x {SEQ}: losses {losses}, flash "
              f"launches {launches}", flush=True)
        check(all(np.isfinite(losses)), f"D {d}: non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"D {d}: loss did not fall: {losses}")
        check(launches == {"fwd": 3 * 2, "bwd": 3 * 2}, f"D {d}: flash launches {launches}")


RING_RANKS = 4           # the virtual ranks of [dp-variants]' rings
RING_CPU_BUCKETS = 2     # buckets also played on the CPU (bitwise check)
DP_VARIANTS = {          # DistributedOptimizer options of [dp-variants]' steps
    "plain": {},
    "overlap": dict(overlap=True),
    "zero1": dict(zero1=True),
    "zero1-overlap": dict(zero1=True, overlap=True),
    "quantized": dict(quantized=True),
    "skip": dict(nonfinite="skip"),
}
SKIP_AT = 2              # the step the skip variant's batch is made non-finite
DP_STEPS = 10            # steps of each variant, in turns


def _ring_buckets():
    """GPT-2-small's gradient buckets, f32, at the 64 MiB threshold: the
    element count of each (``plan_buckets`` over the model's leaves in the
    JAX package's order)."""
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import fusion

    meta = TransformerLM(**GPT2_SMALL, max_len=SEQ, dtype=torch.float32, device="meta")
    leaves = fusion.tree_leaves(fusion.named_tree(list(meta.named_parameters())))
    leaves = [torch.empty(l.shape, dtype=torch.float32, device="meta") for l in leaves]
    return [sum(leaves[i].numel() for i in b) for b in fusion.plan_buckets(leaves, 64 << 20)]


def phase_dp_variants(card):
    """[dp-variants]: (1) the int8 ring allreduce and reduce-scatter of
    ops/quantized.py at 4 virtual ranks on the card over GPT-2-small's f32
    gradient buckets, against the same code on the CPU (bitwise, on the
    first and the last bucket) and the f32 sum (< 3% relative L2, every
    bucket), with the ms and the kernel launches a hop; (2) the GPT-2-small
    DP step at 8 x 1024 with each variant of DP_VARIANTS, in turns with the
    plain step: finite, falling loss, B1 launched, the streamed hooks fired
    for every group, and for skip one non-finite batch leaving the
    parameters bitwise unchanged."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantized as q

    t_phase = time.perf_counter()
    n = RING_RANKS
    sizes = _ring_buckets()
    total = sum(sizes)
    print(f"[dp-variants] GPT-2-small gradients: {total} f32 elements "
          f"({total * 4 / 2**30:.3f} GiB) in {len(sizes)} buckets of 64 MiB", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = [torch.randn(n, size, device="cuda", generator=gen) * 1e-2 for size in sizes]

    def rs_len(size):
        k = -(-size // n)
        return n * (-(-k // q.BLOCK) * q.BLOCK)

    def ring_all(dev):
        ar, rs = [], []
        for i, x in enumerate(inputs):
            if dev == "cpu" and i not in (0, len(inputs) - 1):
                ar.append(None)
                rs.append(None)
                continue
            xs = x.to(dev)
            xp = torch.nn.functional.pad(xs, (0, rs_len(x.shape[1]) - x.shape[1]))
            ar.append(play_ring(n, lambda ring: q.quantized_ring_allreduce(xs[ring.rank],
                                                                           ring=ring)))
            rs.append(play_ring(n, lambda ring: q.quantized_ring_reduce_scatter(
                xp[ring.rank], ring=ring)))
        return ar, rs

    ring_all("cuda")                        # warm up the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ar, rs = ring_all("cuda")
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ring_all("cuda")
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    hops = len(sizes) * n * (2 * (n - 1) + (n - 1))       # every virtual rank's hops
    ar_cpu, rs_cpu = ring_all("cpu")
    worst = 0.0
    for i, x in enumerate(inputs):
        exact = x.sum(0)
        k = rs_len(x.shape[1]) // n
        exact_rs = torch.nn.functional.pad(exact, (0, n * k - exact.numel())).reshape(n, k)
        for r in range(n):
            check(torch.equal(ar[i][r], ar[i][0]), f"int8 allreduce bucket {i}: ranks differ")
            for got, want in ((ar[i][r], exact), (rs[i][r], exact_rs[r])):
                rel = float((got - want).norm() / want.norm())
                worst = max(worst, rel)
                check(rel < 3e-2, f"int8 ring bucket {i} rank {r}: rel L2 {rel:.3e} >= 3e-2")
            if ar_cpu[i] is not None:
                for what, card_out, cpu_out in (("allreduce", ar[i][r], ar_cpu[i][r]),
                                                ("reduce-scatter", rs[i][r], rs_cpu[i][r])):
                    off = card_out.cpu() != cpu_out
                    check(not bool(off.any()),
                          f"int8 {what} bucket {i} rank {r}: card != CPU at {int(off.sum())} "
                          f"elements, max abs {float((card_out.cpu() - cpu_out).abs().max()):.3e}")
    print(f"[dp-variants] int8 ring over {n} virtual ranks on {card}: allreduce and "
          f"reduce-scatter of every bucket in {ring_s * 1e3:.1f} ms, {hops} hops of the "
          f"virtual ranks, {ring_s * 1e3 / hops:.3f} ms and {launches / hops:.1f} kernel "
          f"launches a hop (one card plays all {n} ranks: a hop's time is its quantize, "
          f"pack, copy and dequantize, no link); worst rel L2 to the f32 sum {worst:.3e}; "
          f"buckets 0 and {len(sizes) - 1} bitwise equal to the CPU", flush=True)
    del inputs, ar, rs, ar_cpu, rs_cpu
    torch.cuda.empty_cache()

    hvd.init()
    try:
        rng = np.random.RandomState(4)
        tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                       (BATCH, SEQ))).cuda() for _ in range(2))
        one, nan = torch.tensor(1.0, device="cuda"), torch.tensor(float("nan"), device="cuda")
        runs = {}
        for name, kw in DP_VARIANTS.items():
            model = TransformerLM(**GPT2_SMALL, max_len=SEQ, dtype=torch.bfloat16, seed=0)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8),
                named_parameters=model.named_parameters(), **kw)
            step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]) * b[2], opt)
            runs[name] = dict(model=model, opt=opt, step=step, losses=[], times=[])
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        for s in range(DP_STEPS):
            for name, run in runs.items():      # in turns
                poisoned = name == "skip" and s == SKIP_AT
                if poisoned:
                    before = [p.detach().clone() for p in run["model"].parameters()]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(run["step"](run["model"], (tokens, labels, nan if poisoned else one)))
                run["times"].append(time.perf_counter() - t0)
                run["losses"].append(loss)
                if poisoned:
                    check(np.isnan(loss), f"skip: the poisoned step's loss is {loss}")
                    check(all(torch.equal(a, p) for a, p in zip(before, run["model"].parameters())),
                          "skip: a non-finite batch changed the parameters")
                if "overlap" in DP_VARIANTS[name]:
                    launched, early, groups = run["opt"].streamed_groups
                    check(launched == groups > 1, f"{name}: the hooks launched {launched} of "
                          f"{groups} groups inside the backward (a post-hoc fallback)")
                    check(s == 0 or early > 0, f"{name}: no group launched before the "
                          f"backward's last gradient in step {s + 1}")
        launches = {"fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
        layers = GPT2_SMALL["n_layers"]
        want = DP_STEPS * layers * len(runs)
        check(launches == {"fwd": want, "bwd": want}, f"[dp-variants] flash launches {launches}")
        plain = statistics.median(runs["plain"]["times"][1:])
        for name, run in runs.items():
            finite = [l for i, l in enumerate(run["losses"])
                      if not (name == "skip" and i == SKIP_AT)]
            check(all(np.isfinite(finite)), f"{name}: non-finite loss {run['losses']}")
            check(finite[-1] < finite[0], f"{name}: loss did not fall: {run['losses']}")
            med = statistics.median(run["times"][1:])
            print(f"[dp-variants] {name} {DP_VARIANTS[name]}: losses {run['losses']}; step ms "
                  f"median {med * 1e3:.2f} (steps 2-{DP_STEPS}, in turns) against plain "
                  f"{plain * 1e3:.2f} ({med / plain:.3f}x); streamed groups "
                  f"{run['opt'].streamed_groups}", flush=True)
        print(f"[dp-variants] B1 launches over the {len(runs)} variants' steps {launches}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with all "
              f"{len(runs)} models resident; phase took {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    finally:
        hvd.shutdown()
    del runs
    torch.cuda.empty_cache()


def phase_sp_train():
    import numpy as np
    import torch
    from functools import partial
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    from horovod_tpu_torch.parallel.sp import make_sp_train_step

    hvd.init()
    try:
        mesh = build_mesh({"data": 1, "seq": 1})
        model = TransformerLM(
            **GPT2_SMALL, max_len=SP_SEQ, dtype=torch.bfloat16, seed=0, remat=True,
            attn_fn=partial(ring_attention, group=mesh.get_group("seq"), causal=True))
        rng = np.random.RandomState(1)
        tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                       (SP_BATCH, SP_SEQ))).cuda()
                          for _ in range(2))
        step = make_sp_train_step(
            lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
            torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8),
            mesh)
        torch.cuda.reset_peak_memory_stats()
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = fa.BLOCK_LAUNCHES = fa.BLOCK_BWD_LAUNCHES = 0
        losses, times = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(model, tokens, labels)))
            times.append(time.perf_counter() - t0)
        launches = {"block": fa.BLOCK_LAUNCHES, "block_bwd": fa.BLOCK_BWD_LAUNCHES,
                    "fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
        print(f"[sp] GPT-2-small, ring attention on a data 1 x seq 1 mesh, remat, batch "
              f"{SP_BATCH} x {SP_SEQ} tokens: losses {losses}", flush=True)
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(launches["block"] > 0 and launches["block_bwd"] > 0,
              f"ring block launches {launches}")
        med = statistics.median(times[1:])
        print(f"[sp] step ms median {med * 1e3:.2f} (steps 2-{STEPS}; first "
              f"{times[0] * 1e3:.1f}), tokens/s {SP_BATCH * SP_SEQ / med:.0f}, launches "
              f"{launches} ({launches['block'] / STEPS:g} block forward launches a step, "
              f"expected 24: 12 forward + 12 recomputed under remat; "
              f"{launches['block_bwd'] / STEPS:g} block backward pairs, expected 12), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        profile_step(lambda: float(step(model, tokens, labels)),
                     span="flash_block_backward")
        return launches
    finally:
        hvd.shutdown()


def _randn(shape, dtype, seed, scale=1.0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, device="cuda", generator=g) * scale).to(dtype)


def phase_tp_kernels_f32():
    """B3 and B4 at small ragged shapes: batch > 1, sub-chunks 1 and 2 of a
    chunk at its row offset in the gathered output, the partial product
    with and without an arriving accumulator, and the epilogue. In f32 with
    TF32 off (the FMA kernel) at 2e-4 / 2e-5, and in bf16 with B3's output
    at two bf16 ulps and B4's f32 accumulator at 2e-4 / 2e-5: the shapes
    TMA can take (``_tma_ok``; ragged rows, K and N under a tile) through
    the TMA + wgmma kernel, the others (N 70, K 36: strides off 16 bytes)
    through the WMMA kernel's masked edges and scalar loads. Each case says
    which kernel took it, and bf16 must have sent cases to both."""
    import torch
    from horovod_tpu_torch.ops import collective_matmul as cm

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {torch.float32: [], torch.bfloat16: []}
    paths = {torch.float32: set(), torch.bfloat16: set()}
    for dtype in (torch.float32, torch.bfloat16):
        out_tol = (F32_RTOL, F32_ATOL) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
        for (b, tc, k, n) in ((3, 50, 40, 70), (2, 64, 128, 96), (1, 130, 72, 200),
                              (2, 48, 36, 64), (2, 128, 64, 320)):
            tag = f"{dtype} {(b, tc, k, n)}"
            x = _randn((b, tc, k), dtype, tc + k)
            w = _randn((k, n), dtype, n, k ** -0.5)
            for c in (1, 2):
                sc = tc // c
                out = torch.zeros(b, 4 * tc, n, dtype=dtype, device="cuda")
                ref = torch.zeros_like(out)
                for s in range(c):
                    row = 2 * tc + s * sc
                    a, o = x[:, s * sc:(s + 1) * sc], out[:, row:row + sc]
                    paths[dtype].add(cm._tile(a, w, o, (), False) != cm.SIMT_TILE)
                    cm._launch_chunk_product(a, w, o)
                    cm._chunk_product_plain(x[:, s * sc:(s + 1) * sc], w, ref[:, row:row + sc])
                errs[dtype].append(max_err(out, ref, *out_tol, f"B3 {tag} chunks {c}"))
                check(bool((out[:, :2 * tc] == 0).all() and (out[:, 2 * tc + c * sc:] == 0).all()),
                      f"B3 {tag}: rows outside the chunk were written")
            y = _randn((b, 4 * tc, k), dtype, tc + k + 1)
            acc_in = _randn((b, tc // 2, n), torch.float32, 7)
            for acc in (None, acc_in):
                a = y[:, tc:tc + tc // 2]
                paths[dtype].add(cm._tile(a, w, acc_in, (acc,), False) != cm.SIMT_TILE)
                got = cm._launch_partial_product(a, w, acc)
                want = cm._partial_product_plain(a, w, acc)
                errs[dtype].append(max_err(got, want, F32_RTOL, F32_ATOL, f"B4 {tag}"))
            tma = cm._tile(x, w, x.new_empty(b, tc, n), (), False) != cm.SIMT_TILE
            print(f"[tp-kernels] {tag}: {'tma' if tma else 'simt'} kernel", flush=True)
        parts = [_randn((2, 50, 70), torch.float32, 10 + i) for i in range(3)]
        odd = [_randn((2 * 50 * 70 + 1,), torch.float32, 13 + i)[1:].view(2, 50, 70)
               for i in range(3)]
        for ps in (parts, odd):    # 16-byte loads, and the scalar path off 16 bytes
            for f, bk in ((ps[1], ps[2]), (ps[1], None), (None, None)):
                got = cm._launch_epilogue(ps[0], f, bk, dtype)
                want = cm._epilogue_plain(ps[0], f, bk, dtype)
                check(bool(torch.equal(got, want)),
                      f"B4 epilogue {dtype} differs from its plain version")
    check(paths[torch.bfloat16] == {True, False} and paths[torch.float32] == {False},
          f"bf16 cases must reach both kernels, f32 only the FMA kernel: {paths}")
    print(f"[tp-kernels] B3 (chunks 1/2, row offsets, batch 1-3) and B4 (with and without an "
          f"arriving accumulator) at 5 ragged shapes, bf16 through the TMA and the WMMA "
          f"kernels: max abs err f32 {max(errs[torch.float32]):.2e}, bf16 "
          f"{max(errs[torch.bfloat16]):.2e}; epilogue bitwise (aligned and not)", flush=True)


def phase_tp_kernels_bench(card):
    """B3 and B4 in bf16 at the GPT-2-small tp-4 per-rank shapes: one rank's
    call (B3: 4 chunk products; B4: 4 partial products and the epilogue)
    on the TMA + wgmma kernel and on the earlier WMMA kernel, each against
    the plain versions; both timed in turns in this run (WMMA, TMA, TMA,
    WMMA): CUDA events over a loop of calls, and the device time of the
    call's kernels from torch.profiler's kernel durations. Beside them the
    plain versions' time, the bound and torch.matmul over the same product
    (a yardstick, timed both ways)."""
    import torch
    from horovod_tpu_torch.ops import collective_matmul as cm
    from horovod_tpu_torch.tools.cm_tile_sweep import device_ms

    d, tokens = GPT2_SMALL["d_model"], BATCH * SEQ
    tc = SEQ // TP
    rows = {}
    for call, kernel, fin, fout in (("qkv", "B3", d, 3 * d // TP), ("mlp_up", "B3", d, 4 * d // TP),
                                    ("attn_out", "B4", d // TP, d), ("mlp_down", "B4", 4 * d // TP, d)):
        w = _randn((fin, fout), torch.bfloat16, fout, fin ** -0.5)
        if kernel == "B3":
            x = [_randn((BATCH, tc, fin), torch.bfloat16, 20 + r) for r in range(TP)]
            out = torch.empty(BATCH, SEQ, fout, dtype=torch.bfloat16, device="cuda")
            ref = torch.empty_like(out)
            check(all(cm._tma_ok(x[r], w, out[:, r * tc:(r + 1) * tc]) for r in range(TP)),
                  f"B3 {call}: the main path's operands must take the TMA kernel")

            def run(fn, out=out, x=x, w=w):
                for r in range(TP):
                    fn(x[r], w, out[:, r * tc:(r + 1) * tc])

            def call_fn(legacy, run=run):
                run(lambda a, w_, o: cm._launch_chunk_product(a, w_, o, legacy=legacy))

            run(cm._chunk_product_plain, out=ref)
            err = {}
            for legacy in (True, False):
                call_fn(legacy)
                err[legacy] = max_err(out, ref, BF16_RTOL, BF16_ATOL,
                                      f"B3 bf16 {call} ({'wmma' if legacy else 'tma'})")
            plain = time_ms(lambda: run(cm._chunk_product_plain, out=ref), reps=5)
            gathered = torch.cat(x, dim=1)
            lib_fn = lambda: torch.matmul(gathered, w)
            nbytes = 2 * (tokens * fin + fin * fout + tokens * fout)
            floor = nbytes
        else:
            y = _randn((BATCH, SEQ, fin), torch.bfloat16, 30)

            def run(partial, epilogue):
                # One rank (r = 0) of 4: forward ring 2 hops, backward 1.
                f = partial(y[:, 2 * tc:3 * tc], w, None)
                bk = partial(y[:, 3 * tc:4 * tc], w, None)
                own = partial(y[:, 0:tc], w, None)
                f = partial(y[:, tc:2 * tc], w, f)
                return f, epilogue(own, f, bk, torch.bfloat16)

            def call_fn(legacy, run=run):
                return run(lambda a, w_, acc: cm._launch_partial_product(a, w_, acc, legacy),
                           cm._launch_epilogue)

            f_ref, ref = run(cm._partial_product_plain, cm._epilogue_plain)
            err = {}
            for legacy in (True, False):
                f, out = call_fn(legacy)
                what = f"B4 bf16 {call} ({'wmma' if legacy else 'tma'})"
                err[legacy] = max(max_err(f, f_ref, F32_RTOL, F32_ATOL, f"{what} f32 accumulator"),
                                  max_err(out, ref, BF16_RTOL, BF16_ATOL, f"{what} output"))
            check(cm._tma_ok(y[:, tc:2 * tc], w, f, f),
                  f"B4 {call}: the main path's operands must take the TMA kernel")
            plain = time_ms(lambda: run(cm._partial_product_plain, cm._epilogue_plain), reps=5)
            lib_fn = lambda: torch.matmul(y, w)
            nbytes = 2 * (tokens * fin + fin * fout + tc * BATCH * fout)
            # What this design must move besides: 4 f32 accumulators written
            # and 1 read by the partial products, 3 read by the epilogue.
            floor = nbytes + 4 * 8 * tc * BATCH * fout
        ev = {True: [], False: []}
        dev = {True: [], False: []}
        for legacy in (True, False, False, True):
            ev[legacy].append(time_ms(lambda: call_fn(legacy), reps=50))
            dev[legacy].append(device_ms(lambda: call_fn(legacy), 50, ("gemm_", "mrs_epilogue")))
        lib = time_ms(lib_fn, reps=50)
        lib_dev = device_ms(lib_fn, 50, None)
        # The TMA call's device time by kernel: the products, and B4's epilogue.
        split = {name: device_ms(lambda: call_fn(False), 50, (name,))
                 for name in ((CM_TMA_KERNEL, "mrs_epilogue") if kernel == "B4" else ())}
        ms, ms_dev = statistics.mean(ev[False]), statistics.mean(dev[False])
        old, old_dev = statistics.mean(ev[True]), statistics.mean(dev[True])
        b = bound(nbytes, 2 * tokens * fin * fout)
        rows[call] = dict(max_abs_err=err[False], ms=ms, device_ms=ms_dev, plain_ms=plain,
                          bound=b, library_ms=lib, old_ms=old, old_device_ms=old_dev,
                          library_device_ms=lib_dev, byte_floor_ms=floor / HBM_BYTES_PER_S * 1e3)
        limit = 2.0 if kernel == "B3" else 3.0
        print(f"[tp-kernels] {kernel} {call} bf16 (w {fin} x {fout}, {tokens} tokens over tp {TP}) "
              f"on {card}: max abs err tma {err[False]:.2e}, wmma {err[True]:.2e}; one rank's "
              f"call ms, events / device: tma {ms:.4f} / {ms_dev:.4f} (runs "
              f"{[round(v, 4) for v in ev[False]]} / {[round(v, 4) for v in dev[False]]}), wmma "
              f"{old:.4f} / {old_dev:.4f} (runs {[round(v, 4) for v in ev[True]]} / "
              f"{[round(v, 4) for v in dev[True]]}); plain {plain:.4f}; torch.matmul "
              f"{lib:.4f} / {lib_dev:.4f}; bound {b[0]:.4f} by {b[1]}"
              + (f", f32 accumulator byte floor {floor / HBM_BYTES_PER_S * 1e3:.4f}; tma device "
                 f"ms by kernel: partial products {split[CM_TMA_KERNEL]:.4f}, epilogue "
                 f"{split['mrs_epilogue']:.4f}" if kernel == "B4" else "")
              + f". Device time tma/wmma {ms_dev / old_dev:.3f} (target <= 1/3: "
              f"{'met' if ms_dev <= old_dev / 3 else 'missed'}), tma/torch.matmul "
              f"{ms_dev / lib_dev:.2f} (target <= {limit:g}: "
              f"{'met' if ms_dev <= limit * lib_dev else 'missed'})", flush=True)
    return rows


class VirtualRing:
    """One rank of a ring played on one card by threads: ``post`` hands the
    sends to the neighbours through a shared mailbox, and each hop is a
    device copy of what the neighbour sent (the same stream for all ranks,
    so the copy follows the kernel that made the data)."""

    def __init__(self, rank, n, mailbox, barrier, hops=None):
        self.rank, self.n, self.mailbox, self.barrier = rank, n, mailbox, barrier
        self.hops = hops

    def post(self, sends):
        if self.hops is not None:
            self.hops[0] += 1
        self.mailbox[self.rank] = sends
        self.barrier.wait()
        recvs = []
        for i, (_, step) in enumerate(sends):
            sent, sent_step = self.mailbox[(self.rank - step) % self.n][i]
            check(sent_step == step, "virtual ring: the ranks posted different hops")
            recvs.append(sent.clone())
        self.barrier.wait()
        return recvs, None

    @staticmethod
    def wait(handle):
        return handle[0]


def play_ring(n, fn):
    """Run ``fn(ring)`` for n virtual ranks in n threads; their results by
    rank. A failure in any rank fails the phase."""
    import threading

    barrier = threading.Barrier(n, timeout=120)
    mailbox = [None] * n
    results, errors = [None] * n, []

    def body(r):
        try:
            results[r] = fn(VirtualRing(r, n, mailbox, barrier))
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    import torch

    torch.cuda.synchronize()
    return results


class VirtualHop:
    """One level of a grid of ranks played on one card by threads, the
    transport seam of topo/compositor.py (``rank``, ``n`` and the level's
    primitives): each primitive puts this rank's tensor on the level's
    board, waits for the level's other ranks, and computes its result from
    theirs with device ops on the one stream all threads share, so a read
    follows the kernel that made the data. ``hops[0]`` counts the
    primitives (the int8 ring's posts too) its grid rank ran: the rank's
    virtual hops."""

    def __init__(self, rank, n, board, hops):
        self.rank, self.n, self.board, self.hops = rank, n, board, hops

    def _all(self, x):
        self.hops[0] += 1
        slots, barrier = self.board["slots"], self.board["barrier"]
        slots[self.rank] = x
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_reduce(self, x, op=None):
        import torch
        from horovod_tpu_torch.common.types import ReduceOp

        got = torch.stack(self._all(x))
        op = ReduceOp.SUM if op is None else op
        return got.sum(0) if op == ReduceOp.SUM else got.amin(0) if op == ReduceOp.MIN \
            else got.amax(0)

    def reduce_scatter(self, x):
        import torch

        return torch.stack(self._all(x)).sum(0).chunk(self.n)[self.rank].clone()

    def all_gather(self, x):
        import torch

        return torch.cat(self._all(x))

    def broadcast(self, x, root):
        return self._all(x)[root].clone()

    def all_to_all(self, x):
        import torch

        return torch.cat([g.chunk(self.n)[self.rank] for g in self._all(x)])

    def exchange(self, x, peer):
        return self._all(x)[peer].clone()

    @property
    def ring(self):
        return VirtualRing(self.rank, self.n, self.board["ring"], self.board["ring_barrier"],
                           self.hops)


def play_grid(cross, local, fn):
    """Run ``fn(levels)`` for the cross * local virtual ranks of a (cross,
    local) grid in threads, rank = c * local + l; ``levels`` has ``rank``,
    ``cross`` and ``local`` (the rank's hops) and ``flat`` (one hop over all
    ranks). Returns (results by rank, virtual hops a rank ran)."""
    import threading

    import torch

    n = cross * local
    boards = []

    def board(size):
        b = {"slots": [None] * size, "barrier": threading.Barrier(size, timeout=120),
             "ring": [None] * size, "ring_barrier": threading.Barrier(size, timeout=120)}
        boards.append(b)
        return b

    cross_boards = [board(cross) for _ in range(local)]
    local_boards = [board(local) for _ in range(cross)]
    flat_board = board(n)
    hops = [[0] for _ in range(n)]
    results, errors = [None] * n, []

    def body(r):
        c, l = divmod(r, local)
        levels = types.SimpleNamespace(
            rank=r, cross=VirtualHop(c, cross, cross_boards[l], hops[r]),
            local=VirtualHop(l, local, local_boards[c], hops[r]),
            flat=VirtualHop(r, n, flat_board, hops[r]))
        try:
            results[r] = fn(levels)
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append(e)
            for b in boards:
                b["barrier"].abort()
                b["ring_barrier"].abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    return results, hops[0][0]


HIER_CROSS, HIER_LOCAL = 2, 2    # [hier]'s virtual grid
HIER_STEPS = 6                   # steps of each [hier] model, in turns
HIER_SKIP_AT = 2                 # the step the skip variant's batch is made non-finite
HIER_MODELS = {                  # name: (composed, make_train_step options)
    "dp-plain": (False, {}),
    "dp-hierarchical": (False, dict(hierarchical=True)),
    "tp-plain": (True, {}),
    "tp-overlap": (True, dict(overlap=True)),
    "tp-zero1": (True, dict(zero1=True)),
    "tp-quantized": (True, dict(quantized=True)),
    "tp-skip": (True, dict(nonfinite="skip")),
}


def phase_hier(card):
    """[hier]: (1) the two-level schedules of topo/compositor.py over a
    (cross 2, local 2) grid of virtual ranks on the card, at GPT-2-small's
    f32 gradient buckets in f32 and bf16: allgather, broadcast (two-level
    and two-level-sa) and alltoall bitwise equal to the flat result over the
    four ranks, allreduce (SUM, AVERAGE, MIN, MAX) and reduce-scatter held
    to the f32 sum (MIN/MAX bitwise; sums within n roundings of the dtype,
    n 2^-24 (f32) or 2^-8 (bf16) times sum_r |x_r|), the two-level int8
    allreduce within the int8 ring's 3e-2 relative L2 of the f32 sum, and
    hierarchical Adasum within 1e-5 relative L2 of
    hierarchical_adasum_reference (float64); the ms and kernel launches a
    virtual hop of each. (2) The GPT-2-small DP step at 8 x 1024 with
    hierarchical=True on a (cross 1, local 1) mesh and the composed step at
    data 1 x model 1 with overlap, zero1, quantized and nonfinite="skip", in
    turns with the plain DP and composed steps: finite, falling losses, B1
    launched for every step, the streamed groups launched in the backward,
    and the skip step's parameters bitwise unchanged."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.types import ReduceOp
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss, make_gpt_loss_fn
    from horovod_tpu_torch.ops import adasum, quantized
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh, build_mesh
    from horovod_tpu_torch.parallel.rules import named_tree_paths
    from horovod_tpu_torch.topo import compositor as C
    from horovod_tpu_torch.utils.convert import local_params_from_flax, params_to_numpy

    t_phase = time.perf_counter()
    n = HIER_CROSS * HIER_LOCAL
    sizes = _ring_buckets()
    gen = torch.Generator(device="cuda").manual_seed(11)
    inputs = [torch.randn(n, size, device="cuda", generator=gen) * 1e-2 for size in sizes]
    ends = (0, len(sizes) - 1)          # the buckets every collective runs on
    grid = lambda levels: (levels.cross, levels.local)       # noqa: E731
    print(f"[hier] {n} virtual ranks as (cross {HIER_CROSS}, local {HIER_LOCAL}) on {card}: "
          f"GPT-2-small's {len(sizes)} f32 gradient buckets of up to 64 MiB a rank", flush=True)

    def timed(name, fn):
        """Play fn over the grid: once to warm up, once timed, once under
        the profiler for the kernel launches; (results, ms, hops a rank,
        launches a hop)."""
        play_grid(HIER_CROSS, HIER_LOCAL, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, hops = play_grid(HIER_CROSS, HIER_LOCAL, fn)
        ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            play_grid(HIER_CROSS, HIER_LOCAL, fn)
        launches = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation)
        per_hop = launches / max(hops * n, 1)
        print(f"[hier] {name}: {ms:.2f} ms for the {n} ranks, {hops} virtual hops a rank, "
              f"{per_hop:.1f} kernel launches a hop", flush=True)
        return out

    def sum_bound(xs, dtype):
        unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
        return n * unit * xs.float().abs().sum(0)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for i in range(len(sizes)):
            xs = inputs[i].to(dtype)
            exact = xs.float().sum(0)
            bound = sum_bound(xs, dtype)
            ops = ((ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN, ReduceOp.MAX) if i in ends
                   else (ReduceOp.SUM,))
            for op in ops:
                out = timed(f"{tag} bucket {i} ({sizes[i]} elements) allreduce {op.name}",
                            lambda lv: C.lower_allreduce(xs[lv.rank], grid(lv), op=op))
                for r in range(n):
                    check(out[r].dtype == dtype, f"allreduce {op.name}: dtype {out[r].dtype}")
                    check(torch.equal(out[r], out[0]), f"allreduce {op.name}: ranks differ")
                if op in (ReduceOp.MIN, ReduceOp.MAX):
                    want = xs.amin(0) if op == ReduceOp.MIN else xs.amax(0)
                    check(torch.equal(out[0], want), f"{tag} allreduce {op.name} not bitwise")
                    continue
                scale = n if op == ReduceOp.AVERAGE else 1
                err = (out[0].float() * scale - exact).abs()
                check(bool((err <= bound).all()), f"{tag} bucket {i} allreduce {op.name}: "
                      f"{int((err > bound).sum())} elements past n roundings")
                worst[f"{tag} allreduce"] = max(worst.get(f"{tag} allreduce", 0.0),
                                                float((err / bound.clamp_min(1e-30)).max()))
            if i not in ends:
                continue
            k = -(-sizes[i] // n)
            xp = torch.nn.functional.pad(xs, (0, n * k - sizes[i]))
            rs = timed(f"{tag} bucket {i} reduce-scatter",
                       lambda lv: C.lower_reducescatter(xp[lv.rank], grid(lv)))
            exact_rs = xp.float().sum(0).reshape(n, k)
            bound_rs = sum_bound(xp, dtype).reshape(n, k)
            for r in range(n):
                check(bool(((rs[r].float() - exact_rs[r]).abs() <= bound_rs[r]).all()),
                      f"{tag} reduce-scatter rank {r}: past n roundings")
            for name, two, flat in (
                    ("allgather", lambda lv: C.lower_allgather(xs[lv.rank], grid(lv)),
                     lambda lv: C.lower_allgather(xs[lv.rank], (lv.flat,))),
                    ("broadcast two-level", lambda lv: C.lower_broadcast(
                        xs[lv.rank], grid(lv), root_rank=3),
                     lambda lv: C.lower_broadcast(xs[lv.rank], (lv.flat,), root_rank=3)),
                    ("broadcast two-level-sa", lambda lv: C.lower_broadcast(
                        xs[lv.rank], grid(lv), root_rank=2, algorithm="two-level-sa"),
                     lambda lv: C.lower_broadcast(xs[lv.rank], (lv.flat,), root_rank=2)),
                    ("alltoall", lambda lv: C.lower_alltoall(xp[lv.rank], grid(lv)),
                     lambda lv: C.lower_alltoall(xp[lv.rank], (lv.flat,)))):
                got = timed(f"{tag} bucket {i} {name}", two)
                want, _ = play_grid(HIER_CROSS, HIER_LOCAL, flat)
                for r in range(n):
                    check(torch.equal(got[r], want[r]),
                          f"{tag} bucket {i} {name} rank {r}: not bitwise the flat result")
                del got, want
        torch.cuda.empty_cache()
    for i, x in enumerate(inputs):
        q = timed(f"int8 two-level allreduce bucket {i}",
                  lambda lv: quantized.quantized_hierarchical_allreduce(x[lv.rank], grid(lv)))
        exact = x.sum(0)
        for r in range(n):
            check(torch.equal(q[r], q[0]), f"int8 two-level bucket {i}: ranks differ")
        rel = float((q[0] - exact).norm() / exact.norm())
        worst["int8 rel L2"] = max(worst.get("int8 rel L2", 0.0), rel)
        check(rel < 3e-2, f"int8 two-level bucket {i}: rel L2 {rel:.3e} >= 3e-2")
    last = inputs[-1]
    got = timed(f"hierarchical Adasum bucket {len(sizes) - 1}",
                lambda lv: adasum.hierarchical_adasum_allreduce(
                    last[lv.rank], local_group=lv.local, cross_group=lv.cross))
    want = torch.from_numpy(adasum.hierarchical_adasum_reference(
        list(last.double().cpu().numpy()), HIER_LOCAL)).to("cuda")
    rel = float((got[0].double() - want).norm() / want.norm())
    worst["adasum rel L2"] = rel
    check(rel < 1e-5, f"hierarchical Adasum: rel L2 {rel:.3e} to the float64 reference")
    print(f"[hier] every two-level schedule held on {card}: data movement bitwise the flat "
          f"result, MIN/MAX bitwise; worst share of the n-rounding bound, rel L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    del inputs, got, want, q
    torch.cuda.empty_cache()

    hvd.init()
    try:
        hmesh = build_hierarchical_mesh(1)
        tmesh = build_mesh({"data": 1, "model": 1})
        rng = np.random.RandomState(5)
        tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                       (BATCH, SEQ))).cuda() for _ in range(2))
        one = torch.ones(BATCH, device="cuda")
        nan = torch.full((BATCH,), float("nan"), device="cuda")
        flat = params_to_numpy(TransformerLM(**GPT2_SMALL, max_len=SEQ, seed=0))
        tp_loss = make_gpt_loss_fn(GPT2_SMALL["n_heads"], model_axis="model")
        runs = {}
        for name, (composed, kw) in HIER_MODELS.items():
            adamw = lambda leaves: torch.optim.AdamW(leaves, lr=3e-4, weight_decay=1e-4,  # noqa
                                                     eps=1e-8)
            if composed:
                params = local_params_from_flax(flat, "gpt", tmesh)
                step = hvd.make_train_step(
                    lambda p, b: tp_loss(p, b[:2]) * b[2].mean(),
                    adamw([t for _, t in named_tree_paths(params)]), mesh=tmesh, rules="gpt",
                    **kw)
                leaves = [t for _, t in named_tree_paths(params)]
            else:
                params = TransformerLM(**GPT2_SMALL, max_len=SEQ, dtype=torch.bfloat16, seed=0)
                step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]) * b[2].mean(),
                                           adamw(params.parameters()), mesh=hmesh, **kw)
                leaves = list(params.parameters())
            runs[name] = dict(params=params, step=step, leaves=leaves, losses=[], times=[])
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        for s in range(HIER_STEPS):
            for name, run in runs.items():      # in turns
                poisoned = name == "tp-skip" and s == HIER_SKIP_AT
                if poisoned:
                    before = [t.detach().clone() for t in run["leaves"]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(run["step"](run["params"], (tokens, labels, nan if poisoned else one)))
                run["times"].append(time.perf_counter() - t0)
                run["losses"].append(loss)
                if poisoned:
                    check(all(torch.equal(a, t) for a, t in zip(before, run["leaves"])),
                          "tp-skip: a non-finite batch changed the parameters")
                if "overlap" in HIER_MODELS[name][1]:
                    launched, _, groups = run["step"].optimizer.streamed_groups
                    check(launched == groups > 1, f"{name}: the hooks launched {launched} of "
                          f"{groups} groups inside the backward (a post-hoc fallback)")
        launches = {"fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
        want = HIER_STEPS * GPT2_SMALL["n_layers"] * len(runs)
        check(launches == {"fwd": want, "bwd": want}, f"[hier] flash launches {launches}")
        check(runs["dp-hierarchical"]["step"].optimizer._hierarchical,
              "dp-hierarchical: the step does not reduce two-level")
        for base, names in (("dp-plain", ["dp-hierarchical"]),
                            ("tp-plain", ["tp-overlap", "tp-zero1", "tp-quantized", "tp-skip"])):
            plain = statistics.median(runs[base]["times"][1:])
            for name in [base] + names:
                run = runs[name]
                finite = [l for i, l in enumerate(run["losses"])
                          if not (name == "tp-skip" and i == HIER_SKIP_AT)]
                check(all(np.isfinite(finite)), f"{name}: non-finite loss {run['losses']}")
                check(finite[-1] < finite[0], f"{name}: loss did not fall: {run['losses']}")
                med = statistics.median(run["times"][1:])
                print(f"[hier] {name} {HIER_MODELS[name][1]}: losses {run['losses']}; step ms "
                      f"median {med * 1e3:.2f} (steps 2-{HIER_STEPS}, in turns) against {base} "
                      f"{plain * 1e3:.2f} ({med / plain:.3f}x)", flush=True)
        print(f"[hier] B1 launches over the {len(runs)} models' steps {launches}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase took "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        hvd.shutdown()
    del runs
    torch.cuda.empty_cache()


def phase_tp_ring():
    """A 4-rank bidirectional ring on one card through the port's schedule,
    at the GPT-2-small tp-4 shapes in bf16: B3 forward (q/k/v), B3 through
    an identity weight with sub-chunks 2, B4 forward (MLP down), and both
    dual-primitive backwards. Returns the B3/B4 launch counts."""
    import torch
    from horovod_tpu_torch.ops import collective_matmul as cm

    d, n = GPT2_SMALL["d_model"], TP
    tc = SEQ // n
    bf = torch.bfloat16
    x = [_randn((BATCH, tc, d), bf, 40 + r) for r in range(n)]
    gathered = torch.cat(x, dim=1)
    wq = _randn((d, 3 * d // n), bf, 44, d ** -0.5)
    launches = {"b3": 0, "b4": 0}

    def ring_run(fn):
        # The counts cover the rings alone, not the comparisons' launches.
        cm.AGMM_LAUNCHES = cm.MRS_LAUNCHES = 0
        results = play_ring(n, fn)
        launches["b3"] += cm.AGMM_LAUNCHES
        launches["b4"] += cm.MRS_LAUNCHES
        return results

    outs = ring_run(lambda ring: cm._ag_matmul(x[ring.rank], wq, ring, 1))
    ref = torch.empty(BATCH, SEQ, wq.shape[1], dtype=bf, device="cuda")
    cm._launch_chunk_product(gathered, wq, ref)
    for r in range(n):
        check(bool(torch.equal(outs[r], ref)),
              f"B3 ring rank {r}: not bitwise the kernel over the gathered input")
    eye = torch.eye(d, dtype=bf, device="cuda")
    outs = ring_run(lambda ring: cm._ag_matmul(x[ring.rank], eye, ring, 2))
    for r in range(n):
        check(bool(torch.equal(outs[r], gathered)),
              f"B3 ring rank {r} through an identity weight: rows not bitwise the gathered x")
    print(f"[tp-ring] B3 over {n} virtual ranks (x [{BATCH}, {tc}, {d}] each, w {tuple(wq.shape)}): "
          f"every rank bitwise the kernel over the gathered input; identity weight, sub-chunks "
          f"2: bitwise the gathered x", flush=True)

    f = 4 * d // n
    y = [_randn((BATCH, SEQ, f), bf, 50 + r) for r in range(n)]
    w = [_randn((f, d), bf, 54 + r, f ** -0.5) for r in range(n)]
    z = ring_run(lambda ring: cm._mrs(y[ring.rank], w[ring.rank], ring, 1))
    psum = sum(y[r].float() @ w[r].float() for r in range(n))
    err_mrs = max_err(torch.cat(z, dim=1), psum.to(bf), BF16_RTOL, BF16_ATOL,
                      "B4 ring gathered vs the sum over ranks")
    print(f"[tp-ring] B4 over {n} virtual ranks (y [{BATCH}, {SEQ}, {f}], w [{f}, {d}] each): "
          f"gathered outputs vs sum_r y_r @ w_r: max abs err {err_mrs:.2e}", flush=True)

    # The dual-primitive backwards with one cotangent per rank.
    ct3 = [_randn((BATCH, SEQ, wq.shape[1]), bf, 60 + r) for r in range(n)]
    g3 = ring_run(lambda ring: cm._agmm_bwd(x[ring.rank], wq, ct3[ring.rank], ring, 1))
    ct_sum = sum(c.float() for c in ct3)
    dx_want = (ct_sum @ wq.float().t()).to(bf)
    err = max_err(torch.cat([g[0] for g in g3], dim=1), dx_want, BF16_RTOL, BF16_ATOL,
                  "B3 backward dx (through B4)")
    for r in range(n):
        dw_want = gathered.float().reshape(-1, d).t() @ ct3[r].float().reshape(-1, wq.shape[1])
        err = max(err, rel_err(g3[r][1], dw_want, f"B3 backward dw rank {r}"))
    ct4 = [_randn((BATCH, tc, d), bf, 70 + r) for r in range(n)]
    ct4_all = torch.cat(ct4, dim=1)
    g4 = ring_run(lambda ring: cm._mrs_bwd(y[ring.rank], w[ring.rank], ct4[ring.rank], ring, 1))
    for r in range(n):
        dy_ref = torch.empty(BATCH, SEQ, f, dtype=bf, device="cuda")
        cm._launch_chunk_product(ct4_all, w[r].t().contiguous(), dy_ref)
        check(bool(torch.equal(g4[r][0], dy_ref)),
              f"B4 backward dy rank {r} (through B3): not bitwise the kernel over the gathered ct")
        dw_want = y[r].float().reshape(-1, f).t() @ ct4_all.float().reshape(-1, d)
        err = max(err, rel_err(g4[r][1], dw_want, f"B4 backward dw rank {r}"))
    # Expected: B3 60 (4 ranks x 4 chunk products for q/k/v; x (1 + 2 x 3)
    # with sub-chunks 2; x 4 in the B4 backward), B4 32 (4 ranks x 4 partial
    # products, forward and in the B3 backward).
    print(f"[tp-ring] dual-primitive backwards (dx of B3 through B4, dy of B4 through B3 "
          f"bitwise, dw rings): max err {err:.2e}; launches {launches}", flush=True)
    check(launches == {"b3": 60, "b4": 32}, f"B3/B4 launches {launches}, expected 60/32")
    return launches


def phase_tp_train():
    """The composed DP×TP step on one card: GPT-2-small, data 1 x model 1."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, make_gpt_loss_fn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.rules import named_tree_paths
    from horovod_tpu_torch.utils.convert import local_params_from_flax, params_to_numpy

    hvd.init()
    try:
        mesh = build_mesh({"data": 1, "model": 1})
        flat = params_to_numpy(TransformerLM(**GPT2_SMALL, max_len=SEQ, seed=0))
        params = local_params_from_flax(flat, "gpt", mesh)
        rng = np.random.RandomState(2)
        tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                       (BATCH, SEQ))).cuda() for _ in range(2))
        step = hvd.make_train_step(
            make_gpt_loss_fn(GPT2_SMALL["n_heads"], model_axis="model"),
            torch.optim.AdamW([t for _, t in named_tree_paths(params)], lr=3e-4,
                              weight_decay=1e-4, eps=1e-8),
            mesh=mesh, rules="gpt")
        torch.cuda.reset_peak_memory_stats()
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        losses, times = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(params, (tokens, labels))))
            times.append(time.perf_counter() - t0)
        print(f"[tp] GPT-2-small, composed make_train_step(rules='gpt') on a data 1 x model 1 "
              f"mesh, batch {BATCH} x {SEQ}: losses {losses}", flush=True)
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(fa.FWD_LAUNCHES > 0 and fa.BWD_LAUNCHES > 0,
              f"flash launches {fa.FWD_LAUNCHES}/{fa.BWD_LAUNCHES}")
        med = statistics.median(times[1:])
        print(f"[tp] step ms median {med * 1e3:.2f} (steps 2-{STEPS}; first "
              f"{times[0] * 1e3:.1f}), tokens/s {BATCH * SEQ / med:.0f}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    finally:
        hvd.shutdown()


CNN_SIDE, CNN_CLASSES = 224, 1000    # bench.py's ResNet-50 default, at its batch 32
CNN_BATCHES = (32, 256)
ZOO = [("vgg16", 224), ("inception3", 299), ("resnet18", 224), ("mnist", 28)]
ZOO_BATCH, ZOO_STEPS = 8, 3


def _cnn_step(model, hvd):
    """bench.py's CNN step: SGD 0.01 with momentum 0.9 through
    DistributedOptimizer, mean softmax cross-entropy."""
    import torch
    import torch.nn.functional as F

    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                                   named_parameters=model.named_parameters())
    return hvd.make_train_step(lambda m, b: F.cross_entropy(m(b[0]), b[1]), opt)


def _cnn_batch(n, side, classes, channels=3, seed=0):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randn(n, side, side, channels).astype(np.float32)).cuda()
    return images, torch.from_numpy(rng.randint(0, classes, n)).cuda()


def phase_cnn():
    """The image-classification path: a narrow f32 ResNet on the card
    against the CPU, ResNet-50 at bench.py's default width and batch for 5
    steps with MFU and one profiled step, then VGG-16, Inception-v3,
    ResNet-18 and MnistCNN for 3 steps each."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.bench import _mfu
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.mnist_cnn import MnistCNN
    from horovod_tpu_torch.models.resnet import ResNet
    from torch.utils.flop_counter import FlopCounterMode

    t_phase = time.perf_counter()
    # (a) f32 with TF32 off: cuDNN against the CPU, train mode (batch
    # statistics, the asymmetric SAME pads, the running update).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels = _cnn_batch(4, 32, 10, seed=1)
    cpu = ResNet([1, 1], 10, 8, torch.float32, device="cpu", seed=1)
    card = ResNet([1, 1], 10, 8, torch.float32, device="cuda", seed=1)
    card.load_state_dict(cpu.state_dict())
    results = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        logits = model(images.to(dev))
        loss = F.cross_entropy(logits, labels.to(dev))
        loss.backward()
        results.append((logits, loss, {n: p.grad for n, p in model.named_parameters()},
                        dict(model.named_buffers())))
    (lc, sc, gc, bc), (lg, sg, gg, bg) = results
    err = max_err(lg.cpu(), lc, 1e-3, 1e-4, "narrow ResNet logits")
    err = max(err, max_err(sg.cpu(), sc, 1e-3, 1e-4, "narrow ResNet loss"))
    for n in gc:
        err = max(err, max_err(gg[n].cpu(), gc[n], 1e-3, 1e-4, f"narrow ResNet grad {n}"))
    for n in bc:
        err = max(err, max_err(bg[n].cpu(), bc[n], 1e-3, 1e-4, f"narrow ResNet stats {n}"))
    print(f"[cnn] narrow f32 ResNet (8 filters, 32 px), card vs CPU, TF32 off: max abs err "
          f"{err:.2e} over logits, loss, {len(gc)} gradients and {len(bc)} running "
          f"statistics", flush=True)

    torch.backends.cudnn.benchmark = True
    hvd.init()
    try:
        # (b) ResNet-50 at bench.py's default, batch 32 x 224² and 1000
        # classes, and at batch 256, where the host is expected to keep up.
        check(hvd.size() == 1, f"expected one rank, got {hvd.size()}")
        for batch_size in CNN_BATCHES:
            model = get_model("resnet50", num_classes=CNN_CLASSES, seed=0)
            n_params = sum(p.numel() for p in model.parameters())
            batch = _cnn_batch(batch_size, CNN_SIDE, CNN_CLASSES)
            start = {k: v.clone() for k, v in model.named_buffers()}
            step = _cnn_step(model, hvd)
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for _ in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(model, batch)))
                times.append(time.perf_counter() - t0)
            moved = sum(bool((v != start[k]).any()) for k, v in model.named_buffers())
            tag = f"[cnn] ResNet-50 batch {batch_size}"
            print(f"{tag}: {n_params} params, {batch_size} x {CNN_SIDE}² x 3, {CNN_CLASSES} "
                  f"classes, NCCL world size {hvd.size()}: losses {losses}; {moved} of "
                  f"{len(start)} running statistics moved", flush=True)
            check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
            check(losses[-1] < losses[0], f"loss did not fall: {losses}")
            check(moved == len(start), f"only {moved} of {len(start)} running statistics moved")
            med = statistics.median(times[1:])
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            with FlopCounterMode(display=False) as counter:
                step(model, batch)
            flops = counter.get_total_flops()
            mfu = _mfu(flops, 1, med, torch.cuda.get_device_name(0))
            print(f"{tag}: step ms median {med * 1e3:.2f} (steps 2-{STEPS}; first "
                  f"{times[0] * 1e3:.1f}), img/s {batch_size / med:.1f}, {flops / 1e9:.1f} "
                  f"GFLOP a step (flop counter), MFU {mfu} against the dense bf16 peak, peak "
                  f"memory {peak_gib:.2f} GiB", flush=True)
            profile_step(lambda: float(step(model, batch)), classify=cnn_family,
                         families=("conv", "bn", "elementwise", "optimizer", "gemm", "nccl",
                                   "other"), tag=f"cnn profile b{batch_size}")
            del model, step, batch
            torch.cuda.empty_cache()

        # (c) the rest of the zoo, 3 steps each at batch 8, with cuDNN's
        # heuristics (autotuning each of Inception's shapes costs ~15 s).
        torch.backends.cudnn.benchmark = False
        for name, side in ZOO:
            kw = {"image_size": side} if name.startswith("vgg") else {}
            model = (MnistCNN(seed=0) if name == "mnist"
                     else get_model(name, num_classes=CNN_CLASSES, seed=0, **kw))
            channels, classes = (1, 10) if name == "mnist" else (3, CNN_CLASSES)
            batch = _cnn_batch(ZOO_BATCH, side, classes, channels, seed=2)
            step = _cnn_step(model, hvd)
            t0 = time.perf_counter()
            losses = [float(step(model, batch)) for _ in range(ZOO_STEPS)]
            print(f"[cnn] {name}, batch {ZOO_BATCH} x {side}²: losses {losses} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            check(all(np.isfinite(losses)), f"{name}: non-finite loss: {losses}")
            check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
            del model, step, batch
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
        hvd.shutdown()
    print(f"[cnn] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_bench(slice_tokens_per_s: float):
    """The port's bench for resnet50 and transformer at reduced iterations,
    each in a process of its own: its one JSON line, the metric name, a
    positive value and 0 < mfu <= 1."""
    import os

    t_phase = time.perf_counter()
    runs = [("resnet50", "resnet50_synthetic_images_per_sec_per_chip"),
            ("transformer", "transformer_synthetic_tokens_per_sec_per_chip")]
    for model, metric in runs:
        # The transformer at [slice]'s batch of 8 (bench.py's default is 32 a card).
        cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", "--model", model,
               "--num-warmup-batches", "3", "--num-batches-per-iter", "10", "--num-iters", "2",
               *(["--batch-size", str(BATCH)] if model == "transformer" else [])]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": os.getcwd()})
        check(proc.returncode == 0, f"bench {model} exited {proc.returncode}: "
              f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        check(len(lines) == 1, f"bench {model} printed {len(lines)} JSON lines")
        out = json.loads(lines[0])
        mfu = out["detail"]["mfu"]
        print(f"[bench] {' '.join(cmd[2:])}: {lines[0]}", flush=True)
        check(out["metric"] == metric, f"bench {model}: metric {out['metric']}")
        check(out["value"] > 0, f"bench {model}: value {out['value']}")
        check(mfu is not None and 0 < mfu <= 1, f"bench {model}: mfu {mfu}")
        if model == "transformer":
            print(f"[bench] transformer {out['value']:.1f} tokens/s against [slice]'s "
                  f"{slice_tokens_per_s:.1f} in this run ({out['value'] / slice_tokens_per_s:.3f}x)",
                  flush=True)
    print(f"[bench] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


EAGER_DTYPES = ("f32", "bf16", "f16", "i32", "i64", "u8")
EAGER_TURNS = 5          # the grouped allreduce against fused_allreduce, in turns
EAGER_LAT_REPS = 60      # 4-byte allreduces a cycle time


def _eager_ops_on_card(hvd, card):
    """Every eager op on CUDA tensors of every dtype at one rank."""
    import torch

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
              "i32": torch.int32, "i64": torch.int64, "u8": torch.uint8}
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_checks = 0
    for tag, dt in dtypes.items():
        if dt.is_floating_point:
            x = (torch.randn(1000, 7, device="cuda", generator=gen) * 3).to(dt)
        else:
            x = torch.randint(0, 100, (1000, 7), device="cuda", generator=gen).to(dt)
        outs = {f"allreduce {op}": hvd.allreduce(x, op=getattr(hvd.ReduceOp, op),
                                                  name=f"e.{tag}.{op}")
                for op in ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT")}
        outs["allgather"] = hvd.allgather(x, name=f"e.{tag}.ag")
        outs["broadcast"] = hvd.broadcast(x, 0, name=f"e.{tag}.bc")
        outs["alltoall"] = hvd.alltoall(x, name=f"e.{tag}.a2a")
        outs["alltoall splits"], rs = hvd.alltoall(x, splits=[x.shape[0]], name=f"e.{tag}.a2av")
        outs["reducescatter"] = hvd.reducescatter(x, name=f"e.{tag}.rs")
        for i, o in enumerate(hvd.grouped_allreduce([x, x[:10]], op=hvd.Sum,
                                                    name=f"e.{tag}.gar")):
            outs[f"grouped allreduce {i}"] = o if i == 0 else torch.cat([o, x[10:]])
        outs["grouped allgather"] = hvd.grouped_allgather([x], name=f"e.{tag}.gag")[0]
        outs["grouped reducescatter"] = hvd.grouped_reducescatter([x], name=f"e.{tag}.grs")[0]
        for what, o in outs.items():
            check(o.is_cuda and o.device == x.device, f"[eager] {tag} {what} left the card")
            check(o.dtype == dt and torch.equal(o, x), f"[eager] {tag} {what} is not the input")
        check(rs.tolist() == [x.shape[0]], f"[eager] {tag} alltoall splits {rs}")
        n_checks += len(outs)
        if dt.is_floating_point:
            # pre 0.5, post 3: the input times 1.5, one rounding of the dtype.
            got = hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5, postscale_factor=3.0,
                                name=f"e.{tag}.scaled").double()
            want = x.double() * 1.5
            ulp = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
                   torch.float16: 2.0 ** -11}[dt]
            err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
            check(err <= 2 * ulp, f"[eager] {tag} scaled sum {err:.3e} beyond one rounding")
            n_checks += 1
    print(f"[eager] {n_checks} op x dtype results on {card}: each on the card, data movement "
          f"and sums over one rank bitwise the input, scaled sums within one rounding, over "
          f"dtypes {', '.join(dtypes)}", flush=True)


def _eager_stream_safety(hvd):
    """The input is written on a side stream (a spin kernel, then a chain
    of adds) just before the enqueue: the executor must wait on the ready
    event, and synchronize must order the side stream after the plan."""
    import torch

    side = torch.cuda.Stream()
    adds = 40
    x = torch.zeros(1 << 24, device="cuda")
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)          # ~0.1 s of spinning before the writes
        for _ in range(adds):
            x.add_(1.0)
        h = hvd.allreduce_async(x, op=hvd.Sum, name="e.stream")
        out = hvd.synchronize(h)
        total = out.sum()                       # on the side stream, after the plan
    torch.cuda.synchronize()
    ok = bool(torch.all(out == adds)) and float(total) == adds * x.numel()
    check(ok, f"[eager] stream safety: the result holds {float(out.min())}..{float(out.max())}, "
              f"not the final {adds}")
    print(f"[eager] stream safety: {adds} adds after a spin kernel on a side stream, enqueued "
          f"from it; the result holds the final value {adds} in all {x.numel()} elements",
          flush=True)


def _eager_latency(hvd, reps: int):
    """Median ms of a 4-byte allreduce: enqueue to synchronize's return, and
    to the value on the host."""
    import torch

    x = torch.ones(1, device="cuda")
    to_sync, to_host = [], []
    for i in range(reps):
        t0 = time.perf_counter()
        h = hvd.allreduce_async(x, op=hvd.Sum, name="e.lat")
        out = hvd.synchronize(h)
        t1 = time.perf_counter()
        check(float(out) == 1.0, f"[eager] latency probe returned {float(out)}")
        t2 = time.perf_counter()
        if i >= 5:
            to_sync.append((t1 - t0) * 1e3)
            to_host.append((t2 - t0) * 1e3)
    return statistics.median(to_sync), statistics.median(to_host)


def phase_eager(card):
    """[eager]: the eager API over the native core and the NCCL executor at
    one rank (see the module docstring, 13)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.env import Config
    from horovod_tpu_torch.core.nccl_executor import NcclPlanExecutor
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.tools.eager_parity import gpt2_small_grads

    t_phase = time.perf_counter()
    hvd.init()
    try:
        rt = basics._runtime.eager
        check(isinstance(rt.executor, NcclPlanExecutor) and hvd.nccl_enabled(),
              f"[eager] the runtime runs {type(rt.executor).__name__}, not the NCCL executor")
        default_cycle = rt.core.cycle_time_ms()
        _eager_ops_on_card(hvd, card)
        _eager_stream_safety(hvd)
        objs = hvd.allgather_object({"rank": hvd.rank(), "card": card})
        check(objs == [{"rank": 0, "card": card}], f"[eager] allgather_object {objs}")
        check(hvd.broadcast_object([1, "two", 3.0]) == [1, "two", 3.0], "[eager] broadcast_object")
        ps = hvd.add_process_set([0])
        y = torch.arange(12.0, device="cuda")
        check(torch.equal(hvd.allreduce(y, op=hvd.Sum, process_set=ps), y) and
              torch.equal(hvd.allgather(y, process_set=ps), y), "[eager] size-1 process set")
        hvd.remove_process_set(ps)
        hvd.join()
        hvd.barrier()
        print("[eager] allgather_object, broadcast_object, a size-1 process set, join and "
              "barrier held", flush=True)

        plans, orig = [], rt.executor.execute

        def spy(plan, entries, topo):
            plans.append((len(plan["names"]), int(plan["total_bytes"])))
            return orig(plan, entries, topo)

        rt.executor.execute = spy
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            grads = gpt2_small_grads(dt, "cuda", seed=3)
            elements = sum(g.numel() for g in grads)
            plans.clear()
            outs = hvd.grouped_allreduce(grads, op=hvd.Sum, name=f"e.grads.{tag}")
            check(all(torch.equal(o, g) for o, g in zip(outs, grads)),
                  f"[eager] grouped allreduce {tag} is not the input")
            check(len(plans) == 1 and plans[0][0] == len(grads),
                  f"[eager] grouped allreduce {tag}: plans {plans}, want one of {len(grads)}")
            fused = fusion.fused_allreduce(grads, op=hvd.Sum)
            check(all(torch.equal(o, g) for o, g in zip(fused, grads)),
                  f"[eager] fused_allreduce {tag} is not the input")
            del outs, fused
            times = {"eager": [], "fused": []}
            for i in range(EAGER_TURNS):
                for kind in ("eager", "fused") if i % 2 == 0 else ("fused", "eager"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if kind == "eager":
                        outs = hvd.grouped_allreduce(grads, op=hvd.Sum, name=f"e.grads.{tag}")
                    else:
                        outs = fusion.fused_allreduce(grads, op=hvd.Sum)
                    torch.cuda.synchronize()
                    times[kind].append((time.perf_counter() - t0) * 1e3)
                    del outs
            # Where the host's time goes: the enqueues, then the waits.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handles = hvd.grouped_allreduce_async(grads, op=hvd.Sum, name=f"e.grads.{tag}")
            t1 = time.perf_counter()
            outs = [hvd.synchronize(h) for h in handles]
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            split = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3)
            del outs
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                plans.clear()
                outs = hvd.grouped_allreduce(grads, op=hvd.Sum, name=f"e.grads.{tag}")
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation]
            nccl = [e for e in kernels if "nccl" in e.name.lower()]
            moved = 4 * elements * dt.itemsize      # pack read + write, unpack read + write
            print(f"[eager] grouped_allreduce of GPT-2-small's {len(grads)} parameter tensors, "
                  f"{elements} {tag} elements: {len(plans)} plan(s) of {plans[0][0]} tensors, "
                  f"{plans[0][1]} fused bytes; ms median {statistics.median(times['eager']):.3f} "
                  f"(all {[round(t, 3) for t in times['eager']]}) against "
                  f"fused_allreduce {statistics.median(times['fused']):.3f} "
                  f"(all {[round(t, 3) for t in times['fused']]}), in turns on {card}; "
                  f"bound {moved / HBM_BYTES_PER_S * 1e3:.3f} ms for {moved} bytes moved; "
                  f"one call split: enqueue {split[0]:.3f} ms, synchronize {split[1]:.3f}, "
                  f"device drain {split[2]:.3f}; "
                  f"profiled: {len(nccl)} NCCL kernel(s) a plan ({len(kernels)} kernels, "
                  f"{sum(e.time_range.elapsed_us() for e in kernels) / 1e3:.3f} ms device "
                  f"time)", flush=True)
            del grads, outs
        rt.executor.execute = orig
        lat_default = _eager_latency(hvd, EAGER_LAT_REPS)
    finally:
        hvd.shutdown()
    cfg = Config.from_env()
    cfg.cycle_time_ms = 1.0
    hvd.init(config=cfg)
    try:
        lat_1ms = _eager_latency(hvd, EAGER_LAT_REPS)
    finally:
        hvd.shutdown()
    print(f"[eager] 4-byte allreduce, median ms from enqueue to synchronize / to the value on "
          f"the host: {lat_default[0]:.3f} / {lat_default[1]:.3f} at HOROVOD_CYCLE_TIME "
          f"{default_cycle:g} ms, {lat_1ms[0]:.3f} / {lat_1ms[1]:.3f} at 1 ms "
          f"({EAGER_LAT_REPS - 5} calls each, on {card})", flush=True)
    print(f"[eager] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


BINDING_TURNS = 5        # the hook-driven steps against make_train_step, in turns
SYNC_BN_STEPS = 3        # ResNet-50 steps with every BN synchronized, in turns with plain BN
EXAMPLES = [
    ("pytorch_mnist", []),
    ("pytorch_synthetic_benchmark", ["--num-warmup-batches", "1", "--num-batches-per-iter",
                                     "2", "--num-iters", "2"]),
    ("pytorch_imagenet_resnet50", ["--epochs", "1", "--synthetic-batches", "2"]),
]


def _binding_ops_on_card(bhvd, card):
    """The binding's op surface on CUDA tensors: outputs on the card, the
    in-place forms in the caller's own storage, and an in-place allreduce
    enqueued from a side stream right behind a spin kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    n_checks = 0
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                    ("f16", torch.float16)):
        x = (torch.randn(1000, 7, device="cuda", generator=gen) * 3).to(dt)
        outs = {"allreduce sum": bhvd.allreduce(x, op=bhvd.Sum, name=f"b.{tag}.sum"),
                "allreduce average": bhvd.allreduce(x, name=f"b.{tag}.avg"),
                "allgather": bhvd.allgather(x, name=f"b.{tag}.ag"),
                "broadcast": bhvd.broadcast(x, 0, name=f"b.{tag}.bc"),
                "alltoall": bhvd.alltoall(x, name=f"b.{tag}.a2a"),
                "async": bhvd.synchronize(bhvd.allreduce_async(x, op=bhvd.Sum,
                                                               name=f"b.{tag}.async"))}
        outs["alltoall splits"], rs = bhvd.alltoall(x, splits=torch.tensor([x.shape[0]]),
                                                    name=f"b.{tag}.a2av")
        outs["grouped allreduce"] = bhvd.grouped_allreduce([x], op=bhvd.Sum,
                                                           name=f"b.{tag}.gar")[0]
        outs["grouped allgather"] = bhvd.grouped_allgather([x], name=f"b.{tag}.gag")[0]
        outs["grouped reducescatter"] = bhvd.grouped_reducescatter([x], name=f"b.{tag}.grs")[0]
        for what, o in outs.items():
            check(o.is_cuda and o.device == x.device, f"[torch-binding] {tag} {what} left the card")
            check(o.dtype == dt and torch.equal(o, x), f"[torch-binding] {tag} {what} is not the input")
        check(rs.tolist() == [x.shape[0]], f"[torch-binding] {tag} alltoall splits {rs}")
        for what, fn in (("allreduce_", lambda y: bhvd.allreduce_(y, op=bhvd.Sum,
                                                                  name=f"b.{tag}.ar_")),
                         ("broadcast_", lambda y: bhvd.broadcast_(y, 0, name=f"b.{tag}.bc_")),
                         ("allreduce_async_", lambda y: bhvd.synchronize(bhvd.allreduce_async_(
                             y, op=bhvd.Sum, name=f"b.{tag}.ara_")))):
            y = x.clone()
            ptr = y.data_ptr()
            z = fn(y)
            check(z is y and y.data_ptr() == ptr and torch.equal(y, x),
                  f"[torch-binding] {tag} {what} did not write into the caller's storage")
            n_checks += 1
        n_checks += len(outs)
    side = torch.cuda.Stream()
    adds = 40
    x = torch.zeros(1 << 24, device="cuda")
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)          # ~0.1 s of spinning before the writes
        for _ in range(adds):
            x.add_(1.0)
        ptr = x.data_ptr()
        bhvd.synchronize(bhvd.allreduce_async_(x, op=bhvd.Sum, name="b.stream"))
        total = x.sum()                         # on the side stream, after the write-back
    torch.cuda.synchronize()
    check(x.data_ptr() == ptr and bool(torch.all(x == adds)) and float(total) == adds * x.numel(),
          f"[torch-binding] stream safety: the result holds {float(x.min())}..{float(x.max())}, "
          f"not the final {adds}")
    print(f"[torch-binding] mpi_ops: {n_checks} op x dtype results on {card} (f32, bf16, f16): "
          f"each on the card and bitwise the input; allreduce_/broadcast_/allreduce_async_ "
          f"return the caller's tensor at its own data_ptr; an allreduce_async_ enqueued from a "
          f"side stream behind a spin kernel and {adds} adds holds {adds} in all {x.numel()} "
          f"elements", flush=True)


def _binding_hook_stream(bhvd):
    """A gradient produced on a side stream: the hook records its ready
    event on the stream autograd ran the producer on, so the reduced
    gradient (at one rank, the gradient itself) matches a plain backward."""
    import threading
    import torch

    def mlp():
        torch.manual_seed(5)
        return torch.nn.Sequential(torch.nn.Linear(1024, 4096), torch.nn.GELU(),
                                   torch.nn.Linear(4096, 1024)).cuda()

    side = torch.cuda.Stream()
    x = torch.randn(2048, 1024, device="cuda")
    ref_model, model = mlp(), mlp()
    opt = bhvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                    named_parameters=model.named_parameters())
    seen = []
    for p in model.parameters():
        p.register_post_accumulate_grad_hook(
            lambda p: seen.append((threading.get_ident(), torch.cuda.current_stream().cuda_stream)))
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        ref_model(x).square().mean().backward()
        torch.cuda._sleep(200_000_000)
        model(x).square().mean().backward()
        opt.synchronize()
        grads = [p.grad.clone() for p in model.parameters()]
    torch.cuda.synchronize()
    err = max(float((g - r.grad).abs().max() / r.grad.abs().max())
              for g, r in zip(grads, ref_model.parameters()))
    check(err <= 1e-5, f"[torch-binding] the side-stream gradients came back {err:.3e} off")
    check(len(seen) == 4 and all(s == side.cuda_stream for _, s in seen),
          f"[torch-binding] hooks ran on streams {[s for _, s in seen]}, not the side stream")
    print(f"[torch-binding] gradients produced on a side stream behind a spin kernel: the 4 "
          f"hooks ran on that stream (thread {'not ' if seen[0][0] != threading.get_ident() else ''}"
          f"the caller's), reduced gradients within {err:.1e} (limit 1e-5 of the largest) of a "
          f"plain backward", flush=True)


def _binding_gpt(bhvd, hvd, card):
    """The hook-driven DistributedOptimizer on GPT-2-small against
    make_train_step, in turns, then one step of each variant."""
    import threading
    import numpy as np
    import torch
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"], (BATCH, SEQ))).cuda()
    labels = torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"], (BATCH, SEQ))).cuda()

    def gpt():
        return TransformerLM(**GPT2_SMALL, max_len=SEQ, dtype=torch.bfloat16, seed=0)

    def adamw(m):
        return torch.optim.AdamW(m.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8)

    mb = gpt()
    n_tensors = sum(1 for _ in mb.parameters())
    bopt = bhvd.DistributedOptimizer(adamw(mb), named_parameters=mb.named_parameters())
    bhvd.broadcast_parameters(mb.state_dict(), root_rank=0)
    bhvd.broadcast_optimizer_state(bopt, root_rank=0)
    steps_on = {v["step"].device.type for v in bopt.state.values()}
    check(steps_on == {"cpu"}, f"[torch-binding] AdamW's step counters came back on {steps_on}")
    mt = gpt()
    hvd.broadcast_parameters(mt.state_dict())
    topt = hvd.DistributedOptimizer(adamw(mt), named_parameters=mt.named_parameters())
    tstep = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), topt)

    fired = []
    for p in mb.parameters():
        p.register_post_accumulate_grad_hook(lambda p: fired.append(threading.get_ident()))
    spent = {"enqueue": 0.0, "synchronize": 0.0}

    def timed(fn, key):
        def wrapper(*args):
            t0 = time.perf_counter()
            fn(*args)
            spent[key] += time.perf_counter() - t0
        return wrapper

    bopt._allreduce_grad_async = timed(bopt._allreduce_grad_async, "enqueue")
    bopt.synchronize = timed(bopt.synchronize, "synchronize")
    rt = basics._runtime.eager
    plans, orig_execute = [], rt.executor.execute

    def spy(plan, entries, topo):
        plans.append(len(plan["names"]))
        return orig_execute(plan, entries, topo)

    rt.executor.execute = spy
    rows, times, losses, launches = [], [], [], []
    try:
        for i in range(BINDING_TURNS):
            for kind in ("binding", "make_train_step") if i % 2 == 0 else \
                    ("make_train_step", "binding"):
                torch.cuda.synchronize()
                if kind == "make_train_step":
                    t0 = time.perf_counter()
                    tstep(mt, (tokens, labels))
                    torch.cuda.synchronize()
                    times.append(("make_train_step", time.perf_counter() - t0))
                    continue
                fired.clear()
                plans.clear()
                spent.update(enqueue=0.0, synchronize=0.0)
                f0, b0 = fa.FWD_LAUNCHES, fa.BWD_LAUNCHES
                t0 = time.perf_counter()
                bopt.zero_grad()
                loss = lm_loss(mb(tokens), labels)
                loss.backward()
                t1 = time.perf_counter()
                pending = len(bopt._handles)
                bopt.step()
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                losses.append(float(loss.detach()))
                times.append(("binding", t3 - t0))
                launches.append((fa.FWD_LAUNCHES - f0, fa.BWD_LAUNCHES - b0))
                rows.append({"backward": t1 - t0, "enqueue": spent["enqueue"],
                             "step": t2 - t1, "synchronize": spent["synchronize"],
                             "drain": t3 - t2, "plans": len(plans),
                             "planned_tensors": sum(plans), "hooks": len(fired),
                             "pending": pending,
                             "hook_threads": sorted(set(fired))})
                check(len(fired) == n_tensors and pending == n_tensors,
                      f"[torch-binding] {len(fired)} hooks fired and {pending} handles were "
                      f"pending, want {n_tensors} each")
    finally:
        rt.executor.execute = orig_execute
    check(all(np.isfinite(losses)), f"[torch-binding] non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"[torch-binding] loss did not fall: {losses}")
    check(all(f > 0 and b > 0 for f, b in launches), f"[torch-binding] flash launches {launches}")
    caller = threading.get_ident()
    med = {k: statistics.median([t for kk, t in times if kk == k][1:]) * 1e3
           for k in ("binding", "make_train_step")}
    split = {k: statistics.median([r[k] for r in rows[1:]]) * 1e3
             for k in ("backward", "enqueue", "step", "synchronize", "drain")}
    print(f"[torch-binding] GPT-2-small {BATCH} x {SEQ}, AdamW 3e-4 / wd 1e-4, hook-driven "
          f"DistributedOptimizer: losses {losses}; {n_tensors} hooks fired and {n_tensors} "
          f"handles pending each step; hook threads {rows[-1]['hook_threads']} (caller "
          f"{caller}: {'different' if caller not in rows[-1]['hook_threads'] else 'SAME'}); "
          f"B1 launches a step (fwd, bwd pairs) {launches}", flush=True)
    print(f"[torch-binding] step ms median of steps 2-{BINDING_TURNS}, in turns on {card}: "
          f"binding {med['binding']:.2f} against make_train_step {med['make_train_step']:.2f} "
          f"({med['binding'] / med['make_train_step']:.3f}x); binding split: forward+backward "
          f"{split['backward']:.2f} (of it enqueues in the hooks {split['enqueue']:.2f}), step() "
          f"{split['step']:.2f} (of it synchronize {split['synchronize']:.2f}), device drain "
          f"{split['drain']:.2f}; core plans a step {[r['plans'] for r in rows]} carrying "
          f"{[r['planned_tensors'] for r in rows]} tensors; all "
          f"{[(k, round(t * 1e3, 2)) for k, t in times]}", flush=True)
    del mt, topt, tstep

    # The variants, one step each on fresh optimizers over the same model.
    for h in bopt._hook_handles:
        h.remove()
    del bopt
    opt = bhvd.DistributedOptimizer(adamw(mb), named_parameters=mb.named_parameters(),
                                    backward_passes_per_step=2)
    opt.zero_grad()
    lm_loss(mb(tokens), labels).backward()
    first = len(opt._handles)
    loss = lm_loss(mb(tokens), labels)
    loss.backward()
    second = len(opt._handles)
    opt.step()
    check(first == 0 and second == n_tensors and np.isfinite(float(loss)),
          f"[torch-binding] backward_passes_per_step=2: handles {first} then {second}, loss "
          f"{float(loss)}")
    for h in opt._hook_handles:
        h.remove()
    opt = bhvd.DistributedOptimizer(adamw(mb), named_parameters=mb.named_parameters(),
                                    compression=bhvd.Compression.fp16)
    opt.zero_grad()
    loss16 = lm_loss(mb(tokens), labels)
    loss16.backward()
    opt.step()
    check(np.isfinite(float(loss16)) and all(p.grad.dtype == p.dtype for p in mb.parameters()),
          f"[torch-binding] Compression.fp16: loss {float(loss16)}")
    for h in opt._hook_handles:
        h.remove()
    # op=Adasum at one rank: the rebased parameters are the local step's.
    ref = gpt()
    ref.load_state_dict(mb.state_dict())
    ada = bhvd.DistributedOptimizer(adamw(mb), named_parameters=mb.named_parameters(),
                                    op=bhvd.Adasum)
    plain = adamw(ref)
    ada.zero_grad()
    lossa = lm_loss(mb(tokens), labels)
    lossa.backward()
    for p, q in zip(mb.parameters(), ref.parameters()):
        q.grad = p.grad.clone()
    ada.step()
    plain.step()
    err = max(float((p - q).abs().max()) for p, q in zip(mb.parameters(), ref.parameters()))
    scale = max(float(q.abs().max()) for q in ref.parameters())
    check(err <= 2 * 2.0 ** -23 * scale,
          f"[torch-binding] op=Adasum at one rank: {err:.3e} from the local AdamW step")
    print(f"[torch-binding] one step each: backward_passes_per_step=2 ({first} then {second} "
          f"handles after the two backwards, loss {float(loss):.4f}), Compression.fp16 (loss "
          f"{float(loss16):.4f}), op=Adasum (loss {float(lossa):.4f}; parameters within "
          f"{err:.2e} of the local AdamW step, limit two f32 ulps of the largest {scale:.3f})",
          flush=True)
    del mb, ref, ada, plain, opt
    torch.cuda.empty_cache()


def _forced_sync_batch_norm():
    """SyncBatchNorm forced onto its sync path at one rank (``_use_sync``:
    training mode alone)."""
    from horovod_tpu_torch.torch import SyncBatchNorm

    class ForcedSyncBatchNorm(SyncBatchNorm):
        def _use_sync(self):
            return self.training

    return ForcedSyncBatchNorm


def _binding_resnet(bhvd, hvd, card):
    """ResNet-50 at 32 x 224² through the binding against make_train_step,
    in turns; then with every BN synchronized, in turns with plain BN."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.tools.binding_parity import sync_bn_resnet

    torch.backends.cudnn.benchmark = True
    batch = _cnn_batch(32, CNN_SIDE, CNN_CLASSES)

    def binding_model(sync_bn=False):
        m = get_model("resnet50", num_classes=CNN_CLASSES, seed=0)
        n_bn = sync_bn_resnet(m, _forced_sync_batch_norm()) if sync_bn else 0
        bhvd.broadcast_parameters(m.state_dict(), root_rank=0)
        o = bhvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
                                      named_parameters=m.named_parameters())
        bhvd.broadcast_optimizer_state(o, root_rank=0)

        def step():
            o.zero_grad()
            loss = F.cross_entropy(m(batch[0]), batch[1])
            loss.backward()
            o.step()
            return float(loss)

        return m, step, n_bn

    try:
        mb, bstep, _ = binding_model()
        mt = get_model("resnet50", num_classes=CNN_CLASSES, seed=0)
        tstep = _cnn_step(mt, hvd)
        times = {"binding": [], "make_train_step": []}
        losses = []
        for i in range(BINDING_TURNS):
            for kind in ("binding", "make_train_step") if i % 2 == 0 else \
                    ("make_train_step", "binding"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "binding":
                    losses.append(bstep())
                else:
                    tstep(mt, batch)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"[torch-binding] ResNet-50 losses {losses}")
        med = {k: statistics.median(v[1:]) for k, v in times.items()}
        print(f"[torch-binding] ResNet-50 32 x 224², SGD 0.01 / momentum 0.9: losses {losses}; "
              f"img/s (median of steps 2-{BINDING_TURNS}, in turns on {card}) binding "
              f"{32 / med['binding']:.1f} ({med['binding'] * 1e3:.2f} ms) against "
              f"make_train_step {32 / med['make_train_step']:.1f} "
              f"({med['make_train_step'] * 1e3:.2f} ms)", flush=True)
        del mt, tstep

        ms, sstep, n_bn = binding_model(sync_bn=True)
        check(n_bn == 53, f"[torch-binding] {n_bn} BatchNorm layers replaced, want 53")
        times = {"sync": [], "plain": []}
        slosses = []
        for i in range(SYNC_BN_STEPS):
            for kind in ("sync", "plain") if i % 2 == 0 else ("plain", "sync"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "sync":
                    slosses.append(sstep())
                else:
                    bstep()
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
        check(all(np.isfinite(slosses)), f"[torch-binding] SyncBatchNorm ResNet-50 losses {slosses}")
        med = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
        print(f"[torch-binding] ResNet-50 32 x 224² with all {n_bn} BatchNorms synchronized "
              f"(forced onto the sync path: {2 * n_bn} blocking eager allreduces a step): losses "
              f"{slosses}; step ms (median of steps 2-{SYNC_BN_STEPS}, in turns) "
              f"{med['sync']:.2f} against plain BN {med['plain']:.2f} (+{med['sync'] - med['plain']:.2f}"
              f" ms, {(med['sync'] - med['plain']) / (2 * n_bn):.3f} ms a collective); all "
              f"{ {k: [round(t * 1e3, 2) for t in v] for k, v in times.items()} }", flush=True)
    finally:
        torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()


def _binding_sync_bn(card):
    """SyncBatchNorm's sync path at one rank against nn.BatchNorm2d on the
    same input: f32 with TF32 off, and a bf16 input (the module in f32)."""
    import torch

    cls = _forced_sync_batch_norm()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(21)
    c = 64
    errs = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = (torch.randn(32, c, 28, 28, device="cuda", generator=gen) * 2 + 0.5).to(dt)
        dy = torch.randn(32, c, 28, 28, device="cuda", generator=gen).to(dt)
        sbn = cls(c, eps=1e-5, momentum=0.1, device="cuda")
        ref = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1, device="cuda")
        with torch.no_grad():
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            b = torch.randn(c, device="cuda", generator=gen)
            for m in (sbn, ref):
                m.weight.copy_(w)
                m.bias.copy_(b)
        xs = x.clone().requires_grad_(True)
        xr = x.float().clone().requires_grad_(True)
        ys, yr = sbn(xs), ref(xr)
        ys.backward(dy)
        yr.backward(dy.float())
        check(ys.dtype == dt and xs.grad.dtype == dt, f"[torch-binding] SyncBatchNorm {tag} dtypes")
        # f32: the sums in another order (one-pass E[x^2] - E[x]^2 against
        # cuDNN's); bf16: two bf16 ulps of the f32 reference rounded once.
        y_tol, dx_tol = ((1e-4, 1e-5), (1e-3, 1e-4)) if tag == "f32" else \
            ((BF16_RTOL, 1e-4), (BF16_RTOL, 1e-4))
        e = [max_err(ys, yr.to(dt), *y_tol, f"SyncBatchNorm {tag} output"),
             max_err(xs.grad, xr.grad.to(dt), *dx_tol, f"SyncBatchNorm {tag} dx"),
             max_err(sbn.weight.grad, ref.weight.grad, 1e-4, 1e-3, f"SyncBatchNorm {tag} dweight"),
             max_err(sbn.bias.grad, ref.bias.grad, 1e-4, 1e-3, f"SyncBatchNorm {tag} dbias"),
             max_err(sbn.running_mean, ref.running_mean, 1e-5, 1e-5,
                     f"SyncBatchNorm {tag} running mean"),
             max_err(sbn.running_var, ref.running_var, 1e-5, 1e-5,
                     f"SyncBatchNorm {tag} running var")]
        errs[tag] = [f"{v:.1e}" for v in e]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(f"[torch-binding] SyncBatchNorm's sync path (two eager allreduces on CUDA tensors) "
          f"against nn.BatchNorm2d at one rank on {card}, 32 x {c} x 28², max abs err "
          f"(output, dx, dweight, dbias, running mean, running var): f32 with TF32 off "
          f"{errs['f32']} (tolerances 1e-4/1e-5, 1e-3/1e-4, 1e-4/1e-3 x2, 1e-5/1e-5 x2), bf16 "
          f"input {errs['bf16']} (output and dx at two bf16 ulps of the f32 reference)",
          flush=True)


def _binding_micro():
    """micro_bench at one rank (its --one-rank flag, in the rows)."""
    from horovod_tpu_torch.utils import micro_bench

    record = micro_bench.sweep(one_rank=True)
    rows = record["rows"]
    check(len(rows) == 4 and all(r["one_rank"] and r["compiled_us"] > 0 and
                                 r["eager_np_us"] > 0 and r["eager_dev_us"] > 0 for r in rows),
          f"[micro] rows {rows}")
    for r in rows:
        print(f"[micro] one rank on {record['card']}, {r['bytes']} bytes, {r['reps']} reps: "
              f"median us eager numpy {r['eager_np_med_us']}, eager CUDA tensor "
              f"{r['eager_dev_med_us']}, floor (the NCCL plan executor alone) "
              f"{r['compiled_med_us']}, torch.distributed.all_reduce {r['ref_psum_med_us']}; "
              f"overhead numpy / tensor {r['overhead_np_med_us']} / {r['overhead_dev_med_us']} "
              f"(noise band {r['noise_band_us']})", flush=True)
    print(f"[micro] rows: {json.dumps(rows)}", flush=True)


def _binding_examples():
    """The three example copies, each in its own process, at once."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hvd_examples_") as tmp:
        procs = []
        for name, argv in EXAMPLES:
            if name == "pytorch_imagenet_resnet50":
                argv = argv + ["--checkpoint-format", os.path.join(tmp, "ck-{epoch}.pth.tar")]
            cmd = [sys.executable, "-m", f"horovod_tpu_torch.examples.{name}", *argv]
            procs.append((name, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env={**os.environ, "PYTHONPATH": os.getcwd(), "TMPDIR": tmp})))
        try:
            for name, cmd, proc in procs:
                out = proc.communicate(timeout=600)[0]
                check(proc.returncode == 0, f"[examples] {name} exited {proc.returncode}: "
                      f"{out[-3000:]}")
                print(f"[examples] {' '.join(cmd[1:])}: exit 0; last line: "
                      f"{out.strip().splitlines()[-1] if out.strip() else ''}", flush=True)
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def phase_torch_binding(card):
    """[torch-binding]: the hook-driven binding (``horovod_tpu_torch.torch``)
    at one rank (see the module docstring, 14)."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as bhvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.core.nccl_executor import NcclPlanExecutor

    t_phase = time.perf_counter()
    bhvd.init()
    try:
        check(isinstance(basics._runtime.eager.executor, NcclPlanExecutor),
              "[torch-binding] the eager runtime does not run the NCCL executor")
        _binding_ops_on_card(bhvd, card)
        _binding_hook_stream(bhvd)
        _binding_gpt(bhvd, hvd, card)
        _binding_resnet(bhvd, hvd, card)
        _binding_sync_bn(card)
    finally:
        bhvd.shutdown()
    _binding_micro()
    _binding_examples()
    print(f"[torch-binding] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)

PP_MICRO = 8              # [pp]: microbatches of one sequence, GPT-2-small's 8 x 1024 batch
PP_STAGES = 4             # [pp]: the stages the threads play (3 blocks each)
# [pp]: the pipeline's first loss against make_train_step's on the same weights
# and batch. Both run the same bf16 blocks; they differ in the embedding sum
# (f32 then one cast here, two bf16 lookups added in bf16 in the module) and
# in the GEMMs' row counts, so the mean loss over 8192 tokens moves by a few
# bf16 roundings of its terms, not by a bf16 ulp of the loss (2^-8 = 3.9e-3).
PP_LOSS_RTOL = 1e-2
# [pp]: the 4-stage schedule's gradients against the one-stage run's: each at
# most two bf16 ulps (2^-7) of the tensor's largest element away.
PP_GRAD_REL = 2.0 ** -7
EP_TOKENS, EP_DIMS = 4096, dict(d_model=512, d_hidden=2048, experts=16)
EP_RANKS = 4              # [ep]: the virtual expert ranks


class VirtualLine:
    """One stage of a pipeline played on one card by threads, the transport
    seam of parallel/pp.py (``rank``, ``n``, ``post``, ``wait``,
    ``broadcast``): each post puts this stage's send and whether it receives
    on the board, waits for the other stages, and takes a device copy of
    what its source sent (one stream for all threads, so a read follows the
    kernel that made the data). It checks the schedule's pairing a NCCL run
    would deadlock on: a receive with no matching send, a send nobody takes,
    or shapes and dtypes that differ."""

    def __init__(self, rank, n, board):
        self.rank, self.n, self.board = rank, n, board

    def _all(self, item):
        slots, barrier = self.board["slots"], self.board["barrier"]
        slots[self.rank] = item
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def post(self, send, recv_like, step):
        got = self._all((send, recv_like is not None))
        if send is not None:
            dst = self.rank + step
            check(0 <= dst < self.n and got[dst][1],
                  f"virtual line: stage {self.rank} sent to {dst}, which posted no receive")
        if recv_like is None:
            return None, None
        src = self.rank - step
        sent = got[src][0] if 0 <= src < self.n else None
        check(sent is not None and sent.shape == recv_like.shape and sent.dtype == recv_like.dtype,
              f"virtual line: stage {self.rank} receives {tuple(recv_like.shape)} "
              f"{recv_like.dtype} from {src}, which sent "
              f"{None if sent is None else (tuple(sent.shape), sent.dtype)}")
        return sent.clone(), None

    @staticmethod
    def wait(handle):
        return handle[0]

    def broadcast(self, x, root):
        return self._all((x, False))[root][0].clone()


def play_line(n, fn):
    """Run ``fn(line)`` for n virtual stages in n threads; their results by
    stage. A failure in any stage fails the phase."""
    import threading

    import torch

    board = {"slots": [None] * n, "barrier": threading.Barrier(n, timeout=300)}
    results, errors = [None] * n, []

    def body(s):
        try:
            results[s] = fn(VirtualLine(s, n, board))
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append(e)
            board["barrier"].abort()

    threads = [threading.Thread(target=body, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    return results


def _pp_grads(flat, n_stages, tokens, labels, line):
    """One stage's loss and gradients (zeros where another stage owns the
    parameter) of GPT-2-small through ``pipeline_lm_loss`` at the initial
    weights, as CPU tensors by flax name."""
    import torch
    from horovod_tpu_torch.parallel.pp import pipeline_lm_loss
    from horovod_tpu_torch.tools.pp_parity import (gpt_embed_fn, gpt_head_loss_fn,
                                                   gpt_stage_fn)
    from horovod_tpu_torch.utils.convert import (flatten, nest, pp_params_from_flax,
                                                 pp_params_to_flax)

    params = pp_params_from_flax(flat, n_stages, line.rank)
    loss = pipeline_lm_loss(gpt_embed_fn(torch.bfloat16),
                            gpt_stage_fn(GPT2_SMALL["n_heads"], torch.bfloat16),
                            gpt_head_loss_fn(torch.bfloat16), params["embed"], params["stages"],
                            params["head"], tokens, labels, axis_name=line, remat=True)
    grads = nest({p: t.grad if t.grad is not None else torch.zeros_like(t)
                  for p, t in flatten(params).items()})
    named = pp_params_to_flax(grads, n_stages, line.rank, GPT2_SMALL["n_layers"])
    return float(loss), {k: torch.from_numpy(v) for k, v in named.items()}


def phase_pp(card):
    """[pp]: GPT-2-small through make_pp_lm_train_step on one card, then the
    4-stage schedule played by threads (the module docstring, 15)."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.tools.pp_parity import _gpt_step
    from horovod_tpu_torch.utils.convert import params_to_numpy, pp_params_from_flax

    t_phase = time.perf_counter()
    hvd.init()
    try:
        model = TransformerLM(**GPT2_SMALL, max_len=SEQ, dtype=torch.bfloat16, seed=0)
        flat = params_to_numpy(model)
        rng = np.random.RandomState(3)
        tokens, labels = (torch.from_numpy(rng.randint(0, GPT2_SMALL["vocab_size"],
                                                       (PP_MICRO, 1, SEQ))).cuda()
                          for _ in range(2))

        def adamw(ps):
            return torch.optim.AdamW(ps, lr=3e-4, weight_decay=1e-4, eps=1e-8)

        # make_train_step's first loss: the loss of the initial weights.
        dp_step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]),
                                      adamw(model.parameters()))
        dp_loss = float(dp_step(model, (tokens.reshape(-1, SEQ), labels.reshape(-1, SEQ))))
        del model, dp_step
        mesh = build_mesh({"stage": 1, "data": 1})
        params = pp_params_from_flax(flat, 1, 0)
        step = _gpt_step(mesh, params, torch.bfloat16, GPT2_SMALL["n_heads"], adamw)
        torch.cuda.reset_peak_memory_stats()
        losses, times, launches = [], [], []
        for _ in range(STEPS):
            fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(params, tokens, labels)))
            times.append(time.perf_counter() - t0)
            launches.append((fa.FWD_LAUNCHES, fa.BWD_LAUNCHES))
        print(f"[pp] GPT-2-small through make_pp_lm_train_step on a stage 1 x data 1 mesh, "
              f"{PP_MICRO} microbatches of 1 x {SEQ}, remat, AdamW 3e-4 / wd 1e-4: losses "
              f"{losses}; B1 launches a step (fwd, bwd pairs) {launches}", flush=True)
        check(all(np.isfinite(losses)), f"[pp] non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"[pp] loss did not fall: {losses}")
        check(all(f > 0 and b > 0 for f, b in launches), f"[pp] B1 launches {launches}")
        rel = abs(losses[0] - dp_loss) / abs(dp_loss)
        check(rel <= PP_LOSS_RTOL, f"[pp] first loss {losses[0]} against make_train_step's "
              f"{dp_loss}: rel {rel:.2e} > {PP_LOSS_RTOL}")
        med = statistics.median(times[1:])
        print(f"[pp] first loss {losses[0]:.6f} against make_train_step's {dp_loss:.6f} (rel "
              f"{rel:.2e}, limit {PP_LOSS_RTOL}); step ms median {med * 1e3:.2f} (steps "
              f"2-{STEPS}; first {times[0] * 1e3:.1f}), tokens/s {PP_MICRO * SEQ / med:.0f} on "
              f"{card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        del params, step

        # The one-stage gradients at the initial weights, then 4 stages by threads.
        (ref_loss, ref), = play_line(1, lambda line: _pp_grads(flat, 1, tokens, labels, line))
        t0 = time.perf_counter()
        staged = play_line(PP_STAGES, lambda line: _pp_grads(flat, PP_STAGES, tokens, labels,
                                                              line))
        staged_s = time.perf_counter() - t0
        worst, n_checked, seen = 0.0, 0, set()
        for s, (loss, grads) in enumerate(staged):
            check(loss == staged[0][0], f"[pp] stage {s} loss {loss} != stage 0's {staged[0][0]}")
            for name, g in grads.items():
                owner = (name.startswith("block_") or (s == 0 and name.split("/")[0] in
                                                        ("embeddings", "pos_embeddings"))
                         or (s == PP_STAGES - 1 and name.split("/")[0] in ("ln_f", "lm_head")))
                if not owner:
                    check(not g.any(), f"[pp] stage {s} holds a gradient of {name}")
                    continue
                worst = max(worst, rel_err(g, ref[name], f"[pp] stage {s} grad {name}",
                                           PP_GRAD_REL))
                n_checked += 1
                seen.add(name)
        check(seen == set(ref), f"[pp] gradients never checked: {sorted(set(ref) - seen)}")
        rel = abs(staged[0][0] - ref_loss) / abs(ref_loss)
        check(rel <= PP_GRAD_REL, f"[pp] 4-stage loss {staged[0][0]} against {ref_loss}")
        print(f"[pp] {PP_STAGES}-stage schedule played by {PP_STAGES} threads on {card} "
              f"({PP_MICRO + PP_STAGES - 1} forward and backward ticks, bubble share "
              f"{(PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1):.3f}, {staged_s:.1f} s): loss "
              f"{staged[0][0]:.6f} against the one-stage run's {ref_loss:.6f} (rel {rel:.2e}); "
              f"{n_checked} gradients, worst {worst:.2e} of the tensor's largest element "
              f"(limit {PP_GRAD_REL:.2e})", flush=True)
    finally:
        hvd.shutdown()
    print(f"[pp] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_ep(card):
    """[ep]: the MoE layer's index dispatch against its dense form, 4
    virtual expert ranks against one, and the MoE bench (the module
    docstring, 16)."""
    import os

    import numpy as np
    import torch
    from horovod_tpu_torch.parallel.ep import MoEParams, _moe_ffn_dense, init_moe_params, moe_ffn

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    d, e = EP_DIMS["d_model"], EP_DIMS["experts"]
    p32 = init_moe_params(g, d_model=d, d_hidden=EP_DIMS["d_hidden"], num_experts=e,
                          num_expert_shards=EP_RANKS)
    x32 = torch.randn(EP_RANKS * EP_TOKENS, d, generator=g, device="cuda")
    shard = x32[:EP_TOKENS]
    with torch.no_grad():
        y32, aux32 = moe_ffn(p32, shard, expert_axis=None)
        d32, daux32 = _moe_ffn_dense(p32, shard, expert_axis=None)
        check(torch.equal(y32, d32) and torch.equal(aux32, daux32),
              f"[ep] f32 index dispatch != dense form: max diff {(y32 - d32).abs().max():.3e}")
        p16 = MoEParams(*(t.bfloat16() for t in p32))
        y16, _ = moe_ffn(p16, shard.bfloat16(), expert_axis=None)
        d16, _ = _moe_ffn_dense(p16, shard.bfloat16(), expert_axis=None)
        check(torch.equal(y16, d16), "[ep] bf16 index dispatch != dense form")
        same = ((shard.bfloat16() @ p16.w_router).float().argmax(-1)
                == (shard @ p32.w_router).argmax(-1))
        rows = same & (y16 != 0).any(-1) & (d32 != 0).any(-1)
        err16 = rel_err(y16[rows], d32[rows], "[ep] bf16 against the f32 form")
        dropped = int((~(y32 != 0).any(-1)).sum())
        print(f"[ep] moe_ffn on {card}, {EP_TOKENS} tokens, {e} experts, d {d} / "
              f"{EP_DIMS['d_hidden']}, capacity {max(1, int(1.25 * EP_TOKENS / e))}: index "
              f"dispatch bitwise the dense one-hot form in f32 (TF32 off) and in bf16, "
              f"{dropped} tokens dropped; bf16 against f32 {err16:.2e} of the largest output "
              f"over the {int(rows.sum())} tokens both route alike and keep", flush=True)
        t_idx = time_ms(lambda: moe_ffn(p16, shard.bfloat16(), expert_axis=None), 10)
        t_dense = time_ms(lambda: _moe_ffn_dense(p16, shard.bfloat16(), expert_axis=None), 10)
        print(f"[ep] bf16 forward ms: index dispatch {t_idx:.3f} against the dense form "
              f"{t_dense:.3f}", flush=True)

        # Four virtual expert ranks, each its own shard and experts, by threads.
        per = e // EP_RANKS

        def rank_forward(hop):
            r = hop.rank
            local = MoEParams(p32.w_router, p32.w_in[r * per:(r + 1) * per],
                              p32.w_out[r * per:(r + 1) * per])
            return moe_ffn(local, x32[r * EP_TOKENS:(r + 1) * EP_TOKENS], expert_axis=hop)

        results, hops = play_grid(1, EP_RANKS, lambda lv: rank_forward(lv.local))
        for r, (y, aux) in enumerate(results):
            ref_y, ref_aux = moe_ffn(p32, x32[r * EP_TOKENS:(r + 1) * EP_TOKENS],
                                     expert_axis=None)
            check(torch.equal(y, ref_y) and torch.equal(aux, ref_aux),
                  f"[ep] virtual expert rank {r} != the one-rank forward: max diff "
                  f"{(y - ref_y).abs().max():.3e}")
        print(f"[ep] {EP_RANKS} virtual expert ranks by threads ({hops} all-to-alls a rank): "
              f"every rank's output and aux bitwise the one-rank forward over its shard in f32",
              flush=True)

    cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", "--model", "moe",
           "--num-warmup-batches", "1", "--num-batches-per-iter", "5", "--num-iters", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": os.getcwd()})
    check(proc.returncode == 0, f"[ep] bench moe exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    check(len(lines) == 1, f"[ep] bench moe printed {len(lines)} JSON lines")
    out = json.loads(lines[0])
    det = out["detail"]
    print(f"[ep] {' '.join(cmd[2:])}: {lines[0]}", flush=True)
    check(out["metric"] == "moe_synthetic_tokens_per_sec_per_chip" and out["value"] > 0,
          f"[ep] bench moe: {out['metric']} {out['value']}")
    check(np.isfinite(det["loss"]) and det["loss"] < det["initial_loss"],
          f"[ep] bench moe loss {det['initial_loss']} -> {det['loss']}")
    check(det["mesh"] == {"data": 1, "expert": 1}, f"[ep] bench moe mesh {det['mesh']}")
    print(f"[ep] MoE bench at the reference dims, expert 1: {out['value']:.1f} tokens/s, MFU "
          f"{det['mfu']} ({det['flops_source']}), loss {det['initial_loss']:.4f} -> "
          f"{det['loss']:.4f}, on {card}", flush=True)
    print(f"[ep] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def gpt_family(name: str) -> str:
    """The GPT steps' kernel families: the port's flash kernels (no SDPA in
    the step), cuBLAS GEMMs, NCCL, everything else."""
    return ("flash" if "flash_" in name
            else "gemm" if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet"))
            else "nccl" if "nccl" in name else "other")


def cnn_family(name: str) -> str:
    """The CNN step's kernel families: cuDNN's convolutions (forward, data
    and weight gradients, layout transposes), BatchNorm, the optimizer's
    multi-tensor kernels, NCCL, cuBLAS (the head), elementwise work (relu,
    residual adds, casts, pools, reductions, the fused allreduce's copies)."""
    return ("nccl" if "nccl" in name
            else "conv" if any(s in name for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                                                   "xmma", "nchwtonhwc", "nhwctonchw"))
            else "bn" if "batch_norm" in name or "batchnorm" in name
            else "optimizer" if "multi_tensor" in name
            else "gemm" if any(s in name for s in ("gemm", "cutlass", "cublas", "nvjet"))
            else "elementwise" if any(s in name for s in ("elementwise", "reduce", "pool",
                                                          "copy", "cat", "fill", "index"))
            else "other")


def profile_step(run_step, span=None, classify=gpt_family,
                 families=("flash", "gemm", "nccl", "other"), tag="profile") -> float:
    """One more step under torch.profiler: device time by kernel family
    (``classify`` of a kernel's lower-case name, one of ``families``) and
    the device's busy share of the step (taken after the timed steps, so the
    profiler's cost touches no reported step time). Kernels that start
    inside a ``record_function`` range named ``span`` form a family of
    their own. Returns the busy share (0 when the profiler saw nothing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events, without the annotation ranges (Optimizer.step...)
    # that span other kernels.
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not e.is_user_annotation]
    if not kernels:
        print(f"[{tag}] the profiler saw no device activity: not measured", flush=True)
        return 0.0
    ranges = [(e.time_range.start, e.time_range.end) for e in device
              if e.is_user_annotation and e.name == span]
    families = dict.fromkeys(families, 0.0)
    if span is not None:
        families[span] = 0.0
        if not ranges:
            print(f"[{tag}] no device range named {span}: its family is not measured",
                  flush=True)
    others = {}
    for e in kernels:
        us, start = e.time_range.elapsed_us(), e.time_range.start
        fam = span if any(a <= start < b for a, b in ranges) else classify(e.name.lower())
        families[fam] += us / 1e3
        if fam == "other":
            others[e.name[:70]] = others.get(e.name[:70], 0.0) + us / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{tag}] one step: host {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_ms:.1%}), {len(kernels)} kernels; by family ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in families.items()), flush=True)
    print(f"[{tag}] largest other kernels ms: "
          + "; ".join(f"{n} {v:.2f}" for n, v in top), flush=True)
    return busy / wall_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import horovod_tpu_torch  # noqa: F401 - fails where the repo is missing

    card = phase_card()
    phase_build()
    phase_kernels_f32()
    phase_kernels_bf16()
    rows = phase_kernels_bench()
    phase_block_f32()
    block_rows = phase_block_bench(card)
    rows["flash_block_fwd"] = dict(block_rows["flash_block_fwd"], replaces=f"{REPLACED}:369")
    # The block's VJP, the reference's _flash_block_vjp_bwd.
    for name in ("flash_block_bwd_dq", "flash_block_bwd_dkdv"):
        rows[name] = dict(block_rows[name], replaces=f"{REPLACED}:386")
    phase_ring_merge()
    phase_small_model()
    launches, slice_tokens_per_s = phase_train()
    phase_head_dims()
    phase_dp_variants(card)
    sp_launches = phase_sp_train()
    phase_tp_kernels_f32()
    tp_rows = phase_tp_kernels_bench(card)
    tp_launches = phase_tp_ring()
    phase_tp_train()
    phase_hier(card)
    phase_cnn()
    phase_bench(slice_tokens_per_s)
    phase_eager(card)
    phase_torch_binding(card)
    phase_pp(card)
    phase_ep(card)
    # The B3/B4 rows: the q/k/v call (B3) and the MLP-down call (B4), the
    # largest of each at the main path's shapes; every call is printed above.
    rows["ag_matmul"] = dict(tp_rows["qkv"], replaces=f"{CM_REPLACED}:274")
    rows["matmul_reduce_scatter"] = dict(tp_rows["mlp_down"], replaces=f"{CM_REPLACED}:352")
    counts = {"flash_fwd": launches["fwd"], "flash_bwd_dq": launches["bwd"],
              "flash_bwd_dkdv": launches["bwd"], "flash_block_fwd": sp_launches["block"],
              "flash_block_bwd_dq": sp_launches["block_bwd"],
              "flash_block_bwd_dkdv": sp_launches["block_bwd"],
              "ag_matmul": tp_launches["b3"], "matmul_reduce_scatter": tp_launches["b4"]}
    kernels = [
        {"name": name, "route": "cuda",
         "source": CM_SOURCE if name in ("ag_matmul", "matmul_reduce_scatter") else KERNEL_SOURCE,
         "replaces": r["replaces"], "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"],
         **({"device_ms": r["device_ms"]} if "device_ms" in r else {})}
        for name, r in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
