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
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(["flash_attention", "collective_matmul"])
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
        return launches
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

    def __init__(self, rank, n, mailbox, barrier):
        self.rank, self.n, self.mailbox, self.barrier = rank, n, mailbox, barrier

    def post(self, sends):
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


def profile_step(run_step, span=None) -> None:
    """One more step under torch.profiler: device time by kernel family and
    the device's busy share of the step (taken after the timed steps, so the
    profiler's cost touches no reported step time). Kernels that start
    inside a ``record_function`` range named ``span`` form a family of
    their own."""
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
        print("[profile] the profiler saw no device activity: not measured", flush=True)
        return
    ranges = [(e.time_range.start, e.time_range.end) for e in device
              if e.is_user_annotation and e.name == span]
    families = {"flash": 0.0, "gemm": 0.0, "nccl": 0.0, "other": 0.0}
    if span is not None:
        families[span] = 0.0
        if not ranges:
            print(f"[profile] no device range named {span}: its family is not measured",
                  flush=True)
    others = {}
    for e in kernels:
        name, us = e.name.lower(), e.time_range.elapsed_us()
        start = e.time_range.start
        fam = (span if any(a <= start < b for a, b in ranges)
               else "flash" if "flash_" in name     # the port's kernels: no SDPA in the step
               else "gemm" if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet"))
               else "nccl" if "nccl" in name else "other")
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
    print(f"[profile] one step: host {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_ms:.1%}), {len(kernels)} kernels; by family ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in families.items()), flush=True)
    print("[profile] largest other kernels ms: "
          + "; ".join(f"{n} {v:.2f}" for n, v in top), flush=True)


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
    launches = phase_train()
    phase_head_dims()
    sp_launches = phase_sp_train()
    phase_tp_kernels_f32()
    tp_rows = phase_tp_kernels_bench(card)
    tp_launches = phase_tp_ring()
    phase_tp_train()
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
