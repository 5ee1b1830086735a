#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends:

1. the card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. the build: nvcc compiles ``horovod_tpu_torch/csrc/*.cu`` (sm_90a);
3. each flash-attention kernel against its plain PyTorch version: in f32
   with TF32 off at small shapes and at the GPT-2-small shape (rtol 2e-4 /
   atol 2e-5 forward, 1e-3 / 1e-4 gradients, the tolerances of
   tests/test_flash_attention.py), and in bf16 at the GPT-2-small shape
   (lse at the f32 forward tolerance; O, dQ, dK, dV at two bf16 ulps, see
   ``BF16_RTOL``), with each kernel's time,
   its plain version's time, its bound and, where one exists, the time of
   the library call that computes the same function
   (``scaled_dot_product_attention``, timed only as a yardstick);
4. the ring block kernel (B2) against its plain version: in f32 with TF32
   off at the small shapes, causal and not, at delta -T, 0, +T/2 and +T
   (O, m, l at 2e-4 / 2e-5; at delta >= T exactly m = -1e30, l = 0, O = 0),
   and in bf16 at the long-context shape (BH 2 x 12, T 4096, D 64) at delta
   0 and -T, f32 outputs at the f32 forward tolerance (O relative to its
   row sum l), with its time, the
   plain version's and its bound; beside it the time of the block's dense
   backward (PyTorch, not a kernel);
5. the ring's merge on one card: one bf16 GPT-2-small attention input at T
   4096 cut into 4 sequence pieces; each piece merges its 4 ring blocks in
   the order a ring rank sees them, and the result must match B1's forward
   over the whole sequence within two bf16 ulps;
6. the data-parallel slice: a small f32 model on the card (kernels) against
   the same model on the CPU (plain versions), then ``init()`` over NCCL,
   GPT-2-small width (d_model 768, 12 heads, 12 layers, vocab 32768, T
   1024), ``broadcast_parameters``, ``DistributedOptimizer(AdamW)`` and 5
   steps of ``make_train_step`` on one seeded batch: the loss must be finite
   and fall, and both flash launch counters must have moved; then one more
   step under ``torch.profiler`` for the device time by kernel family and
   the device's busy share (host time there includes the profiler's own
   cost);
7. the sequence-parallel slice: ``init()`` over NCCL, ``build_mesh({"data":
   1, "seq": 1})``, GPT-2-small width at T 4096 with ``ring_attention`` over
   the seq group and ``remat=True``, 5 AdamW steps of ``make_sp_train_step``
   at batch 2 x 4096: the loss must be finite and fall and the ring block
   kernel must have run; then one profiled step, with the block's dense
   backward as a family of its own.

The line before the last is a JSON object with one entry per kernel; the
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
# The kernels and the plain versions both compute in f32 from the same bf16
# inputs and round O, dQ, dK and dV to bf16 once, at the end: they differ by
# at most one bf16 ulp (2^-7 of the value) plus f32 summation noise. The
# limit is two ulps and an absolute floor far below the outputs' size
# (0.05-1), so a dropped or repeated tile fails it.
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-4


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


def phase_build():
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(["flash_attention"])
    secs = time.perf_counter() - t0
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(f"[build] flash_attention built in {secs:.1f} s", flush=True)


def _attention_inputs(bh, t, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, t, d, device="cuda", generator=g).to(dtype)
            for _ in range(4)]


def phase_kernels_f32():
    """f32 with TF32 off: small shapes with every head dim and ragged
    lengths, causal and not, then the GPT-2-small shape (causal, as the
    main path runs it), all at the reference tests' tolerances."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    cases = [(bh, t, d, causal) for (bh, t, d) in ((3, 200, 32), (4, 256, 64), (2, 136, 128))
             for causal in (True, False)] + [(BATCH * H, SEQ, D, True)]
    for (bh, t, d, causal) in cases:
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


def phase_kernels_bench():
    """The GPT-2-small attention shape in bf16: parity and times."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    bh, t = BATCH * H, SEQ
    q, k, v, do = _attention_inputs(bh, t, D, torch.bfloat16, seed=0)
    scale = D ** -0.5
    o, lse = fa._launch_fwd(q, k, v, True, scale)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, True, scale)
    err_fwd = max(max_err(o, o_ref, BF16_RTOL, BF16_ATOL, "bf16 O"),
                  max_err(lse, lse_ref, 2e-4, 2e-5, "bf16 lse"))
    # The backward kernels and the plain backward take the same inputs: the
    # kernel's O and lse (a one-ulp change in O moves rowsum(dO*O) by more
    # than the bf16 limit allows in a few dQ elements).
    dq, dsum = fa._launch_bwd_dq(q, k, v, o, lse, do, True, scale)
    dk, dv = fa._launch_bwd_dkdv(q, k, v, do, lse, dsum, True, scale)
    dq_ref, dk_ref, dv_ref = fa._flash_bwd_plain(q, k, v, o, lse, do, True, scale)
    err_dq = max_err(dq, dq_ref, BF16_RTOL, BF16_ATOL, "bf16 dQ")
    err_dkdv = max(max_err(dk, dk_ref, BF16_RTOL, BF16_ATOL, "bf16 dK"),
                   max_err(dv, dv_ref, BF16_RTOL, BF16_ATOL, "bf16 dV"))
    print(f"[kernels] bf16 bh={bh} t={t} d={D} causal: max abs err O/lse "
          f"{err_fwd:.2e}, dQ {err_dq:.2e}, dK/dV {err_dkdv:.2e}", flush=True)

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


def phase_block_f32():
    """B2 in f32 with TF32 off at the small shapes (ragged lengths
    included), causal and not, at delta -T, 0, +T/2 (cutting through tiles)
    and +T (no key visible)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    for (bh, t, d) in ((3, 200, 32), (4, 256, 64), (2, 136, 128)):
        q, k, v, _ = _attention_inputs(bh, t, d, torch.float32, seed=t + d + 1)
        scale = d ** -0.5
        errs = []
        for causal in (True, False):
            for delta in (-t, 0, t // 2, t):
                o, m, l = fa._launch_block_fwd(q, k, v, delta, causal, scale)
                refs = fa._flash_block_plain(q, k, v, delta, causal, scale)
                tag = f"block f32 bh={bh} t={t} d={d} causal={causal} delta={delta}"
                for name, a, b in zip(("O", "m", "l"), (o, m, l), refs):
                    errs.append(max_err(a, b, F32_RTOL, F32_ATOL, f"{tag} {name}"))
                if causal and delta >= t:
                    check(bool((m == -1e30).all() and (l == 0).all() and (o == 0).all()),
                          f"{tag}: a block with no visible key must give m = -1e30, "
                          f"l = 0, O = 0 exactly")
        print(f"[block] f32 bh={bh} t={t} d={d}, causal and not, delta -T/0/+T/2/+T: "
              f"max abs err {max(errs):.2e}; delta >= T exact", flush=True)


def phase_block_bench():
    """B2 in bf16 at the long-context slice's shape: parity at delta 0 (the
    one-rank ring's only block) and -T (a block from an earlier rank: every
    key visible), the times, and the block's dense backward."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    bh, t = SP_BATCH * H, SP_SEQ
    q, k, v, _ = _attention_inputs(bh, t, D, torch.bfloat16, seed=4)
    scale = D ** -0.5
    rows = {}
    for delta in (0, -t):
        o, m, l = fa._launch_block_fwd(q, k, v, delta, True, scale)
        o_ref, m_ref, l_ref = fa._flash_block_plain(q, k, v, delta, True, scale)
        # O is unnormalised: a sum of l ~ 1e2 terms p v at T 4096, whose f32
        # rounding grows with l. The f32 forward tolerance holds O / l (the
        # attention output it scales), with the reference's l for both.
        l_div = torch.where(l_ref == 0, 1.0, l_ref)[..., None]
        err = max(max_err(o / l_div, o_ref / l_div, F32_RTOL, F32_ATOL,
                          f"block bf16 delta={delta} O / l"),
                  max_err(m, m_ref, F32_RTOL, F32_ATOL, f"block bf16 delta={delta} m"),
                  max_err(l, l_ref, F32_RTOL, F32_ATOL, f"block bf16 delta={delta} l"))
        ms = time_ms(lambda: fa._launch_block_fwd(q, k, v, delta, True, scale), reps=10)
        plain = time_ms(lambda: fa._flash_block_plain(q, k, v, delta, True, scale),
                        reps=2, warmup=1)
        visible = bh * (t * (t + 1) / 2 if delta == 0 else t * t)
        b = bound(2 * 3 * bh * t * D + 4 * bh * t * D + 4 * 2 * bh * t, 4 * D * visible)
        rows[delta] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound=b)
        print(f"[block] bf16 bh={bh} t={t} d={D} causal delta={delta}: max abs err "
              f"{err:.2e}; ms {ms:.4f} (plain {plain:.4f}, bound {b[0]:.4f} by {b[1]}, "
              f"{ms / b[0]:.1f}x)", flush=True)

    # The block's backward is the reference's: a dense recompute of
    # (O, m, l), differentiated by autograd (PyTorch ops, not a kernel).
    o, m, l = fa._launch_block_fwd(q, k, v, 0, True, scale)
    g = torch.Generator(device="cuda").manual_seed(5)
    cts = [torch.randn(x.shape, device="cuda", generator=g) for x in (o, m, l)]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def dense_bwd():
        out = fa._dense_block(qg, kg, vg, 0, scale, True)
        return torch.autograd.grad(out, (qg, kg, vg), cts)

    torch.cuda.reset_peak_memory_stats()
    bwd_ms = time_ms(dense_bwd, reps=3, warmup=1)
    print(f"[block] dense block backward (PyTorch) at bh={bh} t={t} d={D}: {bwd_ms:.4f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return rows[0]


def phase_ring_merge():
    """One card plays a 4-rank ring: each sequence piece of a bf16
    GPT-2-small attention input at T 4096 merges its 4 B2 blocks in the
    order ring rank r sees them (source (r - s) mod 4 at step s), and the
    whole must match B1's forward over the full sequence."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // GPT2_SMALL["n_heads"]
    bh, t, n = SP_BATCH * H, SP_SEQ, 4
    tl = t // n
    q, k, v, _ = _attention_inputs(bh, t, D, torch.bfloat16, seed=6)
    scale = D ** -0.5
    full, _ = fa._launch_fwd(q, k, v, True, scale)
    piece = lambda x, i: x[:, i * tl:(i + 1) * tl].contiguous()
    outs = []
    for r in range(n):
        m = torch.full((bh, tl), -1e30, device="cuda")
        l = torch.zeros(bh, tl, device="cuda")
        o = torch.zeros(bh, tl, D, device="cuda")
        for s in range(n):
            src = (r - s) % n
            o_s, m_s, l_s = fa._launch_block_fwd(piece(q, r), piece(k, src), piece(v, src),
                                                 (src - r) * tl, True, scale)
            m_new = torch.maximum(m, m_s)
            c, c_s = torch.exp(m - m_new), torch.exp(m_s - m_new)
            o = o * c[..., None] + o_s * c_s[..., None]
            l = l * c + l_s * c_s
            m = m_new
        outs.append((o / torch.where(l == 0, 1.0, l)[..., None]).to(torch.bfloat16))
    err = max_err(torch.cat(outs, dim=1), full, BF16_RTOL, BF16_ATOL, "ring merge vs B1")
    print(f"[ring] 4 pieces x 4 blocks merged on one card vs B1 over T {t} "
          f"(bh={bh}, d={D}, causal, bf16): max abs err {err:.2e}", flush=True)


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
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = fa.BLOCK_LAUNCHES = 0
        losses, times = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(model, tokens, labels)))
            times.append(time.perf_counter() - t0)
        launches = {"block": fa.BLOCK_LAUNCHES, "fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
        print(f"[sp] GPT-2-small, ring attention on a data 1 x seq 1 mesh, remat, batch "
              f"{SP_BATCH} x {SP_SEQ} tokens: losses {losses}", flush=True)
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(launches["block"] > 0, f"ring block launches {launches}")
        per_step = launches["block"] / STEPS
        med = statistics.median(times[1:])
        print(f"[sp] step ms median {med * 1e3:.2f} (steps 2-{STEPS}; first "
              f"{times[0] * 1e3:.1f}), tokens/s {SP_BATCH * SP_SEQ / med:.0f}, launches "
              f"{launches} ({per_step:g} block launches a step; expected 24: 12 forward "
              f"+ 12 recomputed under remat), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        profile_step(lambda: float(step(model, tokens, labels)),
                     span="flash_block_backward")
        return launches
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
        fam = ("flash" if "flash_" in name     # the port's kernels: no SDPA in the step
               else span if any(a <= start < b for a, b in ranges)
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

    phase_card()
    phase_build()
    phase_kernels_f32()
    rows = phase_kernels_bench()
    phase_block_f32()
    rows["flash_block_fwd"] = dict(
        phase_block_bench(), replaces=f"{REPLACED}:369",
        # No PyTorch call returns the unnormalised O with the row max and
        # sum; scaled_dot_product_attention normalises.
        library_ms=None)
    phase_ring_merge()
    phase_small_model()
    launches = phase_train()
    sp_launches = phase_sp_train()
    counts = {"flash_fwd": launches["fwd"], "flash_bwd_dq": launches["bwd"],
              "flash_bwd_dkdv": launches["bwd"], "flash_block_fwd": sp_launches["block"]}
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": r["replaces"], "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
