"""Time the collective-matmul kernel (B3/B4) at other tiles, on one GPU.

    python -m horovod_tpu_torch.tools.cm_tile_sweep [--out PATH] [--reps N]

Builds ``csrc/collective_matmul.cu`` once per candidate tile (BM rows, BN
columns, STAGES shared-memory stages: ``HVT_CM_CONFIGS`` set by a header
given to nvcc with ``-include``; one nvcc each, all started together) and
reads ptxas's registers and spills for the TMA + wgmma kernel. Then, at each
(K, N) of the fused GPT step at GPT-2-small width on 4 cards (one chunk of
batch 8 x Tc 256 rows, bf16), it checks each candidate's chunk product (B3,
bf16 out) and partial product (B4, f32 accumulator added to an arriving one)
against their plain versions (the count of elements beyond two bf16 ulps,
and beyond 2e-4 / 2e-5 of the f32 accumulator) and takes each one's device
time: the mean kernel duration ``torch.profiler`` reports over ``--reps``
launches. One JSON line per candidate and (K, N) goes to stdout (and to
``--out`` if given); the card's name and power limit head the output. The
committed choice is ``ops/collective_matmul.py``'s ``TILES``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (BM, BN, STAGES): one or two consumer warpgroups, 64-column boxes.
# Each fits the stages and the staged output tile in shared memory.
CANDIDATES = ((64, 64, 4), (64, 128, 4), (64, 128, 6), (64, 192, 3), (64, 192, 4),
              (64, 192, 5), (64, 256, 3), (64, 256, 4), (128, 64, 4), (128, 128, 3))
# (K, N) of every chunk product of the fused step at GPT-2-small, tp 4.
SHAPES = ((768, 576), (768, 768), (192, 768), (576, 768), (768, 192))
BATCH, TC = 8, 256
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-4    # two bf16 ulps, as chip_smoke.py's
F32_RTOL, F32_ATOL = 2e-4, 2e-5
KERNEL = "gemm_tma_wgmma_kernel"


def _tile_flags(tile):
    """nvcc flags that build this one tile: a header (in the build
    directory) defining HVT_CM_CONFIGS, as -D cannot carry the commas."""
    from horovod_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "cm_tile_" + "_".join(map(str, tile)) + ".h")
    with open(path, "w") as f:
        f.write(f"#define HVT_CM_CONFIGS X({', '.join(map(str, tile))})\n")
    return ("-include", path)


def device_ms(fn, reps: int, names) -> float:
    """Mean device time of one ``fn()``: the durations ``torch.profiler``
    reports for the kernels whose names contain one of ``names`` (every
    kernel for None), summed over ``reps`` calls after a warm-up, over
    ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A capture can come back without the device's activity records (an
    # H100 under torch 2.11 returned none of 50 calls' kernels while the
    # captures before and after it had them): it is taken again, up to
    # three times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (names is None or any(n in e.name for n in names))]
        if us:
            return sum(us) / 1e3 / reps
    raise RuntimeError(f"the profiler saw no kernel named {names} in three captures: "
                       f"not measured")


def _beyond(out, ref, rtol, atol):
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    return float(diff.max()), int((diff > atol + rtol * ref.abs()).sum())


def run_tile(lib, tile, k, n, reps):
    """Check and time one built tile at one (K, N)."""
    import torch
    from horovod_tpu_torch.ops import collective_matmul as cm

    g = torch.Generator(device="cuda").manual_seed(k + n)
    x = torch.randn(BATCH, TC, k, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, device="cuda", generator=g) * k ** -0.5).to(torch.bfloat16)
    acc_in = torch.randn(BATCH, TC, n, device="cuda", generator=g)
    out = torch.empty(BATCH, 4 * TC, n, dtype=torch.bfloat16, device="cuda")[:, TC:2 * TC]
    acc = torch.empty(BATCH, TC, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed with CUDA error {rc}")

    b3 = lambda: check(lib.hvt_chunk_product(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), BATCH, TC, k, n, x.stride(0), out.stride(0),
        1, *tile, stream), "chunk product")
    b4 = lambda: check(lib.hvt_partial_product(
        x.data_ptr(), w.data_ptr(), acc_in.data_ptr(), acc.data_ptr(), BATCH, TC, k, n,
        x.stride(0), 1, *tile, stream), "partial product")
    b3(), b4()
    torch.cuda.synchronize()
    ref = torch.empty_like(out)
    cm._chunk_product_plain(x, w, ref)
    errs = {"b3": _beyond(out, ref, BF16_RTOL, BF16_ATOL),
            "b4": _beyond(acc, cm._partial_product_plain(x, w, acc_in), F32_RTOL, F32_ATOL)}
    ms = {"b3": device_ms(b3, reps, (KERNEL,)), "b4": device_ms(b4, reps, (KERNEL,))}
    return {"k": k, "n": n, "rows": BATCH * TC, "device_ms": ms,
            "max_abs_err": {w_: e[0] for w_, e in errs.items()},
            "beyond_tolerance": {w_: e[1] for w_, e in errs.items()}}


def main(argv=None) -> int:
    import ctypes

    import torch
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import collective_matmul as cm

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON lines here")
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("cm_tile_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    items = [("collective_matmul", _tile_flags(t)) for t in CANDIDATES]
    reports = _build.build(items)
    rows = []
    for tile, item in zip(CANDIDATES, items):
        # The B3 and B4 instantiations: registers, spill stores and loads.
        ptxas = [[kern["registers"], kern["spill_stores"], kern["spill_loads"]]
                 for kern in _build.ptxas_kernels(reports.get(item, ""))
                 if kern["name"].startswith(KERNEL)]
        lib = cm.bind(ctypes.CDLL(_build.library_path(*item)))
        for k, n in SHAPES:
            row = {"tile": list(tile), "card": card, **run_tile(lib, tile, k, n, args.reps),
                   "ptxas": ptxas}
            rows.append(json.dumps(row))
            print(rows[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as out:
            out.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
