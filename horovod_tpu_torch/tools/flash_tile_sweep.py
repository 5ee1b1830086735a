"""Time B1's bf16 tensor-core kernels at other tile sizes, on one GPU.

    python -m horovod_tpu_torch.tools.flash_tile_sweep [--out PATH] [--reps N]

Builds ``csrc/flash_attention.cu`` once per tile set (``HVT_TILES_<D>``
set by a header given to nvcc with ``-include``; one nvcc each, all started
together) and reads ptxas's
registers and spills for the three tensor-core kernels. Then, at each head
dim D in 32, 64 and 128, on causal bf16 inputs of GPT-2-small's width
(d_model 768 = H x D, batch 8 x 1024, so BH = 8 x 768 / D), it checks each
variant's forward and backward against the plain versions that round P and
dS as the kernels do (the count of elements beyond two bf16 ulps; the
midpoint-aware gate is chip_smoke.py's) and times the forward, dQ and dK/dV
kernels with CUDA events. A tile set is (the forward's m16 row groups a
warp, its K-tile rows, the dQ kernel's K-tile rows, the dK/dV kernel's
Q-tile rows). One JSON line per tile set and head dim goes to stdout (and
to ``--out`` if given); the card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Each tile set is built for all three head dims at once.
TILE_SETS = ((1, 32, 32, 32), (1, 64, 64, 64), (1, 128, 128, 16), (2, 32, 32, 32),
             (2, 64, 64, 64))
HEAD_DIMS = (32, 64, 128)
BATCH, SEQ, D_MODEL = 8, 1024, 768
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-4    # two bf16 ulps, as chip_smoke.py's gate (a)
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel")


def _tile_flags(tiles):
    """nvcc flags that build every head dim with this tile set: a header
    (in the build directory) defining HVT_TILES_<D>, as -D cannot carry the
    commas."""
    from horovod_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "tiles_" + "_".join(map(str, tiles)) + ".h")
    with open(path, "w") as f:
        for d in HEAD_DIMS:
            f.write(f"#define HVT_TILES_{d} {', '.join(map(str, tiles))}\n")
    return ("-include", path)


def _time_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _err(out, ref):
    """Max abs error, and the count of elements beyond two bf16 ulps."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    return float(diff.max()), int((diff > BF16_ATOL + BF16_RTOL * ref.abs()).sum())


def run_variant(lib, d, reps):
    """Check and time one built tile set at head dim d."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    bh, t, bf = BATCH * D_MODEL // d, SEQ, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(bf) for _ in range(4))
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse, dsum = (torch.empty(bh, t, device="cuda") for _ in range(2))
    scale, stream = d ** -0.5, torch.cuda.current_stream().cuda_stream
    dims = (bh, t, t, d, 1, scale, 1, stream)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed with CUDA error {rc}")

    fwd = lambda: check(lib.hvt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          lse.data_ptr(), *dims), "forward")
    bwd_dq = lambda: check(lib.hvt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dsum.data_ptr(), *dims), "dQ")
    bwd_dkdv = lambda: check(lib.hvt_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims), "dK/dV")
    fwd(), bwd_dq(), bwd_dkdv()
    torch.cuda.synchronize()
    tiles = fa.kernel_tiles(d, lib)
    o_ref, _ = fa._flash_fwd_plain(q, k, v, True, scale, block_k=tiles["fwd"][1],
                                   p_dtype=bf)
    refs = fa._flash_bwd_plain(q, k, v, o, lse, do, True, scale, p_dtype=bf)
    errs = {name: _err(out, ref) for name, out, ref in
            zip(("O", "dQ", "dK", "dV"), (o, dq, dk, dv), (o_ref, *refs))}
    ms = {"fwd": _time_ms(fwd, reps), "dq": _time_ms(bwd_dq, reps),
          "dkdv": _time_ms(bwd_dkdv, reps)}
    return {"d": d, "bh": bh, "t": t, "tiles": tiles, "ms": ms,
            "max_abs_err": {n: e[0] for n, e in errs.items()},
            "beyond_two_ulps": {n: e[1] for n, e in errs.items()}}


def main(argv=None) -> int:
    import ctypes

    import torch
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON lines here")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_tile_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    items = [("flash_attention", _tile_flags(ts)) for ts in TILE_SETS]
    reports = _build.build(items)
    rows = []
    for ts, item in zip(TILE_SETS, items):
        kernels = [kern for kern in _build.ptxas_kernels(reports.get(item, ""))
                   if kern["name"].split("<")[0] in MMA_KERNELS]
        lib = fa.bind(ctypes.CDLL(_build.library_path(*item)))
        for d in HEAD_DIMS:
            row = {"tile_set": list(ts), "card": card, **run_variant(lib, d, args.reps),
                   "ptxas": {kern["name"]: [kern["registers"], kern["spill_stores"],
                                            kern["spill_loads"]]
                             for kern in kernels if f"<{d}," in kern["name"]}}
            rows.append(json.dumps(row))
            print(rows[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as out:
            out.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
