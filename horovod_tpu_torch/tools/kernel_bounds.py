"""Bounds of the collective-matmul kernels still to port, B3 and B4.

    python -m horovod_tpu_torch.tools.kernel_bounds

The TPU kernels ``_ag_matmul_tpu`` (B3, ``all_gather(x) @ w``) and
``_mrs_tpu`` (B4, ``reduce_scatter(y @ w)``) in
``horovod_tpu/ops/collective_matmul.py`` run on the fused DP×TP path of the
GPT (``tp_apply`` with ``tp_overlap``): per layer, B3 for q/k/v (one
product over the concatenated kernels) and the MLP up-projection, B4 for
the attention output and the MLP down-projection. For each call at
GPT-2-small width (d_model 768, MLP 3072), with the main path's 8192
tokens per data-parallel replica (batch 8 x 1024) split over tp = 4 cards,
this prints one JSON line: the least time
one H100 could take, computed from shapes alone: the larger of the bytes
(each input read once, each output written once, bf16; the gathered x for
B3) over 3.35 TB/s and the FLOPs over 989 TFLOP/s, and beside it the time
the bytes arriving from the other cards need at NVLink's 450 GB/s into a
card (B3: the other cards' bf16 x chunks; B4: their f32 partial sums, as
the TPU kernel's accumulator rides the ring in f32).
"""

from __future__ import annotations

import json

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
NVLINK_IN_BYTES_PER_S = 450e9
D_MODEL, D_MLP = 768, 3072
TP, TOKENS = 4, 8192


def bounds(tp: int, tokens: int):
    t_local = tokens // tp
    rows = []
    # (name, kernel, in features, out features): local weight shards.
    for name, kernel, fin, fout in (
        ("qkv", "B3", D_MODEL, 3 * D_MODEL // tp),
        ("mlp_up", "B3", D_MODEL, D_MLP // tp),
        ("attn_out", "B4", D_MODEL // tp, D_MODEL),
        ("mlp_down", "B4", D_MLP // tp, D_MODEL),
    ):
        flops = 2 * tokens * fin * fout
        w_bytes = 2 * fin * fout
        if kernel == "B3":   # x [t_local, fin] gathered to [tokens, fin]; out [tokens, fout]
            nbytes = 2 * tokens * fin + w_bytes + 2 * tokens * fout
            wire = 2 * (tokens - t_local) * fin
        else:                # y [tokens, fin]; out [t_local, fout]
            nbytes = 2 * tokens * fin + w_bytes + 2 * t_local * fout
            wire = 4 * (tp - 1) * t_local * fout
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        rows.append({
            "call": name, "kernel": kernel, "flops": flops, "bytes": nbytes,
            "bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations",
            "nvlink_in_bytes": wire, "nvlink_ms": wire / NVLINK_IN_BYTES_PER_S * 1e3,
        })
    return rows


def main() -> int:
    for row in bounds(TP, TOKENS):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
