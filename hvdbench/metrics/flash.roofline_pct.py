"""Attention's least time over the device time of the kernels that
implement it, in %.

The least time is counted from the shapes, whatever implements attention:
for each layer, the causal forward (QKᵀ and PV) and its backward (S again,
dV = PᵀdO, dP = dO Vᵀ, dQ = dS K, dK = dSᵀ Q), each bounded by the larger
of its FLOPs over the bf16 peak and its bytes over HBM's bandwidth, with
every input read once and every output written once. The kernels are those
whose names match :data:`PATTERNS`: the port's B1 kernels (forward, dQ,
dK/dV) and PyTorch's SDPA flash and memory-efficient kernels.
"""

import re

from hvdbench import peaks
from hvdbench.metrics._shared import traces

PATTERNS = (r"flash_fwd", r"flash_bwd", r"flash_block", r"pytorch_flash", r"fmha",
            r"efficient_attention", r"cutlassF", r"cutlassB", r"attention_kernel")
_MATCH = re.compile("|".join(PATTERNS))


def attention_work(B: int, T: int, H: int, D: int, elem: int = 2):
    """((forward FLOPs, bytes), (backward FLOPs, bytes)) of one layer's
    causal attention: 2 and 5 products of 2·B·H·T²·D, halved by the mask;
    forward reads q, k, v and writes o and the f32 row statistic; the
    backward reads q, k, v, o, dO and the statistic and writes dq, dk, dv."""
    product = 2 * B * H * T * T * D // 2
    tensor = B * T * H * D * elem
    rows = B * H * T * 4
    return ((2 * product, 4 * tensor + rows), (5 * product, 8 * tensor + rows))


def least_seconds(B: int, T: int, H: int, D: int) -> float:
    return sum(max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
               for flops, nbytes in attention_work(B, T, H, D))


def read(ctx):
    shape = getattr(ctx["family"], "attention_shape", None)
    found = traces(ctx)
    if shape is None or not found:
        return None
    layers, B, T, H, D = shape(ctx["config"], ctx["traffic"])
    bound = least_seconds(B, T, H, D) * layers
    shares = []
    for t in found:
        spent = sum(s for name, s in t["ops"].items() if _MATCH.search(name)) / t["steps"]
        if spent > 0:
            shares.append(100.0 * bound / spent)
    return sum(shares) / len(shares) if shares else None
