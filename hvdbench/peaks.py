"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W), which the shares of a peak and the
rooflines divide by."""

BF16_FLOPS = 989e12        # FLOP/s, bfloat16 and float16 on the tensor cores
HBM_BYTES = 3.35e12        # bytes/s
