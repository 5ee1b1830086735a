"""The whole step's share of the chips' peak: model FLOPs over the window
(the family's count: ``train_flops_per_item``) ÷ (cards × 989 TFLOP/s)."""

from hvdbench.metrics._shared import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "token")
