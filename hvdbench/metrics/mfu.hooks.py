"""``mfu.lm`` of the hook-driven cell, which moves ``tokens_per_s.hooks``."""

from hvdbench.metrics._shared import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "token")
