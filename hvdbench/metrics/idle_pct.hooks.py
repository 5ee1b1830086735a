"""``idle_pct.lm`` of the hook-driven cell, the mean of each rank's own
trace; it moves ``tokens_per_s.hooks``."""

from hvdbench.metrics._shared import idle_pct


def read(ctx):
    return idle_pct(ctx, "token")
