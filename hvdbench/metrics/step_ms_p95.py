"""The 95th percentile of every step's time in the window, from CUDA events
recorded on rank 0's compute stream at the step boundaries. A per-layer
metric of the hook-driven cell: its runs on the card spread by 10-17%
(quartiles over the median), which would need a bound over 0.25."""

import statistics


def read(ctx):
    times = ctx.get("step_ms")
    if not times or len(times) < 20:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
