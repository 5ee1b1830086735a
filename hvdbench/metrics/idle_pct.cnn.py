"""Share of the traced steps' wall in which no device operation runs (the
union of the device intervals from ``torch.profiler``), the mean over ranks."""

from hvdbench.metrics._shared import idle_pct


def read(ctx):
    return idle_pct(ctx, "image")
