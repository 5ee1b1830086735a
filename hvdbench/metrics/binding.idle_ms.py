"""Device-idle ms a step under the hook-driven binding's own ranges:
``hvd.enqueue`` (a gradient hook's compress and enqueue), ``hvd.sync``
(``DistributedOptimizer.synchronize`` outside its inner ranges) and
``hvd.sync.copyback`` (the loop that takes each reduced gradient and
writes it into ``p.grad``), the ranks' mean.

The gaps are ``trace.reduce``'s, labelled by the innermost host operation
open at a gap's start on any thread the profiler records. A gap that opens
inside an ``aten::`` operation within these ranges (the write-back's
``aten::copy_``) or inside the core's ``hvd.sync.wait`` counts under that
name, so this is a lower bound. None where no rank's gaps hold one of
these labels (a program without the ranges).
"""

from hvdbench.metrics._shared import traces

LABELS = ("hvd.enqueue", "hvd.sync", "hvd.sync.copyback")


def read(ctx):
    found = traces(ctx)
    if not any(label in LABELS for t in found for label in t["gaps"]):
        return None
    return sum(1e3 * sum(s for label, s in t["gaps"].items() if label in LABELS) / t["steps"]
               for t in found) / len(found)
