"""NCCL kernel time a step that no other device operation overlaps, the
mean over ranks (``trace.exposed``, the arithmetic of
``tools/dp_parity._exposed_ms``)."""

from hvdbench.metrics._shared import traces


def read(ctx):
    found = [t for t in traces(ctx) if t["nccl_s"] > 0]
    if not found:
        return None
    return sum(1e3 * t["exposed_nccl_s"] / t["steps"] for t in found) / len(found)
