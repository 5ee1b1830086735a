"""What several per-layer readers share: the traces of the ranks that have
one, and a step's model FLOPs as a share of the cards' bf16 peak."""

from hvdbench import peaks


def traces(ctx):
    return [r["trace"] for r in ctx["ranks"] if r.get("trace")]


def mfu_pct(ctx, item: str):
    """Model FLOPs over the window ÷ (cards × the dense bf16 peak), in %."""
    if ctx["item"] != item:
        return None
    flops = (ctx["family"].train_flops_per_item(ctx["config"], ctx["traffic"])
             * ctx["items_per_step"] * ctx["steps"])
    return 100.0 * flops / ctx["window_s"] / (ctx["world"] * peaks.BF16_FLOPS)


def idle_pct(ctx, item: str):
    """The traced steps' wall in which no device operation ran, in %, the
    mean of each rank's own trace."""
    found = traces(ctx)
    if ctx["item"] != item or not found:
        return None
    return sum(100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"] for t in found) / len(found)
