"""Host ms a step inside the hook-driven optimizer's ``synchronize()``
(called by ``step()``), wrapped from the benchmark as
``tools/binding_parity --bench`` wraps it, over the window on rank 0."""


def read(ctx):
    spans = ctx["ranks"][0].get("spans", {})
    if "synchronize_s" not in spans:
        return None
    return 1e3 * spans["synchronize_s"] / ctx["steps"]
