"""Fused plans the native core executed a step on rank 0: the program's
counter ``hvd_plans_total`` over the window, with ``HOROVOD_METRICS`` on,
over the window's steps."""


def read(ctx):
    counters = ctx["ranks"][0].get("counters", {})
    if "plans" not in counters or not counters["plans"]:
        return None
    return counters["plans"] / ctx["steps"]
