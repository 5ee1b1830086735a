"""Device time of one step by kernel family, from ``torch.profiler``.

Only the card's kernels count (the profiler's CPU-side operator events
carry the device time of the kernels they launch, so summing every event
counts each kernel twice). A kernel that starts inside a device range of a
``record_function`` named in ``spans`` counts to that span; the others to
``classify`` of their lower-case name.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence


def profile_step(run_step: Callable[[], object], classify: Callable[[str], str],
                 spans: Sequence[str] = ()) -> Dict[str, object]:
    """Run ``run_step`` once under the profiler. Returns ``host_ms``,
    ``device_busy_ms`` (the union of the kernels' intervals), ``kernels``
    and ``family_ms``; without device activity, ``device`` says it was not
    measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        host_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not e.is_user_annotation]
    if not kernels:
        return {"host_ms": host_ms, "device": "not measured: the profiler saw no device activity"}
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in device
              if e.is_user_annotation and e.name in spans]
    families: Dict[str, float] = dict.fromkeys(spans, 0.0)
    for e in kernels:
        start = e.time_range.start
        fam = next((name for name, a, b in ranges if a <= start < b), None) \
            or classify(e.name.lower())
        families[fam] = families.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (cur_s, cur_e) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    return {"host_ms": host_ms, "device_busy_ms": busy, "kernels": len(kernels),
            "family_ms": families}
