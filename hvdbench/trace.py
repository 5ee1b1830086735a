"""The reduction of a ``torch.profiler`` trace of a few steady steps to
what the per-layer metrics read: the traced window, the time some device
operation ran (the union of their intervals), the NCCL time and the part
of it no other device operation overlapped, the device time by operation
name, and the longest idle gaps by what the host was doing.

Each step runs inside a ``record_function("hvdbench.step")`` range; the
window runs from the first step's start on the host to the later of the
last step's end and the last device operation's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

STEP = "hvdbench.step"
TOP = 10
LABELLED = 5000


def profile_steps(fn: Callable, steps: int, sync: Callable):
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(STEP):
                fn()
        sync()
    return prof


def merged(spans: List[Tuple[float, float]]) -> List[List[float]]:
    """The union of ``spans`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def exposed(nccl: List[Tuple[float, float]], other: List[Tuple[float, float]]) -> float:
    """The time in ``nccl``'s union that no interval of ``other`` covers
    (the arithmetic of ``tools/dp_parity._exposed_ms``)."""
    busy = merged(other)
    covered = 0.0
    for a, b in merged(nccl):
        covered += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    return sum(b - a for a, b in merged(nccl)) - covered


def reduce(device_ops: List[Tuple[float, float, str]], host_ops: List[Tuple[float, float, str]],
           steps: int) -> dict:
    """The reduction of one rank's trace; times in seconds, on any one clock."""
    starts = [a for a, _, n in host_ops if n == STEP]
    if not starts or not device_ops:
        return {}
    t0 = min(starts)
    t1 = max(max(b for _, b, n in host_ops if n == STEP), max(b for _, b, _ in device_ops))
    ops = [(max(a, t0), min(b, t1), n) for a, b, n in device_ops if b > t0 and a < t1]
    busy_spans = merged([(a, b) for a, b, _ in ops])
    busy = sum(b - a for a, b in busy_spans)
    nccl = [(a, b) for a, b, n in ops if "nccl" in n.lower()]
    other = [(a, b) for a, b, n in ops if "nccl" not in n.lower()]
    by_name: Dict[str, float] = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    return {"steps": steps, "window_s": t1 - t0, "busy_s": busy,
            "nccl_s": sum(b - a for a, b in nccl), "exposed_nccl_s": exposed(nccl, other),
            "ops": by_name, "gaps": _gaps(busy_spans, t0, t1, host_ops)}


def _gaps(busy: List[List[float]], t0: float, t1: float, host_ops) -> Dict[str, float]:
    """Idle time by the innermost host operation under each gap's start,
    for the :data:`LABELLED` longest gaps (the rest are summed under their
    own label)."""
    edges = [t0] + [x for span in busy for x in span] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    hs = np.array([a for a, _, n in host_ops if n != STEP])
    he = np.array([b for _, b, n in host_ops if n != STEP])
    names = [n for _, _, n in host_ops if n != STEP]
    out: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        label = "shorter gaps"
        if i < LABELLED:
            label = "host outside any traced op"
            if len(names):
                under = np.nonzero((hs <= a) & (he >= a))[0]
                if len(under):
                    label = names[under[np.argmin(he[under] - hs[under])]]
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def from_profiler(prof, steps: int) -> dict:
    """:func:`reduce` over a finished ``torch.profiler`` session."""
    device_ops, host_ops = [], []
    for e in prof.events():
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                device_ops.append(span)
        else:
            host_ops.append(span)
    return reduce(device_ops, host_ops, steps)


def top(table: Dict[str, float], n: int = TOP) -> List[list]:
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def mean_tables(tables: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for t in tables:
        for k, v in t.items():
            out[k] = out.get(k, 0.0) + v / len(tables)
    return out
