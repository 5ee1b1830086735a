"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's, reduced to three numbers, each held
to its limit from ``limits/<workload>.json``.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: the worst leaf's gap between the two norms of the first
  gradient, over the larger of that leaf's reference norm and the median
  leaf's.
- ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out the parameters whose reference first gradient is above zero
  but under a thousandth of the median leaf's (they move by round-off
  alone under Adam); a leaf with no first gradient at all moves by its
  later gradients and counts, as buffers do.
- ``median_change_gap``: the median of those leaves' gaps of change, where
  the worst leaf's is steady across precisions: a leaf whose gradient sums
  a huge batch averages rounding away, and the worst leaf is then one that
  any precision leaves about as far off.

A cell's limits file names the numbers it holds; the others are reported
on standard error only.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Tuple

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "median_change_gap")
QUIET = 1e-3


def _each(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    scale = statistics.median([ref[n] for n in names if ref[n] > 0] or [0.0])
    out = {}
    for n in names:
        den = max(ref[n], scale)
        out[n] = abs(prog[n] - ref[n]) / den if den > 0 else abs(prog[n])
    return out


def _worst(each: Dict[str, float]) -> Tuple[float, str]:
    where = max(each, key=each.get)
    return each[where], where


def gaps(prog: dict, ref: dict) -> Tuple[Dict[str, float], dict]:
    """(the three numbers, where each was worst and what was left out)."""
    if set(prog["grad"]) != set(ref["grad"]) or set(prog["change"]) != set(ref["change"]):
        raise ValueError("the program's leaves and the reference's differ")
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the program and the reference ran different numbers of steps")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    names = sorted(ref["grad"])
    grad_gap, grad_at = _worst(_each(prog["grad"], ref["grad"], names))
    median = statistics.median([ref["grad"][n] for n in names if ref["grad"][n] > 0])
    quiet = sorted(n for n in names if 0 < ref["grad"][n] < QUIET * median)
    kept = sorted(n for n in ref["change"] if n not in quiet)
    change = _each(prog["change"], ref["change"], kept)
    change_gap, change_at = _worst(change)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
             "median_change_gap": statistics.median(change.values())},
            {"grad_worst": grad_at, "change_worst": change_at, "quiet_leaves": quiet})


def verdict(numbers: Dict[str, float], limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """(every number the cell limits within its limit, {name: {"value", "limit"}})."""
    checks = {n: {"value": numbers[n], "limit": limits[n]["limit"]} for n in NUMBERS
              if n in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def print_checks(checks: Dict[str, dict]) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for name, c in checks.items():
        mark = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {mark}", file=sys.stderr,
              flush=True)
