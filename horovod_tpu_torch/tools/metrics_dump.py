"""Pretty-print or diff metrics snapshots of horovod_tpu_torch (or of the
JAX package: the snapshot and exposition formats are the same).

The port's copy of ``tools/metrics_dump.py``.

Sources (auto-detected per argument):

- a JSON file holding ``hvd.metrics_snapshot()`` output
  (``json.dump(hvd.metrics_snapshot(), f)``);
- an ``http://host:port/metrics`` URL — scraped and parsed from the
  Prometheus text exposition the driver serves.

Usage::

    python -m horovod_tpu_torch.tools.metrics_dump SNAP         # pretty-print
    python -m horovod_tpu_torch.tools.metrics_dump SNAP1 SNAP2  # diff (2 - 1)

Counters/gauges print one line per series; histograms print count, sum,
and mean. Diffs subtract counter/histogram totals (new series appear with
their full value) and show gauges as ``old -> new``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

from ..metrics import export as _export

# Canonical flat form: (name, labelstr) -> (type, value, sum_or_None)
Flat = Dict[Tuple[str, str], Tuple[str, float, float]]


def _labelstr(labels: Dict[str, str]) -> str:
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


def load(source: str) -> Flat:
    if source.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(source, timeout=10) as resp:
            text = resp.read().decode()
        return _from_exposition(_export.parse_prometheus(text))
    with open(source) as f:
        return _from_snapshot(json.load(f))


def _from_snapshot(snap: Dict[str, dict]) -> Flat:
    flat: Flat = {}
    for name, metric in snap.items():
        mtype = metric.get("type", "untyped")
        for s in metric.get("series", []):
            key = (name, _labelstr(s.get("labels", {})))
            if mtype == "histogram":
                flat[key] = (mtype, float(s.get("count", 0)),
                             float(s.get("sum", 0.0)))
            else:
                flat[key] = (mtype, float(s.get("value", 0.0)), 0.0)
    return flat


def _from_exposition(parsed: Dict[str, dict]) -> Flat:
    flat: Flat = {}
    for name, metric in parsed.items():
        mtype = metric.get("type", "untyped")
        if mtype == "histogram":
            counts: Dict[str, float] = {}
            sums: Dict[str, float] = {}
            for sample, labels, value in metric["samples"]:
                lab = _labelstr(
                    {k: v for k, v in labels.items() if k != "le"}
                )
                if sample.endswith("_count"):
                    counts[lab] = value
                elif sample.endswith("_sum"):
                    sums[lab] = value
            for lab, c in counts.items():
                flat[(name, lab)] = (mtype, c, sums.get(lab, 0.0))
        else:
            for _, labels, value in metric["samples"]:
                flat[(name, _labelstr(labels))] = (mtype, value, 0.0)
    return flat


def _fmt_val(v: float) -> str:
    return str(int(v)) if v == int(v) else f"{v:.6g}"


def dump(flat: Flat) -> None:
    width = max((len(f"{n}{{{l}}}") for n, l in flat), default=0)
    for (name, lab) in sorted(flat):
        mtype, value, hsum = flat[(name, lab)]
        series = f"{name}{{{lab}}}" if lab else name
        if mtype == "histogram":
            mean = hsum / value if value else 0.0
            print(f"{series:<{width}}  count={_fmt_val(value)} "
                  f"sum={hsum:.6g} mean={mean:.6g}")
        else:
            print(f"{series:<{width}}  {_fmt_val(value)}")


def diff(a: Flat, b: Flat) -> int:
    changed = 0
    for key in sorted(set(a) | set(b)):
        name, lab = key
        mtype = (b.get(key) or a.get(key))[0]
        va = a.get(key, (mtype, 0.0, 0.0))
        vb = b.get(key, (mtype, 0.0, 0.0))
        series = f"{name}{{{lab}}}" if lab else name
        if mtype == "gauge":
            if va[1] != vb[1]:
                changed += 1
                print(f"{series}  {_fmt_val(va[1])} -> {_fmt_val(vb[1])}")
        elif mtype == "histogram":
            dc, ds = vb[1] - va[1], vb[2] - va[2]
            if dc:
                changed += 1
                print(f"{series}  +count={_fmt_val(dc)} +sum={ds:.6g} "
                      f"mean={ds / dc:.6g}")
        else:
            d = vb[1] - va[1]
            if d:
                changed += 1
                print(f"{series}  {'+' if d > 0 else ''}{_fmt_val(d)}")
    if not changed:
        print("(no differences)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Pretty-print or diff metrics snapshots "
                    "(JSON files or /metrics URLs)."
    )
    ap.add_argument("snapshot", help="snapshot JSON file or /metrics URL")
    ap.add_argument("snapshot2", nargs="?", default=None,
                    help="second snapshot: print the delta (2 - 1)")
    args = ap.parse_args(argv)
    a = load(args.snapshot)
    if args.snapshot2 is None:
        dump(a)
        return 0
    return diff(a, load(args.snapshot2))


if __name__ == "__main__":
    sys.exit(main())
