"""Fleet trace merge: rank windows + driver events → one Chrome trace.

The port's copy of ``horovod_tpu/trace/merge.py``, the rendering half
of ``python -m horovod_tpu_torch.tools.trace_merge`` (importable so the tests
and the trace smoke drive it in-process). Input is the directory the
elastic driver collects into (``<output-dir>/trace/`` by default):

- ``rank.<r>.json``   — per-rank span windows (``TraceTap.window()``
  shape, persisted by ``ElasticDriver._trace_collect``);
- ``driver.json``     — the driver's own window (elastic/HA events);
- ``flight.rank<r>.json`` — flight-recorder dumps (``--postmortem``);
- ``postmortem.json`` — the driver-collected dump bundle.

Output is Chrome-tracing / Perfetto JSON: one process lane per rank
(pid = rank), the driver on its own high-pid lane, per-lane
``hvd_clock_offset`` metadata (the RTT/2 estimate is recorded, never
applied — timestamps stay raw wall clock), fault event-log lines as
instant markers, and — in postmortem mode — a ``DEATH:<reason>`` marker
per dumped rank so "the last N seconds before death, all ranks,
aligned" reads off one screen.

Determinism: given the same inputs the output bytes are identical
(events sorted on a total key, ``sort_keys`` JSON) — the property
the tests lock across two runs and against the JAX package's merge.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# The driver's lane must sort after every plausible rank pid.
DRIVER_PID = 1_000_000

# Stable per-category virtual thread ids inside a rank's lane.
TID_STEPS = 0
TID_EVENTS = 1
TID_EVENT_LOG = 2
# Timeline-mirrored records keep their per-tensor tid, offset into their
# own band so they never collide with the bands above.
TID_TIMELINE_BASE = 10


def load_chrome_trace(path: str) -> List[dict]:
    """Load a catapult JSON array, tolerating the unterminated form both
    timeline writers leave behind on crash (reference behavior: partial
    traces must still load)."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        repaired = text.rstrip().rstrip(",")
        if not repaired.endswith("]"):
            repaired += "\n]"
        return json.loads(repaired)


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def read_dir(directory: str) -> Tuple[Dict[int, dict], Optional[dict]]:
    """Read the driver-collected rank windows (+ the driver's own) from
    a trace directory."""
    ranks: Dict[int, dict] = {}
    driver = None
    for fn in sorted(os.listdir(directory)):
        m = re.fullmatch(r"rank\.(\d+)\.json", fn)
        if m:
            doc = _load_json(os.path.join(directory, fn))
            if doc is not None:
                ranks[int(m.group(1))] = doc
        elif fn == "driver.json":
            driver = _load_json(os.path.join(directory, fn))
    return ranks, driver


def read_flight_dumps(directory: str) -> Dict[int, dict]:
    """Read flight-recorder dumps — the driver-collected
    ``postmortem.json`` bundle when present, else the raw per-rank dump
    files the workers wrote."""
    bundle = _load_json(os.path.join(directory, "postmortem.json"))
    dumps: Dict[int, dict] = {}
    if bundle and isinstance(bundle.get("dumps"), list):
        for doc in bundle["dumps"]:
            if isinstance(doc, dict) and "rank" in doc:
                dumps[int(doc["rank"])] = doc
        return dumps
    for fn in sorted(os.listdir(directory)):
        m = re.fullmatch(r"flight\.rank(\d+)\.json", fn)
        if m:
            doc = _load_json(os.path.join(directory, fn))
            if doc is not None:
                dumps[int(m.group(1))] = doc
    return dumps


def _lane_meta(pid: int, label: str) -> List[dict]:
    return [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": label},
    }]


def _thread_meta(pid: int) -> List[dict]:
    return [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": TID_STEPS,
         "args": {"name": "steps"}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": TID_EVENTS,
         "args": {"name": "events"}},
        {"name": "thread_name", "ph": "M", "pid": pid,
         "tid": TID_EVENT_LOG, "args": {"name": "event_log"}},
    ]


def _emit_window(doc: dict, pid: int, base_ts: float,
                 label: str) -> List[dict]:
    out = _lane_meta(pid, label) + _thread_meta(pid)
    clock = doc.get("clock") or {}
    out.append({
        "name": "hvd_clock_offset", "ph": "M", "pid": pid, "tid": 0,
        "args": {
            "offset_s": clock.get("offset_s", 0.0),
            "rtt_s": clock.get("rtt_s", 0.0),
            "estimated": bool(clock.get("estimated", False)),
            "note": "recorded, not applied; timestamps are raw wall clock",
        },
    })

    def us(ts: float) -> float:
        return round((float(ts) - base_ts) * 1e6, 1)

    for ev in doc.get("events") or []:
        ph = ev.get("ph", "i")
        cat = ev.get("cat", "event")
        if ph == "M" and cat != "timeline":
            # Non-timeline metadata already rendered (clock) or carries
            # no timestamp worth a lane slot.
            continue
        if cat == "step":
            tid = TID_STEPS
        elif cat == "timeline":
            tid = TID_TIMELINE_BASE + int(ev.get("tid", 0) or 0)
        else:
            tid = TID_EVENTS
        rec: Dict[str, Any] = {
            "name": ev.get("name", ""),
            "ph": ph,
            "pid": pid,
            "tid": tid,
            "ts": us(ev.get("ts", base_ts)),
            "cat": cat,
        }
        if ph == "i":
            rec["s"] = "t"
        if "dur" in ev:
            rec["dur"] = round(float(ev["dur"]) * 1e6, 1)
        if ev.get("args"):
            rec["args"] = ev["args"]
        if ph == "M" and cat == "timeline":
            # Mirrored thread_name metadata names the per-tensor lanes.
            rec.pop("ts", None)
            rec.pop("s", None)
        out.append(rec)
    for line in doc.get("event_log") or []:
        if not isinstance(line, dict):
            continue
        out.append({
            "name": f"{line.get('site', '?')}:{line.get('action', '?')}",
            "ph": "i", "s": "t", "pid": pid, "tid": TID_EVENT_LOG,
            # Event-log lines carry no wall clock (they are the
            # byte-diffable deterministic record); pin them to the lane
            # origin, ordered by their sequence number.
            "ts": float(int(line.get("seq", 0) or 0)),
            "cat": "event_log",
            "args": {k: line[k] for k in sorted(line) if line[k] is not None},
        })
    return out


def _min_ts(docs: List[dict]) -> float:
    tss = [
        float(ev["ts"])
        for doc in docs
        for ev in (doc.get("events") or [])
        if "ts" in ev
    ] + [
        float(s[1])
        for doc in docs
        for s in (doc.get("steps") or [])
        if isinstance(s, (list, tuple)) and len(s) >= 3
    ]
    return min(tss) if tss else 0.0


def _sort_key(ev: dict):
    return (
        0 if ev.get("ph") == "M" else 1,
        ev.get("pid", 0),
        ev.get("ts", 0.0),
        ev.get("tid", 0),
        ev.get("name", ""),
        ev.get("ph", ""),
    )


def merge_windows(ranks: Dict[int, dict],
                  driver: Optional[dict] = None) -> dict:
    """Merge rank windows (+ the driver's) into one Chrome trace doc."""
    docs = [ranks[r] for r in sorted(ranks)]
    if driver:
        docs.append(driver)
    base = _min_ts(docs)
    events: List[dict] = []
    for r in sorted(ranks):
        events.extend(_emit_window(ranks[r], r, base, f"rank {r}"))
    if driver:
        events.extend(_emit_window(driver, DRIVER_PID, base, "driver"))
    events.sort(key=_sort_key)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "horovod_tpu trace_merge",
            "ranks": sorted(ranks),
            "driver_lane": bool(driver),
            "clock_note": (
                "per-lane hvd_clock_offset metadata records each "
                "worker's KV-ping RTT/2 estimate against the driver; "
                "timestamps are raw wall clock"
            ),
        },
    }


def merge_postmortem(dumps: Dict[int, dict],
                     window_s: Optional[float] = None) -> dict:
    """Render flight-recorder dumps as the aligned last-moments view:
    every dumped rank gets its lane plus a ``DEATH:<reason>`` marker at
    its dump instant; ``window_s`` trims each lane to the final N
    seconds before its own death."""
    trimmed: Dict[int, dict] = {}
    for r, doc in dumps.items():
        d = dict(doc)
        if window_s is not None:
            cutoff = float(d.get("dumped_at", 0.0)) - float(window_s)
            d["events"] = [
                ev for ev in (d.get("events") or [])
                if float(ev.get("ts", 0.0)) >= cutoff
            ]
            d["steps"] = [
                s for s in (d.get("steps") or [])
                if isinstance(s, (list, tuple)) and len(s) >= 3
                and float(s[2]) >= cutoff
            ]
        trimmed[r] = d
    out = merge_windows(trimmed)
    base = _min_ts(list(trimmed.values()))
    deaths = []
    for r in sorted(trimmed):
        d = trimmed[r]
        deaths.append({
            "name": f"DEATH:{d.get('reason', 'unknown')}",
            "ph": "i", "s": "g", "pid": r, "tid": TID_EVENTS,
            "ts": round((float(d.get("dumped_at", base)) - base) * 1e6, 1),
            "cat": "death",
            "args": {"reason": d.get("reason", "unknown")},
        })
    out["traceEvents"] = sorted(
        out["traceEvents"] + deaths, key=_sort_key
    )
    out["otherData"]["postmortem"] = {
        "ranks": sorted(trimmed),
        "reasons": {str(r): trimmed[r].get("reason", "unknown")
                    for r in sorted(trimmed)},
    }
    return out


# Schema of the --stats summary (the fleet-sim calibrator's input
# contract, sim/calibrate.py). Bump on any shape change.
STATS_SCHEMA_VERSION = 1

# Span names that count as per-collective timing samples: the eager
# runtime's fused-response spans, the native runtime's plan spans
# (both carry payload bytes), and the simulator's hop-labeled stage
# spans (exact bytes/rounds per hop).
_COLLECTIVE_SPAN_PREFIXES = (
    "hvd_response", "hvd_plan", "hvd_collective_stage",
)


def _round9(v: float) -> float:
    return round(float(v), 9)


def stats_summary(ranks: Dict[int, dict],
                  driver: Optional[dict] = None) -> dict:
    """Machine-readable per-rank, per-stage timing summary of a trace
    directory — the calibrator's input contract (``sim/calibrate.py``).
    Pure data reduction: identical inputs give identical output bytes
    (floats rounded, keys sorted by the CLI's serializer), so two
    ``--stats`` passes over one trace diff clean."""
    out: Dict[str, Any] = {
        "schema_version": STATS_SCHEMA_VERSION,
        "world_size": len(ranks),
        "ranks": {},
    }
    for r in sorted(ranks):
        doc = ranks[r]
        steps = [
            [int(s[0]), _round9(s[1]), _round9(s[2])]
            for s in (doc.get("steps") or [])
            if isinstance(s, (list, tuple)) and len(s) >= 3
        ]
        durs = sorted(t1 - t0 for _, t0, t1 in steps)
        gaps = sorted(
            steps[i + 1][1] - steps[i][2] for i in range(len(steps) - 1)
        )

        def pct(xs, p):
            if not xs:
                return 0.0
            return _round9(xs[min(int(p * (len(xs) - 1)), len(xs) - 1)])

        collectives = []
        for ev in doc.get("events") or []:
            name = str(ev.get("name", ""))
            if not name.startswith(_COLLECTIVE_SPAN_PREFIXES):
                continue
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            args = ev.get("args") or {}
            entry: Dict[str, Any] = {
                "name": name,
                "ts": _round9(ev.get("ts", 0.0)),
                "dur_s": _round9(ev["dur"]),
            }
            nbytes = args.get("nbytes", args.get("bytes"))
            if nbytes is not None:
                entry["nbytes"] = int(nbytes)
            for k in ("op", "hop", "rounds", "wire_dtype", "group",
                      "plan"):
                if k in args:
                    entry[k] = args[k]
            collectives.append(entry)
        collectives.sort(key=lambda e: (e["ts"], e["name"]))
        out["ranks"][str(r)] = {
            "step_count": len(steps),
            "steps": steps,
            "step_p50_s": pct(durs, 0.50),
            "step_p99_s": pct(durs, 0.99),
            "gap_p50_s": pct(gaps, 0.50),
            "plan": doc.get("plan") or {},
            "clock": doc.get("clock") or {},
            "collectives": collectives,
            "events_total": len(doc.get("events") or []),
        }
    if driver is not None:
        plans = []
        for ev in driver.get("events") or []:
            if ev.get("name") == "hvd_sim_plan":
                plans.append(dict(ev.get("args") or {}))
        out["driver"] = {
            "events_total": len(driver.get("events") or []),
            "plans": sorted(
                plans, key=lambda p: int(p.get("group", 0))
            ),
        }
    return out


def write_stats(path: str, stats: dict) -> None:
    """Stable serialization for the --stats artifact (same discipline
    as :func:`write_trace`)."""
    from . import atomic_write

    payload = json.dumps(
        stats, sort_keys=True, separators=(",", ":")
    ).encode()
    atomic_write(path, lambda f: f.write(payload))


def write_trace(path: str, doc: dict) -> None:
    """Stable serialization (sorted keys, fixed separators) so identical
    inputs give identical bytes."""
    from . import atomic_write

    payload = json.dumps(
        doc, sort_keys=True, separators=(",", ":")
    ).encode()
    atomic_write(path, lambda f: f.write(payload))
