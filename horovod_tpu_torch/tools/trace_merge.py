"""Merge fleet trace windows into one Perfetto/Chrome trace
(docs/timeline.md "Fleet tracing"); the port's copy of
``tools/trace_merge.py``.

Usage::

    python -m horovod_tpu_torch.tools.trace_merge <trace-dir> [-o merged.json]
    python -m horovod_tpu_torch.tools.trace_merge <trace-dir> --postmortem [--window 10]

``<trace-dir>`` holds the ranks' windows (``trace.TAP.window()``, written
by the job, e.g. ``tools/run_parity.py``, or collected over the KV plane
by the elastic driver) and the flight-recorder dumps
(``HOROVOD_TRACE_DIR``):
``rank.<r>.json`` windows + ``driver.json`` for the live view,
``flight.rank<r>.json`` / ``postmortem.json`` dumps for ``--postmortem``
(the "last N seconds before death, all ranks, aligned" view). Open the
output in https://ui.perfetto.dev or chrome://tracing.

Per-lane ``hvd_clock_offset`` metadata carries each worker's KV-ping
RTT/2 clock estimate against the driver — recorded, never applied;
timestamps stay raw wall clock.

Pure file-in/file-out (no backend, no network); identical inputs give
byte-identical output.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", help="driver-collected trace directory")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (default: <trace-dir>/merged_trace"
                         ".json, or postmortem_trace.json)")
    ap.add_argument("--postmortem", action="store_true",
                    help="render flight-recorder dumps instead of the "
                         "live windows")
    ap.add_argument("--window", type=float, default=None, metavar="S",
                    help="postmortem: trim each lane to the final S "
                         "seconds before its own death")
    ap.add_argument("--stats", action="store_true",
                    help="emit the machine-readable per-rank/per-stage "
                         "timing summary (byte-stable, versioned via "
                         "schema_version; the fleet-sim calibrator's "
                         "input contract, docs/simulation.md) instead "
                         "of a merged trace")
    args = ap.parse_args(argv)

    from ..trace import merge as tmerge

    if not os.path.isdir(args.trace_dir):
        print(f"trace_merge: no such directory: {args.trace_dir}",
              file=sys.stderr)
        return 2

    if args.postmortem:
        dumps = tmerge.read_flight_dumps(args.trace_dir)
        if not dumps:
            print(
                f"trace_merge: no flight-recorder dumps under "
                f"{args.trace_dir}", file=sys.stderr,
            )
            return 1
        doc = tmerge.merge_postmortem(dumps, window_s=args.window)
        out = args.output or os.path.join(
            args.trace_dir, "postmortem_trace.json"
        )
        tmerge.write_trace(out, doc)
        reasons = doc["otherData"]["postmortem"]["reasons"]
        print(
            f"trace_merge: postmortem over ranks "
            f"{sorted(dumps)} ({len(doc['traceEvents'])} events) -> "
            f"{out}; deaths: "
            + ", ".join(f"rank {r}: {v}" for r, v in sorted(reasons.items()))
        )
        return 0

    ranks, driver = tmerge.read_dir(args.trace_dir)
    if not ranks and driver is None:
        print(
            f"trace_merge: no rank windows under {args.trace_dir} "
            "(is the job running with HOROVOD_TRACE=1 and an "
            "--output-dir?)", file=sys.stderr,
        )
        return 1

    if args.stats:
        stats = tmerge.stats_summary(ranks, driver)
        out = args.output or os.path.join(
            args.trace_dir, "trace_stats.json"
        )
        tmerge.write_stats(out, stats)
        n_coll = sum(
            len(stats["ranks"][r]["collectives"])
            for r in stats["ranks"]
        )
        print(
            f"trace_merge: stats over {len(ranks)} rank(s) "
            f"(schema_version {stats['schema_version']}, "
            f"{n_coll} collective samples) -> {out}"
        )
        return 0

    doc = tmerge.merge_windows(ranks, driver)
    out = args.output or os.path.join(args.trace_dir, "merged_trace.json")
    tmerge.write_trace(out, doc)
    print(
        f"trace_merge: merged {len(ranks)} rank lane(s)"
        + (" + driver lane" if driver else "")
        + f" ({len(doc['traceEvents'])} events) -> {out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
