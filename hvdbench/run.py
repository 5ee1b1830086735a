"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 hvdbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic names the path that drives it (``paths/<path>.py``).
The path builds and warms the program's step, takes the readings of the
first steps, runs the window, and with ``--trace 1`` profiles a few steps
after it. Once the program's state is freed, the reference trains the
same first steps from the same weights and batch on the card, and the
comparison decides ``correct``. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

Exits non-zero with no result where the card or cards the cell needs are
missing, and where a JAX module was loaded in this process or a rank.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hvdbench import common  # noqa: E402


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device=None,
             fault=None) -> dict:
    """The result of one run of ``cell`` (the line, as a dict). ``device``
    and ``fault`` are for the tests: a run on the CPU at small widths,
    and a fault planted under the timed path."""
    import torch

    from hvdbench import compare
    from hvdbench import trace as tr
    from hvdbench.reference import loop
    from hvdbench.weights import draw

    config, traffic = cell["config"], cell["traffic"]
    fam = common.family(config)
    path = importlib.import_module(f"hvdbench.paths.{traffic['path']}")
    rec = path.run(cell, seed, seconds, trace, device=device, fault=fault)

    dev = torch.device("cuda", 0) if rec["platform"] == "gpu" else torch.device("cpu")
    spec = fam.leaves(config)
    t = time.perf_counter()
    batch = fam.make_batch(config, traffic, seed, dev, rank=None, world=rec["world"])
    ref = loop.train(common.reference(config), draw(spec, seed, dev),
                     [name for name, _, _, role in spec if role == "buffer"], batch, config,
                     steps=len(rec["readings"]["loss"]))
    del batch
    print(f"hvdbench: the reference took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    numbers, where = compare.gaps(rec["readings"], ref)
    ok, checks = compare.verdict(numbers, cell["limits"])
    print(f"hvdbench: worst leaves {where['grad_worst']} (grad), {where['change_worst']} "
          f"(change); quiet leaves left out of the change: {len(where['quiet_leaves'])}; "
          f"numbers {json.dumps(numbers)}", file=sys.stderr)

    finite = math.isfinite(rec["final_loss"])
    items_per_step = rec["world"] * rec["rows_per_rank"] * fam.items_per_row(config, traffic)
    ctx = {"cell": cell, "config": config, "traffic": traffic, "family": fam,
           "item": fam.ITEM, "world": rec["world"], "chips": cell["chips"],
           "steps": rec["steps"], "window_s": rec["window_s"], "setup_s": rec["setup_s"],
           "items_per_step": items_per_step, "step_ms": rec.get("step_ms"),
           "ranks": rec["ranks"]}
    on_card = rec["platform"] == "gpu"
    # A run off the card measures nothing of the device: no metric.
    metrics = (common.read_metrics(cell["per_layer"] if trace else cell["end_to_end"],
                                   "metrics" if trace else "end_to_end", ctx)
               if on_card else {})
    device_block = {"platform": rec["platform"], "kind": rec["kind"], "count": rec["world"],
                    "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": bool(ok and finite), "attempted": rec["steps"],
              "failed": 0 if finite else rec["steps"], "metrics": metrics,
              "device": device_block}
    traces = [r["trace"] for r in rec["ranks"] if r.get("trace")]
    if trace and traces:
        device_block["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device_block["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        result["breakdown"] = {
            "device_ops": tr.top(tr.mean_tables([t["ops"] for t in traces])),
            "idle_gaps": tr.top(tr.mean_tables([t["gaps"] for t in traces]))}
    result["checks"] = checks
    forbidden = sorted(set(rec["forbidden"]) | set(common.forbidden_modules()))
    if forbidden:
        raise SystemExit(f"hvdbench: JAX modules were loaded: {forbidden[:20]}")
    compare.print_checks(checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_env()
    cell = common.cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"hvdbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
