"""Run cells several times in a row, each run a process of its own as a
benchmark check starts it, and gather each run's result line with the
card's name and power limit.

    python3 hvdbench/rehearse.py --workload gpt2s.graph.1 --seeds 1,2 --seconds 5 \
        --trace 0,1 --out out/rehearse.jsonl

Before any measuring call, the rehearsal is this command at a short
``--seconds`` on one seed with both ``--trace`` values: it builds the
kernels, runs the whole path and the comparison, and reads a trace.
Prints one summary line a run; the full lines and the end of each run's
standard error go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="comma-separated")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    gpu = card()
    print(f"card: {gpu}", flush=True)
    failures = 0
    with open(args.out, "a") as out:
        for workload in args.workload.split(","):
            for seed in args.seeds.split(","):
                for trace in args.trace.split(","):
                    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
                           "--seed", seed, "--seconds", str(args.seconds), "--trace", trace]
                    t = time.perf_counter()
                    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
                    took = time.perf_counter() - t
                    lines = proc.stdout.strip().splitlines()
                    result = None
                    if proc.returncode == 0 and lines:
                        try:
                            result = json.loads(lines[-1])
                        except ValueError:
                            result = None
                    failures += result is None or not result.get("correct")
                    row = {"workload": workload, "seed": int(seed), "trace": int(trace),
                           "rc": proc.returncode, "took_s": took, "card": gpu,
                           "result": result, "stderr_tail": proc.stderr[-3000:]}
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                    brief = ({k: v["value"] for k, v in result["metrics"].items()}
                             if result else proc.stderr[-1500:])
                    checks = ({k: v["value"] for k, v in result["checks"].items()}
                              if result else None)
                    print(json.dumps({"workload": workload, "seed": int(seed), "trace": int(trace),
                                      "rc": proc.returncode, "took_s": round(took, 1),
                                      "correct": result and result["correct"],
                                      "metrics": brief, "checks": checks,
                                      "device": result and result["device"]}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
