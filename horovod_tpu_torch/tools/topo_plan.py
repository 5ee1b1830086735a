"""Offline compositor plan dumper: the port of ``tools/topo_plan.py``.

Pure cost-model output, no device and no process group: builds an
interconnect model (synthetic ``--local/--cross/--pod`` sizes, or
``--detect`` for this process's detected topology, either way honoring
``HOROVOD_TOPOLOGY_MODEL``) and dumps the selected lowering plan for
every collective across a payload ladder as STABLE JSON (sorted keys, no
timestamps): two runs over the same inputs are byte-identical, and equal
to the JAX package's tool for the same model.

Examples::

    # 2 nodes of 4 H100s, default payload ladder
    python -m horovod_tpu_torch.tools.topo_plan --local 4 --cross 2 --generation h100

    # three-level (pod, cross, local) hierarchy, one payload, one op
    python -m horovod_tpu_torch.tools.topo_plan --local 2 --cross 2 --pod 2 \
        --bytes 67108864 --collective allreduce --op MIN

    # whatever this deployment's environment detects
    python -m horovod_tpu_torch.tools.topo_plan --detect
"""

from __future__ import annotations

import argparse
import json
import sys

from ..common.types import ReduceOp
from ..topo import COLLECTIVES, apply_override, select_plan, synthetic_model
from ..topo.model import resolve_model

DEFAULT_BYTES = (
    1024, 64 * 1024, 1024 * 1024, 16 * 1024 * 1024, 64 * 1024 * 1024,
    256 * 1024 * 1024,
)


def build_dump(model, collectives, byte_sizes, op: ReduceOp) -> dict:
    plans = {}
    for coll in collectives:
        entries = []
        for nb in byte_sizes:
            use_op = op if coll in ("allreduce", "reducescatter") else None
            if coll == "reducescatter" and op not in (
                ReduceOp.SUM, ReduceOp.AVERAGE
            ):
                use_op = ReduceOp.SUM
            plan = select_plan(
                model, coll, nb,
                op=use_op if use_op is not None else ReduceOp.SUM,
            )
            entries.append(plan.to_dict())
        plans[coll] = entries
    return {"model": model.to_dict(), "plans": plans}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--local", type=int, default=4,
                    help="ranks a node (the ici hop's size)")
    ap.add_argument("--cross", type=int, default=1,
                    help="nodes (the dcn hop's size)")
    ap.add_argument("--pod", type=int, default=1,
                    help="pods (the dcn-pod hop's size)")
    ap.add_argument("--generation", default="generic",
                    help="generation for the default hop costs "
                         "(h100/v3/v4/v5e/v5p/v6e/generic)")
    ap.add_argument("--detect", action="store_true",
                    help="model from the detected process topology "
                         "instead of the synthetic sizes")
    ap.add_argument("--bytes", default=None,
                    help="comma-separated payload sizes "
                         f"(default {','.join(map(str, DEFAULT_BYTES))})")
    ap.add_argument("--collective", default="all",
                    choices=("all",) + COLLECTIVES)
    ap.add_argument("--op", default="SUM",
                    help="reduce op for allreduce/reducescatter plans")
    ap.add_argument("-o", "--output", default=None,
                    help="write JSON here instead of stdout")
    args = ap.parse_args(argv)

    if args.detect:
        model = resolve_model()
    else:
        model = apply_override(synthetic_model(
            local=args.local, cross=args.cross, pod=args.pod,
            generation=args.generation,
        ))
    byte_sizes = (
        [int(b) for b in args.bytes.split(",") if b.strip()]
        if args.bytes else list(DEFAULT_BYTES)
    )
    collectives = (
        list(COLLECTIVES) if args.collective == "all"
        else [args.collective]
    )
    dump = build_dump(model, collectives, byte_sizes,
                      ReduceOp[args.op.upper()])
    text = json.dumps(dump, sort_keys=True, indent=1) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"[topo] wrote {args.output}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
