"""The readings that a cell's limits are set from, other than the program's
own: the control and the planted faults, each the reference put in the
program's place, against the float32 reference, at the cell's own sizes.

    python3 hvdbench/control.py --workload gpt2s.graph.1 --seeds 11,12,13

Variants (``--variants``, default all that the cell can have):

- ``control``: the reference one precision below the configuration's
  (``reference/lowp.py``: fp8 products where it states bfloat16, TF32
  where it states float32);
- ``half``: half of each rank's rows left out, the mean taken over the rest;
- ``no_exchange`` (cells on several ranks): rank 0's rows alone, as a rank
  whose gradients were never averaged with the others' sees them.

Asked for by name only:

- ``wgrad_double`` (families with bottleneck blocks): the weight gradient
  of every block's 3×3 convolution (``Conv_1``) doubled, as a backward
  that accumulates twice gives it; its line adds the least gap of those
  leaves' first gradients, what one block's fault alone would read;
- ``f64``, ``bf16``: witnesses, not faults: the reference in float64, and
  with the program's bfloat16 operands, against the float32 reference.

``--set key=value`` changes a number of the configuration for the run
(a witness at another init). A state left unchanged reads 1 by the
comparison's measure and needs no run. Prints one JSON line a seed and variant. The benchmark's runs never
run this; it runs on one card whatever the cell's count.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hvdbench import common  # noqa: E402
from hvdbench.faults import TAMPERED  # noqa: E402

VARIANTS = ("control", "half", "no_exchange")
ON_REQUEST = ("wgrad_double", "f64", "bf16")


def _double_conv1(params) -> None:
    for name, p in params.items():
        if name.endswith(TAMPERED):
            p.grad.mul_(2.0)


def readings(cell: dict, seed: int, variants, device) -> list:
    """[{variant, seed, the three numbers}] for one seed."""
    import torch

    from hvdbench import compare
    from hvdbench.reference import loop
    from hvdbench.weights import draw

    config, traffic = cell["config"], cell["traffic"]
    fam, ref = common.family(config), common.reference(config)
    world, B = int(traffic["ranks"]), int(traffic["batch_per_card"])
    spec = fam.leaves(config)
    buffers = [name for name, _, _, role in spec if role == "buffer"]
    batch = fam.make_batch(config, traffic, seed, device, rank=None, world=world)
    base = loop.train(ref, draw(spec, seed, device), buffers, batch, config)
    out = []
    for variant in variants:
        if variant == "no_exchange" and world == 1:
            continue
        tampered = sorted(n for n, *_ in spec if n.endswith(TAMPERED))
        if variant == "wgrad_double" and not tampered:
            continue
        precision, rows, tamper = "f32", batch, None
        if variant in ("control", "f64", "bf16"):
            precision = variant
        elif variant == "wgrad_double":
            tamper = _double_conv1
        elif variant == "half":
            keep = [i for r in range(world) for i in range(r * B, r * B + B // 2)]
            rows = tuple(t[keep] for t in batch)
        elif variant == "no_exchange":
            rows = tuple(t[:B] for t in batch)
        try:
            got = loop.train(ref, draw(spec, seed, device), buffers, rows, config,
                             precision=precision, tamper=tamper)
        except torch.cuda.OutOfMemoryError:
            out.append({"workload": cell["name"], "variant": variant, "seed": seed,
                        "error": "out of memory"})
            torch.cuda.empty_cache()
            continue
        numbers, where = compare.gaps(got, base)
        row = {"workload": cell["name"], "variant": variant, "seed": seed, **numbers,
               "grad_worst": where["grad_worst"], "change_worst": where["change_worst"]}
        if variant == "wgrad_double":
            median = statistics.median(v for v in base["grad"].values() if v > 0)
            row["least_tampered_grad_gap"] = min(
                abs(got["grad"][n] - base["grad"][n]) / max(base["grad"][n], median)
                for n in tampered)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated, of {VARIANTS + ON_REQUEST}")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=NUMBER",
                    help="change a number of the configuration")
    args = ap.parse_args(argv)
    common.set_cache_env()
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = common.cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        if not isinstance(cell["config"].get(key), (int, float)):
            raise SystemExit(f"hvdbench: {key!r} is not a number of the configuration")
        cell["config"][key] = type(cell["config"][key])(float(value))
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(cell, seed, args.variants.split(","), device):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
