"""Topology-compositor smoke: plan dumps byte-stable and plan shapes sane.
Pure cost model: no device, no process group. Budget: under 10 s.

    python -m horovod_tpu_torch.tools.topo_smoke [--device cpu]

The counterpart of ``tools/topo_smoke.py``. For the reference's 1-slice,
2-slice, 4-slice and three-level synthetic topologies (:data:`TOPOLOGIES`)
on the reference's ``v5e`` costs, and again on the port's ``h100`` row:

1. determinism: the plan dump (``tools/topo_plan.build_dump`` over the five
   collectives and the default sizes) is byte-identical across two runs in
   process, and ``python -m horovod_tpu_torch.tools.topo_plan --local 4
   --cross 2 --generation v5e`` prints the same bytes twice;
2. plan shapes: one level stays ring or recursive halving; several levels
   lower a 64 MiB allreduce two-level or split, with fewer dcn bytes than
   the flat plan; MIN lowers two-level and PRODUCT stays flat; the
   homogeneity gate keeps an ineligible model flat.

``--device`` is accepted for the CI script's uniformity; the smoke touches
no device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from .smoke_common import REPO, check, job_env, main_guard, parse_args

TOPOLOGIES = (
    ("1-slice", dict(local=8, cross=1)),
    ("2-slice", dict(local=4, cross=2)),
    ("4-slice", dict(local=2, cross=4)),
    ("2-pod", dict(local=2, cross=2, pod=2)),
)
COLLECTIVES = ["allreduce", "allgather", "reducescatter", "broadcast", "alltoall"]
GENERATIONS = ("v5e", "h100")
CLI_ARGS = ["--local", "4", "--cross", "2", "--generation", "v5e"]


def dump_text(generation: str, sizes: dict) -> str:
    """One topology's plan dump, as the reference's smoke serializes it."""
    from horovod_tpu_torch.common.types import ReduceOp
    from horovod_tpu_torch.tools.topo_plan import DEFAULT_BYTES, build_dump
    from horovod_tpu_torch.topo import synthetic_model

    model = synthetic_model(generation=generation, **sizes)
    return json.dumps(build_dump(model, COLLECTIVES, list(DEFAULT_BYTES), ReduceOp.SUM),
                      sort_keys=True, indent=1)


def check_shapes(name: str, generation: str, sizes: dict) -> str:
    """The plan-shape gates on one topology; the 64 MiB allreduce's line."""
    from horovod_tpu_torch.common.types import ReduceOp
    from horovod_tpu_torch.topo import select_plan, synthetic_model
    from horovod_tpu_torch.topo.compositor import _candidates_allreduce

    model = synthetic_model(generation=generation, **sizes)
    big = select_plan(model, "allreduce", 64 << 20)
    if model.levels == 1:
        check(big.algorithm in ("ring", "recursive-halving"),
              f"{name}/{generation}: single-level allreduce chose {big.algorithm}")
    else:
        check(big.algorithm in ("two-level", "split"),
              f"{name}/{generation}: 64MB allreduce stayed {big.algorithm}")
        flat = _candidates_allreduce(model, 64 << 20, ReduceOp.SUM)["flat"]
        flat_dcn = sum(s.bytes_on_wire for s in flat if "dcn" in s.hop)
        hier_dcn = sum(v for k, v in big.bytes_per_hop.items() if "dcn" in k)
        check(hier_dcn < flat_dcn,
              f"{name}/{generation}: hierarchical DCN bytes {hier_dcn} not < flat {flat_dcn}")
        check(select_plan(model, "allreduce", 1 << 20, op=ReduceOp.MIN).algorithm
              == "two-level", f"{name}/{generation}: MIN did not lower two-level")
        check(select_plan(model, "allreduce", 1 << 20, op=ReduceOp.PRODUCT).algorithm
              == "flat", f"{name}/{generation}: PRODUCT left the flat lowering")
    gated = synthetic_model(generation=generation, eligible=False, **sizes)
    check(select_plan(gated, "allreduce", 64 << 20).algorithm
          in ("flat", "ring", "recursive-halving"),
          f"{name}/{generation}: ineligible model still lowered hierarchically")
    return f"64MB allreduce={big.algorithm}, bytes_per_hop={big.bytes_per_hop}"


def cli_dump() -> bytes:
    """``tools/topo_plan``'s stdout for :data:`CLI_ARGS`."""
    env = job_env()
    env.pop("HOROVOD_TOPOLOGY_MODEL", None)
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.tools.topo_plan",
                           *CLI_ARGS], capture_output=True, env=env, cwd=REPO,
                          check=True).stdout


def main(argv=None) -> int:
    parse_args(__doc__.split("\n")[0], argv)

    def body():
        t0 = time.time()
        for generation in GENERATIONS:
            for name, sizes in TOPOLOGIES:
                check(dump_text(generation, sizes) == dump_text(generation, sizes),
                      f"{name}/{generation}: in-process dumps differ")
                line = check_shapes(name, generation, sizes)
                print(f"[topo-smoke] {name}/{generation}: dump stable, {line}")
        o1, o2 = cli_dump(), cli_dump()
        check(o1 == o2, "topo_plan CLI output differs across runs")
        json.loads(o1)
        print(f"[topo-smoke] CLI dump byte-identical ({len(o1)} bytes)")
        print(f"[topo-smoke] PASS in {time.time() - t0:.1f}s")

    return main_guard("topo", body)


if __name__ == "__main__":
    sys.exit(main())
