"""Fleet-simulator smoke: deterministic predictions, two-level beating
flat at scale, a calibration loop that recovers known constants, and a
real 2-rank trace replayed. Budget: ~30 s on the CPU.

    python -m horovod_tpu_torch.tools.sim_smoke               # the job on 2 cards
    python -m horovod_tpu_torch.tools.sim_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/sim_smoke.py``, over the port's ``sim/``,
``tools/fleet_sim`` and ``tools/trace_merge``:

1. determinism: two ``fleet_sim`` predict runs over 256/1024/4096 ranks
   (the transformer program, 2 steps, seed 0) are byte-identical;
2. two-level beats flat at scale: at 1024 simulated ranks (8 x 128) the
   two-level lowering's step is strictly below flat's;
3. real-trace replay: a 2-rank job under the port's elastic driver with
   ``HOROVOD_TRACE=1`` (8 traced steps of one 256 KiB allreduce);
   ``trace_merge --stats`` over its windows twice gives the same bytes,
   with both ranks' steps and collective samples, and ``fleet_sim
   --replay`` reports finite per-hop and step divergence ratios;
4. calibration loop: a calibration fitted (``fleet_sim --calibrate``) from
   a simulated trace with known constants recovers them within 1%, and a
   replay under it diverges by less than 5% a hop.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

from .smoke_common import REPO, check, job_env, main_guard, need_ranks, parse_args

STEPS = 8

WORKER = """
import os, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import trace as hvd_trace

hvd.init(device=os.environ.get("SMOKE_DEVICE") or None)
dev = hvd.device()
assert hvd.size() == 2
assert hvd_trace.ACTIVE


def train_step(i):
    time.sleep(0.01)
    out = hvd.allreduce(torch.ones(65536, device=dev), name=f'sim.grad.{i}', op=hvd.Sum)
    assert float(out[0]) == hvd.size()


step = hvd_trace.wrap_step(train_step, wire_dtype='f32')
for i in range(%(steps)d):
    step(i)
time.sleep(3.0)  # the driver's collection window
print('SIM_WORKER_DONE', hvd.rank(), flush=True)
hvd.shutdown()
""" % {"steps": STEPS}


def _run_module(module: str, *args) -> None:
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=job_env(),
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"{module} {' '.join(args)} failed rc={proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")


FLEET = "horovod_tpu_torch.tools.fleet_sim"
MERGE = "horovod_tpu_torch.tools.trace_merge"


def gate_determinism(td: str) -> dict:
    outs = []
    for tag in ("a", "b"):
        out = os.path.join(td, f"predict_{tag}.json")
        _run_module(FLEET, "--ranks", "256", "1024", "4096", "--program", "transformer",
                    "--steps", "2", "--seed", "0", "-o", out)
        with open(out, "rb") as f:
            outs.append(f.read())
    check(outs[0] == outs[1], "fleet_sim predict runs are not byte-identical")
    return json.loads(outs[0].decode())


def gate_two_level_beats_flat() -> dict:
    from horovod_tpu_torch.sim import SimConfig, program_from_layers, simulate
    from horovod_tpu_torch.topo.model import synthetic_model

    model = synthetic_model(8, cross=128)
    prog = program_from_layers("gate", [4 << 20] * 8, first_bucket_bytes=1 << 20)
    flat = simulate(model, prog, SimConfig(algorithm="flat"), steps=2)
    two = simulate(model, prog, SimConfig(algorithm="two-level"), steps=2)
    check(two.mean_step_us < flat.mean_step_us,
          f"two-level ({two.mean_step_us}us) must strictly beat flat ({flat.mean_step_us}us) "
          "at 1024 simulated ranks")
    return {"flat_us": round(flat.mean_step_us, 1), "two_level_us": round(two.mean_step_us, 1)}


def check_stats(stats: dict) -> int:
    """Gate 3's trace half: both ranks, their steps, collective samples."""
    check(stats["world_size"] == 2, f"world_size {stats['world_size']}")
    check(stats["ranks"]["0"]["step_count"] >= STEPS - 1,
          f"rank 0 step_count {stats['ranks']['0']['step_count']}")
    samples = sum(len(stats["ranks"][r]["collectives"]) for r in stats["ranks"])
    check(samples > 0, "no collective samples in the real trace")
    return samples


def check_replay_bounded(replay: dict) -> list:
    """Gate 3's replay half: finite, bounded divergence ratios."""
    per_hop = replay["divergence"]["per_hop"]
    check(bool(per_hop), "replay reported no per-hop divergence")
    for hop, entry in per_hop.items():
        r = entry["ratio"]
        check(r is not None and 1e-6 < r < 1e6, f"{hop}: {entry}")
    step_ratio = replay["divergence"]["step"]["ratio"]
    check(step_ratio is not None and 1e-6 < step_ratio < 1e6, f"step ratio {step_ratio}")
    return sorted(per_hop)


def gate_real_trace_replay(td: str, device) -> dict:
    trace_dir = os.path.join(td, "trace")
    script = os.path.join(td, "worker.py")
    with open(script, "w") as f:
        f.write(textwrap.dedent(WORKER))
    env = job_env(device, HOROVOD_TRACE="1", HOROVOD_TRACE_DIR=trace_dir,
                  HOROVOD_TRACE_PUSH_INTERVAL_S="0.25")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--min-np", "2",
         "--max-np", "2", "--output-dir", td, sys.executable, script],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=90)
    text = proc.stdout
    for fn in sorted(os.listdir(td)):
        if fn.startswith("worker.") and fn.endswith((".out", ".err")):
            with open(os.path.join(td, fn), errors="replace") as f:
                text += f"\n--- {fn} ---\n" + f.read()
    check(proc.returncode == 0, f"2-rank traced job failed rc={proc.returncode}\n"
          f"{text[-3000:]}\n{proc.stderr[-2000:]}")
    check("SIM_WORKER_DONE 0" in text and "SIM_WORKER_DONE 1" in text, text[-3000:])
    stats_path = os.path.join(td, "stats.json")
    blobs = []
    for _ in range(2):
        _run_module(MERGE, trace_dir, "--stats", "-o", stats_path)
        with open(stats_path, "rb") as f:
            blobs.append(f.read())
    check(blobs[0] == blobs[1], "--stats output is not byte-stable")
    stats = json.loads(blobs[0].decode())
    samples = check_stats(stats)
    replay_path = os.path.join(td, "replay.json")
    _run_module(FLEET, "--replay", trace_dir, "-o", replay_path)
    with open(replay_path) as f:
        hops = check_replay_bounded(json.load(f))
    return {"steps": stats["ranks"]["0"]["step_count"], "samples": samples, "hops": hops}


def gate_calibration_loop(td: str) -> dict:
    from horovod_tpu_torch.sim import SimConfig, load_calibration, simulate
    from horovod_tpu_torch.sim.core import SimGroup, SimProgram
    from horovod_tpu_torch.topo.model import synthetic_model

    model = synthetic_model(4, cross=2)
    prog = SimProgram(name="cal", groups=(SimGroup("g0", 2 << 20, 200.0),
                                          SimGroup("g1", 1 << 20, 200.0),
                                          SimGroup("g2", 512 << 10, 100.0)),
                      forward_us=200.0, optimizer_us=20.0)
    res = simulate(model, prog, SimConfig(), steps=3)
    tdir = os.path.join(td, "simtrace")
    os.makedirs(tdir, exist_ok=True)
    for r, doc in res.windows().items():
        with open(os.path.join(tdir, f"rank.{r}.json"), "w") as f:
            json.dump(doc, f, sort_keys=True)
    with open(os.path.join(tdir, "driver.json"), "w") as f:
        json.dump(res.driver_window(), f, sort_keys=True)
    calib_path = os.path.join(td, "calibration.json")
    _run_module(FLEET, "--calibrate", tdir, "--local", "4", "-o", calib_path)
    calib = load_calibration(calib_path)
    for h in model.hops:
        entry = calib.hops[h.name]
        check(entry["calibrated"], f"{h.name} not calibrated: {calib.hops}")
        check(abs(entry["bandwidth_gbps"] - h.bandwidth_gbps) < 0.01 * h.bandwidth_gbps,
              f"{h.name}: {entry} vs {h.bandwidth_gbps}")
    replay_path = os.path.join(td, "replay_cal.json")
    _run_module(FLEET, "--replay", tdir, "--local", "4", "--calibration", calib_path,
                "-o", replay_path)
    with open(replay_path) as f:
        replay = json.load(f)
    check(replay["calibration"]["applied"] is True, "the calibration was not applied")
    for hop, entry in replay["divergence"]["per_hop"].items():
        check(abs(entry["ratio"] - 1.0) < 0.05, f"{hop}: {entry}")
    return {"recovered_hops": sorted(calib.hops)}


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv)
    code = need_ranks(2, args.device, "sim")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="sim_smoke_") as td:
            report = gate_determinism(td)
            effs = {str(r["ranks"]): r["scaling_efficiency"] for r in report["results"]}
            scale = gate_two_level_beats_flat()
            loop = gate_calibration_loop(td)
            replay = gate_real_trace_replay(td, args.device)
        print(f"[sim-smoke] OK in {time.time() - t0:.1f}s: predict byte-stable (eff {effs}), "
              f"two-level {scale['two_level_us']}us < flat {scale['flat_us']}us at 1024 ranks, "
              f"calibration recovered {loop['recovered_hops']} with replay ratios ~1, real "
              f"2-rank replay bounded over {replay['samples']} samples ({replay['steps']} "
              f"steps, hops {replay['hops']})")

    return main_guard("sim", body)


if __name__ == "__main__":
    sys.exit(main())
