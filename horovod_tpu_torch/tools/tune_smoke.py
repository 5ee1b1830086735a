"""Compiled-path tuner smoke: a byte-deterministic ``tuned.json``, a tuned
step bitwise the untuned one, a modeled win, a loud stale fallback.
Budget: under 60 s on the CPU.

    python -m horovod_tpu_torch.tools.tune_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.tune_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/tune_smoke.py``, over the port's
``tools/autotune_compiled.py`` (8 samples, seed 0) and
``make_train_step(tuned=...)``:

1. byte determinism: two runs on the mlp3 program (dim 1024, f32 wire
   pinned) write byte-identical files;
2. numeric identity: on 2 ranks (the reference uses its 8-device virtual
   mesh; the mlp3 tuning is made for ``--local 2``, so its signature's mesh
   half is the job's ``{"data": 2}``), the streamed step built with
   ``tuned=<file>`` is bitwise the untuned step and the step built with
   ``tune.tuned_step_kwargs`` by hand, and ``tune.applied_tuned_info``
   says matched (an f32 tuning only regroups elementwise reductions);
3. modeled win: the mlp3 winner's ``exposed_us`` is at most the default's,
   and on the transformer program (``--local 8``, the reference's default)
   at least one free objective strictly improves;
4. stale fallback: the transformer's tuning applied to the mlp3 step warns
   ``FALLING BACK`` on the ``horovod_tpu_torch`` logger, records
   ``matched`` false, and the step is bitwise the untuned one.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .smoke_common import (REPO, check, init_worker, job_env, launch_workers, main_guard,
                           mlp3, mse, need_ranks, parse_args, write_result)

DIM = 1024
SAMPLES = 8
RANKS = 2


def run_tool(out: str, *extra) -> str:
    """One ``tools/autotune_compiled`` run writing ``out``."""
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.autotune_compiled", "--samples",
         str(SAMPLES), "--seed", "0", "--out", out, *extra],
        capture_output=True, text=True, env=job_env(), cwd=REPO, timeout=300)
    check(proc.returncode == 0,
          f"autotune_compiled failed rc={proc.returncode}:\n{proc.stderr[-2000:]}")
    return proc.stdout


def check_modeled_win(tuned: dict, tuned_tf: dict) -> None:
    """Gate 3."""
    obj, base = tuned["objectives"], tuned["baseline"]
    check(obj["exposed_us"] <= base["exposed_us"], f"mlp3 exposed {obj} vs {base}")
    o, s = tuned_tf["objectives"], tuned_tf["baseline"]
    check(o["n_groups"] > s["n_groups"] or o["cost_us"] < s["cost_us"]
          or o["wire_bytes"] < s["wire_bytes"] or o["exposed_us"] < s["exposed_us"],
          f"transformer tuning improved nothing: {o} vs {s}")


def worker(args) -> int:
    import torch

    import horovod_tpu_torch.train as T
    from horovod_tpu_torch import tune

    hvd = init_worker(args.device)
    try:
        dev, r, n = hvd.device(), hvd.rank(), hvd.size()
        rng = np.random.RandomState(1)
        x, y = (rng.randn(2 * n, DIM).astype(np.float32) for _ in range(2))
        batch = (torch.from_numpy(x[2 * r:2 * r + 2]).to(dev),
                 torch.from_numpy(y[2 * r:2 * r + 2]).to(dev))

        def run(tuned, **kw):
            m = mlp3(DIM, dev, np.random.RandomState(0), 0.05, 0.05)
            step = T.make_train_step(mse, torch.optim.SGD(m.parameters(), lr=0.01),
                                     overlap=True, tuned=tuned, **kw)
            loss = float(step(m, batch))
            step.close()
            return [p.detach().clone() for p in m.parameters()], loss

        p_u, loss_u = run(False)
        p_t, loss_t = run(args.tuned)
        info = tune.applied_tuned_info()
        check(bool(info) and info["matched"], f"tuned signature did not match: {info}")
        cfg = tune.load_tuned(args.tuned)
        p_h, _ = run(False, **tune.tuned_step_kwargs(cfg))
        for u, t, h in zip(p_u, p_t, p_h):
            check(torch.equal(u, t), "tuned step numerics differ from untuned")
            check(torch.equal(t, h), "tuned step differs from the same knobs set by hand")
        records = []

        class _Catch(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        catch = _Catch()
        logging.getLogger("horovod_tpu_torch").addHandler(catch)
        try:
            p_s, _ = run(args.stale)
        finally:
            logging.getLogger("horovod_tpu_torch").removeHandler(catch)
        check(any("FALLING BACK" in m for m in records), f"no loud fallback: {records}")
        stale_info = tune.applied_tuned_info()
        check(bool(stale_info) and not stale_info["matched"], f"stale info {stale_info}")
        for u, s in zip(p_u, p_s):
            check(torch.equal(u, s), "stale-tuned fallback step differs from untuned")
        if r == 0:
            write_result(args.out, {"loss": loss_t, "knobs": cfg.knobs,
                                    "untuned_loss": loss_u})
    finally:
        hvd.shutdown()
    return 0


def _extra(ap):
    ap.add_argument("--tuned", default=None, help="(worker) the mlp3 tuning")
    ap.add_argument("--stale", default=None, help="(worker) a tuning for another program")


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv, _extra, worker=True)
    if args.worker:
        return worker(args)
    code = need_ranks(RANKS, args.device, "tune")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="tune_smoke_") as td:
            mlp_a, mlp_b = os.path.join(td, "mlp3_a.json"), os.path.join(td, "mlp3_b.json")
            tf_out = os.path.join(td, "transformer.json")
            mlp_args = ("--program", "mlp3", "--dim", str(DIM), "--wire", "f32", "--local",
                        str(RANKS))
            run_tool(mlp_a, *mlp_args)
            run_tool(mlp_b, *mlp_args)
            with open(mlp_a, "rb") as fa, open(mlp_b, "rb") as fb:
                a, b = fa.read(), fb.read()
            check(a == b, "tuned.json differs between two identical tuner runs")
            print(f"[tune] byte-identical across two runs ({len(a)} bytes)")
            run_tool(tf_out, "--program", "transformer")
            with open(mlp_a) as fa, open(tf_out) as ft:
                tuned, tuned_tf = json.load(fa), json.load(ft)
            check_modeled_win(tuned, tuned_tf)
            s, o = tuned_tf["baseline"], tuned_tf["objectives"]
            print(f"[tune] modeled win: mlp3 exposed {tuned['baseline']['exposed_us']} -> "
                  f"{tuned['objectives']['exposed_us']} us, transformer cost {s['cost_us']} -> "
                  f"{o['cost_us']} us, wire {s['wire_bytes']} -> {o['wire_bytes']} B")
            doc = launch_workers("horovod_tpu_torch.tools.tune_smoke", RANKS, args.device,
                                 ["--tuned", mlp_a, "--stale", tf_out])
        print(f"[tune] tuned step bitwise == untuned == hand-set (loss {doc['loss']:.6f}), "
              f"knobs {doc['knobs']}")
        print("[tune] stale signature warned loudly and fell back to defaults")
        print(f"[tune] smoke OK in {time.time() - t0:.1f}s")

    return main_guard("tune", body)


if __name__ == "__main__":
    sys.exit(main())
