"""The offline autotuner for the compiled path: emit a pinned ``tuned.json``.

The port of ``tools/autotune_compiled.py``, with the same flags::

    python -m horovod_tpu_torch.tools.autotune_compiled --program transformer \\
        --d-model 768 --heads 12 --layers 12 --vocab 32768 --seq-len 1024 \\
        --local 4 --generation h100 --samples 8 --out tuned.json

It sweeps the joint knob space (fusion threshold x streamed first bucket x
topology-plan choice x wire dtype) with the GP/EI machinery of
``horovod_tpu_torch/tune/gp.py`` (seeded, byte-deterministic), scoring each
candidate on two free objectives, with no device: the structural overlap
staircase of the stream groups and the topology compositor's alpha-beta
pricing of each group's payload. ``--measure`` scores each sample by the
measured step time of the ``mlp3`` program on the card instead (the free
models still land in the evidence block); the transformer's measured path
is ``python -m horovod_tpu_torch.bench --model transformer --tuned``.

The programs are built from the port's own parameters on the ``meta``
device (no memory): ``mlp3`` is three ``dim x dim`` layers with biases,
``transformer`` the port's ``TransformerLM`` in f32. The winner is frozen as
``tuned.json``, keyed by the port's step signature (``tune/signature.py``:
the parameter names, shapes and dtypes and the mesh ``{"data": local}``, or
``{"cross", "local"}`` / ``{"pod", "cross", "local"}``), which
``make_train_step(tuned=...)``, ``DistributedOptimizer(tuned=...)``,
``HOROVOD_TUNED_FILE`` and ``bench --tuned`` consume. Every stream-group
plan the winner implies is checked by the symbolic plan verifier first; the
tool exits 5 when one cannot be proven to realize its collective.
``--generation`` takes the interconnect model's rows (``h100`` among them;
``topo/model.py``). Two runs of the same arguments write byte-identical
files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _mesh_axes(args) -> dict:
    if args.cross > 1 or args.pod > 1:
        axes = {}
        if args.pod > 1:
            axes["pod"] = int(args.pod)
        axes["cross"] = int(args.cross)
        axes["local"] = int(args.local)
        return axes
    return {"data": int(args.local)}


def mlp3_params(dim: int, device="meta"):
    """The 3-layer MLP program's parameter tree (``layer<i>.w`` ``[dim,
    dim]``, ``layer<i>.b`` ``[dim]``, f32), the JAX tool's shape."""
    import torch

    return {
        f"layer{i}": {
            "w": torch.empty(dim, dim, dtype=torch.float32, device=device),
            "b": torch.empty(dim, dtype=torch.float32, device=device),
        }
        for i in range(3)
    }


def transformer_params(seq_len: int, d_model: int, n_heads: int, n_layers: int, vocab: int):
    """The port's f32 ``TransformerLM`` on the ``meta`` device. Pass the
    bench's dims (``--layers 12 --d-model 768 --vocab 32768 --seq-len
    1024``) for a tuning whose signature matches ``bench --model
    transformer``."""
    from ..models.transformer import TransformerLM

    return TransformerLM(vocab_size=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                         max_len=seq_len, device="meta")


def _build_spec(args, mesh_axes: dict):
    from .. import tune as T

    if args.program == "mlp3":
        params = mlp3_params(args.dim)
    else:
        params = transformer_params(args.seq_len, args.d_model, args.heads, args.layers,
                                    args.vocab)
    return T.spec_from_params(args.program, params, mesh=mesh_axes), params


def _measure_fn_for(args):
    """The concrete-step timer of ``--measure``: the ``mlp3`` program's DP
    step (SGD 0.01, overlap on) built with each candidate's knobs, on one
    rank on the card (``--device``), timed over ``--measure-reps`` steps
    after one warm step; the median. The free objectives still run: this
    only replaces the score."""
    import time

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    from .. import tune as T
    from ..common.basics import resolve_device

    if args.program != "mlp3":
        raise SystemExit(
            "--measure supports --program mlp3 (the transformer program's measured "
            "path is python -m horovod_tpu_torch.bench --model transformer --tuned)")
    dev = resolve_device(args.device)
    if not hvd.is_initialized():
        from .launch import STORE_DIR_VAR, store_url

        hvd.init(dev, init_method=store_url() if STORE_DIR_VAR in os.environ else None)
    dev = hvd.device()
    n = hvd.size()
    dim = args.dim
    rng = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rng.randn(2 * n, dim).astype(np.float32)).to(dev)
                  for _ in range(2))

    def loss_fn(p, b):
        h = b[0]
        for i in range(3):
            h = torch.tanh(h @ p[f"layer{i}"]["w"] + p[f"layer{i}"]["b"])
        return (h - b[1]).pow(2).mean()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def measure(config) -> float:
        cfg = T.TunedConfig(knobs=dict(config), signature={}, objectives={}, baseline={})
        params = {k: {n_: torch.nn.Parameter(torch.full_like(t, 0.01, device=dev))
                      for n_, t in v.items()} for k, v in mlp3_params(dim, dev).items()}
        leaves = [p for v in params.values() for p in v.values()]
        step = hvd.make_train_step(loss_fn, torch.optim.SGD(leaves, lr=0.01), overlap=True,
                                   tuned=False, **T.tuned_step_kwargs(cfg))
        step(params, batch)           # warm
        sync()
        ts = []
        for _ in range(args.measure_reps):
            t0 = time.perf_counter()
            step(params, batch)
            sync()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    return measure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Offline GP/EI tuner for the compiled path: emit a pinned tuned.json")
    ap.add_argument("--program", default="mlp3", choices=["mlp3", "transformer"],
                    help="program to tune: the 3-layer MLP or the TransformerLM")
    ap.add_argument("--dim", type=int, default=512, help="mlp3 hidden width")
    ap.add_argument("--seq-len", type=int, default=64, help="transformer sequence length")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--samples", type=int, default=16,
                    help="GP/EI sample budget (incl. the default baseline and the corner "
                         "seeds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="tuned.json")
    ap.add_argument("--local", type=int, default=8,
                    help="interconnect model: ranks on the inner hop (NVLink on an H100 "
                         "node); with --cross 1 this is a flat data mesh")
    ap.add_argument("--cross", type=int, default=1,
                    help="ranks on the network hop across nodes (>1 = hierarchical)")
    ap.add_argument("--pod", type=int, default=1, help="ranks on the outermost hop")
    ap.add_argument("--generation", default="generic",
                    help="row of the alpha-beta cost table (h100/v3/v4/v5e/v5p/v6e/generic; "
                         "topo/model.py)")
    ap.add_argument("--wire", default="auto", choices=["auto", "f32", "int8"],
                    help="restrict the wire-dtype dim: 'f32' pins full precision (the tuned "
                         "step stays bitwise the untuned one), 'auto' searches both")
    ap.add_argument("--measure", action="store_true",
                    help="score samples by measured mlp3 step time on --device (free "
                         "objectives still recorded)")
    ap.add_argument("--measure-reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="--measure: cpu, or the card (default)")
    ap.add_argument("--calibration", default=None,
                    help="price the search with measured per-hop constants from a "
                         "calibration.json (python -m horovod_tpu_torch.tools.fleet_sim "
                         "--calibrate); a stale hop-ladder signature warns loudly and the "
                         "search runs on generation defaults")
    ap.add_argument("--zero1", action="store_true",
                    help="tune the streamed-ZeRO-1 reduction shape: groups priced as "
                         "reduce-scatter + parameter all-gather, 'split' dropped, the RS and "
                         "AG plans verified before pinning")
    ap.add_argument("--fixed-comm-us", type=float, default=0.0,
                    help="constant per-step communication outside the DP staircase (the "
                         "composed DP x TP psum term, sim.tp_fixed_comm_us), priced into "
                         "every objective")
    args = ap.parse_args(argv)

    from .. import tune as T
    from ..common.quant import WIRE_INT8
    from ..topo.model import synthetic_model

    model = synthetic_model(local=args.local, cross=args.cross, pod=args.pod,
                            generation=args.generation)
    mesh_axes = _mesh_axes(args)
    spec, _ = _build_spec(args, mesh_axes)
    space = T.space_for_model(model, allow_int8=args.wire != "f32", zero1=args.zero1)
    if args.wire == "int8":
        # Pin the wire dim at int8 by seeding the default there: the space
        # still carries the dim, the default just starts from it.
        space = T.SearchSpace(topo_choices=space.topo_choices, allow_int8=True)

    measure_fn = _measure_fn_for(args) if args.measure else None
    try:
        cfg = T.tune(spec, model, samples=args.samples, seed=args.seed, space=space,
                     measure_fn=measure_fn, zero1=args.zero1, calibration=args.calibration,
                     fixed_comm_us=args.fixed_comm_us)
    except T.TuneVerificationError as e:
        print(f"[autotune] {e}", file=sys.stderr)
        return 5
    if args.wire == "int8" and cfg.knobs.get("wire_dtype") != WIRE_INT8:
        print("[autotune] note: --wire int8 requested but the objective preferred f32 at "
              "this payload; emitting the winner", file=sys.stderr)
    T.save_tuned(cfg, args.out)
    keys = ("n_groups", "cost_us", "exposed_us", "wire_bytes")
    print(json.dumps({
        "program": spec.name,
        "zero1": bool(args.zero1),
        "calibration": cfg.search.get("calibration"),
        "out": args.out,
        "signature": cfg.signature_hash,
        "samples": cfg.search["samples"],
        "knobs": cfg.knobs,
        "objectives": {k: cfg.objectives[k] for k in keys},
        "baseline": {k: cfg.baseline[k] for k in keys},
    }), flush=True)
    if measure_fn is not None:
        import horovod_tpu_torch as hvd

        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
