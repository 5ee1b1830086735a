"""Composed DP x TP smoke: the GPT rule table preflighted clean, the
composed step training with streamed ZeRO-1 and the int8 wire on the data
axis, the per-axis wire bytes, a byte-stable log. Budget: under 30 s on
the CPU.

    python -m horovod_tpu_torch.tools.llm_smoke               # 4 cards
    python -m horovod_tpu_torch.tools.llm_smoke --device cpu  # 4 gloo ranks

The counterpart of ``tools/llm_smoke.py``, on a (data 2, model 2) mesh of
4 ranks, one process a rank: the port's ``TransformerLM`` (vocab 128, d 32,
2 heads, 2 layers, T 16, f32, seed 0), the global batch of 4 sequences
(seed 7), AdamW 1e-3.

1. preflight: the shipped ``gpt`` rule table places the real model's tree
   on the mesh with no finding (``analysis/preflight.check_sharding_rules``);
2. the composed step trains: ``make_train_step(rules="gpt", overlap=True,
   zero1=True, quantized=True)`` (streamed per-bucket reduce-scatter over
   the int8 ring on the data axis, Megatron psums on the model axis), the
   loss lower after the 4 steps than before; and the f32 composed zero1
   trajectory matches the plain composed step (the last loss within 1e-3,
   relative);
3. per-axis wire bytes: ``hvd_axis_wire_bytes_total`` is nonzero on both
   axes, the model axis carried by plain psums only;
4. byte-stable log: the int8 zero1 losses, this rank's final parameter
   digest and the per-axis counters, serialized; the job runs twice and the
   two logs must be equal.

The JAX composed step fails under JAX 0.9's ``check_vma`` (the reference
smoke is red here), so, as ``tests/test_torch_composed_variants.py`` does,
the port's composed step is held to its own plain composed step (gate 2)
and to the properties the reference smoke states, not to a JAX run.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .smoke_common import (check, init_worker, launch_workers, main_guard, need_ranks,
                           parse_args, tensor_digest, write_result)

VOCAB, D, HEADS, LAYERS, T = 128, 32, 2, 2, 16
STEPS = 4
RANKS = 4


def check_axis_bytes(axis: dict) -> None:
    """Gate 3 over ``{'hvd_axis_wire_bytes_total{axis=..,collective=..}':
    bytes}``."""
    data_b = sum(v for k, v in axis.items() if 'axis="data"' in k)
    model_b = sum(v for k, v in axis.items() if 'axis="model"' in k)
    check(data_b > 0 and model_b > 0, f"per-axis wire bytes not on both axes: {axis}")
    check(all('collective="psum"' in k for k in axis if 'axis="model"' in k),
          f"the model axis carried more than plain psums: {axis}")


def worker(args) -> int:
    import torch

    import horovod_tpu_torch.metrics as metrics
    from horovod_tpu_torch.analysis.preflight import check_sharding_rules
    from horovod_tpu_torch.models.transformer import TransformerLM, make_gpt_loss_fn
    from horovod_tpu_torch.ops.fusion import tree_leaves
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.train import make_train_step
    from horovod_tpu_torch.utils.convert import local_params_from_flax, params_to_numpy

    hvd = init_worker(args.device)
    try:
        dev, r = hvd.device(), hvd.rank()
        mesh = build_mesh({"data": 2, "model": 2})
        model = TransformerLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                              max_len=T, dtype=torch.float32, device=dev, seed=0)
        flat = params_to_numpy(model)
        findings = check_sharding_rules("gpt", mesh, {k: v.shape for k, v in flat.items()})
        check(not findings, f"the gpt rule table has findings on the mesh: {findings}")
        rng = np.random.RandomState(7)
        batch = tuple(torch.from_numpy(rng.randint(0, VOCAB, (4, T))).to(dev) for _ in range(2))
        loss_fn = make_gpt_loss_fn(HEADS, model_axis="model", dtype=torch.float32)

        def build(**kw):
            params = local_params_from_flax(flat, "gpt", mesh, device=dev)
            opt = torch.optim.AdamW(tree_leaves(params), lr=1e-3, weight_decay=1e-4, eps=1e-8)
            return make_train_step(loss_fn, opt, mesh=mesh, rules="gpt", **kw), params

        metrics.install(True)
        step_q, pq = build(overlap=True, zero1=True, quantized=True)
        losses_q = [round(float(step_q(pq, batch)), 6) for _ in range(STEPS)]
        check(losses_q[-1] < losses_q[0], f"the composed int8 zero1 step did not train: "
              f"{losses_q}")
        axis = {k: round(v, 1) for k, v in sorted(metrics.flat().items())
                if "hvd_axis_wire_bytes_total" in k}
        metrics.install(False)
        check_axis_bytes(axis)
        step_q.close()
        if args.parity:
            step_f, pf = build(overlap=True, zero1=True)
            step_p, pp = build()
            for _ in range(STEPS):
                lf, lp = float(step_f(pf, batch)), float(step_p(pp, batch))
            check(abs(lf - lp) < 1e-3 * max(abs(lp), 1.0),
                  f"f32 composed zero1 {lf} left the plain composed step {lp}")
        log = {"schema": 1, "losses_int8_zero1": losses_q,
               "final_params_digest": tensor_digest(tree_leaves(pq))[:16],
               "axis_wire_bytes": axis}
        if r == 0:
            write_result(args.out, log)
    finally:
        hvd.shutdown()
    return 0


def _extra(ap):
    ap.add_argument("--parity", action="store_true", help="(worker) run gate 2's f32 pair")


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv, _extra, worker=True)
    if args.worker:
        return worker(args)
    code = need_ranks(RANKS, args.device, "llm")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        mod = "horovod_tpu_torch.tools.llm_smoke"
        log1 = json.dumps(launch_workers(mod, RANKS, args.device, ["--parity"]), sort_keys=True)
        log2 = json.dumps(launch_workers(mod, RANKS, args.device), sort_keys=True)
        check(log1 == log2, f"normalized event logs differ between runs:\n{log1}\n{log2}")
        print(f"llm_smoke: OK in {time.time() - t0:.1f}s — {log1}")

    return main_guard("llm", body)


if __name__ == "__main__":
    sys.exit(main())
