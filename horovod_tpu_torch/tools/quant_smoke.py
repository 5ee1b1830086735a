"""Quantized-wire smoke: the streamed int8 step against the post-hoc one,
its wire, and a byte-stable log. Budget: under 15 s on the CPU.

    python -m horovod_tpu_torch.tools.quant_smoke               # 2 cards
    python -m horovod_tpu_torch.tools.quant_smoke --device cpu  # 2 gloo ranks

The counterpart of ``tools/quant_smoke.py``, on 2 ranks (one process a
rank, in place of the reference's 2-device virtual mesh): the reference's
3-layer tanh MLP (D 16, seed 7), SGD 0.05, per-leaf buckets
(``fusion_threshold_bytes=1``, ``first_bucket_bytes=1``), rank r on rows
4r..4r+3 of the 8-row batch, 4 steps.

1. streamed-quantized step: ``DistributedOptimizer(overlap=True,
   quantized=True)`` with error feedback; its residual must be nonzero after
   the steps (error feedback live);
2. parity: the post-hoc quantized step with the same bucket plan matches it
   bitwise, losses, parameters and residuals (one reduction,
   ``ops/fusion.quantized_ef_allreduce``, two call sites);
3. wire (the reference reads the lowered HLO's collective-permutes): one
   streamed step runs under the graph lint's recorder
   (``analysis/graph_lint.record``), and every ``ppermute`` it issued (the
   int8 ring's hops) must carry int8, with no float all-reduce of a
   gradient. ``collective_permutes`` counts the hops one step issues (2 x
   (n - 1) a bucket), where the reference counts HLO instructions;
4. byte-stable log: the per-step losses, the parameters' and residuals'
   digests and the wire report, serialized; the job runs twice and the two
   logs must be equal.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .smoke_common import (check, init_worker, launch_workers, main_guard, mlp3, mse,
                           need_ranks, parse_args, tensor_digest, write_result)

D = 16
STEPS = 4
RANKS = 2


def build(dev, seed: int = 7):
    """The reference's parameters and batch: (module, (x, y))."""
    import torch

    rng = np.random.RandomState(seed)
    model = mlp3(D, dev, rng, 0.3)
    batch = tuple(torch.from_numpy(rng.randn(8, D).astype(np.float32)).to(dev)
                  for _ in range(2))
    return model, batch


def _step(model, overlap: bool, **kw):
    import torch

    import horovod_tpu_torch.train as T

    opt = T.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05), named_parameters=model.named_parameters(),
        overlap=overlap, quantized=True, error_feedback=True, fusion_threshold_bytes=1,
        first_bucket_bytes=1, tuned=False, **kw)
    return T.make_train_step(mse, opt)


def wire_report(sites) -> dict:
    """The recorded step's wire: its ring hops and their dtypes."""
    perms = [s for s in sites if s.primitive == "ppermute"]
    return {"collective_permutes": len(perms),
            "permute_dtypes": sorted({s.dtype for s in perms}),
            "float_gradient_allreduces": sum(
                1 for s in sites if s.kind == "allreduce" and s.nbytes > 4
                and s.dtype.startswith(("float", "bfloat")))}


def check_wire(report: dict) -> None:
    """Gate 3: int8 hops only, and some."""
    check(report["collective_permutes"] > 0, "no ring hop in the quantized streamed step")
    check(report["permute_dtypes"] == ["int8"],
          f"non-int8 wire payloads: {report['permute_dtypes']}")
    check(report["float_gradient_allreduces"] == 0,
          f"{report['float_gradient_allreduces']} float gradient all-reduces on the int8 wire")


def worker(args) -> int:
    hvd = init_worker(args.device)
    try:
        logs = [run_once(hvd) for _ in range(2)]
        check(logs[0] == logs[1], f"quantized smoke is not byte-stable across runs:\n{logs}")
        if hvd.rank() == 0:
            write_result(args.out, json.loads(logs[0]))
    finally:
        hvd.shutdown()
    return 0


def run_once(hvd) -> str:
    """One pass on an initialized job: the normalized log."""
    import copy

    import torch

    from horovod_tpu_torch.analysis.graph_lint import record
    from horovod_tpu_torch.common.quant import int8_saved_bytes

    dev, r = hvd.device(), hvd.rank()
    model, (x, y) = build(dev)
    rows = slice(4 * r, 4 * r + 4)
    batch = (x[rows], y[rows])
    twin = copy.deepcopy(model)
    stream, posthoc = _step(model, True), _step(twin, False)
    events, report = [], None
    for i in range(STEPS):
        if i == STEPS - 1:
            with record() as rec:
                ls = stream(model, batch)
            report = wire_report(rec.sites)
        else:
            ls = stream(model, batch)
        lp = posthoc(twin, batch)
        check(float(ls) == float(lp), f"step {i}: streamed loss {float(ls)} != "
              f"posthoc {float(lp)}")
        events.append({"step": i, "loss": f"{float(ls):.9e}"})
    for (n, a), b in zip(model.named_parameters(), twin.parameters()):
        check(torch.equal(a, b), f"{n}: streamed and posthoc parameters differ")
    res_s, res_p = stream.optimizer.residual, posthoc.optimizer.residual
    for a, b in zip(res_s, res_p):
        check(torch.equal(a, b), "streamed and posthoc residuals differ")
    check(sum(float(e.abs().sum()) for e in res_s) > 0,
          "EF residual stayed zero: error feedback dead")
    check_wire(report)
    n_grad_bytes = 4 * sum(p.numel() for p in model.parameters())
    log = {"events": events, "params_digest": tensor_digest(model.parameters()),
           "residual_digest": tensor_digest(res_s), **report,
           "gradient_bytes": n_grad_bytes,
           "bytes_saved_per_round": int8_saved_bytes(n_grad_bytes)}
    return json.dumps(log, sort_keys=True)


def main(argv=None) -> int:
    args = parse_args(__doc__.split("\n")[0], argv, worker=True)
    if args.worker:
        return worker(args)
    code = need_ranks(RANKS, args.device, "quant")
    if code is not None:
        return code

    def body():
        t0 = time.time()
        doc = launch_workers("horovod_tpu_torch.tools.quant_smoke", RANKS, args.device)
        print(f"[quant-smoke] OK in {time.time() - t0:.1f}s: {STEPS} streamed==posthoc steps "
              f"bitwise, EF live, {doc['collective_permutes']} int8 hops a step, "
              f"{doc['bytes_saved_per_round']}/{doc['gradient_bytes']} bytes saved per round, "
              "log byte-stable")

    return main_guard("quant", body)


if __name__ == "__main__":
    sys.exit(main())
