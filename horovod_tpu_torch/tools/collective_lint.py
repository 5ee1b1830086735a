"""The collective-safety static checks as a CLI: the port of ``tools/collective_lint.py``.

    python -m horovod_tpu_torch.tools.collective_lint all
    python -m horovod_tpu_torch.tools.collective_lint --json plans
    python -m horovod_tpu_torch.tools.collective_lint divergence

The targets, each a pass of ``horovod_tpu_torch.analysis``:

 - ``examples``: Pass 1 with Pass 4 folded in over the train steps the
   port's example copies build (``horovod_tpu_torch/examples/``): the MNIST
   CNN's ``make_train_step`` under SGD and under Adasum, its hierarchical
   step over a (cross 2, local 2) mesh, each recorded on 4 gloo ranks and
   linted (``graph_lint.lint_step``), and two simulated ranks of the eager
   MNIST loop's submission order (``ordering``);
 - ``runtime``: Pass 2, the lock-discipline lint over the port's threaded
   sources (``runtime_lint``);
 - ``plans``: Pass 3, every candidate plan of the topology compositor
   verified symbolically (``plan_verify``); no process group;
 - ``divergence``: Pass 4 over the port's shipped step variants on 4 gloo
   ranks: the DP step post hoc, ``overlap``, ``hierarchical="auto"``,
   ``nonfinite="skip"``, ``quantized`` with ``overlap`` and ZeRO-1 with
   ``overlap``, then the composed DP×TP, sequence-, pipeline- and
   expert-parallel steps; every one must report zero findings;
 - ``sharding``: Pass 5, the shipped GPT rule table against its reference
   mesh and the model's parameter shapes; no process group;
 - ``all``: every pass.

The ranks of ``examples`` and ``divergence`` are processes this CLI starts
on the CPU (``tools/launch.py``; one start for both under ``all``).

Exit status: 0 clean, 1 findings, 2 the analyzer crashed. ``--json``
prints the versioned document (``schema_version`` 2: sorted findings, a
deterministic key order, the pass inventory), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback

import torch

SCHEMA_VERSION = 2
EXIT_CLEAN, EXIT_FINDINGS, EXIT_CRASH = 0, 1, 2
TARGETS = ("examples", "runtime", "plans", "divergence", "sharding", "all")
RANKS = 4

# The shipped step variants of the DP step (make_train_step's options).
DP_VARIANTS = (
    ("posthoc", {}),
    ("overlap", {"overlap": True}),
    ("hierarchical-auto", {"hierarchical": "auto"}),
    ("guard-skip", {"nonfinite": "skip"}),
    ("quantized-overlap", {"overlap": True, "quantized": True}),
    ("zero1-overlap", {"overlap": True, "zero1": True}),
)
GPT_DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, max_len=32)


# --- the passes without ranks ------------------------------------------------------


def _lint_runtime():
    from horovod_tpu_torch.analysis import lint_runtime

    return lint_runtime()


def _lint_plans():
    from horovod_tpu_torch.analysis.plan_verify import verify_plan_grid

    findings, verified = verify_plan_grid()
    for f in findings:
        f.location = f"plans:{f.location}"
    return findings, verified


def _lint_sharding():
    from horovod_tpu_torch.analysis.sharding_rules import (
        EXAMPLE_GPT_MESH, EXAMPLE_GPT_RULES, example_gpt_params, validate_sharding_rules)

    findings = validate_sharding_rules(EXAMPLE_GPT_RULES, EXAMPLE_GPT_MESH, example_gpt_params())
    for f in findings:
        f.location = f"sharding:{f.location}"
    return findings


# --- the passes on ranks -------------------------------------------------------------


def _prefixed(findings, prefix: str):
    for f in findings:
        f.location = f"{prefix}/{f.location}"
    return findings


def _examples_on_ranks(threshold: int):
    """The example copies' compiled steps, recorded and linted on every
    rank, and the eager MNIST loop on two simulated ranks."""
    import numpy as np
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import analysis
    from horovod_tpu_torch.models.mnist_cnn import MnistCNN
    from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh, build_mesh

    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randn(8, 28, 28, 1).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, (8,))))

    def loss_fn(m, b):
        return F.cross_entropy(m(b[0]), b[1])

    findings = []
    mesh = build_mesh({"data": hvd.size()})
    hmesh = build_hierarchical_mesh(2)
    for label, m, kwargs in (("mnist_sgd", mesh, {}), ("mnist_adasum", mesh, {"op": hvd.Adasum}),
                             ("mnist_hierarchical", hmesh, {"hierarchical": True})):
        model = MnistCNN(device="cpu", seed=0)
        step = hvd.make_train_step(loss_fn, torch.optim.SGD(model.parameters(), lr=0.01),
                                   fusion_threshold_bytes=threshold, mesh=m, **kwargs)
        findings += _prefixed(analysis.lint_step(step, model, batch, mesh=m,
                                                 fusion_threshold_bytes=threshold),
                              f"examples:{label}")

    def eager_loop():
        grads = [np.ones((4, 4), np.float32) for _ in range(4)]
        handles = [hvd.allreduce_async(g, name=f"grad.{i}") for i, g in enumerate(grads)]
        for h in handles:
            hvd.synchronize(h)

    if hvd.rank() == 0:
        traces = analysis.simulate_ranks(eager_loop, 2)
        findings += _prefixed(analysis.check_cross_rank_order(traces), "examples:mnist_eager")
    return findings


class _Affine(torch.nn.Module):
    """The JAX CLI's ``{"w": [16, 4], "b": [4]}`` step body."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(16, 4))
        self.b = torch.nn.Parameter(torch.zeros(4))

    def forward(self, x):
        return x @ self.w + self.b


def _dp_variants():
    """(label, run) of each shipped DP variant, on the JAX CLI's body."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh

    hmesh = build_hierarchical_mesh(2)
    batch = torch.ones(8, 16)
    for label, kwargs in DP_VARIANTS:
        model = _Affine()
        kw = dict(kwargs)
        if label == "hierarchical-auto":
            kw["mesh"] = hmesh
        step = hvd.make_train_step(lambda m, b: ((m(b)) ** 2).mean(),
                                   torch.optim.SGD(model.parameters(), lr=0.01), **kw)
        yield label, (lambda s=step, m=model: s(m, batch))


def _parallel_variants():
    """(label, run) of the composed DP×TP, SP, PP and EP steps at toy
    widths on 4 ranks."""
    from functools import partial

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss, make_gpt_loss_fn
    from horovod_tpu_torch.ops.fusion import tree_leaves
    from horovod_tpu_torch.parallel.ep import make_ep_train_step
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    from horovod_tpu_torch.parallel.sp import make_sp_train_step
    from horovod_tpu_torch.tools import ep_parity, pp_parity
    from horovod_tpu_torch.utils.convert import (local_params_from_flax, params_to_numpy,
                                                 pp_params_from_flax)

    rng = np.random.RandomState(0)
    seq = GPT_DIMS["max_len"]
    tokens = torch.from_numpy(rng.randint(0, GPT_DIMS["vocab_size"], (4, seq)))
    labels = torch.roll(tokens, -1, dims=1)
    flat = params_to_numpy(TransformerLM(**GPT_DIMS, dtype=torch.float32, device="cpu", seed=0))

    tp_mesh = build_mesh({"data": 2, "model": 2})
    local = local_params_from_flax(flat, "gpt", tp_mesh, device="cpu")
    composed = hvd.make_train_step(
        make_gpt_loss_fn(GPT_DIMS["n_heads"], model_axis="model", dtype=torch.float32),
        torch.optim.SGD(tree_leaves(local), lr=0.1), mesh=tp_mesh, rules="gpt")
    yield "composed", lambda: composed(local, (tokens, labels))

    sp_mesh = build_mesh({"data": 2, "seq": 2})
    sp_model = TransformerLM(**GPT_DIMS, dtype=torch.float32, device="cpu", seed=0,
                             attn_fn=partial(ring_attention, group=sp_mesh.get_group("seq"),
                                             causal=True))
    sp = make_sp_train_step(lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
                            torch.optim.SGD(sp_model.parameters(), lr=0.1), sp_mesh)
    yield "sp", lambda: sp(sp_model, tokens, labels)

    pp_mesh = build_mesh({"stage": 2, "data": 2})
    pp_params = pp_params_from_flax(flat, 2, pp_mesh.get_local_rank("stage"), device="cpu")
    pp = pp_parity._gpt_step(pp_mesh, pp_params, torch.float32, GPT_DIMS["n_heads"],
                             lambda ps: torch.optim.SGD(ps, lr=0.1))
    micro = (tokens.reshape(2, 2, seq), labels.reshape(2, 2, seq))
    yield "pp", lambda: pp(pp_params, *micro)

    ep_mesh = build_mesh({"data": 2, "expert": 2})
    ep_params, ep_loss = ep_parity._model(ep_parity.DIMS, 2, ep_mesh.get_local_rank("expert"),
                                          torch.device("cpu"))
    ep = make_ep_train_step(ep_loss, torch.optim.SGD(tree_leaves(ep_params), lr=0.1), ep_mesh)
    ep_batch = tuple(torch.from_numpy(rng.randint(0, ep_parity.DIMS["vocab"], (64,)))
                     for _ in range(2))
    yield "ep", lambda: ep(ep_params, ep_batch)


def _divergence_on_ranks():
    """Pass 4 over every shipped variant, on every rank."""
    from horovod_tpu_torch import analysis

    findings = []
    for variants in (_dp_variants(), _parallel_variants()):
        for label, run in variants:
            findings += _prefixed(analysis.analyze_step(run), f"divergence:{label}")
    return findings


def rank_main(passes, threshold: int, out: str) -> int:
    """One rank of the rank passes; rank 0 writes the findings to ``out``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.tools.launch import store_url

    hvd.init("cpu", init_method=store_url())
    try:
        findings = []
        if "examples" in passes:
            findings += _examples_on_ranks(threshold)
        if "divergence" in passes:
            findings += _divergence_on_ranks()
        if hvd.rank() == 0:
            with open(out, "w") as f:
                json.dump([x.to_dict() for x in findings], f)
    finally:
        hvd.shutdown()
    return 0


def _on_ranks(passes, threshold: int):
    """Start the ranks of ``passes`` on the CPU and read rank 0's findings."""
    from horovod_tpu_torch.analysis.findings import Finding
    from horovod_tpu_torch.tools.launch import launch_ranks

    with tempfile.TemporaryDirectory(prefix="hvd_collective_lint_") as d:
        out = os.path.join(d, "findings.json")
        argv = ["--_rank-passes", ",".join(passes), "--_out", out, "--threshold", str(threshold),
                "all"]
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        code = launch_ranks("horovod_tpu_torch.tools.collective_lint", argv, RANKS)
        if code != 0 or not os.path.exists(out):
            raise RuntimeError(f"the lint's ranks exited {code}")
        with open(out) as f:
            return [Finding(**d) for d in json.load(f)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="collective_lint",
                                 description="Collective-safety static checks of the port")
    ap.add_argument("target", choices=TARGETS,
                    help="examples = Pass 1+4 over the example copies' steps; runtime = Pass 2 "
                         "over the threaded sources; plans = Pass 3 over the compositor's plan "
                         "grid; divergence = Pass 4 over the shipped step variants; sharding = "
                         "Pass 5 over the GPT rule table; all = everything")
    ap.add_argument("--json", action="store_true",
                    help=f"machine-readable output (schema_version {SCHEMA_VERSION})")
    ap.add_argument("--threshold", type=int, default=64 * 1024 * 1024,
                    help="fusion-buffer budget in bytes (default 64 MiB)")
    ap.add_argument("--_rank-passes", dest="rank_passes", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--_out", dest="out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_passes:
        return rank_main(args.rank_passes.split(","), args.threshold, args.out)

    from horovod_tpu_torch.analysis import findings_to_json, sort_findings

    findings, passes, plans_verified = [], [], 0
    want = lambda p: args.target in (p, "all")  # noqa: E731
    if want("plans"):
        fs, plans_verified = _lint_plans()
        findings += fs
        passes.append("plans")
    if want("sharding"):
        findings += _lint_sharding()
        passes.append("sharding")
    on_ranks = [p for p in ("examples", "divergence") if want(p)]
    if on_ranks:
        findings += _on_ranks(on_ranks, args.threshold)
        passes += on_ranks
    if want("runtime"):
        findings += _lint_runtime()
        passes.append("runtime")

    findings = sort_findings(findings)
    if args.json:
        print(findings_to_json(findings, target=args.target, schema_version=SCHEMA_VERSION,
                               passes=sorted(passes), plans_verified=plans_verified))
    else:
        for f in findings:
            print(f.render())
        extra = f", {plans_verified} plans verified" if "plans" in passes else ""
        print(f"collective_lint[{args.target}]: {len(findings)} finding(s){extra}")
    return EXIT_FINDINGS if findings else EXIT_CLEAN


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 - a crash is not a finding
        traceback.print_exc()
        print("collective_lint: analyzer crashed (exit 2, distinct from exit 1, findings)",
              file=sys.stderr)
        sys.exit(EXIT_CRASH)
