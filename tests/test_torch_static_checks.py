"""Passes 1 and 4 in the port, and C5: the recorded collective lint
(``analysis/graph_lint.py``), rank divergence (``analysis/divergence.py``)
and a rebuilt ``overlap=True`` step's hooks.

One spawned run of 4 gloo ranks (``torch_port_harness.run_ranks``) records
everything; the tests compare it with the JAX package on the same inputs:

- divergence: torch programs equivalent to ``tests/test_divergence.py``'s
  (a collective under a rank-dependent branch, switch and loop, a laundered
  predicate; the agreed flag, a collective-free branch, a branch over a
  disjoint axis, a fixed trip count, ``axis_index`` as data) give the rule
  ids over the axes JAX's taint analysis gives on the JAX programs;
- the recorded inventory of the small DP step (2 layers, d_model 64, a
  16 KiB threshold), post hoc, ``overlap`` and ``nonfinite="skip"``, equals
  ``jaxpr_lint.collect_collectives`` of the JAX step at the same size and
  threshold (kind, axes, dtype and bytes of every collective), and lints
  clean; an unbound group, a fused bucket over its budget and a streamed
  step under ``skip`` without the agreement seam are each flagged;
- C5: the overlap step built N times leaves one build's hooks and launches
  one build's collectives a step, with and without ``close()``; a closed
  step raises.
"""

import json

import jax
import jax.numpy as jnp
import optax
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

import horovod_tpu.jax as hvdj
from horovod_tpu import analysis as ref
from horovod_tpu.jax import _shard_map
from horovod_tpu.parallel.mesh import build_mesh as ref_build_mesh

from torch_port_harness import GPT_DIMS, GPT_THRESHOLD, gpt_setup, run_ranks

WORKER = r'''
import json, os
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch import analysis
from horovod_tpu_torch.analysis.graph_lint import inventory
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel.mesh import build_mesh

d = os.environ["HVD_TEST_DIR"]
hvd.init("cpu", init_method=f"file://{d}/store")
r = hvd.rank()
cfg = json.load(open(f"{d}/cfg.json"))
mesh = build_mesh({"data": 4})
grid = build_mesh({"cross": 2, "local": 2})
local = grid.get_group("local")
cross_index = grid.get_local_rank("cross")
x = torch.ones(8, 4)

def cond(v):
    return C.allreduce(v) if r == 0 else v
def switch(v):
    return C.allreduce(v) if r % 2 == 0 else v * 2
def loop(v):
    for _ in range(r):
        v = v + C.allreduce(v)
    return v
def laundered(v):
    return C.allreduce(v, op=hvd.Max) if (r * 3 + 1) % 5 > 2 else v
def seam(v):
    agreed = C.allreduce(torch.tensor([1.0 if r == 0 else 0.0]))
    return C.allreduce(v) if float(agreed) > 0 else v
def collective_free(v):
    return v * 2 if r == 0 else v
def disjoint(v):
    op = hvd.Sum if cross_index == 0 else hvd.Max
    return C.allreduce(v, op=op, group=local)
def fixed_loop(v):
    for _ in range(3):
        v = v + C.allreduce(v)
    return v
def straight_line(v):
    return C.ring_shift(v) + r

out = {"divergence": {}, "inventory": {}, "lint": {}, "c5": {}}
programs = dict(cond=cond, switch=switch, loop=loop, laundered=laundered, seam=seam,
                collective_free=collective_free, disjoint=disjoint, fixed_loop=fixed_loop,
                straight_line=straight_line)
for name, fn in programs.items():
    fs = analysis.analyze_step(fn, x, timeout_s=30)
    out["divergence"][name] = sorted([f.rule, f.details["tainted_axes"]] for f in fs)
out["lint_step_folds"] = sorted({f.rule for f in analysis.lint_step(cond, x, mesh=mesh)})
out["lint_step_clean"] = [f.rule for f in analysis.lint_step(seam, x, mesh=mesh,
                                                             divergence=False)]
# A group that is no axis of the step's mesh.
pair = dist.new_group([0, 1])
fs = analysis.lint_step(lambda v: C.allreduce(v, group=pair) if r < 2 else v, x, mesh=mesh)
out["unbound"] = sorted({(f.rule, f.details.get("axis", "")) for f in fs})

model = TransformerLM(**cfg["dims"], dtype=torch.float32, device="cpu", seed=0)
tok = torch.zeros(2, cfg["dims"]["max_len"], dtype=torch.long)
loss = lambda m, b: lm_loss(m(b[0]), b[1])

def build(**kw):
    return hvd.make_train_step(loss, torch.optim.AdamW(model.parameters(), lr=1e-3),
                               fusion_threshold_bytes=cfg["threshold"], **kw)

for variant, kw in cfg["variants"].items():
    step = build(**kw)
    step(model, (tok, tok))
    fs = analysis.lint_step(step, model, (tok, tok), mesh=mesh,
                            fusion_threshold_bytes=cfg["threshold"])
    with analysis.record(mesh) as rec:
        step(model, (tok, tok))
    out["inventory"][variant] = inventory(rec.sites)
    out["lint"][variant] = [f.render() for f in fs]
    if variant == "posthoc":
        small = analysis.lint_sites(rec.sites, mesh=mesh, fusion_threshold_bytes=1024)
        out["over_budget"] = sorted({f.rule for f in small})
    step.close()

# The skip rule: a streamed reduction without the agreement seam, and the
# optimizer's step, which runs it.
def hand_rolled():
    stream = fusion.stream_param_groups(dict(model.named_parameters()),
                                        lambda gi, g: C.allreduce(torch.cat([t.reshape(-1) for t in g])))
    loss(model, (tok, tok)).backward()
    stream.finish()
    stream.remove()
out["skip_rule"] = sorted({f.rule for f in analysis.lint_step(hand_rolled, nonfinite="skip")})
skip_step = build(overlap=True, nonfinite="skip")
out["skip_rule_optimizer"] = [f.rule for f in analysis.lint_step(skip_step, model, (tok, tok),
                                                                  nonfinite="skip")]
skip_step.close()

# C5: N builds of the overlap step over one model.
def sites_a_step(step):
    with analysis.record() as rec:
        step(model, (tok, tok))
    return len(rec.sites)

for close in (False, True):
    steps, per_step = [], []
    for i in range(cfg["rebuilds"]):
        if close and steps:
            steps[-1].close()
        steps.append(build(overlap=True))
        steps[-1](model, (tok, tok))
        per_step.append(sites_a_step(steps[-1]))
    regs = fusion.stream_registrations(model.parameters())
    try:
        steps[0](model, (tok, tok))
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    out["c5"][str(close)] = dict(per_step=per_step, regs=regs, raised=raised,
                                 groups=list(steps[-1].optimizer.streamed_groups))
    steps[-1].close()
    out["c5"][str(close)]["after_close"] = fusion.stream_registrations(model.parameters())
    try:
        steps[-1](model, (tok, tok))
        out["c5"][str(close)]["closed_raises"] = ""
    except RuntimeError as e:
        out["c5"][str(close)]["closed_raises"] = str(e)
out["n_tensors"] = len(list(model.parameters()))
if r == 0:
    json.dump(out, open(f"{d}/out.json", "w"))
hvd.shutdown()
'''

VARIANTS = {"posthoc": {}, "overlap": {"overlap": True}, "skip": {"nonfinite": "skip"}}
REBUILDS = 3


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    d = tmp_path_factory.mktemp("static_checks")
    with open(d / "cfg.json", "w") as f:
        json.dump({"dims": GPT_DIMS, "threshold": GPT_THRESHOLD, "variants": VARIANTS,
                   "rebuilds": REBUILDS}, f)
    run_ranks(WORKER, 4, d, timeout=300)
    with open(d / "out.json") as f:
        return json.load(f)


# --- divergence: the JAX programs ------------------------------------------------


def _data_mesh():
    return ref_build_mesh({"data": len(jax.devices())})


def _jax_programs():
    def cond(v):
        return lax.cond(lax.axis_index("data") == 0, lambda u: lax.psum(u, "data"),
                        lambda u: u, v)

    def switch(v):
        return lax.switch(lax.axis_index("data") % 2,
                          [lambda u: lax.psum(u, "data"), lambda u: u * 2], v)

    def loop(v):
        r = lax.axis_index("data")
        return lax.while_loop(lambda c: c[0] < r,
                              lambda c: (c[0] + 1, c[1] + lax.psum(c[1], "data")), (0, v))[1]

    def laundered(v):
        derived = (lax.axis_index("data") * 3 + 1) % 5
        return lax.cond(derived > 2, lambda u: lax.pmax(u, "data"), lambda u: u, v)

    def seam(v):
        agreed = lax.psum((lax.axis_index("data") == 0).astype(jnp.float32), "data")
        return lax.cond(agreed > 0, lambda u: lax.psum(u, "data"), lambda u: u, v)

    def collective_free(v):
        return lax.cond(lax.axis_index("data") == 0, lambda u: u * 2, lambda u: u, v)

    def fixed_loop(v):
        return lax.fori_loop(0, 3, lambda i, c: c + lax.psum(c, "data"), v)

    def straight_line(v):
        n = len(jax.devices())
        return lax.ppermute(v, "data", [(i, (i + 1) % n) for i in range(n)]) \
            + lax.axis_index("data").astype(v.dtype)

    def disjoint(v):
        return lax.cond(lax.axis_index("cross") == 0, lambda u: lax.psum(u, "local"),
                        lambda u: lax.pmax(u, "local"), v)

    out = {k: v for k, v in locals().items() if callable(v)}
    return out


@pytest.fixture(scope="module")
def jax_divergence():
    got = {}
    for name, fn in _jax_programs().items():
        if name == "disjoint":
            mesh = ref_build_mesh({"cross": 2, "local": 4})
            step = _shard_map(fn, mesh, in_specs=(P("cross"),), out_specs=P("cross"))
        else:
            step = _shard_map(fn, _data_mesh(), in_specs=(P("data"),), out_specs=P("data"))
        fs = ref.analyze_step(step, jnp.ones((8, 4)))
        got[name] = sorted([f.rule, f.details["tainted_axes"]] for f in fs)
    return got


@pytest.mark.parametrize("name", ["cond", "switch", "loop", "laundered", "seam",
                                  "collective_free", "disjoint", "fixed_loop",
                                  "straight_line"])
def test_divergence_matches_jax(recorded, jax_divergence, name):
    assert recorded["divergence"][name] == jax_divergence[name]
    assert bool(recorded["divergence"][name]) == (name in ("cond", "switch", "loop",
                                                           "laundered"))


def test_lint_step_folds_divergence_in(recorded):
    assert "rank-divergent-collective" in recorded["lint_step_folds"]
    assert recorded["lint_step_clean"] == []


def test_unbound_group_is_an_unknown_axis(recorded):
    assert recorded["unbound"] == [["unknown-axis", "ranks:0,1"]]


# --- the recorded inventory against the jaxpr ---------------------------------------


@pytest.fixture(scope="module")
def jax_inventory():
    model, params, tokens, labels = gpt_setup()
    mesh = ref_build_mesh({"data": 2}, devices=jax.devices()[:2])

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch[0])
        return optax.softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()

    tx = optax.adamw(1e-3)
    out = {}
    for name, kw in VARIANTS.items():
        step = hvdj.make_train_step(loss_fn, tx, mesh, fusion_threshold_bytes=GPT_THRESHOLD,
                                    donate=False, **kw)
        jx = jax.make_jaxpr(step)(params, tx.init(params),
                                  (jnp.asarray(tokens), jnp.asarray(labels)))
        out[name] = sorted([s.kind, list(s.axes), s.dtype, s.nbytes]
                           for s in ref.collect_collectives(jx))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_recorded_inventory_equals_the_jaxpr(recorded, jax_inventory, variant):
    got = sorted(list(map(lambda x: [x[0], list(x[1]), x[2], x[3]], recorded["inventory"][variant])))
    assert got == jax_inventory[variant]
    assert len(got) > 3
    assert recorded["lint"][variant] == []


def test_fusion_budget_and_skip_rule(recorded):
    assert recorded["over_budget"] == ["fusion-over-budget"]
    assert recorded["skip_rule"] == ["guard-skip-no-agreement"]
    assert recorded["skip_rule_optimizer"] == []


# --- C5 -----------------------------------------------------------------------------


@pytest.mark.parametrize("close", [False, True])
def test_c5_rebuilt_overlap_step_keeps_one_builds_hooks(recorded, close):
    rec = recorded["c5"][str(close)]
    n = recorded["n_tensors"]
    # One build's collectives in every build's steady step, one build's hooks.
    assert len(set(rec["per_step"])) == 1 and len(rec["per_step"]) == REBUILDS
    assert rec["regs"] == {"calls": 1, "leaves": n, "hooks": n}
    assert rec["groups"][0] == rec["groups"][2] >= 1
    # The replaced step raises, and so does the last one once closed.
    assert "closed" in rec["raised"] and "closed" in rec["closed_raises"]
    assert rec["after_close"] == {"calls": 0, "leaves": 0, "hooks": 0}
