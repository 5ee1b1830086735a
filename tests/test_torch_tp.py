"""The port's tensor-parallel GPT and composed DP×TP step against the JAX package.

The reference tests' configuration (tests/test_composed.py: vocab 128, d 64,
4 heads, 2 layers, T 16, global batch 4, f32), the same flax initial weights
and tokens, gloo ranks on the CPU:

- classic and fused ``tp_apply(model_axis)`` logits at ``model 2`` and
  ``model 4`` against JAX's ``tp_apply(model_axis="model")`` under
  ``_shard_map(check=False)``, at 1e-5;
- the gathered gradients of every leaf against the gradients of JAX's dense
  ``tp_apply(model_axis=None)``, at rtol 1e-4 / atol 1e-5 (JAX's TP
  gradients under ``check=False`` are not the true ones);
- 3 AdamW steps of the composed ``make_train_step(rules="gpt")`` at
  ``data 2 x model 2``, classic and fused, against JAX's single-axis DP
  ``make_train_step`` at ``data 4`` with the dense loss
  (test_composed_matches_dp_reference: losses rtol 1e-4), parameters at
  rtol 2e-3 / atol 2e-5; and the port's fused step against its classic step
  within the reference's 5e-7 (test_composed_fused_matches_classic), its
  first-step gradients leaf by leaf at f32 rounding, and the few elements
  past 5e-7 after AdamW replayed from the recorded gradients;
- the rule table and ``local_shard_tree`` leaf for leaf against
  ``horovod_tpu/parallel/rules.py``, and the preflight;
- the data-group reduction (``fused_allreduce`` and ``DistributedOptimizer``
  with ``group=``): model ranks keep different shards, data ranks identical;
- the refusals: ``n_heads % n``, ``T % n``, the row bias shape, ``tp_overlap``
  without ``rules``, the composed step's rejections
  (test_tp_overlap_requires_rules and the reference builder's); the
  data-axis options build the composed step (their runs are in
  tests/test_torch_composed_variants.py).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import horovod_tpu.jax as hvdj
from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel import rules as ref_rules
from horovod_tpu.parallel.mesh import build_mesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import rules as port_rules
from horovod_tpu_torch.utils.convert import nest

from torch_port_harness import run_ranks

VOCAB, D, HEADS, LAYERS, T, B, STEPS = 128, 64, 4, 2, 16, 4, 3
FORMS = ("classic", "fused")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params():
    model = ref.TransformerLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                              max_len=T)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, VOCAB, (B, T)).astype(np.int32), rng.randint(0, VOCAB, (B, T)).astype(np.int32)


WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import lm_loss, make_gpt_loss_fn, tp_apply
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel import tp
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.parallel.rules import named_tree_paths
from horovod_tpu_torch.utils.convert import gather_params, local_params_from_flax, nest

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
flat = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
tokens, labels = torch.from_numpy(data["tokens"]).long(), torch.from_numpy(data["labels"]).long()
out = {}

def refused(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""

# tp_apply at model n: logits and the gathered gradients, classic and fused.
mesh = build_mesh({"model": n})
for form in ("classic", "fused"):
    params = local_params_from_flax(flat, "gpt", mesh, device="cpu")
    with tp.mesh_scope(mesh):
        logits = tp_apply(params, tokens, n_heads=cfg["heads"], model_axis="model",
                          dtype=torch.float32, tp_overlap=form == "fused")
    lm_loss(logits, labels).backward()
    out[f"logits_{form}"] = logits.detach()
    grads = nest({k: t.grad for k, t in named_tree_paths(params)})
    for k, g in named_tree_paths(gather_params(grads, "gpt", mesh)):
        out[f"grad_{form}:{k}"] = g
    # n_heads that does not split over the model axis: 2 heads of 32 over 4.
    if n == 4:
        out[f"refuse_heads_{form}"] = refused(lambda: tp_apply(
            params, tokens, n_heads=2, model_axis=mesh.get_group("model"),
            dtype=torch.float32, tp_overlap=form == "fused"))
T = tokens.shape[1]
short = tokens[:, :T - 1]
out["refuse_tokens"] = refused(lambda: tp_apply(
    local_params_from_flax(flat, "gpt", mesh, device="cpu"), short, n_heads=cfg["heads"],
    model_axis=mesh.get_group("model"), dtype=torch.float32, tp_overlap=True))
x = torch.ones(2, 4, 8)
w = torch.ones(8, 6)
out["refuse_bias"] = refused(lambda: tp.row_parallel(x, w, torch.ones(6),
                                                       axis_name=mesh.get_group("model")))
out["refuse_bias_fused"] = refused(lambda: tp.row_parallel_fused(
    torch.ones(2, 4 * n, 8), w, torch.ones(6), axis_name=mesh.get_group("model")))

if n == 4:
    mesh22 = build_mesh({"data": 2, "model": 2})
    # The data-group reduction: a value per (data, model) coordinate.
    di, mi = mesh22.get_local_rank("data"), mesh22.get_local_rank("model")
    mine = [torch.full((3,), 10.0 * mi + di), torch.full((2, 2), 100.0 * mi + 2 * di)]
    red = fusion.fused_allreduce(mine, group=mesh22.get_group("data"))
    out["fused_allreduce"] = torch.cat([t.reshape(-1) for t in red])
    p = torch.nn.Parameter(torch.zeros(4))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                   group=mesh22.get_group("data"))
    p.grad = torch.full((4,), float(10 * mi + di))
    opt.step()
    out["dist_opt"] = p.detach().clone()
    # 3 composed AdamW steps, classic and fused.
    for form in ("classic", "fused"):
        params = local_params_from_flax(flat, "gpt", mesh22, device="cpu")
        step = hvd.make_train_step(
            make_gpt_loss_fn(cfg["heads"], model_axis="model", dtype=torch.float32),
            torch.optim.AdamW([t for _, t in named_tree_paths(params)], lr=1e-3,
                              weight_decay=1e-4, eps=1e-8),
            mesh=mesh22, rules="gpt", tp_overlap=form == "fused")
        losses, grads = [], []
        for _ in range(cfg["steps"]):
            losses.append(float(step(params, (tokens, labels))))
            # The gradients this step's AdamW update used (data-averaged).
            grads.append(torch.cat([t.grad.reshape(-1) for _, t in named_tree_paths(params)]))
        out[f"losses_{form}"] = torch.tensor(losses)
        out[f"grads_{form}"] = torch.stack(grads)
        for k, v in named_tree_paths(gather_params(params, "gpt", mesh22)):
            out[f"step_{form}:{k}"] = v
        out[f"local_{form}"] = torch.cat([t.detach().reshape(-1)
                                          for _, t in named_tree_paths(params)])
    out["leaf_sizes"] = torch.tensor([t.numel() for _, t in named_tree_paths(params)])

np.savez(f"{d}/rank{r}.npz", **{k: (v.detach().numpy() if torch.is_tensor(v) else np.array(v))
                                for k, v in out.items()})
hvd.shutdown()
'''


def _tp_logits(params, tokens, n, form):
    mesh = build_mesh({"model": n}, devices=jax.devices()[:n])
    specs = ref_rules.match_partition_rules("gpt", params)
    fn = hvdj._shard_map(
        lambda p, t: ref.tp_apply(p, t, n_heads=HEADS, model_axis="model", dtype=jnp.float32,
                                  tp_overlap=form == "fused"),
        mesh, in_specs=(specs, P()), out_specs=P(), check=False)
    return np.asarray(jax.jit(fn)(params, jnp.asarray(tokens)))


@pytest.fixture(scope="module")
def jax_side():
    params = _params()
    tokens, labels = _batch()
    flat = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(params)}

    def dense_loss(p):
        logits = ref.tp_apply(p, jnp.asarray(tokens), n_heads=HEADS, dtype=jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    grads = {k: np.asarray(v)
             for k, v in ref_rules.named_tree_paths(jax.jit(jax.grad(dense_loss))(params))}
    logits = {(n, form): _tp_logits(params, tokens, n, form) for n in (2, 4) for form in FORMS}
    dense = np.asarray(jax.jit(lambda p, t: ref.tp_apply(p, t, n_heads=HEADS, dtype=jnp.float32))(
        params, jnp.asarray(tokens)))

    tx = optax.adamw(1e-3)
    step = hvdj.make_train_step(ref.make_gpt_loss_fn(HEADS, model_axis=None, dtype=jnp.float32),
                                tx, build_mesh({"data": 4}, devices=jax.devices()[:4]),
                                donate=False)
    p, s, losses = params, tx.init(params), []
    batch = (jnp.asarray(tokens), jnp.asarray(labels))
    for _ in range(STEPS):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    final = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(p)}
    return dict(params=params, flat=flat, tokens=tokens, labels=labels, grads=grads,
                logits=logits, dense=dense, dp_losses=losses, dp_final=final)


_RUNS = {}


def _port(n, jax_side, tmp_path_factory):
    """The worker's outputs at n gloo ranks, one run per rank count."""
    if n not in _RUNS:
        d = tmp_path_factory.mktemp(f"torch_tp{n}")
        np.savez(d / "inputs.npz", tokens=jax_side["tokens"].astype(np.int64),
                 labels=jax_side["labels"].astype(np.int64),
                 **{f"p:{k}": v for k, v in jax_side["flat"].items()})
        (d / "cfg.json").write_text(json.dumps({"heads": HEADS, "steps": STEPS}))
        run_ranks(WORKER, n, d)
        _RUNS[n] = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
    return _RUNS[n]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"ranks{n}")
def port_run(request, jax_side, tmp_path_factory):
    return request.param, _port(request.param, jax_side, tmp_path_factory)


@pytest.fixture(scope="module")
def port4(jax_side, tmp_path_factory):
    """The 4-rank run, which also trains on the data 2 x model 2 mesh."""
    return _port(4, jax_side, tmp_path_factory)


@pytest.mark.parametrize("form", FORMS)
def test_tp_logits_match_jax_tp_apply(port_run, jax_side, form):
    """Each rank's logits against JAX's ``tp_apply(model_axis="model")`` at
    the same model-axis size (and the dense form), at 1e-5."""
    n, ported = port_run
    for r in range(n):
        got = ported[r][f"logits_{form}"]
        np.testing.assert_allclose(got, jax_side["logits"][(n, form)], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jax_side["dense"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_tp_gradients_match_jax_dense(port_run, jax_side, form):
    """The gradients of every leaf, gathered over the model axis, against
    jax.grad of the dense ``tp_apply(model_axis=None)``."""
    n, ported = port_run
    for name, want in jax_side["grads"].items():
        for r in range(n):
            np.testing.assert_allclose(ported[r][f"grad_{form}:{name}"], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{form} {name} rank {r}")


@pytest.mark.parametrize("form", FORMS)
def test_composed_steps_match_jax_dp(port4, jax_side, form):
    """3 composed AdamW steps at data 2 x model 2 against JAX's DP step at
    data 4 (test_composed_matches_dp_reference)."""
    for r, p in enumerate(port4):
        np.testing.assert_allclose(p[f"losses_{form}"], jax_side["dp_losses"], rtol=1e-4)
    assert jax_side["dp_losses"][-1] < jax_side["dp_losses"][0]
    for name, want in jax_side["dp_final"].items():
        got = port4[0][f"step_{form}:{name}"]
        assert not np.array_equal(got, jax_side["flat"][name]), name
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5, err_msg=f"{form} {name}")


def test_fused_step_matches_classic_step(port4):
    """The port's fused composed step against its classic one
    (test_composed_fused_matches_classic): losses within the reference's
    5e-7 (relative to max(1, |loss|)), and parameters within 5e-7 on all but
    1e-4 of the elements. Measured on the CPU: losses 4.8e-7 apart; one
    parameter of 67,520 per rank 2.0e-6 apart, the others within 5e-7. The
    gradients differ by f32 rounding alone
    (test_fused_gradients_match_classic_at_f32_rounding), and the elements
    past 5e-7 are AdamW's doing at gradients of eps's scale
    (test_fused_step_gap_is_adamw_at_eps_scale_gradients). The bound on the
    rest stays 5e-6."""
    tol = 5e-7
    for p in port4:
        for a, b in zip(p["losses_classic"], p["losses_fused"]):
            assert abs(a - b) <= tol * max(1.0, abs(a))
        diff = np.abs(p["local_classic"] - p["local_fused"])
        assert (diff > tol).sum() <= 1e-4 * diff.size, int((diff > tol).sum())
        assert diff.max() <= 10 * tol, float(diff.max())


def _leaves(p, flat):
    """Split a rank's flat vector of its local leaves, leaf by leaf."""
    bounds = np.concatenate([[0], np.cumsum(p["leaf_sizes"])])
    return [flat[..., a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def test_fused_gradients_match_classic_at_f32_rounding(port4):
    """The gradients of the first composed step at data 2 x model 2, from
    the same parameters, before any optimizer update: fused against
    classic, leaf by leaf, within f32 rounding, 5e-7 of the leaf's largest
    |g| (measured on the CPU: at most 4.7e-7). The rings sum the
    row-parallel partials in another order than gloo's all-reduce, and
    nothing more: a ring that dropped, repeated or misplaced a partial
    would move whole rows by the size of the gradient."""
    for r, p in enumerate(port4):
        for i, (gc, gf) in enumerate(zip(_leaves(p, p["grads_classic"][0]),
                                         _leaves(p, p["grads_fused"][0]))):
            scale = np.abs(gc).max()
            assert np.abs(gf - gc).max() <= 5e-7 * scale, (r, i, np.abs(gf - gc).max(), scale)


def _adamw_path(grads, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """The sum of torch AdamW's updates (weight decay aside) over the
    recorded per-step gradients, in float64."""
    g = grads.astype(np.float64)
    m = v = total = 0.0
    for t in range(1, len(g) + 1):
        m = b1 * m + (1 - b1) * g[t - 1]
        v = b2 * v + (1 - b2) * g[t - 1] ** 2
        total = total + lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
    return total


def test_fused_step_gap_is_adamw_at_eps_scale_gradients(port4):
    """Where the fused and classic parameters end more than 5e-7 apart
    after 3 AdamW steps (test_fused_step_matches_classic_step), AdamW made
    the gap: replaying its updates in float64 from each form's recorded
    gradients gives every element's fused-classic difference within 5e-7,
    and each element past 5e-7 had a first-step |g| within 10x AdamW's
    eps (1e-8), where lr * g / (|g| + eps) turns a rounding-sized change of
    g into a visible share of lr (measured on the CPU: one element a rank on
    two ranks, |g| 3.8e-8, 2.0e-6 apart)."""
    for p in port4:
        gap = p["local_fused"].astype(np.float64) - p["local_classic"]
        replayed = _adamw_path(p["grads_classic"]) - _adamw_path(p["grads_fused"])
        assert np.abs(gap - replayed).max() <= 5e-7, np.abs(gap - replayed).max()
        past = np.abs(gap) > 5e-7
        g1 = np.minimum(np.abs(p["grads_classic"][0]), np.abs(p["grads_fused"][0]))
        assert (g1[past] <= 10 * 1e-8).all(), g1[past]


def test_fused_logits_match_classic(port_run):
    """One forward, fused against classic, at the all_gather_matmul parity
    tolerance (2e-6): the rings sum the row-parallel partials in another
    order than the all-reduce, which moves f32 logits of size ~1 by a few
    ulps."""
    _, ported = port_run
    for p in ported:
        np.testing.assert_allclose(p["logits_fused"], p["logits_classic"], rtol=2e-6, atol=2e-6)


def test_data_group_reduction(port4):
    """``fused_allreduce(group=)`` and ``DistributedOptimizer(group=)`` over
    the data axis of a data 2 x model 2 mesh: the data ranks end identical,
    the model ranks keep their own values (the averages over data of
    10 m + d and 100 m + 2 d)."""
    coords = [(r // 2, r % 2) for r in range(4)]   # rank r = (data, model), model fastest
    for r, (di, mi) in enumerate(coords):
        want = np.concatenate([np.full(3, 10.0 * mi + 0.5), np.full(4, 100.0 * mi + 1.0)])
        np.testing.assert_array_equal(port4[r]["fused_allreduce"], want)
        np.testing.assert_array_equal(port4[r]["dist_opt"], np.full(4, -(10.0 * mi + 0.5)))
        # The same model coordinate on the other data rank: bitwise the same shards.
        twin = [q for q, (dq, mq) in enumerate(coords) if mq == mi and dq != di][0]
        for form in FORMS:
            np.testing.assert_array_equal(port4[r][f"local_{form}"], port4[twin][f"local_{form}"])
    assert not np.array_equal(port4[0]["local_classic"], port4[1]["local_classic"])


@pytest.mark.parametrize("form", FORMS)
def test_refusals_match_reference(port_run, form):
    """``n_heads`` that does not split over the model axis, a length the
    fused path cannot token-shard, a full-size row bias: each refused with
    the reference's message."""
    n, ported = port_run
    for p in ported:
        assert "sequence length (15)" in str(p["refuse_tokens"])
        assert "divisible by the model-axis size" in str(p["refuse_tokens"])
        assert "row_parallel bias must be the [D/n] shard" in str(p["refuse_bias"])
        assert "row_parallel_fused bias must be the [D/n] shard" in str(p["refuse_bias_fused"])
        if n == 4:
            assert "n_heads must divide by the model-axis size" in str(p[f"refuse_heads_{form}"])


# --- the rule table -----------------------------------------------------------


def test_rules_match_jax_leaf_for_leaf(jax_side):
    params = jax_side["params"]
    names = [k for k, _ in ref_rules.named_tree_paths(params)]
    specs = ref_rules.spec_leaves(ref_rules.match_partition_rules("gpt", params))
    tree = port_rules.named_tree_paths(
        port_rules.match_partition_rules("gpt", nest(jax_side["flat"])))
    assert [k for k, _ in tree] == names
    assert dict(tree) == {k: tuple(spec) for k, spec in zip(names, specs)}
    assert port_rules.GPT_RULES == ref_rules.GPT_RULES


@pytest.mark.parametrize("n,i", [(2, 0), (2, 1), (4, 0), (4, 3)])
def test_local_shard_tree_matches_jax(jax_side, n, i):
    params = jax_side["params"]
    want = dict(ref_rules.named_tree_paths(ref_rules.local_shard_tree(
        params, ref_rules.match_partition_rules("gpt", params), {"model": (i, n)})))
    tree = nest(jax_side["flat"])
    got = dict(port_rules.named_tree_paths(port_rules.local_shard_tree(
        tree, port_rules.match_partition_rules("gpt", tree), {"model": (i, n)})))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mesh,match", [
    ({"data": 2, "seq": 2}, "not a mesh axis"),
    ({"data": 1, "model": 3}, "not divisible by model = 3"),
])
def test_preflight_names_the_parameter(jax_side, mesh, match):
    shapes = {k: v.shape for k, v in jax_side["flat"].items()}
    with pytest.raises(ValueError, match=match) as e:
        port_rules.preflight_rules("gpt", mesh, shapes)
    assert "param 'block_0/attention/" in str(e.value)
    port_rules.preflight_rules("gpt", {"data": 2, "model": 4}, shapes)


def test_unknown_rule_table_and_unmatched_leaf():
    with pytest.raises(ValueError, match="unknown named rule table"):
        port_rules.resolve_rules("nope")
    with pytest.raises(ValueError, match="no sharding rule matches param 'a/b'"):
        port_rules.match_partition_rules([(r"^x$", None)], {"a": {"b": np.zeros((2, 2))}})


# --- the builder's refusals ---------------------------------------------------


def test_tp_overlap_requires_rules():
    with pytest.raises(ValueError, match="tp_overlap"):
        hvd.make_train_step(lambda p, b: p, torch.optim.SGD([torch.zeros(1, requires_grad=True)],
                                                            lr=0.1), tp_overlap=True)


@pytest.fixture
def one_rank(tmp_path):
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("option", [dict(zero1=True), dict(overlap=True), dict(quantized=True),
                                    dict(hierarchical=True), dict(nonfinite="skip"),
                                    dict(compression=hvd.Compression.fp16)])
def test_composed_options_not_ported_yet(one_rank, option):
    """The options the composed step refused before its data-axis variants
    were ported: zero1, overlap, quantized and nonfinite now build it (their
    runs are held in tests/test_torch_composed_variants.py); hierarchical
    and compression raise the JAX builder's ValueError, as there."""
    from horovod_tpu_torch.parallel.mesh import build_mesh

    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    mesh = build_mesh({"data": 1, "model": 1})
    if "hierarchical" in option or "compression" in option:
        with pytest.raises(ValueError, match="scopes hierarchy|rejects cast compression"):
            hvd.make_train_step(lambda p, b: p, opt, rules="gpt", mesh=mesh, **option)
    else:
        step = hvd.make_train_step(lambda p, b: p, opt, rules="gpt", mesh=mesh, **option)
        assert callable(step) and step.optimizer is None     # built at the first call


def test_init_composed_zero1_state_not_ported_yet(one_rank):
    """Ported: on a data 1 x model 1 mesh the state holds each bucket
    whole, without an error-feedback residual."""
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.train import init_composed_zero1_state

    params = {"a": {"kernel": torch.arange(6.0).reshape(2, 3)}, "b": {"bias": torch.ones(3)}}
    state = init_composed_zero1_state(torch.optim.SGD([torch.zeros(1)], lr=0.1), params, "gpt",
                                      build_mesh({"data": 1, "model": 1}))
    assert state.ef is None
    shards = torch.cat([s for g in state.shards.values() for s in g.values()])
    assert torch.equal(torch.sort(shards).values,
                       torch.sort(torch.cat([torch.arange(6.0), torch.ones(3)])).values)


_MESH22 = SimpleNamespace(mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=_MESH22, op=hvd.ReduceOp.MAX), "SUM/AVERAGE"),
    (dict(mesh=_MESH22, model_axis="data"), "cannot also be a data axis"),
    (dict(mesh=SimpleNamespace(mesh_dim_names=("data",))), "composed mode needs mesh axes"),
    (dict(mesh=None), "needs mesh="),
    (dict(mesh=_MESH22, rules="nope"), "unknown named rule table"),
])
def test_composed_rejections(kwargs, match):
    kwargs.setdefault("rules", "gpt")
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError, match=match):
        hvd.make_train_step(lambda p, b: p, opt, **kwargs)


def test_tp_parity_tool_two_gloo_ranks():
    """``tools/tp_parity`` (the multi-card check of this path) on the CPU:
    the fused form at model 2 against one whole-batch dense process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.tp_parity", "--ranks", "2",
         "--model", "2", "--fused", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["mesh"] == {"data": 1, "model": 2} and result["data_ranks_identical"]
    assert result["max_loss_rel_err"] <= 1e-6 and result["max_param_abs_err"] <= 1e-5

