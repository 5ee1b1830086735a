"""The composed DP×TP step's data-axis variants against the JAX package.

The JAX composed steps fail under JAX 0.9's ``check_vma`` (ROADMAP §C), so
the variants are held as tests/test_torch_tp.py holds the plain composed
step, on the reference tests' GPT (vocab 128, d 64, 4 heads, 2 layers, T
16, global batch 4, f32, AdamW 1e-3), small fusion buckets so that the tree
travels in several groups and buckets, gloo ranks on the CPU:

- at ``data 4 x model 1``, ``overlap``, ``zero1``, ``quantized`` (the flat
  int8 ring, error feedback off) and ``nonfinite="skip"`` against JAX's
  single-axis DP ``make_train_step`` at ``data 4`` with the same option and
  the dense loss: losses at rtol 1e-4, parameters at rtol 2e-3 / atol 2e-5
  (test_composed_matches_dp_reference's tolerances, as
  tests/test_torch_tp.py holds the plain step), the int8 wire's on all but
  1e-3 of the elements, the rest within what Adam moves in the steps run
  (the rule of tests/test_torch_quantized.py's EF step: XLA's FMA moves an
  int8 at a quantization edge);
- at ``data 2 x model 2``, against the port's own composed plain step:
  overlap equal to post hoc bitwise, zero1 within f32 rounding (1e-6),
  every data rank's shards the same; the int8 wire within its noise; skip
  with only model rank 1's gradient made NaN (a hook on a model-sharded
  leaf, whose gradient meets no model-axis collective) leaving every rank's
  parameters unchanged on that step, and abort raising on every rank;
- ``init_composed_zero1_state`` against the JAX function's ``[d, m]`` cell,
  leaf by leaf: the groups, the bucket partition, the shard lengths and the
  shard values (through an optax transformation whose state is the
  parameter shard it is given); and the state the composed zero1 step
  built, equal to the function's over the step's new parameters;
- the two-level data scope ``("cross", "local")`` at ``(cross 2, local 2,
  model 2)`` over 8 gloo ranks against the same runs with a flat ``data 4``
  scope: post hoc and overlap bitwise (one flat reduction over the same
  ranks), zero1 two-level within f32 rounding;
- the builder's ``ValueError``s, each also raised by the JAX builder:
  ``hierarchical=True``, ``compression``, ``error_feedback``,
  ``topo_algorithm`` and ``quantized`` with an axis tuple.
"""

import json
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu as hvd_jax
import horovod_tpu.jax as hvdj
from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel import rules as ref_rules
from horovod_tpu.parallel.mesh import build_mesh as jax_mesh

import horovod_tpu_torch as hvd

from torch_port_harness import run_ranks

VOCAB, D, HEADS, LAYERS, T, B, STEPS, LR = 128, 64, 4, 2, 16, 4, 3, 1e-3
THRESHOLD, FIRST = 1 << 14, 1 << 12
KNOBS = dict(fusion_threshold_bytes=THRESHOLD)
VARIANTS = {
    "plain": {},
    "overlap": dict(overlap=True, first_bucket_bytes=FIRST),
    "zero1": dict(zero1=True, first_bucket_bytes=FIRST),
    "quantized": dict(quantized=True),
    "skip": dict(nonfinite="skip"),
}
SKIP_STEP = 1
POISONED_LEAF = "block_1/mlp/up/kernel"      # sharded over the model axis


def _runs():
    """(name, mesh axes, data axis, options, the rank whose gradient is
    poisoned at SKIP_STEP or None)."""
    runs = []
    for name, kw in VARIANTS.items():
        runs.append((f"d4m1/{name}", {"data": 4, "model": 1}, "data", kw,
                     1 if name == "skip" else None))
        runs.append((f"d2m2/{name}", {"data": 2, "model": 2}, "data", kw,
                     1 if name == "skip" else None))
    runs.append(("d2m2/abort", {"data": 2, "model": 2}, "data", dict(nonfinite="abort"), 1))
    return runs


def _two_level_runs():
    runs = []
    for name in ("plain", "overlap", "zero1"):
        runs.append((f"flat/{name}", {"data": 4, "model": 2}, "data", VARIANTS[name], None))
        runs.append((f"two-level/{name}", {"cross": 2, "local": 2, "model": 2},
                     ["cross", "local"], VARIANTS[name], None))
    return runs


WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import make_gpt_loss_fn
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.parallel.rules import named_tree_paths
from horovod_tpu_torch.utils.convert import gather_params, local_params_from_flax, nest

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r = hvd.rank()
data = np.load(f"{d}/inputs.npz")
flat = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
tokens, labels = torch.from_numpy(data["tokens"]).long(), torch.from_numpy(data["labels"]).long()
loss_fn = make_gpt_loss_fn(cfg["heads"], model_axis="model", dtype=torch.float32)
poison = {"on": False}
meshes, out, info = {}, {}, {}


def adamw(leaves):
    return torch.optim.AdamW(leaves, lr=cfg["lr"], weight_decay=1e-4, eps=1e-8)


def shards_of(state):
    return {f"{g}/{b}": s.detach().clone() for g, bs in state.shards.items() for b, s in bs.items()}


for name, axes, data_axis, kw, poisoned in cfg["runs"]:
    key = json.dumps(axes)
    if key not in meshes:
        meshes[key] = build_mesh(axes)
    mesh = meshes[key]
    params = local_params_from_flax(flat, "gpt", mesh, device="cpu")
    leaves = [t for _, t in named_tree_paths(params)]
    step = hvd.make_train_step(loss_fn, adamw(leaves), mesh=mesh, rules="gpt",
                               data_axis=tuple(data_axis) if isinstance(data_axis, list)
                               else data_axis, fusion_threshold_bytes=cfg["threshold"], **kw)
    if poisoned == r:
        dict(named_tree_paths(params))[cfg["poisoned_leaf"]].register_hook(
            lambda g: g * float("nan") if poison["on"] else g)
    rec = {"losses": [], "unchanged": [], "raised": []}
    for s in range(cfg["steps"]):
        poison["on"] = poisoned is not None and s == cfg["skip_step"]
        before = torch.cat([t.detach().reshape(-1) for t in leaves])
        try:
            rec["losses"].append(float(step(params, (tokens, labels))))
        except hvd.HorovodInternalError:
            rec["raised"].append(s)
            rec["losses"].append(float("nan"))
        after = torch.cat([t.detach().reshape(-1) for t in leaves])
        rec["unchanged"].append(bool(torch.equal(before, after)))
    poison["on"] = False
    rec["groups"] = list(step.optimizer.streamed_groups)
    info[name] = rec
    out[f"{name}:local"] = torch.cat([t.detach().reshape(-1) for t in leaves])
    gathered = gather_params(params, "gpt", mesh)
    for k, v in named_tree_paths(gathered):
        out[f"{name}:p:{k}"] = v
    if kw.get("zero1"):
        # The state the step built, against the function's over the new params.
        built = shards_of(step.optimizer.zero1_state)
        again = shards_of(hvd.init_composed_zero1_state(
            adamw(leaves), gathered, "gpt", mesh,
            data_axis=tuple(data_axis) if isinstance(data_axis, list) else data_axis,
            threshold_bytes=cfg["threshold"], first_bucket_bytes=kw.get("first_bucket_bytes")))
        rec["zero1_state_same"] = (built.keys() == again.keys()
                                   and all(torch.equal(built[k], again[k]) for k in built))
        rec["zero1_state_keys"] = sorted(built)
if "cell" in cfg:
    mesh = meshes[json.dumps({"data": 2, "model": 2})]
    whole = nest({k: torch.from_numpy(v) for k, v in flat.items()})
    state = hvd.init_composed_zero1_state(adamw([torch.nn.Parameter(torch.zeros(1))]), whole,
                                          "gpt", mesh, threshold_bytes=cfg["threshold"],
                                          first_bucket_bytes=cfg["first"])
    for k, v in shards_of(state).items():
        out[f"cell:{k}"] = v
    info["cell"] = {"coords": [mesh.get_local_rank("data"), mesh.get_local_rank("model")],
                    "ef": state.ef is None}
np.savez(f"{d}/rank{r}.npz", **{k: v.detach().numpy() for k, v in out.items()})
json.dump(info, open(f"{d}/info{r}.json", "w"))
hvd.shutdown()
'''


def _params():
    model = ref.TransformerLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                              max_len=T)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]


def _spawn(d, runs, n, flat, tokens, labels, cell=False):
    np.savez(d / "inputs.npz", tokens=tokens.astype(np.int64), labels=labels.astype(np.int64),
             **{f"p:{k}": v for k, v in flat.items()})
    cfg = {"heads": HEADS, "steps": STEPS, "lr": LR, "threshold": THRESHOLD, "first": FIRST,
           "skip_step": SKIP_STEP, "poisoned_leaf": POISONED_LEAF, "runs": runs}
    if cell:
        cfg["cell"] = True
    (d / "cfg.json").write_text(json.dumps(cfg))
    run_ranks(WORKER, n, d, timeout=240)
    return ([dict(np.load(d / f"rank{r}.npz")) for r in range(n)],
            [json.loads((d / f"info{r}.json").read_text()) for r in range(n)])


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    params = _params()
    flat = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(params)}
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, VOCAB, (B, T)).astype(np.int32)
    labels = rng.randint(0, VOCAB, (B, T)).astype(np.int32)
    arrays, info = _spawn(tmp_path_factory.mktemp("composed_variants"), _runs(), 4, flat,
                          tokens, labels, cell=True)
    return SimpleNamespace(params=params, flat=flat, tokens=tokens, labels=labels,
                           arrays=arrays, info=info)


@pytest.fixture(scope="module")
def two_level(side, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("composed_two_level"), _two_level_runs(), 8,
                  side.flat, side.tokens, side.labels)


def _jax_dp(side, name):
    """JAX's single-axis DP step at data 4 with the variant's option, the
    dense loss (times 1 + the poison rows' sum: NaN on rank 1's rows at
    SKIP_STEP for skip)."""
    base = ref.make_gpt_loss_fn(HEADS, model_axis=None, dtype=jnp.float32)

    def loss_fn(p, b):
        return base(p, (b[0], b[1])) * (1 + b[2].sum())

    kw = dict(KNOBS, **VARIANTS[name])
    if name == "quantized":
        kw["error_feedback"] = False            # the composed int8 wire runs EF-off
    mesh = jax_mesh({"data": 4}, devices=jax.devices()[:4])
    tx = optax.adamw(LR)
    params = side.params
    state = (hvdj.init_zero1_stream_state(tx, params, 4, threshold_bytes=THRESHOLD,
                                          first_bucket_bytes=FIRST)
             if kw.get("zero1") else tx.init(params))
    step = hvdj.make_train_step(loss_fn, tx, mesh, donate=False, **kw)
    losses = []
    for s in range(STEPS):
        rows = np.zeros(B, np.float32)
        if name == "skip" and s == SKIP_STEP:
            rows[1] = np.nan                       # rank 1's row (one row a rank)
        params, state, loss = step(params, state, (jnp.asarray(side.tokens),
                                                   jnp.asarray(side.labels), jnp.asarray(rows)))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(params)}


@pytest.mark.parametrize("name", ["overlap", "zero1", "quantized", "skip"])
def test_data_n_model_1_matches_jax_dp_variant(side, name):
    losses, final = _jax_dp(side, name)
    for r in range(4):
        got = side.info[r][f"d4m1/{name}"]["losses"]
        if name == "skip":
            # The port's poison is on a gradient, JAX's on the loss: the
            # skipped step's reported losses differ (finite / NaN).
            assert np.isnan(losses[SKIP_STEP]) and side.info[r][f"d4m1/{name}"]["unchanged"] \
                == [s == SKIP_STEP for s in range(STEPS)]
            got, want = np.delete(got, SKIP_STEP), np.delete(losses, SKIP_STEP)
        else:
            want = losses
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert losses[-1] < losses[0]
    past = total = 0
    for key, want in final.items():
        got = side.arrays[0][f"d4m1/{name}:p:{key}"]
        assert not np.array_equal(got, side.flat[key]), key
        for r in range(1, 4):
            np.testing.assert_array_equal(side.arrays[r][f"d4m1/{name}:p:{key}"], got)
        if name != "quantized":
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5, err_msg=f"{name} {key}")
            continue
        # The int8 wire: an element whose partial sits on a quantization
        # edge may round to the neighbouring int8 in one ring and not the
        # other (XLA's FMA, tests/test_torch_quantized.py), so a share of
        # 1e-3 of the elements may pass the bound, by no more than Adam
        # moves a parameter in the steps run (the int8 EF step's rule).
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * STEPS, (key, diff.max())
        past += int((diff > 2e-5 + 2e-3 * np.abs(want)).sum())
        total += diff.size
    assert past <= 1e-3 * total, (past, total)


def _twins(r):
    """The rank with rank r's model coordinate on the other data rank of
    data 2 x model 2 (rank = data * 2 + model)."""
    return r ^ 2


@pytest.mark.parametrize("name,exact", [("overlap", True), ("zero1", False)])
def test_data_2_model_2_streamed_and_zero1_equal_posthoc(side, name, exact):
    for r in range(4):
        a, b = side.arrays[r][f"d2m2/{name}:local"], side.arrays[r]["d2m2/plain:local"]
        la, lb = side.info[r][f"d2m2/{name}"]["losses"], side.info[r]["d2m2/plain"]["losses"]
        if exact:
            np.testing.assert_array_equal(a, b)
            assert la == lb
            launched, _, total = side.info[r][f"d2m2/{name}"]["groups"]
            assert launched == total > 1
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            np.testing.assert_allclose(la, lb, rtol=1e-6)
            assert side.info[r][f"d2m2/{name}"]["zero1_state_same"]
        np.testing.assert_array_equal(a, side.arrays[_twins(r)][f"d2m2/{name}:local"])
    assert not np.array_equal(side.arrays[0]["d2m2/plain:local"],
                              side.arrays[1]["d2m2/plain:local"])


def test_data_2_model_2_quantized_trains_within_int8_noise(side):
    for r in range(4):
        q, p = side.arrays[r]["d2m2/quantized:local"], side.arrays[r]["d2m2/plain:local"]
        assert not np.array_equal(q, p)
        assert np.linalg.norm(q - p) / np.linalg.norm(p) < 5e-2
        np.testing.assert_array_equal(q, side.arrays[_twins(r)]["d2m2/quantized:local"])
        losses = side.info[r]["d2m2/quantized"]["losses"]
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, side.info[r]["d2m2/plain"]["losses"], rtol=1e-3)


@pytest.mark.parametrize("policy", ["skip", "abort"])
def test_data_2_model_2_one_model_rank_poisoned_skips_everywhere(side, policy):
    """Only rank 1 (data 0, model 1) gets a NaN gradient at SKIP_STEP; the
    flag is agreed over the data AND the model group, so every rank of the
    mesh leaves its parameters as they were (and under abort raises)."""
    for r in range(4):
        rec = side.info[r][f"d2m2/{policy}"]
        assert rec["unchanged"] == [s == SKIP_STEP for s in range(STEPS)], (r, rec)
        assert rec["raised"] == ([SKIP_STEP] if policy == "abort" else [])
        finite = [l for s, l in enumerate(rec["losses"]) if s != SKIP_STEP]
        assert np.all(np.isfinite(finite)) and finite[-1] < finite[0]
    np.testing.assert_array_equal(side.arrays[0]["d2m2/skip:local"],
                                  side.arrays[0]["d2m2/abort:local"])


def test_init_composed_zero1_state_matches_jax_cell(side):
    """The JAX function's [d, m] cell, through an optax transformation
    whose state is the parameter shard it was given: the same groups,
    buckets, shard lengths and values."""
    keep = optax.GradientTransformation(lambda p: {"shard": p}, lambda g, s, p=None: (g, s))
    mesh = jax_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    cells = hvdj.init_composed_zero1_state(keep, side.params, "gpt", mesh,
                                           threshold_bytes=THRESHOLD, first_bucket_bytes=FIRST)
    assert cells.ef is None
    for r in range(4):
        di, mi = side.info[r]["cell"]["coords"]
        assert (di, mi) == (r // 2, r % 2) and side.info[r]["cell"]["ef"]
        got = {k[5:]: v for k, v in side.arrays[r].items() if k.startswith("cell:")}
        want = {f"{g}/{b}": np.asarray(s["shard"])[di, mi]
                for g, bs in cells.opt.items() for b, s in bs.items()}
        assert got.keys() == want.keys() and len(got) > 2
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["plain", "overlap", "zero1"])
def test_two_level_dp_scope_matches_flat_scope(two_level, name):
    arrays, info = two_level
    for r in range(8):
        a = arrays[r][f"two-level/{name}:local"]
        b = arrays[r][f"flat/{name}:local"]
        la, lb = info[r][f"two-level/{name}"]["losses"], info[r][f"flat/{name}"]["losses"]
        if name == "zero1":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            np.testing.assert_allclose(la, lb, rtol=1e-6)
            assert info[r][f"two-level/{name}"]["zero1_state_same"]
        else:
            np.testing.assert_array_equal(a, b)
            assert la == lb
        assert la[-1] < la[0]


# --- the builder's refusals ---------------------------------------------------

_MESH = SimpleNamespace(mesh_dim_names=("data", "model"))
_HMESH = SimpleNamespace(mesh_dim_names=("cross", "local", "model"))


@pytest.mark.parametrize("kwargs,match", [
    (dict(hierarchical=True), "scopes hierarchy to the DP axes"),
    (dict(compression="fp16"), "rejects cast compression"),
    (dict(error_feedback=True), "runs the int8 wire EF-off"),
    (dict(topo_algorithm="two-level"), "drop topo_algorithm"),
    (dict(quantized=True, tuple=True), "two-level DP scope has no int8"),
])
def test_composed_refusals_match_jax(kwargs, match):
    kwargs = dict(kwargs)
    two_level = kwargs.pop("tuple", False)
    port, jkw = dict(kwargs), dict(kwargs)
    if "compression" in kwargs:
        port["compression"] = hvd.Compression.fp16
        jkw["compression"] = hvd_jax.Compression.fp16
    axes = {"cross": 1, "local": 1, "model": 1} if two_level else {"data": 1, "model": 1}
    jmesh = jax_mesh(axes, devices=jax.devices()[:1])
    scope = ("cross", "local") if two_level else "data"
    with pytest.raises(ValueError, match=match):
        hvdj.make_train_step(lambda p, b: p, optax.sgd(0.1), jmesh, rules="gpt",
                             axis_name=scope, **jkw)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError, match=match):
        hvd.make_train_step(lambda p, b: p, opt, rules="gpt", mesh=_HMESH if two_level else _MESH,
                            data_axis=scope, **port)
