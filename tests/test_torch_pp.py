"""The port's pipeline parallelism (``horovod_tpu_torch.parallel.pp``)
against the JAX package's (``horovod_tpu.parallel.pp``).

One spawn of 4 gloo ranks runs every port case; the JAX side runs on the
conftest's virtual CPU devices with the same weights (carried across as
numpy) and batches:

- ``pipeline_apply`` at stage 4 (rtol 1e-5 / atol 1e-5);
- ``make_pp_train_step`` under SGD 0.05 at stage 4 x data 1 and stage 2 x
  data 2 (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5), and every stage
  moving under SGD 1.0 (``test_tp_pp.py``'s check);
- ``make_pp_lm_train_step`` on ``test_tp_pp.py``'s toy LM at stage 2 x data
  2, ``remat`` True and False (the same tolerances for embed, stages and
  head);
- a 4-block d-64 GPT (flash attention's plain version on the CPU) split over
  2 and 4 stages against the JAX ``tp_apply`` + ``lm_loss`` unpipelined on
  the whole batch, one SGD step (the same tolerances).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from horovod_tpu.jax import _shard_map
from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.parallel.pp import (init_pp_lm_state, init_pp_state, make_pp_lm_train_step,
                                     make_pp_train_step, pipeline_apply)
from horovod_tpu.parallel.rules import named_tree_paths
from horovod_tpu_torch.utils import convert

from torch_port_harness import run_ranks

N = 4
D = 8
TRAIN_MESHES = {"s4d1": (4, 1), "s2d2": (2, 2)}
LM_MESH = (2, 2)
GPT_DIMS = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=4, max_len=32)
GPT_MICRO, GPT_MB, GPT_T, GPT_LR = 2, 4, 32, 0.1

WORKER = r'''
import json, os
from functools import partial
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import lm_loss
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.parallel import pp
from horovod_tpu_torch.tools.pp_parity import gpt_embed_fn, gpt_head_loss_fn, gpt_stage_fn
from horovod_tpu_torch.utils import convert

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r = hvd.rank()
data = np.load(f"{d}/inputs.npz")
out = {}
meshes = {(s, n // s): build_mesh({"stage": s, "data": n // s}) for s, n in ((4, 4), (2, 4))}


def arrays(prefix):
    return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


def t(name):
    return torch.from_numpy(data[name])


def stage_fn(p, x, s):
    return torch.relu(x @ p["w"] + p["b"])


# pipeline_apply at stage 4.
mesh = meshes[(4, 1)]
row = convert.stacked_row(convert.nest(arrays("A/p/")), mesh.get_local_rank("stage"), "cpu")
out["A/y"] = pp.pipeline_apply(stage_fn, row, t("A/x"), axis_name=mesh.get_group("stage"))

# make_pp_train_step, SGD 0.05, and SGD 1.0 on ones/zeros (every stage moves).
for name, (s, dp) in cfg["train_meshes"].items():
    mesh = meshes[(s, dp)]
    row = convert.stacked_row(convert.nest(arrays(f"B/{name}/p/")), mesh.get_local_rank("stage"),
                              "cpu")
    opt = pp.init_pp_state(lambda ps: torch.optim.SGD(ps, lr=0.05), row)
    step = pp.make_pp_train_step(lambda o, l: ((o - l) ** 2).mean(), stage_fn, opt, mesh)
    out[f"B/{name}/loss"] = step(row, t(f"B/{name}/x"), t(f"B/{name}/y"))
    out[f"B/{name}/w"] = row["w"].detach()
mesh = meshes[(4, 1)]
row = convert.stacked_row(convert.nest(arrays("C/p/")), mesh.get_local_rank("stage"), "cpu")
before = row["w"].detach().clone()
step = pp.make_pp_train_step(lambda o, l: ((o - l) ** 2).mean(), stage_fn,
                             pp.init_pp_state(lambda ps: torch.optim.SGD(ps, lr=1.0), row), mesh)
step(row, torch.ones(2, 4, 4), torch.zeros(2, 4, 4))
out["C/moved"] = (row["w"].detach() - before).abs().sum()

# make_pp_lm_train_step on the toy LM.
s, dp = cfg["lm_mesh"]
mesh = meshes[(s, dp)]
for remat in (True, False):
    params = {"embed": convert.stacked_row({"table": data["D/embed"][None]}, 0, "cpu"),
              "stages": convert.stacked_row({"w": data["D/stages"]}, mesh.get_local_rank("stage"),
                                            "cpu"),
              "head": convert.stacked_row({"proj": data["D/head"][None]}, 0, "cpu")}
    step = pp.make_pp_lm_train_step(
        lambda p, tok: p["table"][tok], lambda p, h, s: torch.tanh(h @ p["w"]),
        lambda p, h, lab: lm_loss(h @ p["proj"], lab),
        pp.init_pp_lm_state(lambda ps: torch.optim.SGD(ps, lr=0.1), params), mesh, remat=remat)
    out[f"D/{remat}/loss"] = step(params, t("D/tokens"), t("D/labels"))
    for part, leaf in (("embed", "table"), ("stages", "w"), ("head", "proj")):
        out[f"D/{remat}/{part}"] = params[part][leaf].detach()

# A 4-block GPT split over 2 and 4 stages, one SGD step.
flat = arrays("E/p/")
dims = cfg["gpt_dims"]
for s in (2, 4):
    mesh = meshes[(s, 4 // s)]
    stage = mesh.get_local_rank("stage")
    params = convert.pp_params_from_flax(flat, s, stage, device="cpu")
    step = pp.make_pp_lm_train_step(
        gpt_embed_fn(torch.float32), gpt_stage_fn(dims["n_heads"], torch.float32),
        gpt_head_loss_fn(torch.float32),
        pp.init_pp_lm_state(lambda ps: torch.optim.SGD(ps, lr=cfg["gpt_lr"]), params), mesh)
    out[f"E/{s}/loss"] = step(params, t("E/tokens"), t("E/labels"))
    for k, v in convert.pp_params_to_flax(params, s, stage, dims["n_layers"]).items():
        out[f"E/{s}/p/{k}"] = torch.from_numpy(v)
np.savez(f"{d}/rank{r}.npz", **{k: v.detach().numpy() for k, v in out.items()})
hvd.shutdown()
'''


def _stacked_stage_params(seed, n_stages, d):
    k = jax.random.split(jax.random.PRNGKey(seed), n_stages)
    return {"w": jnp.stack([jax.random.normal(k[i], (d, d)) * (d ** -0.5)
                            for i in range(n_stages)]),
            "b": jnp.zeros((n_stages, d))}


def _stage_fn(p, x, s):
    return jax.nn.relu(x @ p["w"] + p["b"])


def _mse(o, l):
    return jnp.mean((o - l) ** 2)


def _lm_setup(n_stages, dp, d=8, vocab=16, mb=2, n_micro=4, seed=5):
    """test_tp_pp.py's _lm_pp_setup at (stage, data) = (n_stages, dp)."""
    kp = jax.random.split(jax.random.PRNGKey(seed), 4)
    params = {"embed": {"table": jax.random.normal(kp[0], (vocab, d)) * 0.5},
              "stages": {"w": jax.random.normal(kp[1], (n_stages, d, d)) * 0.3},
              "head": {"proj": jax.random.normal(kp[2], (d, vocab)) * 0.5}}
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (n_micro, mb * dp, 6)).astype(np.int32)
    labels = rng.randint(0, vocab, (n_micro, mb * dp, 6)).astype(np.int32)
    return params, tokens, labels


def _lm_fns():
    def embed_fn(p, tok):
        return p["table"][tok]

    def stage_fn(p, h, s):
        return jnp.tanh(h @ p["w"])

    def head_loss_fn(p, h, lab):
        return optax.softmax_cross_entropy_with_integer_labels(h @ p["proj"], lab).mean()

    return embed_fn, stage_fn, head_loss_fn


def _mesh(stage, data, devices):
    return build_mesh({"stage": stage, "data": data}, devices=devices[:stage * data])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices):
    arrays, jax_out = {}, {}

    # A: pipeline_apply at stage 4.
    pa = _stacked_stage_params(2, 4, D)
    xa = np.random.RandomState(2).randn(4, 2, D).astype(np.float32)
    arrays.update({"A/x": xa, **{f"A/p/{k}": np.asarray(v) for k, v in pa.items()}})
    mesh = _mesh(4, 1, devices)

    def run_a(p, xm):
        outs = pipeline_apply(_stage_fn, jax.tree.map(lambda t: t[0], p), xm, axis_name="stage")
        mask = (jax.lax.axis_index("stage") == 3).astype(outs.dtype)
        return jax.lax.psum(outs * mask, "stage")

    jax_out["A/y"] = np.asarray(jax.jit(_shard_map(
        run_a, mesh, in_specs=(P("stage"), P()), out_specs=P()))(pa, jnp.asarray(xa)))

    # B: make_pp_train_step, SGD 0.05.
    for name, (s, dp) in TRAIN_MESHES.items():
        pb = _stacked_stage_params(3, s, D)
        rng = np.random.RandomState(3)
        xb = rng.randn(4, 4, D).astype(np.float32)
        yb = rng.randn(4, 4, D).astype(np.float32)
        arrays.update({f"B/{name}/x": xb, f"B/{name}/y": yb,
                       **{f"B/{name}/p/{k}": np.asarray(v) for k, v in pb.items()}})
        tx = optax.sgd(0.05)
        step = make_pp_train_step(_mse, _stage_fn, tx, _mesh(s, dp, devices), donate=False)
        new, _, loss = step(pb, init_pp_state(tx, pb), jnp.asarray(xb), jnp.asarray(yb))
        jax_out[f"B/{name}/loss"], jax_out[f"B/{name}/w"] = float(loss), np.asarray(new["w"])

    # C: every stage moves.
    pc = _stacked_stage_params(4, 4, 4)
    arrays.update({f"C/p/{k}": np.asarray(v) for k, v in pc.items()})

    # D: the toy LM.
    s, dp = LM_MESH
    pd, tok, lab = _lm_setup(s, dp)
    arrays.update({"D/embed": np.asarray(pd["embed"]["table"]),
                   "D/stages": np.asarray(pd["stages"]["w"]),
                   "D/head": np.asarray(pd["head"]["proj"]),
                   "D/tokens": tok.astype(np.int64), "D/labels": lab.astype(np.int64)})
    tx = optax.sgd(0.1)
    for remat in (True, False):
        step = make_pp_lm_train_step(*_lm_fns(), tx, _mesh(s, dp, devices), remat=remat,
                                     donate=False)
        new, _, loss = step(pd, init_pp_lm_state(tx, pd), jnp.asarray(tok), jnp.asarray(lab))
        jax_out[f"D/{remat}/loss"] = float(loss)
        for part, leaf in (("embed", "table"), ("stages", "w"), ("head", "proj")):
            jax_out[f"D/{remat}/{part}"] = np.asarray(new[part][leaf])

    # E: the GPT, unpipelined in JAX on the whole batch.
    rng = np.random.RandomState(7)
    shape = (GPT_MICRO, GPT_MB, GPT_T)
    tok, lab = (rng.randint(0, GPT_DIMS["vocab_size"], shape).astype(np.int32) for _ in range(2))
    model = ref.TransformerLM(**GPT_DIMS, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tok[0, :1]))["params"]
    flat = {k: np.asarray(v) for k, v in named_tree_paths(params)}
    arrays.update({"E/tokens": tok.astype(np.int64), "E/labels": lab.astype(np.int64),
                   **{f"E/p/{k}": v for k, v in flat.items()}})

    def gpt_loss(p):
        logits = ref.tp_apply(p, jnp.asarray(tok.reshape(-1, GPT_T)),
                              n_heads=GPT_DIMS["n_heads"], dtype=jnp.float32)
        return ref.lm_loss(logits, jnp.asarray(lab.reshape(-1, GPT_T)))

    loss, grads = jax.value_and_grad(gpt_loss)(params)
    jax_out["E/loss"] = float(loss)
    jax_out["E/init"] = flat
    jax_out["E/p"] = {k: np.asarray(v) for k, v in named_tree_paths(
        jax.tree.map(lambda p, g: p - GPT_LR * g, params, grads))}

    d = tmp_path_factory.mktemp("torch_pp")
    np.savez(d / "inputs.npz", **arrays)
    (d / "cfg.json").write_text(json.dumps({
        "train_meshes": TRAIN_MESHES, "lm_mesh": LM_MESH, "gpt_dims": GPT_DIMS,
        "gpt_lr": GPT_LR}))
    run_ranks(WORKER, N, d, timeout=240)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(N)], jax_out


def test_pipeline_apply_matches_jax(runs):
    ported, want = runs
    np.testing.assert_allclose(ported[3]["A/y"], want["A/y"], rtol=1e-5, atol=1e-5)
    for r in range(3):
        assert not ported[r]["A/y"].any(), "the non-last stages return zeros"


@pytest.mark.parametrize("name", sorted(TRAIN_MESHES))
def test_pp_train_step_matches_jax(runs, name):
    ported, want = runs
    s, dp = TRAIN_MESHES[name]
    for r in range(N):
        stage = r // dp
        np.testing.assert_allclose(ported[r][f"B/{name}/loss"], want[f"B/{name}/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ported[r][f"B/{name}/w"], want[f"B/{name}/w"][stage],
                                   rtol=1e-4, atol=1e-5)


def test_pp_grad_flows_through_all_stages(runs):
    ported, _ = runs
    moved = [float(ported[r]["C/moved"]) for r in range(N)]
    assert all(m > 1e-8 for m in moved), f"stages without gradient: {moved}"


@pytest.mark.parametrize("remat", [True, False])
def test_pp_lm_matches_jax(runs, remat):
    ported, want = runs
    s, dp = LM_MESH
    for r in range(N):
        stage = r // dp
        np.testing.assert_allclose(ported[r][f"D/{remat}/loss"], want[f"D/{remat}/loss"],
                                   rtol=1e-5)
        for part in ("embed", "head"):
            np.testing.assert_allclose(ported[r][f"D/{remat}/{part}"], want[f"D/{remat}/{part}"],
                                       rtol=1e-4, atol=1e-5, err_msg=part)
        np.testing.assert_allclose(ported[r][f"D/{remat}/stages"],
                                   want[f"D/{remat}/stages"][stage], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stages", [2, 4])
def test_pp_gpt_matches_unpipelined_jax(runs, stages):
    ported, want = runs
    prefix = f"E/{stages}/p/"
    seen = set()
    for r in range(N):
        np.testing.assert_allclose(ported[r][f"E/{stages}/loss"], want["E/loss"], rtol=1e-5)
        for key in ported[r]:
            if key.startswith(prefix):
                name = key[len(prefix):]
                seen.add(name)
                got = ported[r][key]
                assert not np.array_equal(got, want["E/init"][name]), name
                np.testing.assert_allclose(got, want["E/p"][name], rtol=1e-4, atol=1e-5,
                                           err_msg=name)
    assert seen == set(want["E/p"]), "every parameter is some stage's"


def test_pp_params_round_trip():
    """``pp_params_from_flax`` puts block i on stage i // (L / n) and
    ``pp_params_to_flax`` brings every leaf back under its flax name."""
    rng = np.random.RandomState(0)
    flat = {"embeddings/embedding": rng.randn(8, 4), "pos_embeddings/embedding": rng.randn(6, 4),
            "ln_f/scale": rng.randn(4), "ln_f/bias": rng.randn(4), "lm_head/kernel": rng.randn(4, 8),
            **{f"block_{i}/mlp/up/kernel": rng.randn(4, 4) for i in range(4)}}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    back = {}
    for stage in range(2):
        params = convert.pp_params_from_flax(flat, 2, stage, device="cpu")
        assert sorted(params["stages"]) == ["block_0", "block_1"]
        np.testing.assert_array_equal(
            params["stages"]["block_1"]["mlp"]["up"]["kernel"].detach().numpy(),
            flat[f"block_{2 * stage + 1}/mlp/up/kernel"])
        assert all(t.requires_grad for t in convert.flatten(params).values())
        back.update(convert.pp_params_to_flax(params, 2, stage, 4))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(ValueError, match="evenly"):
        convert.pp_params_from_flax(flat, 3, 0, device="cpu")


@pytest.mark.parametrize("example, last", [("tp_pp_demo", "DEMO DONE"),
                                           ("moe_expert_parallel", "final loss")])
def test_example_runs_on_gloo_ranks(tmp_path, example, last):
    """The example copies (``examples/jax_tp_pp_demo.py``,
    ``examples/jax_moe_expert_parallel.py``) at 4 gloo ranks with
    ``--device cpu``: they finish, and every printed loss trajectory falls."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "2", "TMPDIR": str(tmp_path), "PYTHONPATH": repo}
    out = subprocess.run([sys.executable, "-m", f"horovod_tpu_torch.examples.{example}",
                          "--device", "cpu", "--ranks", "4"], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith(last), lines
    curves, losses = [], None
    for line in lines:
        if "loss" in line and not line.startswith("DP"):
            losses.append(float(line.split("loss")[1]))
        else:
            losses = []
            curves.append(losses)
    curves = [c for c in curves if c]
    assert curves and all(c[-1] < c[0] for c in curves), curves
