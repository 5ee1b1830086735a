"""The port's sequence-parallel training against the JAX package's.

- ``make_sp_train_step`` at 4 gloo ranks on a ``data 2 x seq 2`` mesh, with
  ring attention inside the model, against ``horovod_tpu.parallel.sp``'s
  step on a ``{"data": 2, "seq": 2}`` mesh of 4 virtual CPU devices: the
  configuration of test_sp_training_matches_dense (vocab 64, d 32, 4
  heads, 2 layers, T 32, B 4, SGD 0.1, 3 steps), the same flax initial
  weights and tokens, and its tolerances: losses rtol 1e-4, parameters
  rtol 2e-3 / atol 2e-5.
- ``remat=True`` against ``remat=False``: the same loss and gradients.
- The input embedding in bf16: each form of the port bitwise equal to its
  own JAX form where the activations enter ``block_0``.
- ``tools/sp_parity`` (the multi-card check of this path) on the CPU.
"""

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.parallel.ring_attention import ring_attention
from horovod_tpu.parallel.rules import named_tree_paths
from horovod_tpu.parallel.sp import make_sp_train_step
from horovod_tpu_torch.models import transformer as port
from horovod_tpu_torch.utils.convert import load_flax_params, params_from_flax

from torch_port_harness import run_ranks

VOCAB = 64
DIMS = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, max_len=64)
B, T, STEPS, N = 4, 32, 3, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, VOCAB, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


WORKER = r'''
import json, os
from functools import partial
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.parallel.ring_attention import ring_attention
from horovod_tpu_torch.parallel.sp import make_sp_train_step
from horovod_tpu_torch.utils.convert import load_flax_params, params_to_numpy

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r = hvd.rank()
data = np.load(f"{d}/inputs.npz")
mesh = build_mesh({"data": 2, "seq": 2})
model = TransformerLM(**cfg["dims"], dtype=torch.float32, device="cpu",
                      attn_fn=partial(ring_attention, group=mesh.get_group("seq"), causal=True))
load_flax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p:")})
step = make_sp_train_step(lambda m, tok, lab, pos: lm_loss(m(tok, positions=pos), lab),
                          torch.optim.SGD(model.parameters(), lr=0.1), mesh)
tokens, labels = torch.from_numpy(data["tokens"]), torch.from_numpy(data["labels"])
losses = [float(step(model, tokens, labels)) for _ in range(cfg["steps"])]
np.savez(f"{d}/rank{r}.npz", losses=np.array(losses),
         **{f"p:{k}": v for k, v in params_to_numpy(model).items()})
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tokens, labels = _data()
    dense = ref.TransformerLM(**DIMS, dtype=jnp.float32)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    init = {n: np.asarray(l) for n, l in named_tree_paths(params)}

    d = tmp_path_factory.mktemp("torch_sp")
    np.savez(d / "inputs.npz", tokens=tokens.astype(np.int64), labels=labels.astype(np.int64),
             **{f"p:{k}": v for k, v in init.items()})
    (d / "cfg.json").write_text(json.dumps({"dims": DIMS, "steps": STEPS}))
    run_ranks(WORKER, N, d)
    ported = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]

    sp_model = ref.TransformerLM(**DIMS, dtype=jnp.float32,
                                 attn_fn=partial(ring_attention, axis_name="seq", causal=True))

    def loss_fn(p, tok, lab, positions):
        logits = sp_model.apply({"params": p}, tok, positions=positions)
        return optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean()

    mesh = build_mesh({"data": 2, "seq": 2}, devices=jax.devices()[:N])
    tx = optax.sgd(0.1)
    step = make_sp_train_step(loss_fn, tx, mesh, donate=False)
    opt_state = tx.init(params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens),
                                       jnp.asarray(labels))
        losses.append(float(loss))
    final = {n: np.asarray(l) for n, l in named_tree_paths(params)}
    return ported, losses, final, init


def test_sp_losses_match_jax(runs):
    ported, losses, _, _ = runs
    for r in range(N):
        np.testing.assert_allclose(ported[r]["losses"], losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_sp_params_match_jax(runs):
    ported, _, final, init = runs
    for name, want in final.items():
        got = ported[0][f"p:{name}"]
        assert not np.array_equal(got, init[name]), name
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5, err_msg=name)


def test_sp_ranks_hold_identical_params(runs):
    ported = runs[0]
    for key in ported[0]:
        for r in range(1, N):
            np.testing.assert_array_equal(ported[r][key], ported[0][key], err_msg=key)


def test_remat_matches_no_remat():
    """``remat=True`` (each block under ``torch.utils.checkpoint``) gives the
    loss and gradients of ``remat=False``, as ``nn.remat(Block)`` does."""
    tokens, labels = (torch.from_numpy(x).long() for x in _data(1))
    grads, losses = [], []
    for remat in (False, True):
        m = port.TransformerLM(**DIMS, dtype=torch.float32, device="cpu", seed=3, remat=remat)
        loss = port.lm_loss(m(tokens), labels)
        loss.backward()
        losses.append(loss.detach())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    torch.testing.assert_close(losses[1], losses[0], rtol=0, atol=0)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)


class _Stop(Exception):
    pass


def _first_layer_norm_input(module, fn, monkeypatch):
    """Run ``fn`` until its first ``_layer_norm`` (block_0's ln_1) and return
    that call's input: the embedded activations entering block_0."""
    seen = []

    def capture(x, p, dtype):
        seen.append(x)
        raise _Stop

    monkeypatch.setattr(module, "_layer_norm", capture)
    with pytest.raises(_Stop):
        fn()
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("form", ["module", "tp_apply"])
def test_bf16_embedding_bitwise_matches_jax(form, monkeypatch):
    """In bf16 the flax module adds two bf16 lookups (``nn.Embed(dtype=
    bf16)``) and the JAX ``tp_apply`` adds in f32 and casts once; each form
    of the port must give its own JAX form's activations bit for bit."""
    tokens, _ = _data(2)
    flax_model = ref.TransformerLM(**DIMS, dtype=jnp.bfloat16)
    params = flax_model.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:1]))["params"]
    flat = {n: np.asarray(l) for n, l in named_tree_paths(params)}
    tok = torch.from_numpy(tokens).long()
    if form == "module":
        _, state = flax_model.apply({"params": params}, jnp.asarray(tokens),
                                    capture_intermediates=True, mutable=["intermediates"])
        inter = state["intermediates"]
        want = inter["embeddings"]["__call__"][0] + inter["pos_embeddings"]["__call__"][0]
        m = port.TransformerLM(**DIMS, dtype=torch.bfloat16, device="cpu")
        load_flax_params(m, flat)
        got = _first_layer_norm_input(port, lambda: m(tok), monkeypatch)
    else:
        want = _first_layer_norm_input(
            ref, lambda: ref.tp_apply(params, jnp.asarray(tokens), n_heads=DIMS["n_heads"],
                                      dtype=jnp.bfloat16), monkeypatch)
        tree = params_from_flax(flat, device="cpu")
        got = _first_layer_norm_input(
            port, lambda: port.tp_apply(tree, tok, n_heads=DIMS["n_heads"],
                                        dtype=torch.bfloat16), monkeypatch)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))


def test_sp_parity_tool_two_gloo_ranks():
    """``tools/sp_parity`` (the multi-card check of the SP path) on the CPU:
    a data 1 x seq 2 ring against one whole-batch dense process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.sp_parity", "--ranks", "2",
         "--seq", "2", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["mesh"] == {"data": 1, "seq": 2} and result["ranks_identical"]
    assert result["max_loss_rel_err"] <= 1e-4 and result["params_beyond_tolerance"] == 0
