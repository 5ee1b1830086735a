"""The port's GPT against the JAX package's, at bench ``--smoke`` size.

The same weights (``TransformerLM.init``, carried over by
``params_from_flax``) and the same tokens, made from a seeded numpy
generator, go through both. Both forms of the port are checked: the
``nn.Module`` against the flax module, ``tp_apply`` against ``tp_apply``.

Tolerances. In f32 both sides compute the same function with other
summation orders (XLA's and oneDNN's matmuls, the online softmax in the
attention); the logits sum over d_model 128 and the gradients over 256
tokens, so they agree to about 1e-6 relative and are held at rtol 1e-4 /
atol 1e-5. In bf16 the two frameworks round at other places, so the
bf16 run is held at the flash tests' 5e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel.rules import named_tree_paths
from horovod_tpu_torch.models import transformer as port
from horovod_tpu_torch.utils.convert import (
    flatten,
    load_flax_params,
    nest,
    param_tree,
    params_from_flax,
    params_to_numpy,
)

DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=128)
B, T = 2, 128


@pytest.fixture(scope="module")
def setup():
    model = ref.TransformerLM(**DIMS, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, DIMS["vocab_size"], (B, T)).astype(np.int32)
    labels = rng.randint(0, DIMS["vocab_size"], (B, T)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    flat = {n: np.asarray(l) for n, l in named_tree_paths(params)}
    return params, flat, tokens, labels


def _port_module(flat, dtype=torch.float32):
    m = port.TransformerLM(**DIMS, dtype=dtype, device="cpu", seed=123)
    load_flax_params(m, flat)
    return m


def test_params_from_flax_of_init(setup):
    params, flat, _, _ = setup
    tree = params_from_flax(flat, device="cpu")
    assert params_to_numpy(tree).keys() == flat.keys()
    for n, a in params_to_numpy(tree).items():
        np.testing.assert_array_equal(a, flat[n])
    # The module's parameters map one to one onto the flax tree.
    m = port.TransformerLM(**DIMS, dtype=torch.float32, device="cpu")
    names = {n.replace(".", "/"): tuple(p.shape) for n, p in m.named_parameters()}
    assert names == {n: a.shape for n, a in flat.items()}
    load_flax_params(m, flat)
    for n, a in params_to_numpy(m).items():
        np.testing.assert_array_equal(a, flat[n])


def _jax_module_fn(params, tokens, labels, dtype):
    model = ref.TransformerLM(**DIMS, dtype=dtype)

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return ref.lm_loss(logits, jnp.asarray(labels)), logits

    return loss


def _jax_tp_fn(params, tokens, labels, dtype):
    def loss(p):
        logits = ref.tp_apply(p, jnp.asarray(tokens), n_heads=DIMS["n_heads"], dtype=dtype)
        return ref.lm_loss(logits, jnp.asarray(labels)), logits

    return loss


@pytest.mark.parametrize("form", ["module", "tp_apply"])
def test_f32_logits_loss_grads_match_jax(setup, form):
    params, flat, tokens, labels = setup
    fn = (_jax_module_fn if form == "module" else _jax_tp_fn)(
        params, tokens, labels, jnp.float32)
    (loss_ref, logits_ref), grads_ref = jax.value_and_grad(fn, has_aux=True)(params)
    grads_ref = {n: np.asarray(g) for n, g in named_tree_paths(grads_ref)}

    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    if form == "module":
        m = _port_module(flat)
        logits = m(tok)
        leaves = dict(m.named_parameters())
    else:
        leaves = {n.replace("/", "."): t.requires_grad_() for n, t in
                  flatten(params_from_flax(flat, device="cpu")).items()}
        tree = nest(leaves, sep=".")
        logits = port.tp_apply(tree, tok, n_heads=DIMS["n_heads"], dtype=torch.float32)
    loss = port.lm_loss(logits, lab)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    got = {n.replace(".", "/"): p.grad.numpy() for n, p in leaves.items()}
    assert got.keys() == grads_ref.keys()
    for n in got:
        np.testing.assert_allclose(got[n], grads_ref[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("form", ["module", "tp_apply"])
def test_bf16_logits_match_jax(setup, form):
    params, flat, tokens, labels = setup
    fn = (_jax_module_fn if form == "module" else _jax_tp_fn)(
        params, tokens, labels, jnp.bfloat16)
    loss_ref, logits_ref = fn(params)
    tok = torch.from_numpy(tokens)
    if form == "module":
        logits = _port_module(flat, torch.bfloat16)(tok)
    else:
        logits = port.tp_apply(params_from_flax(flat, device="cpu"), tok,
                               n_heads=DIMS["n_heads"], dtype=torch.bfloat16)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(port.lm_loss(logits, torch.from_numpy(labels)).item(),
                               float(loss_ref), rtol=5e-2)


def test_module_and_twin_agree_on_one_tree(setup):
    """The module and ``tp_apply`` over the module's own parameters."""
    _, flat, tokens, labels = setup
    m = _port_module(flat)
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    loss_fn = port.make_gpt_loss_fn(DIMS["n_heads"], dtype=torch.float32)
    torch.testing.assert_close(loss_fn(param_tree(m), (tok, lab)),
                               port.lm_loss(m(tok), lab), rtol=1e-6, atol=1e-6)


def test_tensor_parallel_not_ported_yet(setup):
    """Tensor parallelism is ported now (tests/test_torch_tp.py holds it
    against the JAX package); what is left to refuse here is a model axis
    named with no mesh in scope to look it up in."""
    _, flat, tokens, _ = setup
    with pytest.raises(ValueError, match="no mesh is in scope"):
        port.tp_apply(params_from_flax(flat, device="cpu"), torch.from_numpy(tokens),
                      n_heads=DIMS["n_heads"], model_axis="model")


def test_head_dim_16_trains_against_flax(monkeypatch):
    """A GPT with d_model / n_heads = 16, a head dim the kernels are not
    built for: the port pads it to 32 on the flash path (checked by the
    head dims the flash forward receives) and takes 3 AdamW steps against
    the flax module and optax.adamw on the same weights and batch. Losses
    at rtol 1e-5; parameters as tests/test_torch_train.py holds them: all
    within what 3 steps can move, the bulk within 1% of a step."""
    from horovod_tpu_torch.ops import flash_attention as fa
    import optax

    dims = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, max_len=32)
    lr, steps = 1e-3, 3
    rng = np.random.RandomState(16)
    tokens = rng.randint(0, dims["vocab_size"], (2, 32)).astype(np.int32)
    labels = rng.randint(0, dims["vocab_size"], (2, 32)).astype(np.int32)
    model = ref.TransformerLM(**dims, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens[:1]))["params"]
    flat = {n: np.asarray(l) for n, l in named_tree_paths(params)}

    tx = optax.adamw(lr)
    loss_fn = lambda p: ref.lm_loss(model.apply({"params": p}, jnp.asarray(tokens)),
                                    jnp.asarray(labels))
    state, want_losses = tx.init(params), []
    for _ in range(steps):
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(loss))

    seen = []
    fwd = fa._flash_fwd
    monkeypatch.setattr(fa, "_flash_fwd", lambda q, *a: seen.append(q.shape[-1]) or fwd(q, *a))
    m = port.TransformerLM(**dims, dtype=torch.float32, device="cpu", seed=7)
    load_flax_params(m, flat)
    opt = torch.optim.AdamW(m.parameters(), lr=lr, weight_decay=1e-4, eps=1e-8)
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    got_losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = port.lm_loss(m(tok), lab)
        loss.backward()
        opt.step()
        got_losses.append(loss.item())
    assert set(seen) == {32} and len(seen) == steps * dims["n_layers"]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert want_losses[-1] < want_losses[0]
    got = params_to_numpy(m)
    diffs = np.concatenate([np.abs(got[n] - np.asarray(l)).ravel()
                            for n, l in named_tree_paths(params)])
    assert diffs.max() <= 2 * lr * steps
    assert np.mean(diffs > lr / 100) <= 1e-4
