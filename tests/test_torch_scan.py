"""``utils/step_graph.capture_step`` (the counterpart of the JAX bench's
``scan_steps``) and the bench's ``--scan``, against the JAX package.

- Three AdamW steps of the 2-layer GPT of ``torch_port_harness.GPT_DIMS``
  from one set of flax weights, at one rank on the CPU: one
  ``capture_step(..., length=3)`` call against the JAX DP step under
  ``jax.lax.scan(length=3)``, and against three plain port steps (bitwise:
  on the CPU a call runs the steps eagerly). Against JAX the loss and the
  parameters are held at rtol 1e-5 / atol 1e-6, the DP parity tolerance,
  except the parameters whose first gradient is nonzero but under ten times
  AdamW's eps (1e-8): there the update ``g / (|g| + eps)`` turns the two
  frameworks' round-off in ``g`` (~1e-9) into up to ~1% of a step (C2's
  finding). Those (7 of 134,400 elements here) are held to what three
  Adam steps can move, 2 * lr * 3.
- ``bench --smoke --device cpu`` for the transformer and ResNet-18 with
  ``--scan`` and ``--no-scan``: the same last loss bitwise, ``detail.scan``
  saying which ran; ``--tp 2 --ranks 2 --scan`` turns the scan off with the
  JAX bench's stderr line.
- The public names of ``horovod_tpu.jax`` and ``horovod_tpu`` against the
  port's ``train`` and root: each has its counterpart there, or is one of
  the names ROADMAP's "Not to port" gives a reason for.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import horovod_tpu
import horovod_tpu.jax as hvdj
from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.parallel.rules import named_tree_paths

import horovod_tpu_torch as hvd
import horovod_tpu_torch.train as port_train
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.utils.convert import load_flax_params, params_to_numpy
from horovod_tpu_torch.utils.step_graph import StepGraph, capture_step

from torch_port_harness import GPT_DIMS, GPT_LR, GPT_STEPS, REPO, gpt_setup


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX DP step on a 1-device data mesh, three steps folded into one
    ``lax.scan`` as the JAX bench's ``scan_steps`` folds them."""
    model, params, tokens, labels = gpt_setup()
    init = {k: np.asarray(v) for k, v in named_tree_paths(params)}

    def loss_fn(p, b):
        return ref.lm_loss(model.apply({"params": p}, b[0]), b[1])

    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    tx = optax.adamw(GPT_LR)
    step = hvdj.make_train_step(loss_fn, tx, mesh, donate=False)
    batch = (jnp.asarray(tokens), jnp.asarray(labels))

    @jax.jit
    def scan_steps(p, s):
        def body(carry, _):
            p, s = carry
            p, s, loss = step(p, s, batch)
            return (p, s), loss

        (p, s), losses = jax.lax.scan(body, (p, s), None, length=GPT_STEPS)
        return p, s, losses[-1]

    p, _, loss = scan_steps(params, tx.init(params))
    final = {k: np.asarray(v) for k, v in named_tree_paths(p)}
    grads = jax.grad(lambda q: loss_fn(q, batch))(params)
    first = {k: np.abs(np.asarray(v)) for k, v in named_tree_paths(grads)}
    return init, tokens, labels, float(loss), final, first


@pytest.fixture()
def one_rank(tmp_path):
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _port_step(init, tokens, labels):
    model = TransformerLM(**GPT_DIMS, dtype=torch.float32, device="cpu", seed=0)
    load_flax_params(model, init)
    opt = torch.optim.AdamW(model.parameters(), lr=GPT_LR, weight_decay=1e-4, eps=1e-8)
    step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
    batch = (torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(labels.astype(np.int64)))
    return model, step, batch


def test_three_scanned_steps_match_jax_scan_and_plain_steps(jax_scan, one_rank):
    init, tokens, labels, want_loss, want, first = jax_scan
    model, step, batch = _port_step(init, tokens, labels)
    run = capture_step(step, model, batch, length=GPT_STEPS, warmup=0)
    loss = run()
    assert run.graph is None and run.launches is None and run.form.startswith("eager loop")
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5, atol=1e-6)
    got = params_to_numpy(model)
    eps_scale = 0
    for name, w in want.items():
        assert not np.array_equal(got[name], init[name]), name
        tiny = (first[name] > 0) & (first[name] < 10 * 1e-8)
        eps_scale += int(tiny.sum())
        np.testing.assert_allclose(got[name][~tiny], w[~tiny], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert np.all(np.abs(got[name][tiny] - w[tiny]) <= 2 * GPT_LR * GPT_STEPS), name
    assert eps_scale <= 1e-4 * sum(w.size for w in want.values()), eps_scale

    plain_model, plain_step, plain_batch = _port_step(init, tokens, labels)
    for _ in range(GPT_STEPS):
        plain_loss = plain_step(plain_model, plain_batch)
    assert torch.equal(plain_loss, loss)
    for name, p in params_to_numpy(plain_model).items():
        np.testing.assert_array_equal(got[name], p, err_msg=name)


def test_capture_runs_the_warmup_once_then_length_steps_a_call(one_rank):
    """The warm-up steps run once, at ``capture()`` or at the first call;
    each call runs ``length`` steps; the CPU has no graph."""
    calls = []

    def step(params, batch):
        calls.append(1)
        params[0].add_(batch)
        return params[0].sum()

    x = torch.zeros(2)
    run = capture_step(step, [x], torch.ones(2), length=3, warmup=2)
    assert isinstance(run, StepGraph) and not run.on_card
    assert float(run.capture()) == 4.0 and len(calls) == 2
    assert run.capture() is None and len(calls) == 2
    assert float(run()) == 10.0 and len(calls) == 5
    lazy = capture_step(step, [x], torch.ones(2), length=1, warmup=1)
    assert float(lazy()) == 14.0 and len(calls) == 7
    for bad in ({"length": 0}, {"length": 1, "warmup": -1}):
        with pytest.raises(ValueError):
            capture_step(step, [x], x, **bad)


def _bench(*argv, **extra_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO, **extra_env)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--smoke", "--device", "cpu",
         *argv], env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])["detail"], proc.stderr


@pytest.mark.parametrize("model", ["transformer", "resnet18"])
def test_bench_scan_and_no_scan_end_on_the_same_loss(model):
    """The same warm-up and timed steps either way: the last loss bitwise,
    and ``detail.scan`` says which mode ran. With the trace tap armed the
    transformer's step spans are the 2 x 2 timed steps' in both modes."""
    trace = {"HOROVOD_TRACE": "1"} if model == "transformer" else {}
    scanned, _ = _bench("--model", model, "--scan", **trace)
    plain, _ = _bench("--model", model, "--no-scan", **trace)
    assert scanned["scan"] is True and plain["scan"] is False
    assert scanned["scan_form"].startswith("eager loop") and "scan_form" not in plain
    assert np.isfinite(plain["loss"]) and scanned["loss"] == plain["loss"]
    if trace:
        for detail in (scanned, plain):
            spans = detail["step_skew"]["step_spans"]
            assert (spans["source"], spans["steps"], spans["steps_per_span"]) == \
                ("trace-step-tap", 4, 1), spans


def test_bench_tp_turns_the_scan_off_with_bench_pys_line():
    detail, err = _bench("--model", "transformer", "--tp", "2", "--ranks", "2", "--scan",
                         "--num-warmup-batches", "1")
    assert ("[bench] --tp: on-device scan disabled (the composed step builds on first call)"
            in err)
    assert detail["scan"] is False and detail["reduction_mode"] == "posthoc+tp2"


# The public names of the JAX package's modules that have no counterpart
# in the port (ROADMAP "Not to port" gives the same reasons).
NOT_TO_PORT = {
    "Mesh": "jax.sharding's mesh: the port's meshes are torch DeviceMeshes (parallel/mesh.py)",
    "P": "jax.sharding.PartitionSpec: the port's rules carry their own spec form",
    "shard_tree": "device_put onto NamedShardings: a torch rank holds its shards as tensors "
                  "(local_shard_tree)",
    "gather_tree": "the inverse device_put: a torch rank gathers its shards by all_gather",
    "make_shard_and_gather_fns": "jitted device_put pairs per leaf; nothing to jit in torch",
    "preflight_rules": "replaced by analysis.preflight.check_sharding_rules",
    "stream_scan_body": "a lax.scan body over stacked layer parameters: each torch layer's "
                        "parameters are tensors of their own, which the streamed hooks "
                        "already reduce (stream_param_groups)",
}


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)
            and getattr(getattr(module, n), "__module__", None) not in ("typing", "__future__")
            and type(getattr(module, n)).__module__ != "__future__"}


@pytest.mark.parametrize("jax_module,port_modules", [
    (hvdj, (port_train, hvd)), (horovod_tpu, (hvd,)),
])
def test_public_names_have_their_counterparts(jax_module, port_modules):
    have = set().union(*(_public(m) for m in port_modules))
    missing = _public(jax_module) - have - set(NOT_TO_PORT)
    assert not missing, sorted(missing)
    assert not set(NOT_TO_PORT) & have, sorted(set(NOT_TO_PORT) & have)
