"""The port's data-parallel training step against the JAX package's.

Three steps of ``make_train_step`` at 2 gloo ranks on the CPU against
``horovod_tpu.jax.make_train_step`` on a 2-device ``data`` mesh: the same
GPT at bench ``--smoke`` size in f32, the same flax initial weights, the
same global batch (each rank takes its half, as the mesh shards it), and
``optax.adamw(3e-4)`` against ``AdamW(3e-4, weight_decay=1e-4, eps=1e-8)``.

Tolerance. Losses: rtol 1e-5. Parameters: each Adam step moves a
parameter by at most about lr = 3e-4, and only float round-off separates
the two gradients, so all but one element in 10^4 agree within a hundredth
of a step (3e-6). Adam divides each gradient by its own running RMS, so
where a gradient cancels to near zero its round-off becomes a visible part
of the step (up to 3% of a step seen); those few elements are held only to
what three steps can move at all, 2 * lr * 3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import horovod_tpu.jax as hvdj
from horovod_tpu.models import transformer as ref
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.parallel.rules import named_tree_paths

from torch_port_harness import run_ranks

DIMS = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, max_len=128)
GLOBAL_BATCH, T, STEPS, N = 4, 128, 3, 2
LR = 3e-4

WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.utils.convert import load_flax_params, params_to_numpy

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
model = TransformerLM(**cfg["dims"], dtype=torch.float32, device="cpu", seed=100 + r)
if r == 0:   # the other ranks start elsewhere: broadcast_parameters fixes that
    load_flax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p:")})
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
opt = hvd.DistributedOptimizer(
    torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8),
    named_parameters=model.named_parameters())
hvd.broadcast_optimizer_state(opt, root_rank=0)
step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
per = data["tokens"].shape[0] // n
shard = slice(r * per, (r + 1) * per)
batch = (torch.from_numpy(data["tokens"][shard]), torch.from_numpy(data["labels"][shard]))
losses = [float(step(model, batch)) for _ in range(cfg["steps"])]
np.savez(f"{d}/rank{r}.npz", losses=np.array(losses),
         **{f"p:{k}": v for k, v in params_to_numpy(model).items()})
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, DIMS["vocab_size"], (GLOBAL_BATCH, T)).astype(np.int32)
    labels = rng.randint(0, DIMS["vocab_size"], (GLOBAL_BATCH, T)).astype(np.int32)
    model = ref.TransformerLM(**DIMS, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    init = {n: np.asarray(l) for n, l in named_tree_paths(params)}

    d = tmp_path_factory.mktemp("torch_train")
    np.savez(d / "inputs.npz", tokens=tokens.astype(np.int64), labels=labels.astype(np.int64),
             **{f"p:{k}": v for k, v in init.items()})
    (d / "cfg.json").write_text(json.dumps({"dims": DIMS, "steps": STEPS}))
    run_ranks(WORKER, N, d)
    port = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]

    def loss_fn(p, batch):
        tok, lab = batch
        return ref.lm_loss(model.apply({"params": p}, tok), lab)

    mesh = build_mesh({"data": N}, devices=jax.devices()[:N])
    tx = optax.adamw(LR)
    step = hvdj.make_train_step(loss_fn, tx, mesh)
    opt_state = tx.init(params)
    batch = (jnp.asarray(tokens), jnp.asarray(labels))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    final = {n: np.asarray(l) for n, l in named_tree_paths(params)}
    return port, losses, final, init


def test_losses_match_jax(runs):
    port, losses, _, _ = runs
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], losses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_params_match_jax_after_steps(runs):
    port, _, final, init = runs
    diffs = []
    for name, want in final.items():
        got = port[0][f"p:{name}"]
        assert got.shape == want.shape, name
        assert not np.array_equal(got, init[name]), name
        diffs.append(np.abs(got - want).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR * STEPS            # no more than Adam can move
    assert np.mean(diffs > LR / 100) <= 1e-4       # the bulk within 1% of a step


def test_ranks_hold_identical_params(runs):
    port = runs[0]
    for key in port[0]:
        np.testing.assert_array_equal(port[1][key], port[0][key], err_msg=key)


@pytest.fixture
def one_rank(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def test_backward_passes_per_step_averages_microbatches(one_rank):
    """Two accumulated half-batch backward passes with
    ``backward_passes_per_step=2`` give the full-batch mean gradient, the
    contract of ``GradientAccumulator`` in the JAX package."""
    hvd = one_rank
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(3, 2))
    x = torch.randn(4, 3)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.0), backward_passes_per_step=2)
    for half in (x[:2], x[2:]):
        (half @ w).pow(2).mean().backward()
    opt.synchronize()
    full = torch.autograd.grad((x @ w).pow(2).mean(), w)[0]
    torch.testing.assert_close(w.grad, full)

    acc = hvdj.GradientAccumulator(2)
    port_acc = hvd.GradientAccumulator(2)
    g = {"a": torch.ones(2), "b": [torch.full((3,), 2.0)]}
    total = port_acc.add(port_acc.add(port_acc.init(g), g), g)
    assert torch.equal(total["a"], torch.full((2,), 2.0))
    assert torch.equal(total["b"][0], torch.full((3,), 4.0))
    assert [port_acc.should_reduce(i) for i in range(4)] == [acc.should_reduce(i) for i in range(4)]


@pytest.mark.parametrize("option", ["hierarchical", "tuned"])
def test_unported_options_raise(one_rank, option):
    """What is left unported: plan selection (hierarchical="planned"; True
    runs two-level, tests/test_torch_hierarchical.py) and pinned tunings,
    both ROADMAP A13."""
    hvd = one_rank
    w = torch.nn.Parameter(torch.zeros(2))
    value = "planned" if option == "hierarchical" else True
    with pytest.raises(NotImplementedError, match=option):
        hvd.make_train_step(lambda p, b: p.sum(), torch.optim.SGD([w], lr=0.1),
                            **{option: value})


@pytest.mark.parametrize("kwargs,match", [
    (dict(quantized=True, compression="fp16"), "already compresses the wire to int8"),
    (dict(quantized=True, op="Max"), "quantized=True supports"),
    (dict(overlap=True, op="Adasum"), "overlap=True supports elementwise"),
    (dict(zero1=True, compression="fp16"), "cast compression has no"),
    (dict(error_feedback=True), "error_feedback=True requires quantized=True"),
])
def test_bad_combinations_raise_like_jax(one_rank, kwargs, match):
    """Each combination the JAX builders refuse with a ValueError, the
    port's builder refuses too."""
    import horovod_tpu as hvd_jax

    hvd = one_rank
    port = dict(kwargs)
    ref = dict(kwargs)
    if "compression" in kwargs:
        port["compression"] = hvd.Compression.fp16
        ref["compression"] = hvd_jax.Compression.fp16
    if "op" in kwargs:
        port["op"] = getattr(hvd, kwargs["op"])
        ref["op"] = getattr(hvd_jax, kwargs["op"])
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=match):
        hvdj.make_train_step(lambda p, b: jnp.sum(p), optax.sgd(0.1), mesh, **ref)
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match=match):
        hvd.make_train_step(lambda p, b: p.sum(), torch.optim.SGD([w], lr=0.1), **port)


def test_make_train_step_wraps_plain_optimizer_and_returns_aux(one_rank):
    hvd = one_rank
    w = torch.nn.Parameter(torch.ones(2))
    step = hvd.make_train_step(lambda p, b: ((p * b).sum(), {"n": b.sum()}),
                               torch.optim.SGD([w], lr=0.5), has_aux=True)
    loss, aux = step(w, torch.tensor([1.0, 2.0]))
    assert loss.item() == 3.0 and aux["n"].item() == 3.0
    torch.testing.assert_close(w.detach(), torch.tensor([0.5, 0.0]))
    with pytest.raises(ValueError, match="DistributedOptimizer"):
        hvd.make_train_step(lambda p, b: p.sum(),
                            hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1)),
                            op=hvd.Sum)


def test_dp_parity_tool_two_gloo_ranks():
    """``tools/dp_parity`` (the multi-card check of the DP path) on the CPU:
    2 ranks on shards against one process on the whole batch."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.dp_parity", "--ranks", "2",
         "--device", "cpu"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ranks"] == 2 and result["ranks_identical"]
    assert result["max_loss_rel_err"] <= 1e-5


def test_broadcast_optimizer_state_keeps_state_and_types(one_rank):
    """With state present (after a step), the broadcast carries tensors and
    numbers back with their types and devices (one rank: unchanged)."""
    hvd = one_rank
    w = torch.nn.Parameter(torch.ones(3))
    opt = hvd.DistributedOptimizer(torch.optim.AdamW([w], lr=0.1, weight_decay=1e-4))
    w.grad = torch.full((3,), 0.5)
    opt.step()
    before = {k: v.clone() for k, v in opt.state[w].items()}
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    after = opt.state[w]
    for key, value in before.items():
        assert torch.equal(after[key], value) and after[key].device == value.device
    group = opt.param_groups[0]
    assert isinstance(group["lr"], float) and group["lr"] == 0.1
    assert isinstance(group["amsgrad"], bool) and group["amsgrad"] is False
