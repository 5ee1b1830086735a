"""The port's data-parallel CNN step (BatchNorm state) against the JAX
package's, the port's bench, and the CNN parity tool.

The step: ``ResNet(stage_sizes=[1, 1], num_filters=8)`` in f32 at 32 px,
SGD 0.01 with momentum 0.9, three steps of the port's ``make_train_step``
against ``horovod_tpu.jax.make_train_step(has_aux=True)``, whose loss
returns the new ``batch_stats`` as aux (pmean-averaged by the step, as
``bench.py:1575`` does) and takes them back in at the next step. On one
device; then at 2 gloo ranks against a 2-device ``data`` mesh, where each
rank normalises its own half of the batch and the running statistics are
averaged. Both sides start from the same weights and from running
statistics that are not flax's defaults, which rank 0 alone holds before
``broadcast_parameters``.

Tolerance. Losses rtol 1e-5; parameters and running statistics atol
1e-5 / rtol 1e-4 (SGD moves a parameter by lr · g, and only float
round-off separates the two gradients).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import horovod_tpu.jax as hvdj
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu.parallel.mesh import build_mesh
from horovod_tpu.parallel.rules import named_tree_paths

from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.utils.convert import batch_stats_to_numpy, nest, params_to_numpy

from torch_port_harness import REPO, run_ranks

GLOBAL_BATCH, SIDE, CLASSES, STEPS, LR = 4, 32, 10, 3, 0.01
TOL = dict(rtol=1e-4, atol=1e-5)

WORKER = r'''
import json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.resnet import ResNet
from horovod_tpu_torch.utils.convert import (
    batch_stats_to_numpy, load_flax_params, params_to_numpy)

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
model = ResNet([1, 1], 10, 8, torch.float32, device="cpu", seed=100 + r)
if r == 0:   # the other ranks start elsewhere, statistics too: the broadcast fixes that
    load_flax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p:")},
                     {k[2:]: data[k] for k in data.files if k.startswith("s:")})
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
broadcast = batch_stats_to_numpy(model)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                               named_parameters=model.named_parameters())
step = hvd.make_train_step(lambda m, b: F.cross_entropy(m(b[0]), b[1]), opt)
per = data["images"].shape[0] // n
shard = slice(r * per, (r + 1) * per)
batch = (torch.from_numpy(data["images"][shard]), torch.from_numpy(data["labels"][shard]))
losses = [float(step(model, batch)) for _ in range(int(data["steps"]))]
np.savez(f"{d}/rank{r}.npz", losses=np.array(losses),
         **{f"p:{k}": v for k, v in params_to_numpy(model).items()},
         **{f"s:{k}": v for k, v in batch_stats_to_numpy(model).items()},
         **{f"b:{k}": v for k, v in broadcast.items()})
hvd.shutdown()
'''


def _start():
    """Inputs, and starting weights and (non-default) running statistics
    from the port's seeded init, as flat flax-named numpy trees."""
    rng = np.random.RandomState(0)
    images = rng.randn(GLOBAL_BATCH, SIDE, SIDE, 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, GLOBAL_BATCH)
    model = resnet.ResNet([1, 1], CLASSES, 8, torch.float32, device="cpu", seed=7)
    params = params_to_numpy(model)
    stats = {n: (0.2 + 0.5 * rng.rand(*v.shape)).astype(np.float32) if n.endswith("var")
             else (0.1 * rng.randn(*v.shape)).astype(np.float32)
             for n, v in batch_stats_to_numpy(model).items()}
    return images, labels, params, stats


def _jax_steps(images, labels, params, stats, n_devices):
    """The JAX step on a ``data`` mesh of ``n_devices``: losses, and the
    final parameters and running statistics as flat numpy trees."""
    model = ref_resnet.ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=CLASSES,
                              dtype=jnp.float32)

    def loss_fn(state, batch):
        x, y = batch
        logits, new = model.apply(state, x, train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, new["batch_stats"]

    # The running statistics ride in the step's parameter tree: no loss
    # reads them in training, so their gradients are zero and SGD leaves
    # them; the step's averaged aux replaces them after each step.
    state = jax.tree.map(jnp.asarray, {"params": nest(params), "batch_stats": nest(stats)})
    tx = optax.sgd(LR, momentum=0.9)
    step = hvdj.make_train_step(loss_fn, tx, build_mesh({"data": n_devices},
                                                        devices=jax.devices()[:n_devices]),
                                has_aux=True)
    opt_state = tx.init(state)
    batch = (jnp.asarray(images), jnp.asarray(labels, jnp.int32))
    losses = []
    for _ in range(STEPS):
        state, opt_state, loss, new_stats = step(state, opt_state, batch)
        state = {"params": state["params"], "batch_stats": new_stats}
        losses.append(float(loss))
    flat = lambda t: {n: np.asarray(v) for n, v in named_tree_paths(t)}  # noqa: E731
    return losses, flat(state["params"]), flat(state["batch_stats"])


def _assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=f"{what} {name}")


def test_one_device_step_matches_jax_has_aux(tmp_path):
    """Three steps on one rank: the port's buffers, updated by the forward
    and averaged over one rank, follow the JAX step's aux."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.convert import load_flax_params

    images, labels, params, stats = _start()
    want_losses, want_params, want_stats = _jax_steps(images, labels, params, stats, 1)
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        model = resnet.ResNet([1, 1], CLASSES, 8, torch.float32, device="cpu", seed=0)
        load_flax_params(model, params, stats)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
                                       named_parameters=model.named_parameters())
        step = hvd.make_train_step(lambda m, b: F.cross_entropy(m(b[0]), b[1]), opt)
        batch = (torch.from_numpy(images), torch.from_numpy(labels))
        losses = [float(step(model, batch)) for _ in range(STEPS)]
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _assert_trees_close(params_to_numpy(model), want_params, "param")
    _assert_trees_close(batch_stats_to_numpy(model), want_stats, "stats")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    images, labels, params, stats = _start()
    d = tmp_path_factory.mktemp("torch_cnn_train")
    np.savez(d / "inputs.npz", images=images, labels=labels.astype(np.int64), steps=STEPS,
             **{f"p:{k}": v for k, v in params.items()},
             **{f"s:{k}": v for k, v in stats.items()})
    run_ranks(WORKER, 2, d)
    port = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return port, stats, _jax_steps(images, labels, params, stats, 2)


def test_two_ranks_match_jax_two_device_mesh(two_ranks):
    """Per-shard BatchNorm, gradients averaged over the fused allreduce,
    running statistics averaged over the data axis after the update."""
    port, _, (want_losses, want_params, want_stats) = two_ranks
    for r in range(2):
        np.testing.assert_allclose(port[r]["losses"], want_losses, rtol=1e-5)
        got = {k[2:]: v for k, v in port[r].items() if k.startswith("p:")}
        _assert_trees_close(got, want_params, f"rank {r} param")
        got = {k[2:]: v for k, v in port[r].items() if k.startswith("s:")}
        _assert_trees_close(got, want_stats, f"rank {r} stats")


def test_broadcast_parameters_carries_the_running_statistics(two_ranks):
    port, stats, _ = two_ranks
    for r in range(2):
        for name, want in stats.items():
            np.testing.assert_array_equal(port[r][f"b:{name}"], want, err_msg=name)
    for key in port[0]:
        np.testing.assert_array_equal(port[1][key], port[0][key], err_msg=key)


def _subprocess_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    return env


# The detail keys bench.py prints (bench.py:1674-1692 and :1121-1182), less
# the blocks of subsystems the port has not ported (wire, step_skew, sim,
# mesh) and less the reference's supervisor.
CNN_DETAIL = {"total_img_per_sec", "n_chips", "batch_per_chip", "image_size", "loss",
              "platform", "device_kind", "scan", "dtype", "tuned", "mfu",
              "flops_per_step_per_chip", "flops_source", "backend_init_s",
              "backend_init_attempts"}
LM_DETAIL = {"total_tokens_per_sec", "n_chips", "batch_per_chip", "seq_len", "n_params",
             "loss", "platform", "device_kind", "attention", "optimizer_state",
             "gradient_wire", "reduction_mode", "tuned", "step_time_s", "scan", "mfu",
             "flops_per_step_per_chip", "flops_source", "backend_init_s",
             "backend_init_attempts"}


@pytest.mark.parametrize("model,metric,unit,keys", [
    ("resnet50", "resnet50_synthetic_images_per_sec_per_chip", "img/s/chip", CNN_DETAIL),
    ("transformer", "transformer_synthetic_tokens_per_sec_per_chip", "tokens/s/chip",
     LM_DETAIL),
])
def test_bench_smoke_prints_bench_py_json_line(model, metric, unit, keys):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--smoke", "--device", "cpu",
         "--model", model, "--num-warmup-batches", "1"],
        env=_subprocess_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert out["metric"] == metric and out["unit"] == unit and out["value"] > 0
    assert keys <= set(out["detail"]), keys - set(out["detail"])
    detail = out["detail"]
    assert detail["platform"] == "cpu" and detail["mfu"] is None and detail["n_chips"] == 1
    assert detail["flops_source"] == "flop-counter" and detail["flops_per_step_per_chip"] > 0
    assert np.isfinite(detail["loss"])
    if model == "resnet50":
        assert out["vs_baseline"] == pytest.approx(out["value"] / (1656.82 / 16), abs=1e-3)


@pytest.mark.parametrize("flag,mode,state,wire", [
    ("--overlap", "overlap+streamed", "replicated", "full-precision"),
    ("--zero1", "posthoc+zero1", "zero1-sharded", "full-precision"),
    ("--quantized", "quantized", "replicated", "int8-quantized"),
])
def test_bench_variant_flags_report_bench_py_detail(flag, mode, state, wire):
    """``--overlap``, ``--zero1`` and ``--quantized`` run the transformer
    step and report ``bench.py``'s ``reduction_mode``, ``optimizer_state``
    and ``gradient_wire`` for the flag."""
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--smoke", "--device", "cpu",
         "--model", "transformer", "--num-warmup-batches", "1", flag],
        env=_subprocess_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    detail = json.loads(proc.stdout.strip().splitlines()[-1])["detail"]
    assert (detail["reduction_mode"], detail["optimizer_state"], detail["gradient_wire"]) == \
        (mode, state, wire)
    assert np.isfinite(detail["loss"])


@pytest.mark.parametrize("argv,item", [
    (["--tp", "2"], "A6"),
    (["--serve"], "A11"), (["--scan"], "'Next' 3"), (["--tuned", "t.json"], "A13"),
])
def test_bench_unported_options_exit_and_name_their_item(argv, item, capsys):
    from horovod_tpu_torch import bench

    with pytest.raises(SystemExit) as exc:
        bench.parse_args(argv + ["--device", "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP {item}" in err


def test_bench_moe_takes_the_reference_smoke_dims(capsys):
    """--model moe is ported (ROADMAP A10): --smoke takes bench.py's MoE
    smoke batch (2 x 64 tokens a card, 2 x 2 steps); the DP-step-only
    options are refused."""
    from horovod_tpu_torch import bench

    args = bench.parse_args(["--model", "moe", "--smoke", "--device", "cpu"])
    assert (args.batch_size, args.seq_len, args.num_batches_per_iter, args.num_iters) == \
        (2, 64, 2, 2)
    assert bench.moe_mesh_axes(8) == {"data": 2, "expert": 4}
    assert bench.moe_mesh_axes(6) == {"data": 3, "expert": 2}
    assert bench.moe_mesh_axes(3) == {"data": 3, "expert": 1}
    for flag in ("--overlap", "--zero1", "--quantized"):
        with pytest.raises(SystemExit):
            bench.parse_args(["--model", "moe", flag, "--device", "cpu"])


@pytest.mark.parametrize("argv,ranks,micro_ranks", [
    ([], 1, 0), (["--micro"], 1, 2), (["--micro", "--ranks", "4"], 4, 4),
])
def test_bench_micro_ranks(argv, ranks, micro_ranks):
    """--micro is ported (utils/micro_bench.py): its sweep runs at --ranks
    ranks, 2 by default, while the bench itself defaults to one."""
    from horovod_tpu_torch import bench

    args = bench.parse_args(argv + ["--device", "cpu"])
    assert (args.ranks, args.micro_ranks) == (ranks, micro_ranks)


def test_bench_micro_refuses_one_rank(capsys):
    from horovod_tpu_torch import bench

    with pytest.raises(SystemExit):
        bench.parse_args(["--micro", "--ranks", "1", "--device", "cpu"])
    assert "at least 2 ranks" in capsys.readouterr().err


def test_bench_mfu_is_null_past_one_and_peak_by_sku():
    from horovod_tpu_torch import bench

    assert bench._peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench._peak_flops("NVIDIA H100 PCIe") == 756e12
    assert bench._peak_flops("NVIDIA H100 NVL") == 835e12
    assert bench._peak_flops("cpu") is None
    assert bench._mfu(989e12 / 4, 1, 0.5, "NVIDIA H100 80GB HBM3") == 0.5
    assert bench._mfu(989e12, 2, 1.0, "NVIDIA H100 80GB HBM3") is None   # 2.0: published null
    assert bench._reconcile_flops(1e9, 8e9, "gpu")[1].startswith("analytic")
    assert bench._reconcile_flops(1e9, 8e9, "cpu") == (1e9, "flop-counter")


def test_dp_parity_tool_resnet18_two_gloo_ranks():
    """``tools/dp_parity --model resnet18`` on the CPU: 2 ranks against
    rank 0's replay of both shards, BatchNorm state included."""
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.dp_parity", "--ranks", "2",
         "--device", "cpu", "--model", "resnet18"],
        env={**_subprocess_env(), "OMP_NUM_THREADS": "1"}, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["model"] == "resnet18" and result["ranks"] == 2
    assert result["ranks_identical"] and result["stats_moved"]
    assert result["max_loss_rel_err"] <= 1e-5 and result["max_stats_abs_err"] <= 1e-4
