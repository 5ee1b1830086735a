"""The binding's tools on the CPU: the micro-benchmark at 2 gloo ranks and
the three PyTorch example copies with ``--no-cuda``.

- ``utils/micro_bench.py`` at 2 gloo ranks, 2 reps a size (the rep count is
  capped for time): one row a payload size (1 KiB to 16 MiB), every column
  of the JAX worker's rows present, every latency positive.
- ``horovod_tpu_torch/examples/pytorch_*.py``: each copy runs once with
  ``--no-cuda`` at its smallest size and exits 0.
"""

import json
import os
import subprocess
import sys

import pytest

from torch_port_harness import REPO

COLUMNS = {"bytes", "np", "reps", "noise_band_us", "overhead_within_noise", "floor_source",
           "eager_np_med_us", "eager_dev_med_us", "compiled_med_us", "overhead_np_med_us",
           "overhead_dev_med_us", "eager_np_us", "eager_dev_us", "compiled_us",
           "overhead_np_us", "overhead_dev_us", "ref_psum_med_us", "ref_psum_us"}


def _env(tmp_path):
    return dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")


def test_micro_bench_two_gloo_ranks(tmp_path):
    out = tmp_path / "micro.json"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.utils.micro_bench", "--ranks", "2",
         "--device", "cpu", "--max-reps", "2", "--out", str(out)],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    record = json.loads(out.read_text())
    assert record["ranks"] == 2 and record["device"] == "cpu" and not record["one_rank"]
    rows = record["rows"]
    assert [r["bytes"] for r in rows] == [1 << 10, 1 << 16, 1 << 20, 1 << 24]
    for r in rows:
        assert COLUMNS <= set(r), COLUMNS - set(r)
        assert r["np"] == 2 and r["reps"] == 2
        for k in ("eager_np_med_us", "eager_dev_med_us", "compiled_med_us", "eager_np_us",
                  "eager_dev_us", "compiled_us", "ref_psum_med_us", "ref_psum_us"):
            assert r[k] > 0, (k, r)


def test_micro_bench_needs_two_ranks_or_the_flag():
    from horovod_tpu_torch.utils import micro_bench

    with pytest.raises(SystemExit):
        micro_bench.main(["--ranks", "1"])
    assert micro_bench.reps_for(1 << 10) == 100 and micro_bench.reps_for(1 << 24) == 10
    assert micro_bench.reps_for(1 << 20, cap=3) == 3


@pytest.mark.parametrize("name,argv", [
    ("pytorch_mnist", []),
    ("pytorch_synthetic_benchmark", ["--batch-size", "2", "--image-size", "32",
                                     "--num-warmup-batches", "1",
                                     "--num-batches-per-iter", "1", "--num-iters", "1"]),
    ("pytorch_imagenet_resnet50", ["--epochs", "1", "--synthetic-batches", "1",
                                   "--batch-size", "2", "--val-batch-size", "2",
                                   "--image-size", "32"]),
])
def test_example_runs_on_the_cpu(tmp_path, name, argv):
    if name == "pytorch_imagenet_resnet50":
        argv = argv + ["--checkpoint-format", str(tmp_path / "ck-{epoch}.pth.tar")]
    proc = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.examples.{name}", "--no-cuda", *argv],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip()
