"""The trace reduction's arithmetic on synthetic intervals, and the check
that no JAX module was loaded."""

import pytest

from hvdbench import common
from hvdbench import trace as tr


def _reduced():
    host = [(0.0, 1.0, tr.STEP), (1.0, 2.0, tr.STEP), (0.1, 0.15, "cudaGraphLaunch"),
            (0.5, 0.9, "DistributedOptimizer.synchronize"), (0.4, 1.9, "outer")]
    device = [(0.2, 0.5, "gemm"), (0.3, 0.6, "ncclDevKernel_AllReduce"),
              (0.9, 1.2, "ncclDevKernel_AllReduce"), (1.1, 1.8, "gemm"),
              (1.95, 2.1, "flash_fwd")]
    return tr.reduce(device, host, 2)


def test_idle_is_the_window_less_the_union_of_device_intervals():
    r = _reduced()
    assert r["window_s"] == pytest.approx(2.1)
    # Union: [0.2, 0.6], [0.9, 1.8], [1.95, 2.1].
    assert r["busy_s"] == pytest.approx(0.4 + 0.9 + 0.15)
    assert r["ops"]["gemm"] == pytest.approx(1.0)


def test_exposed_nccl_is_what_no_other_operation_covers():
    r = _reduced()
    assert r["nccl_s"] == pytest.approx(0.6)
    # [0.3, 0.6] under gemm until 0.5; [0.9, 1.2] under gemm from 1.1.
    assert r["exposed_nccl_s"] == pytest.approx(0.1 + 0.2)
    assert tr.exposed([(0, 1)], [(0, 1)]) == 0
    assert tr.exposed([(0, 1), (0.5, 2)], []) == pytest.approx(2)


def test_idle_gaps_go_to_the_innermost_host_operation():
    gaps = _reduced()["gaps"]
    # [0.0, 0.2] starts before any host operation but the step's.
    assert gaps["host outside any traced op"] == pytest.approx(0.2)
    assert gaps["DistributedOptimizer.synchronize"] == pytest.approx(0.3)
    assert gaps["outer"] == pytest.approx(0.15)


def test_a_trace_with_no_device_operation_reduces_to_nothing():
    assert tr.reduce([], [(0.0, 1.0, tr.STEP)], 1) == {}


def test_the_jax_check_compares_whole_top_level_names():
    assert common.forbidden_modules(["horovod_tpu_torch", "horovod_tpu_torch.torch",
                                     "jaxtyping", "torch"]) == []
    assert common.forbidden_modules(["horovod_tpu.ops", "jax", "jaxlib.xla_client",
                                     "flax.linen", "optax", "torch"]) == [
        "flax.linen", "horovod_tpu.ops", "jax", "jaxlib.xla_client", "optax"]


def test_a_run_of_the_harness_loads_no_jax_module():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); from hvdbench import common, run, control, "
            "rehearse, compare, state, trace; from hvdbench.paths import graph, hooks; "
            "import horovod_tpu_torch, horovod_tpu_torch.torch, horovod_tpu_torch.run; "
            "print(common.forbidden_modules())" % common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**__import__("os").environ, "JAX_PLATFORMS": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
