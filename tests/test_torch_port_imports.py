"""The PyTorch port stands alone: no JAX at import, no reference imports,
the same knob registry as the JAX package, and no quiet CPU fallback for
an entry point that asks for the card."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu.common.env as ref_env
import horovod_tpu_torch.common.env as port_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "horovod_tpu_torch")


def test_import_loads_no_jax():
    # A subprocess: this test process imported jax already (conftest).
    code = (
        "import sys, horovod_tpu_torch, horovod_tpu_torch.models.transformer, "
        "horovod_tpu_torch.utils.convert, horovod_tpu_torch.ops.flash_attention, "
        "horovod_tpu_torch.parallel.mesh, horovod_tpu_torch.parallel.ring_attention, "
        "horovod_tpu_torch.parallel.sp, horovod_tpu_torch.tools.sp_parity, "
        "horovod_tpu_torch.tools.dp_parity, horovod_tpu_torch.tools.kernel_bounds, "
        "horovod_tpu_torch.examples.long_context_sp, horovod_tpu_torch.parallel.rules, "
        "horovod_tpu_torch.parallel.tp, horovod_tpu_torch.ops.collective_matmul, "
        "horovod_tpu_torch.tools.tp_parity, horovod_tpu_torch.models, "
        "horovod_tpu_torch.models.layers, horovod_tpu_torch.models.resnet, "
        "horovod_tpu_torch.models.vgg, horovod_tpu_torch.models.inception, "
        "horovod_tpu_torch.models.mnist_cnn, horovod_tpu_torch.bench, "
        "horovod_tpu_torch.common.quant, horovod_tpu_torch.ops.quantized, "
        "horovod_tpu_torch.ops.adasum, horovod_tpu_torch.parallel.zero, "
        "horovod_tpu_torch.guard, horovod_tpu_torch.guard.nonfinite, "
        "horovod_tpu_torch.topo, horovod_tpu_torch.topo.compositor, "
        "horovod_tpu_torch.parallel, horovod_tpu_torch.parallel._stacked, "
        "horovod_tpu_torch.parallel.pp, horovod_tpu_torch.parallel.ep, "
        "horovod_tpu_torch.utils.convergence, horovod_tpu_torch.tools.pp_parity, "
        "horovod_tpu_torch.tools.ep_parity, horovod_tpu_torch.examples.tp_pp_demo, "
        "horovod_tpu_torch.examples.moe_expert_parallel\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_planning_modules_load_no_jax():
    """The interconnect model, the planner, the verifier, the simulator and
    their tools, imported and driven once, leave jax, flax, optax and the
    JAX package out of sys.modules."""
    code = (
        "import sys, horovod_tpu_torch.topo as T, horovod_tpu_torch.sim as S, "
        "horovod_tpu_torch.analysis.plan_verify as V, horovod_tpu_torch.tools.topo_plan, "
        "horovod_tpu_torch.tools.fleet_sim as F\n"
        "m = T.synthetic_model(4, cross=2, generation='h100')\n"
        "assert T.select_plan(m, 'allreduce', 1 << 26).algorithm\n"
        "assert V.verify_plan_grid()[0] == []\n"
        "S.simulate(m, S.program_from_layers('p', [1 << 20] * 4), steps=2)\n"
        "S.simulate_serve(S.ServeSimConfig(qps=20, duration_s=1))\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_analysis_modules_and_cli_load_no_jax():
    """The static checks (``analysis/``: the sharding rules, the runtime
    lint, the graph lint, rank divergence, the pre-flight) and their CLI,
    imported and driven once without ranks, leave jax, flax, optax and the
    JAX package out of sys.modules."""
    code = (
        "import sys, horovod_tpu_torch.analysis as A, horovod_tpu_torch.analysis.graph_lint, "
        "horovod_tpu_torch.analysis.divergence, horovod_tpu_torch.analysis.runtime_lint, "
        "horovod_tpu_torch.analysis.sharding_rules as S, horovod_tpu_torch.analysis.preflight "
        "as P, horovod_tpu_torch.tools.collective_lint as L\n"
        "assert A.lint_runtime() == []\n"
        "assert S.validate_sharding_rules(S.EXAMPLE_GPT_RULES, S.EXAMPLE_GPT_MESH, "
        "S.example_gpt_params()) == []\n"
        "assert P.check_sharding_rules('gpt', {'data': 2, 'model': 2}) == []\n"
        "assert L.main(['sharding']) == 0\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_tune_modules_load_no_jax():
    """The tuner (``tune/``), its tools and the re-plan's planning half,
    imported and driven once (a GPT-2-small spec on the meta device tuned,
    a re-plan priced), leave jax, flax, optax and the JAX package out of
    sys.modules."""
    code = (
        "import sys, horovod_tpu_torch, horovod_tpu_torch.tune as T, "
        "horovod_tpu_torch.tools.autotune_compiled, horovod_tpu_torch.tools.tune_parity, "
        "horovod_tpu_torch.run.selfdrive as sd\n"
        "from horovod_tpu_torch.models.transformer import TransformerLM\n"
        "from horovod_tpu_torch.topo.model import synthetic_model\n"
        "m = TransformerLM(32768, d_model=768, n_heads=12, n_layers=12, device='meta')\n"
        "spec = T.spec_from_params('gpt', m, mesh={'data': 4})\n"
        "cfg = T.tune(spec, synthetic_model(4, generation='h100'), samples=4)\n"
        "assert T.tuned_step_kwargs(cfg)['fusion_threshold_bytes'] > 0\n"
        "assert sd.candidate_configs(synthetic_model(4), sd._normalize_config(None))\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_eager_modules_load_no_jax():
    """The eager API, its runtimes, the executor, the binding to the core
    and the analysis modules, imported and driven once on the CPU, leave
    jax, flax, optax and the JAX package out of sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "import horovod_tpu_torch as hvd, horovod_tpu_torch.eager, horovod_tpu_torch.core, "
        "horovod_tpu_torch.core.runtime, horovod_tpu_torch.core.native_runtime, "
        "horovod_tpu_torch.core.nccl_executor, horovod_tpu_torch.common.native, "
        "horovod_tpu_torch.analysis.findings, horovod_tpu_torch.analysis.ordering, "
        "horovod_tpu_torch.analysis.groups, horovod_tpu_torch.analysis.preflight, "
        "horovod_tpu_torch.fault, horovod_tpu_torch.metrics, horovod_tpu_torch.trace, "
        "horovod_tpu_torch.tools.eager_parity\n"
        "hvd.init(device='cpu')\n"
        "assert hvd.allreduce(np.ones(2, np.float32), op=hvd.Sum).tolist() == [1.0, 1.0]\n"
        "hvd.shutdown()\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr



def test_elastic_modules_load_no_jax():
    """The elastic state, the digest, the reshard planner and the
    checkpoints, imported and used once on the CPU, leave jax, flax, optax
    and the JAX package out of sys.modules."""
    code = (
        "import sys, torch\n"
        "import horovod_tpu_torch as hvd, horovod_tpu_torch.elastic as el, "
        "horovod_tpu_torch.guard.digest as dg, horovod_tpu_torch.parallel.reshard as R, "
        "horovod_tpu_torch.utils.checkpoint as ck, horovod_tpu_torch.torch.elastic, "
        "horovod_tpu_torch.tools.elastic_parity, horovod_tpu_torch.examples.pytorch_mnist_elastic, "
        "horovod_tpu_torch.examples.elastic_train\n"
        "s = el.TensorState(w=torch.ones(2), step=1); s.commit(); dg.state_digest(s)\n"
        "assert R.shard_len(100, 3) == 34 and hvd.elastic is el\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_binding_modules_load_no_jax_and_torch_is_pytorch():
    """The torch binding (a subpackage named ``torch``), its micro-benchmark
    and its parity tool, imported and driven once on the CPU, leave jax,
    flax, optax and the JAX package out of sys.modules; ``import torch``
    inside and after them is PyTorch's own."""
    code = (
        "import sys, torch as before\n"
        "import horovod_tpu_torch.torch as hvd, horovod_tpu_torch.torch.mpi_ops, "
        "horovod_tpu_torch.torch.compression, horovod_tpu_torch.torch.sync_batch_norm, "
        "horovod_tpu_torch.utils.micro_bench, horovod_tpu_torch.tools.binding_parity\n"
        "import torch\n"
        "assert torch is before and hasattr(torch, 'nn'), torch.__file__\n"
        "assert hvd.SyncBatchNorm.__mro__[1] is torch.nn.modules.batchnorm._BatchNorm\n"
        "hvd.init(device='cpu')\n"
        "x = torch.ones(2)\n"
        "assert hvd.allreduce_(x, op=hvd.Sum) is x\n"
        "hvd.shutdown()\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(torch.__file__)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip().splitlines()[-1]
    assert os.path.dirname(path) == os.path.dirname(torch.__file__), path
    assert not path.startswith(PORT), path

def test_launcher_and_observability_load_no_jax():
    """The launcher, the metrics registry, the fleet trace, the Python
    timeline and their tools, imported and the CLI's --check-build run,
    leave jax, flax, optax and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch.run, horovod_tpu_torch.run.run, "
        "horovod_tpu_torch.run.launcher, horovod_tpu_torch.run.http_server, "
        "horovod_tpu_torch.run.config_parser, horovod_tpu_torch.run.disk_cache, "
        "horovod_tpu_torch.run.safe_shell_exec, horovod_tpu_torch.run.task_runner, "
        "horovod_tpu_torch.metrics, horovod_tpu_torch.metrics.export, "
        "horovod_tpu_torch.metrics.registry, horovod_tpu_torch.trace, "
        "horovod_tpu_torch.trace.merge, horovod_tpu_torch.trace.pusher, "
        "horovod_tpu_torch.utils.timeline, horovod_tpu_torch.tools.run_parity, "
        "horovod_tpu_torch.tools.metrics_dump, horovod_tpu_torch.tools.trace_merge\n"
        "from horovod_tpu_torch.run.run import check_build\n"
        "assert '[X] PyTorch' in check_build()\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_elastic_driver_modules_and_cli_load_no_jax():
    """The elastic driver, its journal and the self-driving policies, and
    a ``python -m horovod_tpu_torch.run --min-np 1 ...`` process that runs
    a job under the driver, leave jax, flax, optax and the JAX package out
    of sys.modules."""
    code = (
        "import runpy, sys\n"
        "import horovod_tpu_torch.run.elastic_driver, horovod_tpu_torch.run.journal, "
        "horovod_tpu_torch.run.selfdrive, horovod_tpu_torch.tools.driver_parity, "
        "horovod_tpu_torch.tools.serve_smoke\n"
        "sys.argv = ['hvdrun', '-np', '1', '--min-np', '1', '--max-np', '1', 'true']\n"
        "try:\n"
        "    runpy.run_module('horovod_tpu_torch.run', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert 'horovod_tpu_torch.run.elastic_driver' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generation 1: size 1" in proc.stderr, proc.stderr


def test_chip_smoke_imports_nothing_of_jax_or_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|horovod_tpu)\b|horovod_tpu\.",
                         re.MULTILINE)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        text = f.read()
    assert "import jax" not in text and not pattern.search(text)


def test_fault_and_probe_modules_load_no_jax():
    """The fault plans, the ring NIC probe and the chaos tool, imported and
    a plan parsed and fired once, leave jax, flax, optax and the JAX
    package out of sys.modules."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch.fault, horovod_tpu_torch.fault.plan, "
        "horovod_tpu_torch.fault.injector, horovod_tpu_torch.fault.backoff, "
        "horovod_tpu_torch.fault.preemption, horovod_tpu_torch.run.network, "
        "horovod_tpu_torch.run.probe, horovod_tpu_torch.tools.chaos_parity\n"
        "from horovod_tpu_torch import fault\n"
        "fault.install_plan(fault.FaultPlan.from_json('{\"faults\": [{\"kind\": \"delay\"}]}'))\n"
        "fault.fault_point('enqueue', 'x')\n"
        "assert [e['action'] for e in fault.events()] == ['delay']\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_serve_modules_load_no_jax():
    """The serving stack, its parity tool and the demo's ``--help`` leave
    jax, flax, optax and the JAX package out of sys.modules."""
    code = (
        "import runpy, sys\n"
        "import horovod_tpu_torch.serve, horovod_tpu_torch.serve.batcher, "
        "horovod_tpu_torch.serve.kvcache, horovod_tpu_torch.serve.engine, "
        "horovod_tpu_torch.serve.frontend, horovod_tpu_torch.tools.serve_parity\n"
        "from horovod_tpu_torch import make_decode_step\n"
        "sys.argv = ['serve', '--help']\n"
        "try:\n"
        "    runpy.run_module('horovod_tpu_torch.serve', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'horovod_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout


def test_serving_entry_points_default_to_the_card(no_gpu):
    """``bench --serve`` and the serving demo start on the card, and
    without one they raise instead of serving on the CPU."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.serve import __main__ as demo

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--serve", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main([])


def _knobs(mod):
    return {k: getattr(mod, k) for k in dir(mod) if k.startswith("HOROVOD_")}


def test_knob_registry_matches_reference():
    """Mirrors the reference's env surface: the same names, values and
    Config fields with the same defaults."""
    assert _knobs(port_env) == _knobs(ref_env)
    assert port_env.FUSION_BUFFER_ATOMIC_UNIT == ref_env.FUSION_BUFFER_ATOMIC_UNIT
    assert port_env.XLA_PERF_PRESETS == ref_env.XLA_PERF_PRESETS
    ref_fields = {f.name: f.default for f in dataclasses.fields(ref_env.Config)}
    port_fields = {f.name: f.default for f in dataclasses.fields(port_env.Config)}
    assert port_fields == ref_fields


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_FUSION_THRESHOLD", "12345"),
    ("HOROVOD_CYCLE_TIME", "2.5"),
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", "1"),
    ("HOROVOD_SERVE_MAX_BATCH", "16"),
])
def test_config_from_env_matches_reference(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    ref = dataclasses.asdict(ref_env.Config.from_env())
    port = dataclasses.asdict(port_env.Config.from_env())
    assert port == ref


def test_unknown_preset_rejected_like_reference(monkeypatch):
    monkeypatch.setenv("HOROVOD_XLA_PERF_PRESET", "bogus")
    with pytest.raises(ValueError, match="unknown HOROVOD_XLA_PERF_PRESET"):
        ref_env.resolve_perf_preset()
    with pytest.raises(ValueError, match="unknown HOROVOD_XLA_PERF_PRESET"):
        port_env.resolve_perf_preset()


def test_source_imports_nothing_of_jax_or_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|horovod_tpu)\b|horovod_tpu\.",
                         re.MULTILINE)
    offenders = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as f:
                    text = f.read()
                if "import jax" in text or pattern.search(text):
                    offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


def test_topology_from_env(monkeypatch):
    from horovod_tpu_torch.common import topology

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert (topology.detect().rank, topology.detect().size) == (0, 1)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    t = topology.detect()
    assert (t.rank, t.size, t.local_rank, t.local_size, t.source) == (3, 4, 1, 2, "torchrun")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    assert topology.detect().source == "env"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_gpu):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.utils.convert import params_from_flax

    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(64, d_model=32, n_heads=1, n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_flax({"w": np.zeros(2, np.float32)})
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.mnist_cnn import MnistCNN

    for name in ("resnet50", "vgg16", "inception3"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(name, num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MnistCNN()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke", "--model", "moe"])
    from horovod_tpu_torch.parallel.ep import init_moe_params
    from horovod_tpu_torch.utils import convert

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_moe_params(torch.Generator(), d_model=4, d_hidden=4, num_experts=2,
                        num_expert_shards=1)
    w = np.zeros((2, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.moe_params_from_numpy((w[0], w, w))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.stacked_row({"w": w}, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.pp_params_from_flax({"block_0/w": w[0]}, 1, 0)
    # Asking for the CPU explicitly works.
    TransformerLM(64, d_model=32, n_heads=1, n_layers=1, device="cpu")
    get_model("resnet18", num_classes=10, device="cpu")


def test_long_context_example_defaults_to_the_card(no_gpu, monkeypatch, capsys):
    """The sequence-parallel example starts one rank per card and refuses
    to start without one unless asked for the CPU."""
    from horovod_tpu_torch.examples import long_context_sp

    monkeypatch.delenv("HOROVOD_RANK", raising=False)
    monkeypatch.setattr(sys, "argv", ["long_context_sp"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit):
        long_context_sp.main()
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["tp_pp_demo", "moe_expert_parallel"])
def test_pp_ep_examples_default_to_the_card(no_gpu, monkeypatch, capsys, name):
    """The pipeline- and expert-parallel examples, likewise."""
    import importlib

    example = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
    monkeypatch.delenv("HOROVOD_RANK", raising=False)
    monkeypatch.setattr(sys, "argv", [name])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit):
        example.main()
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launchers never fall back: a CPU tensor handed to a kernel
    wrapper is refused before anything is built."""
    from horovod_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_fwd(q, q, q, True, 1.0)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_bwd(q, q, q, q, lse, q, True, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_block_fwd(q, q, q, 0, True, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_block(q.to("meta"), q.to("meta"), q.to("meta"), 0, sm_scale=1.0)


def test_collective_matmul_wrappers_never_fall_back(monkeypatch):
    """B3/B4's wrappers take the plain version only for CPU tensors: a
    tensor anywhere else (here on the meta device) goes to the kernel
    launch, which refuses it here, where there is no card; the plain
    version is never reached."""
    from horovod_tpu_torch.ops import collective_matmul as cm

    def plain(*_):
        raise AssertionError("a plain version was reached for a non-CPU tensor")

    for name in ("_chunk_product_plain", "_partial_product_plain", "_epilogue_plain"):
        monkeypatch.setattr(cm, name, plain)
    a = torch.zeros(2, 4, 8, device="meta")
    w = torch.zeros(8, 6, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cm._chunk_product(a, w, torch.zeros(2, 4, 6, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cm._partial_product(a, w)
    acc = torch.zeros(2, 4, 6, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cm._epilogue(acc, acc, None, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cm._launch_chunk_product(torch.zeros(2, 4, 8), torch.zeros(8, 6), torch.zeros(2, 4, 6))
