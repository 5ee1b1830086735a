"""What every cell shares: the manifest and the files found by name, the
cache directories, the clock of set-up, the seeds, and the check that no
JAX module was loaded.

Imports nothing of the program, so that the reference, the tests and the
launcher's own process can use it freely.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
CACHE = os.path.join(HERE, ".cache")

# Compared with the part of each module name before the first dot, whole:
# ``horovod_tpu_torch`` is not ``horovod_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def set_cache_env() -> None:
    """Point every compile and kernel cache a run could write at fixed
    directories inside the checkout (the port's own nvcc and g++ builds
    already land in ``horovod_tpu_torch/build/``), and keep libraries that
    could load JAX by themselves from doing so."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = list(sys.modules if modules is None else modules)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_start_s() -> float:
    """This process's start on the ``CLOCK_BOOTTIME`` clock, in seconds
    (``/proc/self/stat``'s start time); the module's import time where
    ``/proc`` cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def boot_clock() -> float:
    """Seconds on ``CLOCK_BOOTTIME``, the clock every process of a run shares."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


_IMPORTED = boot_clock()


def phase(name: str, start_s: float) -> None:
    """Note on standard error when a phase of set-up ended, in seconds
    since ``start_s`` (the run's process start on ``CLOCK_BOOTTIME``)."""
    print(f"hvdbench: set-up {name} done at {boot_clock() - start_s:.2f} s", file=sys.stderr,
          flush=True)


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream (weights, data) of a run."""
    return (int(seed) * 1_000_003 + 7919 * int(stream)) % (2 ** 63 - 1)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def cell(workload: str, bench: Optional[dict] = None) -> Dict[str, Any]:
    """Everything one cell is made of, found by name: its entry, its
    configuration, its traffic, its limits and the metrics it reports."""
    bench = bench or manifest()
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"hvdbench: no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(entries)}")
    entry = entries[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(os.path.join(ROOT, config_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))

    def reported(metric: dict) -> bool:
        if "workloads" in metric:
            return workload in metric["workloads"]
        return True

    end_to_end = [m for m in bench["end_to_end"] if reported(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"name": workload, "entry": entry, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": end_to_end, "per_layer": per_layer,
            "chips": int(entry["chips"])}


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this package, loaded by path (a
    metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"hvdbench_{kind}_{name}", path)
    if spec is None or not os.path.exists(path):
        raise SystemExit(f"hvdbench: no {kind} file for {name!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(config: dict):
    """The module of the configuration's family (``families/<family>.py``)."""
    return importlib.import_module(f"hvdbench.families.{config['family']}")


def reference(config: dict):
    """The plain reference of the configuration's family (``reference/<family>.py``)."""
    return importlib.import_module(f"hvdbench.reference.{config['family']}")


def read_metrics(specs: List[dict], kind: str, ctx: dict) -> Dict[str, dict]:
    """Each metric's reader over the run's context; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for spec in specs:
        value = load_file(kind, spec["name"]).read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out
