"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``horovod_tpu_torch/build/``, keyed by a hash of the
source and the flags (with any extra ones, e.g. ``-include`` of a header
that sets the flash kernels' tile sizes for a sweep), so an edited source
builds anew and an unchanged one loads at once. A build that fails raises with nvcc's output.
``ptxas_kernels`` reads ptxas's report: registers and spills per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str, extra_flags: Sequence[str] = ()) -> str:
    """Where ``csrc/<name>.cu`` builds to, given its current source."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((*NVCC_FLAGS, *extra_flags)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable) -> Dict:
    """Compile every named source that is not built yet, one nvcc each, all
    started together. Returns nvcc's report (ptxas's registers, shared
    memory and spills) for each source it compiled. A name may also be a
    (name, extra flags) pair, for variants of one source built side by side."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for item in names:
        name, extra = (item, ()) if isinstance(item, str) else item
        out = library_path(name, extra)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[item] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp,
             os.path.join(CSRC_DIR, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failures = {}, []
    for item, (out, tmp, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {item} (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, out)
        reports[item] = report
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    key = (name, tuple(extra_flags))
    lib: Optional[ctypes.CDLL] = _loaded.get(key)
    if lib is None:
        build([key])
        lib = ctypes.CDLL(library_path(*key))
        _loaded[key] = lib
    return lib


def ptxas_kernels(report: str) -> List[dict]:
    """Each kernel in ptxas's ``-v`` report: its name with its integer
    template arguments (``flash_fwd_mma_kernel<64,2,64>``), registers and
    spill bytes (stores, loads)."""
    kernels, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            # The kernel's identifier: <length><name> with a name ending in
            # _kernel. The last such pair wins: a namespace mangled before
            # it can hold digits that read as a longer one.
            names = [mangled[m.end():m.end() + int(m.group())]
                     for m in re.finditer(r"\d+", mangled)]
            name = ([n for n in names if n.endswith("_kernel")] or [mangled])[-1]
            args = re.findall(r"Li(\d+)E", mangled)
            cur = {"name": name + (f"<{','.join(args)}>" if args else ""), "mangled": mangled,
                   "registers": None, "spill_stores": 0, "spill_loads": 0}
            kernels.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None and cur["registers"] is None:
            cur["registers"] = int(m.group(1))
    return kernels
