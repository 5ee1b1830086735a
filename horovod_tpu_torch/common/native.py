"""ctypes binding to the native control-plane core, the port's own copy.

The counterpart of ``horovod_tpu/common/basics.py:1-263`` over the C++
sources in ``cpp/src`` and ``cpp/include``, which stay as they are. The
core negotiates, fuses and caches; it hands out plans, which the port runs
on ``torch.distributed`` and reports done.

The library is built from the checkout at first use, one g++ a source, all
started together, then linked (``cpp/Makefile``'s flags)::

    g++ -O2 -std=c++17 -fPIC -pthread -Icpp/include -c cpp/src/<name>.cc
    g++ -shared -pthread -Wl,-Bsymbolic -static-libstdc++ -static-libgcc \
        -Wl,--exclude-libs,ALL -o build/libhvd_core-<hash>.so *.o

into ``horovod_tpu_torch/build/``, keyed by a hash of the sources, the
headers, the flags and the compiler's version. The C++ runtime is linked
in and kept private: on the H100 machine (g++ 13.3, glibc 2.39) a core
linked against the shared libstdc++ segfaults inside ``hvd_core_next_plan``
once plans flow, with or without torch in the process, at -O0 as at -O2;
linked statically it runs (``chip_smoke.py`` ``[eager]``).
``cpp/`` is never written and its
``libhvd_core.so`` never loaded: the core is process-global state, so the
JAX package's core and the port's are two libraries opened side by side
(``RTLD_LOCAL``; ``-Bsymbolic`` binds each library's calls to its own
``Core::Get()``). Concurrent builds (xdist workers, ranks) serialize on a
file lock, and the library is renamed into place. A failed build raises
with g++'s output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG)
CPP_DIR = os.path.join(REPO_ROOT, "cpp")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("message", "core", "transport", "autotune", "c_api")
HEADERS = ("common.h", "core.h", "message.h")
COMPILE_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")
LINK_FLAGS = ("-shared", "-pthread", "-Wl,-Bsymbolic", "-static-libstdc++", "-static-libgcc",
              "-Wl,--exclude-libs,ALL")

_lib: Optional[ctypes.CDLL] = None


class NativeCoreUnavailable(RuntimeError):
    """The core's library could not be built or loaded."""


def _sources():
    return ([os.path.join(CPP_DIR, "src", f"{n}.cc") for n in SOURCES]
            + [os.path.join(CPP_DIR, "include", "hvd", h) for h in HEADERS])


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def _compiler_version(cxx: Optional[str]) -> str:
    if cxx is None:
        return ""
    out = subprocess.run([cxx, "-dumpfullversion", "-dumpversion"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def library_path() -> str:
    """Where the core builds to, given the current sources, flags and
    compiler."""
    cxx = _compiler()
    h = hashlib.sha256(" ".join((cxx or "", _compiler_version(cxx), *COMPILE_FLAGS, "|",
                                 *LINK_FLAGS)).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libhvd_core-{h.hexdigest()[:16]}.so")


def ensure_built() -> str:
    """Build the core's library unless it is built; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = _compiler()
    if cxx is None:
        raise NativeCoreUnavailable("g++ not found: the native core is built from cpp/src")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libhvd_core.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):         # another process built it meanwhile
            return out
        work = tempfile.mkdtemp(prefix="hvd_core_", dir=BUILD_DIR)
        try:
            include = os.path.join(CPP_DIR, "include")
            procs = [(n, subprocess.Popen(
                [cxx, *COMPILE_FLAGS, f"-I{include}", "-c",
                 os.path.join(CPP_DIR, "src", f"{n}.cc"), "-o", os.path.join(work, f"{n}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for n in SOURCES]
            failures = []
            for n, p in procs:
                report, _ = p.communicate()
                if p.returncode != 0:
                    failures.append(f"g++ failed on cpp/src/{n}.cc (exit {p.returncode}):\n{report}")
            if failures:
                raise NativeCoreUnavailable("\n".join(failures))
            tmp = os.path.join(work, "libhvd_core.so")
            link = subprocess.run(
                [cxx, *LINK_FLAGS, "-o", tmp, *(os.path.join(work, f"{n}.o") for n in SOURCES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise NativeCoreUnavailable(f"linking the native core failed:\n{link.stdout}")
            os.replace(tmp, out)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The core's library, built first if needed, with its signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built(), mode=os.RTLD_LOCAL | os.RTLD_NOW)
    c_int, c_ll, c_dbl, c_str = ctypes.c_int, ctypes.c_longlong, ctypes.c_double, ctypes.c_char_p
    lib.hvd_core_init.restype = c_int
    lib.hvd_core_init.argtypes = [
        c_int, c_int, c_int, c_int, c_int, c_int, c_dbl, c_ll,
        c_int, c_int, c_int, c_int, c_int, c_int, c_int,
        c_str, c_str, c_int, c_str, c_int, c_int, c_str, c_int,
    ]
    lib.hvd_core_shutdown.restype = None
    lib.hvd_core_flush_hint.restype = None
    lib.hvd_core_initialized.restype = c_int
    for fn in ("rank", "size", "local_rank", "local_size", "cross_rank", "cross_size"):
        getattr(lib, f"hvd_core_{fn}").restype = c_int
    lib.hvd_core_enqueue.restype = c_ll
    lib.hvd_core_enqueue.argtypes = [
        c_int, c_str, c_int, ctypes.POINTER(c_ll), c_int, c_int, c_int, c_dbl, c_dbl,
        c_ll, c_int, c_int, c_str, c_int,
    ]
    lib.hvd_core_grouped_splits.restype = c_ll
    lib.hvd_core_grouped_splits.argtypes = []
    lib.hvd_core_register_process_set.restype = c_int
    lib.hvd_core_register_process_set.argtypes = [
        c_int, ctypes.POINTER(c_int), c_int, c_str, c_int]
    lib.hvd_core_remove_process_set.restype = c_int
    lib.hvd_core_remove_process_set.argtypes = [c_int, c_str, c_int]
    lib.hvd_core_enqueue_join.restype = c_ll
    lib.hvd_core_enqueue_join.argtypes = [c_str, c_int]
    lib.hvd_core_next_plan.restype = c_int
    lib.hvd_core_next_plan.argtypes = [c_str, c_int, c_int]
    lib.hvd_core_plan_done.restype = None
    lib.hvd_core_plan_done.argtypes = [ctypes.c_ulonglong, c_int, c_str, c_dbl, c_ll]
    lib.hvd_core_ticket_status.restype = c_int
    lib.hvd_core_ticket_status.argtypes = [ctypes.c_ulonglong, c_str, c_int]
    lib.hvd_core_cycle_time_ms.restype = c_dbl
    lib.hvd_core_tuned_flags.restype = c_int
    lib.hvd_core_cache_size.restype = c_ll
    lib.hvd_core_start_timeline.restype = c_int
    lib.hvd_core_start_timeline.argtypes = [c_str, c_int]
    lib.hvd_core_stop_timeline.restype = None
    lib.hvd_core_fusion_threshold.restype = c_ll
    lib.hvd_core_timeline_activity.restype = None
    lib.hvd_core_timeline_activity.argtypes = [c_str, c_str, c_int]
    _lib = lib
    return lib


class _CoreError(RuntimeError):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


_LOG_LEVELS = {"trace": 0, "debug": 1, "info": 2, "warning": 3, "warn": 3, "error": 4}


class NativeCore:
    """Thin OO wrapper over the C ABI."""

    ERRBUF = 4096

    def __init__(self):
        self.lib = load()

    def init(self, cfg, topo, coord_addr: str = "", coord_port: int = 0) -> None:
        err = ctypes.create_string_buffer(self.ERRBUF)
        rc = self.lib.hvd_core_init(
            topo.rank, topo.size, topo.local_rank, topo.local_size,
            topo.cross_rank, topo.cross_size,
            ctypes.c_double(cfg.cycle_time_ms),
            ctypes.c_longlong(cfg.fusion_threshold_bytes),
            cfg.cache_capacity,
            0 if cfg.stall_check_disable else int(cfg.stall_warning_time_seconds),
            int(cfg.stall_shutdown_time_seconds),
            1 if cfg.autotune else 0,
            cfg.autotune_warmup_samples,
            cfg.autotune_steps_per_sample,
            _LOG_LEVELS.get(cfg.log_level.lower(), 2),
            # HOROVOD_TIMELINE is the coordinator's file, as in the reference
            # (operations.cc opens it on rank 0): ranks writing one path would
            # interleave into a file that does not load. start_timeline opens
            # one on any rank.
            (cfg.timeline_filename if topo.rank == 0 else "").encode(),
            coord_addr.encode(),
            coord_port,
            cfg.autotune_log_file.encode(),
            1 if cfg.hierarchical_allreduce else 0,
            1 if cfg.hierarchical_allgather else 0,
            err, self.ERRBUF,
        )
        if rc != 0:
            raise _CoreError(-rc, f"native core init failed: {err.value.decode()}")

    def shutdown(self) -> None:
        self.lib.hvd_core_shutdown()

    def flush_hint(self) -> None:
        """A producer is now blocked waiting: the next cycle may seal at
        once instead of holding the fusion grace."""
        self.lib.hvd_core_flush_hint()

    def initialized(self) -> bool:
        return bool(self.lib.hvd_core_initialized())

    def enqueue(self, request_type: int, name: str, dtype: int, shape, root_rank: int,
                reduce_op: int, prescale: float, postscale: float, group_id: int = 0,
                group_size: int = 0, process_set_id: int = 0) -> int:
        err = ctypes.create_string_buffer(self.ERRBUF)
        arr = (ctypes.c_longlong * len(shape))(*shape)
        ticket = self.lib.hvd_core_enqueue(
            request_type, name.encode(), dtype, arr, len(shape), root_rank,
            reduce_op, ctypes.c_double(prescale), ctypes.c_double(postscale),
            ctypes.c_longlong(group_id), group_size, process_set_id,
            err, self.ERRBUF,
        )
        if ticket < 0:
            raise _CoreError(-ticket, err.value.decode())
        return int(ticket)

    def register_process_set(self, psid: int, ranks) -> None:
        err = ctypes.create_string_buffer(self.ERRBUF)
        arr = (ctypes.c_int * len(ranks))(*ranks)
        rc = self.lib.hvd_core_register_process_set(psid, arr, len(ranks), err, self.ERRBUF)
        if rc != 0:
            raise _CoreError(-rc, err.value.decode())

    def remove_process_set(self, psid: int) -> None:
        err = ctypes.create_string_buffer(self.ERRBUF)
        rc = self.lib.hvd_core_remove_process_set(psid, err, self.ERRBUF)
        if rc != 0:
            raise _CoreError(-rc, err.value.decode())

    def grouped_splits(self) -> int:
        """Groups that could not fuse into one plan (members of several
        signatures) since init."""
        return int(self.lib.hvd_core_grouped_splits())

    def enqueue_join(self) -> int:
        err = ctypes.create_string_buffer(self.ERRBUF)
        ticket = self.lib.hvd_core_enqueue_join(err, self.ERRBUF)
        if ticket < 0:
            raise _CoreError(-ticket, err.value.decode())
        return int(ticket)

    def next_plan(self, timeout_ms: int = 100, bufsize: int = 1 << 20):
        """The next plan as a dict, or 0 on a timeout, -1 when the core is
        down, -2 when the buffer is too small."""
        buf = ctypes.create_string_buffer(bufsize)
        r = self.lib.hvd_core_next_plan(buf, bufsize, timeout_ms)
        if r > 0:
            return json.loads(buf.value.decode())
        return r

    def plan_done(self, plan_id: int, status: int, error: str, duration_s: float,
                  bytes_moved: int) -> None:
        self.lib.hvd_core_plan_done(plan_id, status, error.encode(),
                                    ctypes.c_double(duration_s), ctypes.c_longlong(bytes_moved))

    def ticket_status(self, ticket: int):
        """(state, error): state 0 in progress, 1 done, < 0 failed."""
        err = ctypes.create_string_buffer(self.ERRBUF)
        r = self.lib.hvd_core_ticket_status(ticket, err, self.ERRBUF)
        return r, (err.value.decode() if r < 0 else "")

    def cycle_time_ms(self) -> float:
        return float(self.lib.hvd_core_cycle_time_ms())

    def fusion_threshold(self) -> int:
        return int(self.lib.hvd_core_fusion_threshold())

    def tuned_flags(self) -> int:
        """The autotuned categorical bits: 1 hierarchical allreduce, 2
        hierarchical allgather, 4 cache enabled."""
        return int(self.lib.hvd_core_tuned_flags())

    def cache_size(self) -> int:
        return int(self.lib.hvd_core_cache_size())

    def start_timeline(self, path: str, mark_cycles: bool = False) -> int:
        """Start the catapult timeline; 0 on success, else a status code."""
        return int(self.lib.hvd_core_start_timeline(path.encode(), 1 if mark_cycles else 0))

    def stop_timeline(self) -> None:
        self.lib.hvd_core_stop_timeline()

    def timeline_activity(self, tensor: str, activity: str, begin: bool) -> None:
        self.lib.hvd_core_timeline_activity(tensor.encode(), activity.encode(),
                                            1 if begin else 0)
