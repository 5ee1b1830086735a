"""What the port's CI smokes share: the card check, the jobs under the
port's launcher, and the event logs.

Every smoke runs on the card unless ``--device cpu`` asks for the CPU
(gloo ranks, as the reference's CI runs with ``JAX_PLATFORMS=cpu``). A
smoke that needs more ranks than there are cards exits 2 naming the count
(:func:`need_ranks`); it never drops to the CPU quietly. A job's worker
script reads the device from ``SMOKE_DEVICE`` (unset: its card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import traceback
from typing import List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEVICE_VAR = "SMOKE_DEVICE"


class SmokeFailure(AssertionError):
    """A smoke's gate did not hold."""


def check(cond: bool, msg: str) -> None:
    """Fail the smoke with ``msg`` unless ``cond``."""
    if not cond:
        raise SmokeFailure(msg)


def parse_args(description: str, argv=None, extra=None, worker: bool = False):
    """``--device`` (cpu, or the card: the default), with ``worker`` the
    hidden ``--worker``/``--out`` of a rank :func:`launch_workers` starts,
    plus the smoke's own options added by ``extra(parser)``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    if worker:
        ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
        ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    if extra is not None:
        extra(ap)
    return ap.parse_args(argv)


def need_ranks(n: int, device: Optional[str], name: str) -> Optional[int]:
    """None when the smoke can run ``n`` ranks on ``device``; else print why
    and return 2 (the exit code): one card a rank, no quiet CPU fallback."""
    if device == "cpu":
        return None
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= n:
        return None
    print(f"[{name}-smoke] needs {n} cards (one a rank); {have} visible. "
          f"Run it with --device cpu for the gloo rehearsal.", file=sys.stderr)
    return 2


def main_guard(name: str, fn) -> int:
    """Run ``fn()``; a failed gate (an ``AssertionError``) prints ``FAIL``
    and exits 1, any other error exits 2 (the reference's CI codes: findings 1, a crash 2)."""
    try:
        return int(fn() or 0)
    except AssertionError as exc:
        print(f"[{name}-smoke] FAIL: {exc}", file=sys.stderr)
        return 1
    except Exception:  # noqa: BLE001 - a crash, not a finding
        traceback.print_exc()
        return 2


def job_env(device: Optional[str] = None, **extra) -> dict:
    """This process's environment for a job: without a job's rendezvous
    (``HOROVOD_*``, ``MASTER_*``, ``TORCHELASTIC_*``), the repository on
    ``PYTHONPATH``, the device, then ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_", "TORCHELASTIC_"))}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.setdefault("OMP_NUM_THREADS", "1")
    env["HOROVOD_CYCLE_TIME"] = "1"
    if device:
        env[DEVICE_VAR] = device
    else:
        env.pop(DEVICE_VAR, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _read(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()


def run_elastic_job(hvdrun_args: Sequence[str], script_text: str, *, device: Optional[str],
                    extra_env: Optional[dict] = None, timeout: float = 300,
                    workdir: Optional[str] = None) -> Tuple[subprocess.CompletedProcess, dict]:
    """``python -m horovod_tpu_torch.run <hvdrun_args> --output-dir <td>
    python worker.py`` (the elastic driver with elastic flags); returns the
    launcher's process (text) and ``{worker id: stdout, "<id>.err": stderr,
    "driver.log" | "fault_schedule.json" | "fault_events.jsonl": text}``."""
    with tempfile.TemporaryDirectory(prefix="hvd_smoke_", dir=workdir) as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(textwrap.dedent(script_text))
        env = job_env(device, ELASTIC_TD=td,
                      HOROVOD_FAULT_EVENT_LOG=os.path.join(td, "fault_events.jsonl"),
                      **(extra_env or {}))
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", *hvdrun_args, "--output-dir", td,
             sys.executable, script], env=env, cwd=REPO, capture_output=True, text=True,
            timeout=timeout)
        outs = {}
        for fn in os.listdir(td):
            if fn.startswith("worker.") and fn.endswith(".out"):
                outs[fn[len("worker."):-len(".out")]] = _read(os.path.join(td, fn))
            elif fn.startswith("worker.") and fn.endswith(".err"):
                outs[fn[len("worker."):]] = _read(os.path.join(td, fn))
            elif fn in ("driver.log", "fault_schedule.json", "fault_events.jsonl"):
                outs[fn] = _read(os.path.join(td, fn))
    return proc, outs


def run_workers(script_text: str, np_: int, *, device: Optional[str],
                extra_env: Optional[dict] = None, timeout: float = 180,
                expect_failure: bool = False):
    """A plain (non-elastic) ``-np`` launch of a worker script; each rank's
    stdout, or with ``expect_failure`` the launcher's process."""
    with tempfile.TemporaryDirectory(prefix="hvd_smoke_") as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(textwrap.dedent(script_text))
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_), "--output-dir",
             td, sys.executable, script], env=job_env(device, **(extra_env or {})), cwd=REPO,
            capture_output=True, text=True, timeout=timeout)
        outs = [_read(os.path.join(td, f"rank.{r}.out"))
                if os.path.exists(os.path.join(td, f"rank.{r}.out")) else "" for r in range(np_)]
        errs = [_read(os.path.join(td, f"rank.{r}.err"))
                for r in range(np_) if os.path.exists(os.path.join(td, f"rank.{r}.err"))]
    if expect_failure:
        return proc
    check(proc.returncode == 0,
          f"launcher rc={proc.returncode}\nstdout={proc.stdout[-3000:]}\n"
          f"stderr={proc.stderr[-3000:]}\nrank outs={outs}\nrank errs={[e[-2000:] for e in errs]}")
    return outs


def normalized_events(path: str) -> List[tuple]:
    """A multi-process event log's per-rank view: lines sorted by (rank,
    seq). Two runs of one seeded plan must give equal views."""
    if not os.path.exists(path):
        return []
    lines = [json.loads(l) for l in open(path) if l.strip()]
    return sorted((e.get("rank"), e["seq"], e["site"], e["hit"], e["action"], e["detail"])
                  for e in lines)


def finals(outs, prefix: str = "FINAL") -> List[str]:
    """The lines starting with ``prefix`` of every output."""
    texts = outs.values() if isinstance(outs, dict) else outs
    return [l for o in texts for l in o.splitlines() if l.startswith(prefix)]


def launch_workers(module: str, n: int, device: Optional[str], argv: Sequence[str] = (),
                   timeout: float = 300) -> dict:
    """Run ``python -m <module> --worker --out <file> [--device ...] <argv>``
    as ranks 0..n-1 (``tools/launch.launch_ranks``: a file store, one
    process a rank) and return the JSON rank 0 wrote to ``<file>``."""
    from .launch import launch_ranks

    with tempfile.TemporaryDirectory(prefix="hvd_smoke_") as td:
        out = os.path.join(td, "out.json")
        full = ["--worker", "--out", out, *(["--device", device] if device else []), *argv]
        code = launch_ranks(module, full, n, timeout)
        check(code == 0, f"{module}: a rank exited {code}")
        check(os.path.exists(out), f"{module}: rank 0 wrote no result")
        with open(out) as f:
            return json.load(f)


def init_worker(device: Optional[str]):
    """``hvd.init`` of a rank :func:`launch_workers` started; the module."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import resolve_device

    from .launch import store_url

    hvd.init(resolve_device(device), init_method=store_url())
    return hvd


def write_result(path: Optional[str], doc: dict) -> None:
    """Rank 0's result for :func:`launch_workers`."""
    if path:
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True)


def tensor_digest(tensors) -> str:
    """sha256 over the tensors' bytes, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mlp3(d: int, device, rng, scale: float, bias_scale: float = 0.0):
    """The reference smokes' three-layer tanh MLP as a module: ``layer<i>``
    with ``w`` [d, d] and ``b`` [d], ``x -> tanh(x @ w + b)`` three times;
    drawn from ``rng`` layer by layer, ``w`` as ``randn * scale`` then ``b``
    as ``randn * bias_scale`` (zeros, and no draw, when it is 0)."""
    import numpy as np
    import torch

    class MLP3(torch.nn.Module):
        def forward(self, x):
            for i in range(3):
                layer = getattr(self, f"layer{i}")
                x = torch.tanh(x @ layer.w + layer.b)
            return x

    model = MLP3()
    for i in range(3):
        layer = torch.nn.Module()
        w = (rng.randn(d, d) * scale).astype(np.float32)
        b = ((rng.randn(d) * bias_scale).astype(np.float32) if bias_scale
             else np.zeros(d, np.float32))
        layer.w = torch.nn.Parameter(torch.tensor(w, device=device))
        layer.b = torch.nn.Parameter(torch.tensor(b, device=device))
        model.add_module(f"layer{i}", layer)
    return model


def mse(model, batch):
    """The reference smokes' loss: the mean squared error of ``model(x)``."""
    x, y = batch
    return ((model(x) - y) ** 2).mean()
