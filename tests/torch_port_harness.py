"""Run a script of the PyTorch port as n gloo ranks on the CPU.

The ranks are separate processes (one default process group each) that
rendezvous through a ``FileStore`` in the test's own directory, so tests
running side by side under xdist never share a port. The worker script
imports only ``horovod_tpu_torch``; it finds its directory in
``HVD_TEST_DIR`` and its store at ``file://$HVD_TEST_DIR/store``.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(script: str, n: int, workdir, timeout: float = 180.0) -> list:
    """Run ``script`` as ranks 0..n-1; return their outputs. Fails with the
    output of every rank when one exits non-zero or the run times out."""
    path = os.path.join(str(workdir), "worker.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["HVD_TEST_DIR"] = str(workdir)
    env["OMP_NUM_THREADS"] = "2"
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, path],
                env={**env, "HOROVOD_RANK": str(r), "HOROVOD_SIZE": str(n),
                     "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": str(n)},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(
            f"ranks {failed} failed:\n" + "\n".join(
                f"--- rank {r} ---\n{o}" for r, o in enumerate(outs))
        )
    return outs
