"""Process spawning with whole-tree cleanup.

The port's copy of ``horovod_tpu/run/safe_shell_exec.py``. Role parity with the reference's ``run/common/util/safe_shell_exec.py``
(middleman process group, graceful terminate then kill): each worker runs in
its own process group; terminate() SIGTERMs the group, escalating to
SIGKILL after a grace period.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import IO, Dict, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5


class ManagedProcess:
    def __init__(
        self,
        command: List[str] | str,
        env: Optional[Dict[str, str]] = None,
        stdout: Optional[IO] = None,
        stderr: Optional[IO] = None,
        shell: bool = False,
    ):
        self.proc = subprocess.Popen(
            command,
            env=env,
            stdout=stdout if stdout is not None else None,
            stderr=stderr if stderr is not None else None,
            shell=shell,
            start_new_session=True,  # own process group for tree-kill
        )

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        return self.proc.wait(timeout=timeout)

    def terminate(self) -> None:
        """SIGTERM the process group; SIGKILL after the grace period."""
        try:
            pgid = os.getpgid(self.proc.pid)
        except ProcessLookupError:
            return
        try:
            os.killpg(pgid, signal.SIGTERM)
        except ProcessLookupError:
            return
        deadline = time.monotonic() + GRACEFUL_TERMINATION_TIME_S
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.1)
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def execute(
    command: List[str] | str,
    env: Optional[Dict[str, str]] = None,
    stdout: Optional[IO] = None,
    stderr: Optional[IO] = None,
    shell: bool = False,
) -> int:
    """Run a command to completion, forwarding SIGINT/SIGTERM to its tree.

    The handler only records the signal; the polling loop terminates the
    tree. (The JAX copy terminates inside the handler, interrupting
    ``Popen.wait``, whose lock then keeps ``terminate``'s polls from seeing
    the child die, so it always waits the whole grace period.)"""
    mp = ManagedProcess(command, env=env, stdout=stdout, stderr=stderr,
                        shell=shell)
    forwarded = []

    def handler(signum, frame):
        forwarded.append(signum)

    old_int = signal.signal(signal.SIGINT, handler)
    old_term = signal.signal(signal.SIGTERM, handler)
    try:
        while (rc := mp.poll()) is None:
            if forwarded:
                mp.terminate()
                return mp.wait()
            time.sleep(0.05)
        return rc
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)
