"""Worker allocation and process fan-out.

The port of ``horovod_tpu/run/launcher.py`` (role parity with the
reference's Gloo launcher, ``run/gloo_run.py``): slot allocation over
hosts into SlotInfo{rank, local_rank, cross_rank, ...}; spawn each rank
(locally or over ssh) with the full ``HOROVOD_*`` env; kill the remaining
ranks when one fails; forward SIGINT/SIGTERM.

Rendezvous, where the port differs: the JAX launcher picks free ports for
the core's controller and the JAX coordinator by binding and closing
them, and exports ``HOROVOD_CONTROLLER_ADDR``/``PORT`` and
``HOROVOD_JAX_COORDINATOR``. Here the launcher hosts the job's
``torch.distributed`` TCPStore itself, bound to port 0 (torchrun's agent
store), and exports ``MASTER_ADDR``/``MASTER_PORT`` with
``TORCHELASTIC_USE_AGENT_STORE=True``, so every rank's ``env://``
rendezvous is a client of it and no rank races for a port. The core's
controller endpoint is agreed through that store at ``init``
(``eager._native_runtime``), so no ``HOROVOD_CONTROLLER_PORT`` is
exported. The ranks also get torchrun's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, so a script that calls
``torch.distributed.init_process_group`` itself runs under the launcher
too. No ``CUDA_VISIBLE_DEVICES`` is set: rank r's ``init`` takes
``cuda:<local_rank>``.
"""

from __future__ import annotations

import os
import socket
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import safe_shell_exec

LOCAL_HOST_NAMES = ("localhost", "127.0.0.1")

# The environment a remote rank gets through ssh (build_remote_command).
FORWARDED_PREFIXES = ("HOROVOD_", "MASTER_", "TORCHELASTIC_", "NCCL_", "CUDA_", "TORCH_",
                      "PATH", "PYTHONPATH", "LD_LIBRARY")
TORCHRUN_NAMES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")

# How long the launcher's store waits on a rank's request.
STORE_TIMEOUT_S = 1800


@dataclass
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts: str) -> List[Tuple[str, int]]:
    """Parse ``host1:4,host2:4`` (reference ``-H`` format)."""
    out = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append((name, int(slots)))
        else:
            out.append((part, 1))
    return out


def parse_hostfile(path: str) -> List[Tuple[str, int]]:
    """Parse hostfile lines ``hostname slots=N`` (reference format)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            slots = 1
            for fld in fields[1:]:
                if fld.startswith("slots="):
                    slots = int(fld.split("=", 1)[1])
            out.append((fields[0], slots))
    return out


def allocate(hosts: Sequence[Tuple[str, int]], np_: int) -> List[SlotInfo]:
    """Fill hosts in order (reference _allocate): ranks get consecutive
    local_ranks per host; cross_rank = index of the host among hosts that
    have a worker at that local_rank."""
    slots: List[Tuple[str, int]] = []  # (host, local_rank)
    host_counts: Dict[str, int] = {}
    for host, capacity in hosts:
        for _ in range(capacity):
            if len(slots) >= np_:
                break
            slots.append((host, host_counts.get(host, 0)))
            host_counts[host] = host_counts.get(host, 0) + 1
    if len(slots) < np_:
        total = sum(c for _, c in hosts)
        raise ValueError(
            f"Requested {np_} processes but hosts supply only {total} slots"
        )
    local_sizes: Dict[str, int] = {}
    for host, _ in slots:
        local_sizes[host] = local_sizes.get(host, 0) + 1
    # cross structure: ranks with the same local_rank across hosts
    cross_groups: Dict[int, List[int]] = {}
    infos: List[SlotInfo] = []
    for rank, (host, local_rank) in enumerate(slots):
        cross_groups.setdefault(local_rank, []).append(rank)
    for rank, (host, local_rank) in enumerate(slots):
        group = cross_groups[local_rank]
        infos.append(
            SlotInfo(
                hostname=host,
                rank=rank,
                size=np_,
                local_rank=local_rank,
                local_size=local_sizes[host],
                cross_rank=group.index(rank),
                cross_size=len(group),
            )
        )
    return infos


def ssh_base_cmd(host, ssh_port=None, batch=False, connect_timeout=None):
    """The one ssh invocation prefix (options + host) shared by the
    pre-flight probe and the rank fan-out, so a connectivity option added
    for one cannot silently diverge from the other."""
    cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if batch:
        cmd += ["-o", "BatchMode=yes"]
    if connect_timeout:
        cmd += ["-o", f"ConnectTimeout={int(connect_timeout)}"]
    if ssh_port:
        cmd += ["-p", str(ssh_port)]
    return cmd + [host]


def check_hosts_reachable(hostnames, ssh_port=None, timeout=8.0,
                          cache=None):
    """Fail-fast SSH pre-flight (reference ``run/run.py:62-115`` +
    ``run/util/cache.py``): every remote host must answer a BatchMode
    ``ssh <host> true`` before any rank is launched, so a dead host
    produces one clear per-host message instead of a start-timeout
    minutes later. Successful probes are cached on disk with a TTL;
    failures are always re-probed (a fixed host must not stay "down"
    for the cache lifetime).
    """
    import concurrent.futures
    import subprocess

    remote = [h for h in dict.fromkeys(hostnames) if not _is_local(h)]
    if not remote:
        return

    def probe(host):
        key = f"ssh:{host}:{ssh_port or 22}"
        if cache is not None and cache.get(key):
            return host, True
        cmd = ssh_base_cmd(
            host, ssh_port, batch=True, connect_timeout=timeout
        ) + ["true"]
        try:
            ok = subprocess.run(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=timeout + 4,
            ).returncode == 0
        except Exception:  # noqa: BLE001 - unreachable is unreachable
            ok = False
        return host, ok

    with concurrent.futures.ThreadPoolExecutor(
        max_workers=min(len(remote), 32)
    ) as pool:
        results = list(pool.map(probe, remote))
    if cache is not None:
        # One batched write after the pool joins: concurrent per-host
        # puts would overwrite each other's entries.
        fresh = {
            f"ssh:{h}:{ssh_port or 22}": True for h, ok in results if ok
        }
        if fresh:
            cache.put_many(fresh)
    unreachable = sorted(h for h, ok in results if not ok)
    if unreachable:
        err = RuntimeError(
            "hvdrun: unable to connect over ssh to: "
            + ", ".join(unreachable)
            + ". Verify the host names in -H/--hostfile are reachable and "
            "passwordless ssh (BatchMode) is configured."
        )
        # The elastic path launches with the reachable subset and lets
        # the driver blacklist/retry the rest.
        err.failed_hosts = unreachable
        raise err


def build_remote_command(
    host: str,
    rank_env: Dict[str, str],
    command: List[str],
    ssh_port: Optional[int] = None,
) -> List[str]:
    """The one ssh fan-out command builder (reference get_remote_command):
    env must be inlined since ssh doesn't forward it. The forwarded names
    are the port's: ``HOROVOD_*``, the rendezvous (``MASTER_*``, torchrun's
    rank names, ``TORCHELASTIC_*``), ``NCCL_*``, ``CUDA_*``, ``TORCH_*``
    and the paths; no ``JAX_``/``XLA_``."""
    env_str = " ".join(
        f"{k}={_shquote(v)}"
        for k, v in rank_env.items()
        if k.startswith(FORWARDED_PREFIXES) or k in TORCHRUN_NAMES
    )
    return ssh_base_cmd(host, ssh_port) + [
        f"cd {_shquote(os.getcwd())} > /dev/null 2>&1 ; "
        f"{env_str} " + " ".join(_shquote(c) for c in command),
    ]


def _is_local(host: str) -> bool:
    return host in LOCAL_HOST_NAMES or host == socket.gethostname()


def build_rank_env(
    slot: SlotInfo,
    base_env: Dict[str, str],
    master_addr: str,
    master_port: int,
) -> Dict[str, str]:
    """Rank ``slot.rank``'s environment: the ``HOROVOD_*`` topology of the
    JAX launcher, and the launcher's store (``MASTER_ADDR``/``PORT``, the
    agent-store switch) in place of the controller and JAX coordinator
    endpoints."""
    env = dict(base_env)
    env.update(
        {
            "HOROVOD_RANK": str(slot.rank),
            "HOROVOD_SIZE": str(slot.size),
            "HOROVOD_LOCAL_RANK": str(slot.local_rank),
            "HOROVOD_LOCAL_SIZE": str(slot.local_size),
            "HOROVOD_CROSS_RANK": str(slot.cross_rank),
            "HOROVOD_CROSS_SIZE": str(slot.cross_size),
            "MASTER_ADDR": master_addr,
            "MASTER_PORT": str(master_port),
            "RANK": str(slot.rank),
            "WORLD_SIZE": str(slot.size),
            "LOCAL_RANK": str(slot.local_rank),
            "LOCAL_WORLD_SIZE": str(slot.local_size),
            "TORCHELASTIC_USE_AGENT_STORE": "True",
            "TORCHELASTIC_RESTART_COUNT": "0",
        }
    )
    return env


def _store_addr(slots: List[SlotInfo], base_env: Dict[str, str]) -> str:
    """The address the ranks reach the launcher's store at: loopback when
    every rank is local, else this host's address (on ``HOROVOD_IFACE``'s
    first interface when one is pinned)."""
    if all(_is_local(s.hostname) for s in slots):
        return "127.0.0.1"
    iface = base_env.get("HOROVOD_IFACE", "").split(",")[0]
    if iface:
        import fcntl
        import struct

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            packed = fcntl.ioctl(s.fileno(), 0x8915,  # SIOCGIFADDR
                                 struct.pack("256s", iface[:15].encode()))
        return socket.inet_ntoa(packed[20:24])
    return socket.gethostbyname(socket.gethostname())


def host_store(addr: str):
    """The job's TCPStore, served by this process on a port the OS picks."""
    from datetime import timedelta

    import torch.distributed as dist

    return dist.TCPStore(addr, 0, None, True, timedelta(seconds=STORE_TIMEOUT_S),
                         wait_for_workers=False)


def launch_job(
    command: List[str],
    slots: List[SlotInfo],
    env: Optional[Dict[str, str]] = None,
    ssh_port: Optional[int] = None,
    output_dir: Optional[str] = None,
    verbose: bool = False,
) -> int:
    """Spawn every rank; return the first nonzero exit code (0 if all ok).
    On any failure the remaining ranks are terminated (reference gloo_run
    fan-out kill). The job's store lives in this process until every rank
    has ended."""
    base_env = dict(env if env is not None else os.environ)
    # The ring probe's address for a remote rank 0 (run.py); popped, so a
    # launch from inside a rank does not inherit the parent job's.
    probed = base_env.pop("HOROVOD_PROBED_CONTROLLER_ADDR", "")
    if not _is_local(slots[0].hostname):
        # Rank 0 hosts the core's controller: its host (its probed address
        # when the probe ran), with the port agreed through the store.
        base_env["HOROVOD_CONTROLLER_ADDR"] = probed or slots[0].hostname
    master_addr = _store_addr(slots, base_env)
    store = host_store(master_addr)

    procs: List[Tuple[SlotInfo, safe_shell_exec.ManagedProcess]] = []
    outfiles = []
    for slot in slots:
        rank_env = build_rank_env(slot, base_env, master_addr, store.port)
        if _is_local(slot.hostname):
            cmd = command
        else:
            cmd = build_remote_command(
                slot.hostname, rank_env, command, ssh_port
            )
        stdout = stderr = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            stdout = open(os.path.join(output_dir, f"rank.{slot.rank}.out"), "wb")
            stderr = open(os.path.join(output_dir, f"rank.{slot.rank}.err"), "wb")
            outfiles += [stdout, stderr]
        if verbose:
            print(f"[hvdrun] rank {slot.rank} on {slot.hostname}: {cmd}")
        procs.append(
            (slot, safe_shell_exec.ManagedProcess(cmd, env=rank_env,
                                                  stdout=stdout, stderr=stderr))
        )

    exit_code = 0
    try:
        done = set()
        while len(done) < len(procs):
            for slot, mp in procs:
                if slot.rank in done:
                    continue
                rc = mp.poll()
                if rc is not None:
                    done.add(slot.rank)
                    if rc != 0 and exit_code == 0:
                        exit_code = rc
                        print(
                            f"[hvdrun] rank {slot.rank} failed with exit code "
                            f"{rc}; terminating remaining ranks",
                            file=sys.stderr,
                        )
                        for s2, m2 in procs:
                            if s2.rank not in done:
                                m2.terminate()
            time.sleep(0.05)
    except KeyboardInterrupt:
        for _, mp in procs:
            mp.terminate()
        exit_code = 130
    finally:
        for f in outfiles:
            f.close()
        del store
    return exit_code


def _shquote(s: str) -> str:
    import shlex

    return shlex.quote(s)
