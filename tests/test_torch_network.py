"""The port's ring NIC probe (horovod_tpu_torch/run/network.py and
run/probe.py) against the JAX package's (horovod_tpu/run/network.py):

- tests/test_network.py's seven tests (the HMAC secret and ``Wire``
  framing, ping and a wrong key, the driver/task ring over three tasks, a
  task service running a command, ``discover_common_interfaces`` over two
  local probe processes, the address codec), run against the port's
  module;
- a frame written by either package's ``Wire`` reads in the other's (the
  messages themselves are each package's own classes);
- end to end through the launcher: ``python -m horovod_tpu_torch.run -np 3``
  over ``localhost`` + fake ``hosta`` + ``hostb`` through an ssh PATH shim
  (it runs the command here): the ring probe runs over the three hosts
  (``python -m horovod_tpu_torch.run.probe`` on each, through the shim for
  the fake ones), ``HOROVOD_IFACE`` reaches the ranks, and the job's
  allreduce is right.
"""

import io
import os
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu.run import network as jax_net

from horovod_tpu_torch.run import network as port_net

import test_network as ref_tests
from torch_port_harness import run_reference_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE = ["test_secret_roundtrip", "test_wire_roundtrip_and_tamper",
             "test_ping_and_wrong_key", "test_driver_task_registration_and_ring",
             "test_task_service_run_command", "test_discover_common_interfaces_local",
             "test_address_codec"]


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_network_test_holds_for_the_port(name, request):
    run_reference_test(ref_tests, name, {"net": port_net}, request)


@pytest.mark.parametrize("writer,reader", [(port_net, jax_net), (jax_net, port_net)])
def test_wire_frames_cross_packages(writer, reader):
    key = writer.make_secret_key()
    buf = io.BytesIO()
    writer.Wire(key).write({"addresses": [("10.0.0.1", 9)]}, buf)
    buf.seek(0)
    assert reader.Wire(key).read(buf) == {"addresses": [("10.0.0.1", 9)]}
    assert writer.repr_addresses({"lo": [("127.0.0.1", 5)]}) == \
        reader.repr_addresses({"lo": [("127.0.0.1", 5)]})


def test_nic_probe_through_an_ssh_shim(tmp_path):
    """``localhost`` + fake ``hosta`` + ``hostb``: the pre-flight, the ring
    probe's tasks on the fake hosts and their ranks go through the ssh
    binary (a PATH shim that runs the command here); the ranks find the
    launcher's store on the probed interface."""
    shim_dir = tmp_path / "bin"
    shim_dir.mkdir()
    shim = shim_dir / "ssh"
    shim.write_text(textwrap.dedent("""\
        #!/bin/sh
        while [ $# -gt 0 ]; do
          case "$1" in
            -o|-p) shift 2 ;;
            -*) shift ;;
            *) break ;;
          esac
        done
        host="$1"; shift
        echo "$host $*" >> "$SSH_SHIM_LOG"
        exec /bin/sh -c "$*"
        """))
    shim.chmod(0o755)
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent("""\
        import os
        import numpy as np
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        s = hvd.allreduce(np.full(2, float(hvd.rank() + 1), np.float32), op=hvd.Sum, name="e2e")
        print("NICE2E", hvd.rank(), hvd.size(), float(s[0]), os.environ.get("HOROVOD_IFACE"),
              os.environ.get("MASTER_ADDR"), flush=True)
        hvd.shutdown()
        """))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "2"
    env["PATH"] = f"{shim_dir}{os.pathsep}{env.get('PATH', '')}"
    env["SSH_SHIM_LOG"] = str(tmp_path / "ssh.log")
    for k in ("HOROVOD_IFACE", "HOROVOD_RANK", "HOROVOD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out_dir = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "3", "-H",
         "localhost:1,hosta:1,hostb:1", "--disable-cache", "--verbose", "--output-dir",
         str(out_dir), sys.executable, str(worker)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    outs = {f: (out_dir / f).read_text() for f in os.listdir(out_dir)} if out_dir.exists() else {}
    assert proc.returncode == 0, (proc.stdout, proc.stderr, outs)
    lines = sorted(l.split() for o in outs.values() for l in o.splitlines()
                   if l.startswith("NICE2E"))
    assert [l[:4] for l in lines] == [["NICE2E", str(r), "3", "6.0"] for r in range(3)], outs
    routable = next(l for l in proc.stdout.splitlines() if "routable interfaces" in l)
    ifaces = {l[4] for l in lines}
    assert len(ifaces) == 1 and ifaces.pop().split(",")[0] in routable
    calls = (tmp_path / "ssh.log").read_text().splitlines()
    probes = [c.split()[0] for c in calls if "horovod_tpu_torch.run.probe" in c]
    assert sorted(probes) == ["hosta", "hostb"], calls
    # The secret travels over ssh's stdin, never on the command line.
    assert all(f'{port_net.SECRET_ENV}="$_HVDKEY"' in c for c in calls
               if "horovod_tpu_torch.run.probe" in c)
