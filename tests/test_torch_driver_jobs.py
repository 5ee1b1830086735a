"""The port's elastic driver end to end: gloo ranks on the CPU under
``python -m horovod_tpu_torch.run`` (``run/elastic_driver.py``).

- a 2-rank job in which one rank is killed re-forms in process and ends
  with the state the uninterrupted job would have;
- a discovery script that grows from 1 slot to 2 grows the world;
- a host killed past ``--blacklist-threshold`` is blacklisted, the world
  shrinks, and after ``--blacklist-cooldown`` the host is re-admitted
  (two local "hosts": ``localhost`` and ``127.0.0.1``);
- an exit 79 in in-process mode is a failure (the JAX package's
  ``tests/test_elastic.py::test_driver_79_exit_is_failure_in_inprocess_mode``
  with the port's CLI and worker).

Each job rendezvouses through the driver's KV server and the store host's
TCPStores (one a generation), each on a port the OS picks, never a fixed
port.
The worker is ``torch_port_harness.ELASTIC_WORKER``: ``w += allreduce(1)``
a step, so ``w == step * size`` while the size holds.
"""

import json
import os
import stat
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_harness import run_port_elastic  # noqa: E402


def _kill(rank, at_step, gen=1, code=43):
    return json.dumps({"seed": 11, "faults": [{"kind": "kill", "site": "step", "rank": rank,
                                               "gen": gen, "at_step": at_step,
                                               "exit_code": code}]})


def _steps(recs, wid):
    return [r for r in recs.get(wid, []) if r["event"] == "step"]


def _ends(recs):
    return {wid: [r for r in rs if r["event"] == "end"] for wid, rs in recs.items()}


def _script(tmp_path, text):
    path = tmp_path / "discover.sh"
    path.write_text("#!/bin/sh\n" + text)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_killed_rank_reforms_in_process(tmp_path):
    proc, recs = run_port_elastic(["-np", "2", "--min-np", "2", "--max-np", "2"], tmp_path,
                                  env={"HOROVOD_FAULT_PLAN": _kill(1, 3)})
    assert proc.returncode == 0, (proc.stdout, proc.stderr, recs)
    err = proc.stderr
    assert "rejoin mode: inprocess" in err, err
    assert "localhost:1 failed with exit code 43" in err, err
    assert "generation 2: size 2" in err, err
    # The survivor stays the same process and rolls back to commit 3; the
    # dead slot is respawned into generation 2 and synced from it.
    pids0 = {r["pid"] for r in recs["localhost:0"]}
    assert len(pids0) == 1, recs["localhost:0"]
    assert [r["step"] for r in _steps(recs, "localhost:0") if r["gen"] == 2] == [4, 5, 6]
    starts1 = [r for r in recs["localhost:1"] if r["event"] == "start"]
    assert [r["gen"] for r in starts1] == [1, 2], starts1
    for wid, ends in _ends(recs).items():
        assert [(e["step"], e["w"]) for e in ends] == [(6, 12.0)], (wid, ends)


def test_discovery_grows_the_world(tmp_path):
    out = tmp_path / "out"
    script = _script(tmp_path, f'if [ -f "{out}/flag" ]; then echo localhost:2; '
                               f'else echo localhost:1; fi\n')
    proc, recs = run_port_elastic(
        ["--min-np", "1", "--max-np", "2", "--host-discovery-script", script,
         "--elastic-discovery-interval", "0.2"], tmp_path,
        env={"TEST_STEPS": "10", "TEST_STEP_S": "0.2", "TEST_FLAG_AT": "2"})
    assert proc.returncode == 0, (proc.stdout, proc.stderr, recs)
    assert "generation 1: size 1" in proc.stderr and "generation 2: size 2" in proc.stderr
    # The first worker keeps its process and its state across the growth;
    # the new one joins generation 2 and both end on the same state.
    assert len({r["pid"] for r in recs["localhost:0"]}) == 1
    gen2 = _steps(recs, "localhost:1")
    assert gen2 and all(r["gen"] == 2 and r["size"] == 2 for r in gen2), gen2
    ends = _ends(recs)
    assert ends["localhost:0"][-1]["w"] == ends["localhost:1"][-1]["w"]
    assert ends["localhost:0"][-1]["step"] == 10
    grown = min(r["step"] for r in gen2)
    want = sum(1.0 if s < grown else 2.0 for s in range(1, 11))
    assert ends["localhost:0"][-1]["w"] == want, (grown, ends)


def test_blacklist_after_threshold_and_readmission(tmp_path):
    script = _script(tmp_path, "echo localhost:1\necho 127.0.0.1:1\n")
    proc, recs = run_port_elastic(
        ["--min-np", "1", "--max-np", "2", "--host-discovery-script", script,
         "--elastic-discovery-interval", "0.2", "--blacklist-threshold", "1",
         "--blacklist-cooldown", "2"], tmp_path,
        env={"HOROVOD_FAULT_PLAN": _kill(1, 2), "TEST_STEPS": "16", "TEST_STEP_S": "0.25"})
    assert proc.returncode == 0, (proc.stdout, proc.stderr, recs)
    err = proc.stderr
    assert "127.0.0.1:0 failed with exit code 43 (host failures: 1)" in err, err
    assert "blacklisted host 127.0.0.1 (strike 1; quarantined for 2s)" in err, err
    assert "re-admitting host 127.0.0.1 after dead quarantine" in err, err
    sizes = [int(l.split("size ")[1].split()[0]) for l in err.splitlines()
             if "] generation " in l]
    assert sizes[:3] == [2, 1, 2], err
    # localhost:0 keeps one process through the shrink and the regrowth;
    # the re-admitted host's slot starts fresh and syncs from it.
    assert len({r["pid"] for r in recs["localhost:0"]}) == 1
    back = [r for r in recs["127.0.0.1:0"] if r["event"] == "start"]
    assert len(back) >= 2 and back[-1]["gen"] >= 3, back
    ends = _ends(recs)
    assert ends["localhost:0"][-1]["w"] == ends["127.0.0.1:0"][-1]["w"], ends
    assert ends["localhost:0"][-1]["step"] == 16


def test_exit_79_is_a_failure_in_inprocess_mode(tmp_path):
    script = ("import sys\nimport horovod_tpu_torch as hvd\n"
              "hvd.init(device='cpu')\nsys.exit(79)\n")
    proc, _ = run_port_elastic(
        ["-np", "2", "--min-np", "2", "--max-np", "2", "--blacklist-threshold", "2"],
        tmp_path, env={"HOROVOD_ELASTIC_REJOIN_MODE": "inprocess"}, script=script)
    assert proc.returncode != 0, proc.stderr
    assert "failed with exit code 79" in proc.stderr, proc.stderr
    assert "requesting respawn" not in proc.stderr, proc.stderr
    assert "blacklisted" in proc.stderr, proc.stderr
