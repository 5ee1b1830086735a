"""The port's elastic driver end to end, part two: spares and the
control plane's own failures (gloo ranks on the CPU, the worker of
``torch_port_harness.ELASTIC_WORKER``).

- ``--spares 1``: a parked spare takes a killed rank's place in the next
  generation, on its own slot (its own card), and the dead slot becomes
  the new spare;
- ``kill_driver`` followed by ``--resume``: the resumed driver replays the
  journal, reclaims the KV port, raises the epoch and adopts the workers
  through a fresh generation (in-process mode), every step taken once;
- ``--auto-resume`` in respawn mode: the supervisor resumes the driver,
  which republishes the same world, and the workers reattach in place
  (the same pids: the store host kept their generation's store up).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_harness import run_port_elastic  # noqa: E402

# The driver dies 8 s in, past the workers' start (a driver that dies while
# the workers still rendezvous on its store fails their init: the adoption
# then falls back to a restart) and inside their 40 x 0.25 s of training.
KILL_DRIVER = json.dumps({"seed": 5, "faults": [{"kind": "kill_driver", "after_s": 8.0}]})
DRIVER_STEPS = {"TEST_STEPS": "40", "TEST_STEP_S": "0.25"}


def _ends(recs):
    return {wid: [r for r in rs if r["event"] == "end"] for wid, rs in recs.items()}


def _journal(tmp_path):
    with open(tmp_path / "od" / "driver_journal.json") as f:
        return json.load(f)


def test_spare_takes_a_killed_ranks_place(tmp_path):
    plan = json.dumps({"seed": 3, "faults": [{"kind": "kill", "site": "step", "rank": 1,
                                              "gen": 1, "at_step": 3, "exit_code": 43}]})
    proc, recs = run_port_elastic(
        ["-H", "localhost:3", "--min-np", "2", "--max-np", "2", "--spares", "1"], tmp_path,
        env={"HOROVOD_FAULT_PLAN": plan, "TEST_STEPS": "8"})
    assert proc.returncode == 0, (proc.stdout, proc.stderr, recs)
    err = proc.stderr
    assert "spawned spare localhost:2 (parked until promoted)" in err, err
    assert "promoted spare localhost:2 into generation 2" in err, err
    assert "spawned spare localhost:1" in err, err  # the dead slot, back as a spare
    spare = [r for r in recs["localhost:2"] if r["event"] == "start"]
    assert spare and spare[0]["gen"] == 2 and spare[0]["rank"] == 1, spare
    ends = _ends(recs)
    assert [e["w"] for e in ends["localhost:0"]] == [16.0], ends
    assert [e["w"] for e in ends["localhost:2"]] == [16.0], ends
    journal = _journal(tmp_path)
    world = journal["world"]
    # The spare keeps its slot's local rank (its card) in the world.
    assert world["assignments"]["localhost:2"]["local_rank"] == 2, world
    assert world["assignments"]["localhost:2"]["rank"] == 1, world
    assert journal["finished"] is True


def test_kill_driver_then_resume_adopts_the_fleet(tmp_path):
    args = ["-np", "2", "--min-np", "2", "--max-np", "2"]
    env = {"HOROVOD_FAULT_PLAN": KILL_DRIVER, **DRIVER_STEPS}
    first, _ = run_port_elastic(args, tmp_path, env=env)
    assert first.returncode == 67, (first.stdout, first.stderr)
    assert "fault plan: killing driver (exit 67)" in first.stderr
    resumed, recs = run_port_elastic(["--resume", *args], tmp_path, env=env)
    assert resumed.returncode == 0, (resumed.stdout, resumed.stderr, recs)
    err = resumed.stderr
    assert "driver journal:" in err and "(epoch 2)" in err, err
    assert "resumed at generation 2 (epoch 2)" in err, err
    assert "all adopted workers completed" in err, err
    for wid in ("localhost:0", "localhost:1"):
        assert f"worker {wid} reattached" in err, err
        # One process a slot, from the first driver's spawn to the end.
        assert len({r["pid"] for r in recs[wid]}) == 1, recs[wid]
        steps = [r["step"] for r in recs[wid] if r["event"] == "step"]
        assert steps == list(range(1, 41)), steps  # no step repeated or lost
    ends = _ends(recs)
    assert {e["w"] for es in ends.values() for e in es} == {80.0}, ends
    journal = _journal(tmp_path)
    assert journal["epoch"] == 2 and journal["finished"] is True


def test_auto_resume_reattaches_in_place_in_respawn_mode(tmp_path):
    proc, recs = run_port_elastic(
        ["-np", "2", "--min-np", "2", "--max-np", "2", "--auto-resume"], tmp_path,
        env={"HOROVOD_FAULT_PLAN": KILL_DRIVER, "HOROVOD_ELASTIC_REJOIN_MODE": "respawn",
             **DRIVER_STEPS})
    assert proc.returncode == 0, (proc.stdout, proc.stderr, recs)
    err = proc.stderr
    assert "driver died abnormally (exit 67); resuming from the journal" in err, err
    assert "resumed at generation 1 (epoch 2)" in err, err
    for wid in ("localhost:0", "localhost:1"):
        assert f"worker {wid} reattached" in err, err
        assert len({r["pid"] for r in recs[wid]}) == 1, recs[wid]
        assert {r["gen"] for r in recs[wid]} == {1}, recs[wid]
    ends = _ends(recs)
    assert {e["w"] for es in ends.values() for e in es} == {80.0}, ends
    with open(tmp_path / "events.jsonl") as f:
        events = [json.loads(l) for l in f]
    # Each worker reattaches once: after parking, or at once when its
    # commit probe's retries already reach the resumed driver.
    actions = [e["action"] for e in events]
    assert actions.count("reattach") == 2, actions
