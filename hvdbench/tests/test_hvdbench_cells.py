"""Each cell's whole run on the CPU at smoke widths: the path, the
readings, the reference and the comparison. A run off the card reports no
metric. With the timed path broken underneath, ``correct`` comes out false
for each fault the cell can have; the control, at a size a test can hold,
reads far above a sound run."""

import json
import subprocess
import sys

import pytest
import torch

from hvdbench import common, compare, control
from hvdbench.run import run_cell

from .conftest import smoke_cell

SEED = 2 ** 31 + 4099
CELLS = [w["name"] for w in common.manifest()["workloads"]]


def _faults(name):
    faults = ["unchanged", "half"]
    cell = common.cell(name)
    if cell["traffic"]["ranks"] > 1:
        faults.append("no_exchange")
    if cell["config"]["family"] == "resnet":
        faults.append("wgrad_double")
    return faults


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_reports_no_device_metric(name):
    result = run_cell(smoke_cell(name), SEED, 2.0, True, device="cpu")
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"
    assert "breakdown" not in result
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(compare.NUMBERS) & set(smoke_cell(name)["limits"])
    assert result["attempted"] >= 3 and result["failed"] == 0


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in _faults(n)])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    result = run_cell(smoke_cell(name), SEED, 0.5, False, device="cpu", fault=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_a_sound_run(name):
    cell = smoke_cell(name, ranks=4)
    sound = run_cell(smoke_cell(name), SEED, 0.5, False, device="cpu")["checks"]
    got = {r["variant"]: r for r in control.readings(cell, SEED, control.VARIANTS,
                                                     torch.device("cpu"))}
    ratio = max(got["control"][n] / max(sound[n]["value"], 1e-12) for n in sound)
    assert ratio >= 3, (got["control"], sound)
    for variant in set(got) - {"control"}:
        assert any(got[variant][n] > cell["limits"][n]["limit"] for n in sound)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "hvdbench/run.py", "--workload", CELLS[0], "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "hvdbench/run.py", "--workload", CELLS[0], "--seed",
                          str(SEED), "--seconds", "3", "--trace", "1"], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"] and result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("last_bn_scale", [0.0, None])
def test_a_doubled_branch_weight_gradient_shows_only_off_a_zero_scale(last_bn_scale):
    """Behind a zero scale the branch's convolutions have no first-step
    gradient, so a fault in their backward reads nothing; at the
    configuration's scale it fails a limit."""
    cell = smoke_cell("resnet50.graph.1")
    if last_bn_scale is not None:
        cell["config"]["last_bn_scale"] = last_bn_scale
    (got,) = control.readings(cell, SEED, ["wgrad_double"], torch.device("cpu"))
    over = any(got[n] > spec["limit"] for n, spec in cell["limits"].items())
    assert over is (last_bn_scale is None), got


def test_the_float64_witness_reads_far_below_the_limits():
    cell = smoke_cell("resnet50.graph.1")
    (got,) = control.readings(cell, SEED, ["f64"], torch.device("cpu"))
    assert all(got[n] < spec["limit"] / 10 for n, spec in cell["limits"].items()), got
