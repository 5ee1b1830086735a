"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import os
import re

import pytest

from hvdbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hvdbench/run.py"]
    assert all(os.path.isdir(os.path.join(common.ROOT, p)) for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(common.MANIFEST) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_config_files_hold_what_the_manifest_says():
    for c in BENCH["configs"]:
        cfg = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_and_reports_enough(name):
    cell = common.cell(name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e
    for m in cell["end_to_end"]:
        assert callable(common.load_file("end_to_end", m["name"]).read)
    for m in cell["per_layer"]:
        assert callable(common.load_file("metrics", m["name"]).read)
    assert set(cell["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
    assert cell["traffic"]["ranks"] == cell["chips"]
    assert os.path.exists(os.path.join(common.HERE, "paths", cell["traffic"]["path"] + ".py"))
    fam = common.family(cell["config"])
    assert fam.leaves(cell["config"]) and common.reference(cell["config"])


def test_every_per_layer_metric_is_reported_with_what_it_moves():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            cell = common.cell(w)
            assert m["moves"] in {x["name"] for x in cell["end_to_end"]}


def test_every_limit_states_its_readings():
    for name in CELLS:
        for number, spec in common.cell(name)["limits"].items():
            assert spec["limit"] > 0 and spec["set_from"], (name, number)


def test_the_manifest_is_plain_json():
    with open(common.MANIFEST) as f:
        assert json.load(f) == BENCH
