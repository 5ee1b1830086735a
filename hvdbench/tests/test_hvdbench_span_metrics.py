"""The reader of device-idle ms under the binding's own profiler ranges
(``binding.idle_ms``) on synthetic ``gaps`` tables: which labels it takes,
ms a step, the mean over ranks, and None where none of its labels is
present."""

import pytest

from hvdbench import common

NAME = "binding.idle_ms"


def _read(*gap_tables, steps=4):
    ranks = [{"trace": {"steps": steps, "gaps": gaps}} for gaps in gap_tables]
    return common.load_file("metrics", NAME).read({"ranks": ranks})


GAPS = {
    "host outside any traced op": 0.5,
    "aten::copy_": 0.25,
    "hvd.sync.wait": 0.02,
    "hvd.enqueue": 0.004,
    "hvd.sync": 0.001,
    "hvd.sync.copyback": 0.002,
    "hvd_plan_17": 0.008,
    "hvd.pack": 0.0004,
    "hvd.syncing": 0.3,
    "hvd.enqueue.extra": 0.3,
}


@pytest.mark.parametrize("steps", [1, 4, 8])
def test_sums_its_own_labels_a_step(steps):
    assert _read(GAPS, steps=steps) == pytest.approx(1e3 * (0.004 + 0.001 + 0.002) / steps)


@pytest.mark.parametrize("label, seconds", [
    ("hvd.enqueue", 0.004), ("hvd.sync", 0.001), ("hvd.sync.copyback", 0.002)])
def test_each_label_counts_alone(label, seconds):
    assert _read({label: seconds, "aten::copy_": 0.1}, steps=2) == pytest.approx(1e3 * seconds / 2)


def test_the_mean_over_ranks_counts_a_rank_without_the_labels_as_zero():
    one = _read(GAPS, steps=2)
    assert _read(GAPS, {"aten::copy_": 0.1}, steps=2) == pytest.approx(one / 2)
    assert _read(GAPS, GAPS, steps=2) == pytest.approx(one)


@pytest.mark.parametrize("gaps", [
    {"host outside any traced op": 0.5, "aten::copy_": 0.2},
    {"hvd.sync.wait": 0.1, "hvd_plan_3": 0.1, "hvd.pack": 0.1},
])
def test_none_where_no_label_of_its_own_is_present(gaps):
    assert _read(gaps) is None


def test_none_without_a_trace():
    assert _read() is None
    assert common.load_file("metrics", NAME).read({"ranks": [{"trace": {}}, {}]}) is None


def test_stays_within_the_idle_time():
    assert _read(GAPS) <= sum(GAPS.values()) * 1e3 / 4


def test_the_manifest_reports_it_in_the_hook_driven_cell_alone():
    (entry,) = [m for m in common.manifest()["per_layer"] if m["name"] == NAME]
    assert entry["workloads"] == ["gpt2s.hooks.4"] and entry["layer"] == "entry"
    assert entry["moves"] == "tokens_per_s.hooks" and entry["unit"] == "ms"
    assert entry["source"] == "program_span" and entry["better"] == "lower"
    assert NAME in [m["name"] for m in common.cell("gpt2s.hooks.4")["per_layer"]]
