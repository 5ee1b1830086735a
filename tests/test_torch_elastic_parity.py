"""``tools/elastic_parity.py --smoke``: elastic state live on gloo ranks.

The tool's scripted driver (a KV server and a TCPStore a generation, in the
tool's process) runs every case at once on the CPU, a 2-layer d-64 GPT in
f32: a crash at 4 ranks re-formed in process at 3, whose survivors agree
bitwise and whose steps after the rollback give the losses of a reference
run at 3 from the sync root's state, bitwise; a preemption that keeps the
state (no step repeats); a respawn whose slots resume from their persisted
snapshots; a spare promoted into generation 2 with the sync root's state;
a ZeRO-1 shrink 4 -> 2 whose rows are the reshard of the rows gathered over
the old world; and the one-rank case of chip_smoke's ``[elastic]`` (a
preemption, then a rollback out of ``backward()``, every later loss bitwise
the uninterrupted run's).
"""

from torch_port_harness import run_tool

CASES = ["crash", "preempt", "respawn", "spare", "zero1", "one"]


def test_elastic_parity_smoke_cases_on_gloo(tmp_path):
    args = ["--smoke", "--parallel", "--quick", "--out", str(tmp_path)]
    for c in CASES:
        args += ["--case", c]
    out = run_tool("horovod_tpu_torch.tools.elastic_parity", args, timeout=420)
    assert out["ok"], out["failures"]
    cases = out["cases"]
    assert sorted(cases) == sorted(CASES)
    assert cases["crash"]["gens"] == [4, 3] and cases["crash"]["losses_compared"] == 9
    assert [r["kind"] for r in cases["crash"]["reformations"]] == ["rollback"] * 3
    assert cases["crash"]["kill_to_exception_s"] < 60       # the stall-derived timeout
    assert cases["preempt"]["exits"]["3"] == [0]
    assert cases["respawn"]["respawned_with_snapshot"] == [0, 1, 2]
    assert cases["spare"]["gens"] == [3, 3] and cases["spare"]["exits"]["3"] == [0]
    assert cases["zero1"]["gens"] == [4, 2] and cases["zero1"]["zero1_n"] == [[4, 2], [4, 2]]
    assert all(cases["zero1"]["zero1_rows_equal"])
    assert [r["kind"] for r in cases["one"]["reformations"]] == ["preempt", "rollback"]
    assert cases["one"]["losses_compared"] == 5
