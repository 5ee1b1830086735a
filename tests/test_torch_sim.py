"""The port's fleet simulator and calibrator against the JAX package.

- ``simulate`` (report, trace windows, driver lane), ``straggler_sensitivity``
  and ``simulate_serve`` give the JAX package's JSON bytes for the same
  seeded inputs, fault plans included; ``program_from_layers``,
  ``program_from_spec`` and ``tp_fixed_comm_us`` its programs.
- ``fit_calibration`` gives the same ``calibration.json`` from one stats
  document written here, ``apply_calibration`` the same model, the
  staleness warning the same text (the tool it names is the port's);
  ``divergence_report`` and ``measured_from_stats`` the same documents.
- ``tools/fleet_sim`` (predict, ``--serve``, ``--calibrate``,
  ``--replay``, ``--resize`` with and without ``--zero1``) writes the JAX
  tool's bytes.
- The JAX package's own simulator tests (``tests/test_sim.py``) run
  against the port's modules (``run_reference_test``).
"""

import importlib.util
import json
import logging
import os

import pytest

import test_sim as ref_sim
from horovod_tpu import sim as jsim
from horovod_tpu.fault.plan import FaultPlan as JPlan
from horovod_tpu.topo import model as jmodel
from horovod_tpu.trace import merge as jmerge

from horovod_tpu_torch import sim as tsim
from horovod_tpu_torch.fault.plan import FaultPlan as TPlan
from horovod_tpu_torch.tools import fleet_sim as ttool
from horovod_tpu_torch.topo import model as tmodel
from horovod_tpu_torch.trace import merge as tmerge

from torch_port_harness import REPO, run_reference_test

LAYERS = [4 * (32768 * 768 + 1024 * 768)] + [4 * (12 * 768 * 768 + 9 * 768)] * 12 + [4 * 2 * 768]
FAULTS = json.dumps({"seed": 7, "faults": [
    {"kind": "delay", "rank": 3, "site": "step", "seconds": 0.002, "frac": 0.5},
    {"kind": "delay", "rank": 5, "site": "step", "seconds": 0.0005, "every": 2},
    {"kind": "drop", "site": "step", "frac": 0.1}]})
SERVE_FAULTS = json.dumps({"seed": 3, "faults": [
    {"kind": "drop", "site": "request", "frac": 0.05},
    {"kind": "delay", "site": "request", "seconds": 0.003, "frac": 0.1},
    {"kind": "kill_replica", "site": "replica", "at_step": 40}]})
CONFIGS = {
    "auto": dict(),
    "two-level-int8": dict(algorithm="two-level", wire_dtype="int8"),
    "zero1": dict(zero1=True),
    "posthoc-split": dict(algorithm="split", overlap=False),
    "flat-sum": dict(algorithm="flat", op="SUM"),
}
SHAPES = {"flat-8": dict(local=8), "c4l8": dict(local=8, cross=4),
          "three": dict(local=4, cross=2, pod=2)}


def _pair(sizes, generation="generic"):
    return (jmodel.synthetic_model(generation=generation, **sizes),
            tmodel.synthetic_model(generation=generation, **sizes))


def _config(pkg, kw):
    kw = dict(kw)
    if "op" in kw:
        from horovod_tpu.common.types import ReduceOp as J
        from horovod_tpu_torch.common.types import ReduceOp as T

        kw["op"] = (J if pkg is jsim else T)[kw["op"]]
    return pkg.SimConfig(**kw)


def _sim_doc(pkg, model, plan_cls, config, tp=0.0):
    prog = pkg.program_from_layers("gpt", LAYERS, fusion_threshold_bytes=16 << 20,
                                   first_bucket_bytes=1 << 20, fixed_comm_us=tp)
    res = pkg.simulate(model, prog, _config(pkg, config), steps=4,
                       fault_plan=plan_cls.from_json(FAULTS), seed=7)
    return json.dumps({"program": prog.to_dict(), "report": res.to_report(),
                       "windows": res.windows(max_ranks=8), "driver": res.driver_window(),
                       "busy": res.per_hop_busy_us(),
                       "sensitivity": pkg.straggler_sensitivity(model, prog,
                                                                _config(pkg, config))},
                      sort_keys=True)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_simulate_same_bytes_as_jax(config, shape):
    jm, tm = _pair(SHAPES[shape])
    assert _sim_doc(tsim, tm, TPlan, CONFIGS[config]) == \
        _sim_doc(jsim, jm, JPlan, CONFIGS[config])


def test_tp_program_and_spec_equal_jax():
    jm, tm = _pair(dict(local=4, cross=2), "v5p")
    for overlap in (False, True):
        kw = dict(overlap=overlap, chunks=2, compute_us_per_psum=300.0)
        got = tsim.tp_fixed_comm_us(tm, 8 * 1024 * 768 * 2, 4, 48, **kw)
        assert got == jsim.tp_fixed_comm_us(jm, 8 * 1024 * 768 * 2, 4, 48, **kw)
        assert _sim_doc(tsim, tm, TPlan, {}, tp=got) == _sim_doc(jsim, jm, JPlan, {}, tp=got)

    class Spec:
        name, layer_bytes = "spec", LAYERS

    cfg = {"fusion_threshold_bytes": 8 << 20, "first_bucket_bytes": 1 << 19}
    assert tsim.program_from_spec(Spec, cfg).to_dict() == jsim.program_from_spec(Spec, cfg).to_dict()


@pytest.mark.parametrize("qps", [40.0, 400.0])
def test_simulate_serve_same_bytes_as_jax(qps):
    for faults in (None, SERVE_FAULTS):
        kw = dict(qps=qps, duration_s=3.0, replicas=2, max_batch_size=8, seed=5)
        got = tsim.simulate_serve(tsim.ServeSimConfig(**kw),
                                  fault_plan=faults and TPlan.from_json(faults))
        want = jsim.simulate_serve(jsim.ServeSimConfig(**kw),
                                   fault_plan=faults and JPlan.from_json(faults))
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        assert got["served"] > 0


# One stats document, as ``trace_merge --stats`` writes it: hop-labelled
# stage spans on both hops, and bytes-only plan spans the calibrator
# attributes to the bottleneck hop.
STATS = {"schema_version": 1, "world_size": 2, "ranks": {
    "0": {"steps": [[0, 0.0, 0.010], [1, 0.012, 0.021], [2, 0.024, 0.034]],
          "collectives": [
              {"name": "hvd_collective_stage:reduce_scatter", "ts": 0.001, "dur_s": 0.00021,
               "nbytes": 3 << 20, "rounds": 3, "hop": "ici"},
              {"name": "hvd_collective_stage:all_gather", "ts": 0.002, "dur_s": 0.00052,
               "nbytes": 12 << 20, "rounds": 3, "hop": "ici"},
              {"name": "hvd_collective_stage:all_reduce", "ts": 0.003, "dur_s": 0.0041,
               "nbytes": 1 << 20, "rounds": 2, "hop": "dcn"},
              {"name": "hvd_collective_stage:all_reduce", "ts": 0.004, "dur_s": 0.0113,
               "nbytes": 5 << 20, "rounds": 2, "hop": "dcn"},
              {"name": "hvd_plan", "ts": 0.005, "dur_s": 0.0012, "nbytes": 2 << 20}]},
    "1": {"steps": [[0, 0.0005, 0.0101], [1, 0.0121, 0.0212], [2, 0.0241, 0.0338]],
          "collectives": [{"name": "hvd_plan", "ts": 0.005, "dur_s": 0.0031,
                           "nbytes": 6 << 20}]}}}


def test_calibration_equals_jax(tmp_path, caplog):
    jm, tm = _pair(dict(local=4, cross=2))
    got, want = tsim.fit_calibration(STATS, tm), jsim.fit_calibration(STATS, jm)
    assert got.to_json() == want.to_json()
    assert got.hops["ici"]["calibrated"] and got.hops["dcn"]["calibrated"]
    assert tsim.apply_calibration(tm, got).to_json() == jsim.apply_calibration(jm, want).to_json()
    path = tmp_path / "calibration.json"
    tsim.save_calibration(got, str(path))
    assert path.read_text() == want.to_json()
    assert tsim.resolve_calibration(str(path)).to_json() == want.to_json()
    # A calibration for another hop ladder: the same warning, the model kept.
    jflat, tflat = _pair(dict(local=8))
    caplog.set_level(logging.WARNING)
    assert tsim.apply_calibration(tflat, got, where="test") is tflat
    assert jsim.apply_calibration(jflat, want, where="test") is jflat
    msgs = [r.getMessage() for r in caplog.records if "FALLING BACK" in r.getMessage()]
    assert len(msgs) == 2
    assert msgs[0] == msgs[1].replace("tools/fleet_sim.py",
                                      "python -m horovod_tpu_torch.tools.fleet_sim")
    with pytest.raises(ValueError, match="FALLING BACK"):
        tsim.apply_calibration(tflat, got, strict=True)
    # The replay's documents.
    measured = tsim.measured_from_stats(STATS, tm)
    assert measured == jsim.measured_from_stats(STATS, jm)
    kw = dict(modeled_step_us=9000.0, measured_step_us=float(measured["step_us"]))
    assert tsim.divergence_report({"ici": 700.0, "dcn": 2000.0}, measured["per_hop_us"], **kw) \
        == jsim.divergence_report({"ici": 700.0, "dcn": 2000.0}, measured["per_hop_us"], **kw)


def test_divergence_report_publishes_its_gauge():
    from horovod_tpu_torch import metrics

    metrics.install(True)
    try:
        tsim.divergence_report({"ici": 10.0}, {"ici": 5.0}, modeled_step_us=4.0,
                               measured_step_us=2.0)
        series = metrics.snapshot()["hvd_sim_divergence_ratio"]["series"]
        assert sorted((s["labels"]["hop"], s["value"]) for s in series) == \
            [("ici", 2.0), ("step", 2.0)]
    finally:
        metrics.reset()


def _jax_tool():
    spec = importlib.util.spec_from_file_location("ref_fleet_sim",
                                                  os.path.join(REPO, "tools", "fleet_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sim_trace(tmp_path_factory):
    """A simulated run's trace windows and their --stats document (the
    replay and calibrate modes' input)."""
    d = tmp_path_factory.mktemp("simtrace")
    assert ttool.main(["--ranks", "8", "--local", "4", "--steps", "3", "--program", "mlp3",
                       "--trace-out", str(d / "trace"), "-o", str(d / "r.json")]) == 0
    stats = tmerge.stats_summary(*tmerge.read_dir(str(d / "trace")))
    assert stats == jmerge.stats_summary(*jmerge.read_dir(str(d / "trace")))
    (d / "stats.json").write_text(json.dumps(stats))
    return d


@pytest.mark.parametrize("args", [
    ["--ranks", "64", "256", "--local", "8", "--steps", "2"],
    ["--ranks", "32", "--local", "4", "--algorithm", "two-level", "--wire", "int8", "--zero1",
     "--fault-plan", FAULTS, "--steps", "3"],
    ["--ranks", "16", "--local", "4", "--tp", "2", "--generation", "v5p", "--no-overlap"],
    ["--serve", "--qps", "50,300", "--serve-duration", "2", "--fault-plan", SERVE_FAULTS],
    ["--calibrate", "STATS", "--local", "4"],
    ["--replay", "STATS", "--local", "4"],
    ["--replay", "TRACE", "--local", "4"],
], ids=["predict", "predict-int8-zero1-faults", "predict-tp", "serve", "calibrate",
        "replay-stats", "replay-trace"])
def test_fleet_sim_tool_writes_the_jax_bytes(args, sim_trace, tmp_path):
    ref = _jax_tool()
    args = [str(sim_trace / "stats.json") if a == "STATS" else
            str(sim_trace / "trace") if a == "TRACE" else a for a in args]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert ttool.main(args + ["-o", str(tmp_path / "port" / "out.json")]) == 0
    assert ref.main(args + ["-o", str(tmp_path / "jax" / "out.json")]) == 0
    got, want = ((tmp_path / k / "out.json").read_text() for k in ("port", "jax"))
    assert got == want and len(got) > 100


def test_fleet_sim_resize_names_a13b(tmp_path):
    """``--resize`` prices the reshard; with ``--zero1`` its time too,
    through ``price_resize(model=)`` (A13b): the JAX tool's bytes."""
    ref = _jax_tool()
    for extra in ([], ["--zero1"]):
        args = ["--ranks", "8", "--local", "4", "--resize", "4,2", *extra]
        assert ttool.main(args + ["-o", str(tmp_path / "port.json")]) == 0
        assert ref.main(args + ["-o", str(tmp_path / "jax.json")]) == 0
        got, want = ((tmp_path / k).read_text() for k in ("port.json", "jax.json"))
        assert got == want and ("modeled_time_us" in got) == bool(extra)


# The JAX package's own simulator tests, against the port (its CLI, tuner
# and JAX-metrics tests have their counterparts above).
REF_TESTS = [
    "test_seed_determinism_byte_identical", "test_scaling_efficiency_monotone_vs_payload",
    "test_efficiency_drops_with_rank_count", "test_two_level_beats_flat_at_1024",
    "test_delay_fault_shifts_exactly_the_faulted_lane", "test_straggler_sensitivity_bounds",
    "test_unsupported_fault_kinds_warn", "test_zero1_adds_allgather_stages",
    "test_program_from_layers_matches_stream_partition",
    "test_calibration_fit_recovers_known_constants", "test_calibration_staleness_fallback",
    "test_calibration_transfers_across_sizes", "test_calibration_uncovered_hop_keeps_defaults",
    "test_replay_divergence_known_constants", "test_divergence_honest_null_without_measurement",
    "test_stats_summary_byte_stable_and_versioned", "test_tp_fixed_comm_prices_innermost_hop",
    "test_fixed_comm_exposed_not_compute",
]
SWAPS = {name: getattr(tsim, name) for name in (
    "Calibration", "SimConfig", "SimGroup", "SimProgram", "apply_calibration",
    "divergence_report", "fit_calibration", "load_calibration", "measured_from_stats",
    "model_signature", "program_from_layers", "save_calibration", "simulate",
    "straggler_sensitivity")}
SWAPS.update(FaultPlan=TPlan, Hop=tmodel.Hop, InterconnectModel=tmodel.InterconnectModel,
             synthetic_model=tmodel.synthetic_model, tmerge=tmerge)


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_sim_tests(name, request):
    run_reference_test(ref_sim, name, SWAPS, request)
