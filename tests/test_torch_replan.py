"""The live re-plan's planning half and the driver's trigger against the JAX
package.

- The JAX package's own re-plan tests (``tests/test_selfdrive.py``:
  ``propose_replan``, the notice's shape, ``spec_from_windows``,
  ``model_for_world``) run against the port's modules.
- ``candidate_configs``, ``propose_replan``, ``verify_replan`` and
  ``price_resize(model=)`` give the JAX package's values for GPT-2-small's
  program on drifted ``h100`` and ``generic`` models (the JAX side gets the
  port's model objects).
- ``elastic.adopted_step_kwargs`` is the JAX package's translation.
- The driver's ``_maybe_replan`` on a one-slot job: a divergent
  ``HOROVOD_CALIBRATION_FILE`` publishes one notice (journal first, then
  ``elastic/replan``, ``hvd_replan_total``), the same file never again, a
  resumed driver re-stamps it with its epoch; the skew trend fires once a
  generation; a proposal the verifier refutes is refused and counted.
"""

import json
import os

import pytest

import test_selfdrive as ref_selfdrive
from horovod_tpu import elastic as jelastic
from horovod_tpu.run import selfdrive as jsd
from horovod_tpu.sim import calibrate as jcal
from horovod_tpu.topo import model as jmodel
from horovod_tpu.tune import objective as jobj

from horovod_tpu_torch import elastic as telastic
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.run import elastic_driver as ed
from horovod_tpu_torch.run import selfdrive as psd
from horovod_tpu_torch.sim import calibrate as tcal
from horovod_tpu_torch.topo import model as tmodel
from horovod_tpu_torch.tune import objective as tobj

from torch_port_harness import run_reference_test

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
REF_TESTS = ["test_propose_replan_strictly_better_and_verified",
             "test_replan_notice_shape_is_deterministic",
             "test_spec_from_windows_and_env_override", "test_model_for_world_shapes"]
SWAPS = {"sd": psd, "synthetic_model": tmodel.synthetic_model,
         "ProgramSpec": tobj.ProgramSpec, "calibrated_model": tobj.calibrated_model,
         "Calibration": tcal.Calibration, "model_signature": tcal.model_signature}


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_replan_test_holds_for_the_port(name, request):
    run_reference_test(ref_selfdrive, name, SWAPS, request)


def _spec():
    from horovod_tpu_torch import tune as T
    from horovod_tpu_torch.models.transformer import TransformerLM

    return T.spec_from_params("gpt", TransformerLM(**GPT2_SMALL, device="meta"),
                              mesh={"data": 4})


def _calibration(model, factor):
    hop = model.hops[-1]
    return {"version": 1, "signature": tcal.model_signature(model), "source": "test",
            "meta": {}, "hops": {hop.name: {"calibrated": True, "latency_us": hop.latency_us,
                                            "bandwidth_gbps": hop.bandwidth_gbps / factor}}}


PLAN_CASES = {"h100-flat4-x4": ("h100", dict(local=4), 4.0, None),
              "h100-grid-x2": ("h100", dict(local=4, cross=2), 2.0, None),
              "generic-flat8-x3-int8": ("generic", dict(local=8), 3.0, "int8"),
              "h100-flat4-none": ("h100", dict(local=4), None, None)}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planning_half_equals_the_reference(case):
    gen, sizes, factor, wire = PLAN_CASES[case]
    pm = tmodel.synthetic_model(generation=gen, **sizes)
    jm = jmodel.InterconnectModel.from_dict(pm.to_dict())
    spec = _spec()
    jspec = jobj.ProgramSpec(name=spec.name, layers=spec.layers)
    current = None if wire is None else {"wire_dtype": wire}
    pcal = jcal_ = None
    if factor is not None:
        doc = _calibration(pm, factor)
        pcal, jcal_ = tcal.Calibration.from_dict(doc), jcal.Calibration.from_dict(doc)
    base = psd._normalize_config(current)
    assert psd.candidate_configs(pm, base) == jsd.candidate_configs(jm, base)
    got = psd.propose_replan(spec, pm, current, pcal, drift=1.5)
    want = jsd.propose_replan(jspec, jm, current, jcal_, drift=1.5)
    assert (got is None) == (want is None)
    if got is not None:
        assert json.dumps(got.to_notice(1, 2, 3), sort_keys=True) == \
            json.dumps(want.to_notice(1, 2, 3), sort_keys=True)
        assert psd.verify_replan(spec, got.config, pm, pcal) == [] == \
            jsd.verify_replan(jspec, want.config, jm, jcal_)
    assert psd.price_resize(spec.total_bytes, 4, 2, model=pm, quantized=True) == \
        jsd.price_resize(spec.total_bytes, 4, 2, model=jm, quantized=True)


def test_adopted_step_kwargs_equal_the_reference(monkeypatch):
    notice = {"id": 1, "gen": 1, "epoch": 1, "config": {
        "fusion_threshold_bytes": 1 << 22, "first_bucket_bytes": 1 << 20,
        "topo_algorithm": "two-level", "wire_dtype": "int8"}}
    assert telastic.adopted_step_kwargs() is None
    monkeypatch.setattr(telastic, "_adopted_replan", notice)
    monkeypatch.setattr(jelastic, "_adopted_replan", notice)
    assert telastic.adopted_step_kwargs() == jelastic.adopted_step_kwargs() == {
        "fusion_threshold_bytes": 1 << 22, "first_bucket_bytes": 1 << 20, "quantized": True,
        "hierarchical": "auto", "topo_algorithm": "two-level"}


# --- the driver's trigger ----------------------------------------------------------

# The published world the re-plan prices on: four slots of one host (the
# one-slot job's supervision loop never runs here).
WORLD = {"gen": 1, "epoch": 1, "size": 4, "assignments": {
    f"127.0.0.1:{i}": {"rank": i, "local_rank": i, "local_size": 4, "cross_rank": 0,
                       "cross_size": 1} for i in range(4)}}


def _driver(td, env, resume=False):
    return ed.ElasticDriver(["true"], min_np=1, max_np=1, hosts=[("127.0.0.1", 1)],
                            env=env, output_dir=td, resume=resume)


@pytest.fixture
def replan_env(tmp_path, monkeypatch):
    """A one-slot job's re-plan inputs: GPT-2-small's program as
    HOROVOD_REPLAN_SPEC and a calibration of the driver's model whose
    bandwidth is 4x below its row as HOROVOD_CALIBRATION_FILE."""
    model = psd.model_for_world(WORLD)
    spec = _spec()
    spec_path, calib_path = str(tmp_path / "spec.json"), str(tmp_path / "calibration.json")
    with open(spec_path, "w") as f:
        json.dump({"name": "gpt", "layers": [list(l) for l in spec.layers]}, f)
    calib = tcal.Calibration.from_dict(_calibration(model, 4.0))
    tcal.save_calibration(calib, calib_path)
    monkeypatch.setenv(psd.REPLAN_SPEC_ENV, spec_path)
    monkeypatch.setenv("HOROVOD_CALIBRATION_FILE", calib_path)
    tmetrics.install(True)
    yield {"model": model, "spec": spec, "calib": calib, "td": str(tmp_path / "od")}
    tmetrics.install(False)


def test_driver_replan_fires_journals_and_restamps(replan_env):
    env = {psd.REPLAN_DIVERGENCE_ENV: "0.5"}
    drv = _driver(replan_env["td"], env)
    try:
        drv._gen, drv._last_world = 1, dict(WORLD)     # generation 1 published
        drv._maybe_replan()
        doc = drv._replan_doc
        assert doc is not None and doc["id"] == 1 and doc["trigger"] == "divergence"
        want = psd.propose_replan(replan_env["spec"], replan_env["model"], None,
                                  replan_env["calib"])
        assert doc["config"] == want.config and doc["calib"] == replan_env["calib"].signature_hash
        assert json.loads(drv._kv.snapshot("elastic")["replan"].decode()) == doc
        with open(os.path.join(replan_env["td"], "driver_journal.json")) as f:
            assert json.load(f)["replan"] == doc
        assert tmetrics.flat().get('hvd_replan_total{trigger="divergence"}') == 1.0
        # The same calibration never fires again.
        drv._last_replan_check = 0.0
        drv._maybe_replan()
        assert drv._replan_doc == doc
        epoch = drv._epoch
    finally:
        drv._kv.close()
    again = _driver(replan_env["td"], env, resume=True)
    try:
        assert again._replan_doc["id"] == 1 and again._replan_doc["epoch"] == epoch + 1
        raw = json.loads(again._kv.snapshot("elastic")["replan"].decode())
        assert raw["epoch"] == epoch + 1 and raw["config"] == doc["config"]
        again._last_world = dict(WORLD)
        again._maybe_replan()      # the journaled calibration hash holds
        assert again._replan_doc["id"] == 1
    finally:
        again._kv.close()


def test_driver_skew_trend_and_refused_verification(replan_env, monkeypatch):
    """The skew trend re-plans on the best model available (the row's
    defaults here: no calibration file) once a generation; a proposal the verifier refutes is
    refused and counted, never published."""
    monkeypatch.delenv("HOROVOD_CALIBRATION_FILE")
    drv = _driver(replan_env["td"], {psd.REPLAN_SKEW_ENV: "0.05"})
    try:
        drv._last_world = dict(WORLD)
        drv._skew_trend.extend([0.01] * 8)
        drv._maybe_replan()
        assert drv._replan_doc is None and not drv._skew_replanned
        verify = psd.verify_replan
        psd.verify_replan = lambda *a: [type("F", (), {"render": lambda self: "PV0 refuted"})()]
        try:
            drv._skew_trend.extend([0.2] * 8)
            drv._last_replan_check = 0.0
            drv._maybe_replan()
        finally:
            psd.verify_replan = verify
        assert drv._replan_doc is None and drv._skew_replanned
        assert tmetrics.flat().get('hvd_replan_total{trigger="refused-verification"}') == 1.0
        drv._skew_replanned = False
        drv._last_replan_check = 0.0
        drv._maybe_replan()
        assert drv._replan_doc["trigger"] == "skew-trend" and drv._replan_doc["calib"] is None
    finally:
        drv._kv.close()
