"""The port's compiled-path tuner (``horovod_tpu_torch/tune``) against the JAX
package's (``horovod_tpu/tune``).

- The JAX package's own pure-Python tuner tests (``tests/test_tune.py``:
  the GP, the space, the objectives, the verifier gate, the signature, the
  gauge, the knob mapping, the TP term) run against the port's modules
  (``run_reference_test``).
- The GP agrees with the C++ engine (``hvd_autotune_gp_probe`` in the
  port's build of the native core) to 1e-9, its EI argmax exactly, and with
  the JAX package's copy exactly.
- ``tune()`` gives the JAX package's ``tuned.json`` byte for byte, the
  signature set aside (it keys on the port's parameter names), for
  GPT-2-small on a flat ``generic`` model of 4, a two-level model, the
  ``h100`` row (handed to the JAX package as a model object), a
  calibration and the ZeRO-1 shape; ``tools/autotune_compiled`` writes the
  JAX tool's bytes the same way and two runs are byte-identical.
- ``spec_from_params`` on the port's GPT gives the JAX package's layers and
  bytes for the flax weights it carries.
- The step: a one-rank ``make_train_step(tuned=...)`` gives the hand-set
  knobs' losses bitwise; a stale pin warns and runs untuned; the env knob;
  ``DistributedOptimizer(tuned=...)`` on the params half; the executor's
  verdict stamp; a JAX-keyed ``tuned.json`` is refused (the deliberate
  difference).
"""

import ctypes
import importlib.util
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import test_tune as ref_tune
from horovod_tpu import tune as J
from horovod_tpu.topo import model as jmodel
from horovod_tpu.tune import gp as jgp

from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import tune as P
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops.fusion import layer_group_bytes, plan_layer_groups
from horovod_tpu_torch.topo import model as tmodel
from horovod_tpu_torch.tune import gp as pgp

from torch_port_harness import GPT_DIMS, REPO, gpt_setup, run_reference_test

GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
KNOBS = {"fusion_threshold_bytes": 2 << 20, "first_bucket_bytes": 256 << 10,
         "topo_algorithm": "auto", "wire_dtype": "f32"}

SWAPS = {"T": P, "gp_mod": pgp, "synthetic_model": tmodel.synthetic_model,
         "plan_layer_groups": plan_layer_groups, "layer_group_bytes": layer_group_bytes,
         "hvd_metrics": tmetrics, "ReduceOp": ReduceOp}
REF_TESTS = [
    "test_gp_fit_interpolates_observations", "test_gp_deterministic_sample_sequence",
    "test_space_encode_decode_roundtrip", "test_space_freezes_topo_on_flat_model",
    "test_layer_group_bytes_matches_partition", "test_free_objectives_int8_cheaper_on_wire",
    "test_tuner_refuses_corrupted_plan", "test_tuner_verifies_clean_grid",
    "test_signature_stable_and_mesh_sensitive", "test_tuned_info_gauge_and_source",
    "test_tuned_step_kwargs_mapping", "test_free_objectives_fixed_comm_constant_shift",
    "test_tune_records_fixed_comm_and_keeps_winner", "test_space_roundtrip_with_tp_and_bf16",
    "test_tp_term_priced_from_chunked_plan", "test_tune_tp_rejects_legacy_constant_alongside",
    "test_tune_tp_records_winner_computed_fixed_comm",
    "test_tuned_step_kwargs_maps_tp_chunks_to_overlap",
]


@pytest.fixture(autouse=True)
def _fresh_record(monkeypatch):
    monkeypatch.setattr(P, "_applied_info", None)
    monkeypatch.delenv("HOROVOD_TUNED_FILE", raising=False)


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_tune_test_holds_for_the_port(name, request):
    run_reference_test(ref_tune, name, SWAPS, request)


# --- the GP ---------------------------------------------------------------------


def test_gp_matches_the_native_engine_and_the_reference():
    """tests/test_tune.py's golden 5-D trace, through the port's own build of
    the native core: posterior means and variances and EI within 1e-9 of
    ``hvd_autotune_gp_probe``, the EI argmax equal; the JAX copy's numbers
    exactly."""
    from horovod_tpu_torch.common import native

    fn = native.load().hvd_autotune_gp_probe
    fn.restype = ctypes.c_int
    dbl_p = ctypes.POINTER(ctypes.c_double)
    fn.argtypes = [dbl_p, dbl_p, ctypes.c_int, dbl_p, ctypes.c_int, dbl_p, dbl_p, dbl_p,
                   ctypes.POINTER(ctypes.c_int)]
    xs = [(0.25, 0.125, 0.0, 0.0, 0.0), (0.75, 0.50, 1.0, 0.0, 1.0),
          (0.125, 0.875, 0.0, 1.0, 0.0), (0.50, 0.25, 1.0, 1.0, 1.0),
          (0.875, 0.625, 0.0, 0.0, 1.0), (0.375, 0.375, 1.0, 0.0, 0.0)]
    ys = [120.0, 310.0, 95.0, 270.0, 330.0, 180.0]
    cands = [(i / 8.0, j / 8.0, float(b0), float(b1), float(w))
             for i in range(0, 9, 2) for j in range(0, 9, 2)
             for b0 in (0, 1) for b1 in (0, 1) for w in (0, 1)]
    n, m = len(xs), len(cands)
    mu_c, var_c, ei_c = ((ctypes.c_double * m)() for _ in range(3))
    am_c = ctypes.c_int(-1)
    rc = fn((ctypes.c_double * (n * 5))(*[v for x in xs for v in x]),
            (ctypes.c_double * n)(*ys), n,
            (ctypes.c_double * (m * 5))(*[v for c in cands for v in c]), m,
            mu_c, var_c, ei_c, ctypes.byref(am_c))
    assert rc == 0
    gp, ref = pgp.fit(xs, ys), jgp.fit(xs, ys)
    for i, c in enumerate(cands):
        mu, var = pgp.posterior(gp, c)
        assert abs(mu - mu_c[i]) < 1e-9 and abs(var - var_c[i]) < 1e-9, i
        assert abs(pgp.expected_improvement(gp, c) - ei_c[i]) < 1e-9
        assert (mu, var) == jgp.posterior(ref, c)
        assert pgp.expected_improvement(gp, c) == jgp.expected_improvement(ref, c)
    assert pgp.ei_argmax(gp, cands) == am_c.value == jgp.ei_argmax(ref, cands)
    a, b = pgp.Lcg(7), jgp.Lcg(7)
    assert [a.next_index(97) for _ in range(20)] == [b.next_index(97) for _ in range(20)]


# --- the tuner's output ---------------------------------------------------------


def _gpt2_spec(mesh):
    from horovod_tpu_torch.models.transformer import TransformerLM

    return P.spec_from_params("transformer", TransformerLM(**GPT2_SMALL, device="meta"),
                              mesh=mesh)


def _body(cfg) -> dict:
    d = cfg.to_dict()
    d.pop("signature")
    return d


def _calibration(model, factor):
    from horovod_tpu_torch.sim import calibrate as tcal

    hop = model.hops[-1]
    return tcal.Calibration(signature=tcal.model_signature(model), source="test", hops={
        hop.name: {"calibrated": True, "latency_us": hop.latency_us * factor,
                   "bandwidth_gbps": hop.bandwidth_gbps / factor}}).to_dict()


TUNE_CASES = {
    "generic-local4": dict(sizes=dict(local=4), generation="generic"),
    "generic-two-level": dict(sizes=dict(local=4, cross=2), generation="generic"),
    "h100-local4": dict(sizes=dict(local=4), generation="h100"),
    "h100-local4-f32": dict(sizes=dict(local=4), generation="h100", allow_int8=False),
    "h100-two-level-zero1": dict(sizes=dict(local=4, cross=2), generation="h100", zero1=True),
    "h100-calibrated": dict(sizes=dict(local=4), generation="h100", calibration=3.0),
}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_output_equals_the_reference_bytes(case):
    """The same spec and model (the JAX side gets the port's model as a
    model object, which holds the ``h100`` row the JAX package lacks): the
    same knobs, objectives, baseline, history and search, byte for byte."""
    c = TUNE_CASES[case]
    pm = tmodel.synthetic_model(generation=c["generation"], **c["sizes"])
    jm = jmodel.InterconnectModel.from_dict(pm.to_dict())
    spec = _gpt2_spec({"data": pm.size})
    jspec = J.ProgramSpec(name=spec.name, layers=spec.layers, signature=spec.signature)
    kw = dict(samples=8, seed=0, zero1=c.get("zero1", False))
    pkw, jkw = dict(kw), dict(kw)
    if "allow_int8" in c:
        pkw["space"] = P.space_for_model(pm, allow_int8=False)
        jkw["space"] = J.space_for_model(jm, allow_int8=False)
    if "calibration" in c:
        from horovod_tpu.sim import calibrate as jcal
        from horovod_tpu_torch.sim import calibrate as tcal

        doc = _calibration(pm, c["calibration"])
        pkw["calibration"] = tcal.Calibration.from_dict(doc)
        jkw["calibration"] = jcal.Calibration.from_dict(doc)
    got, want = P.tune(spec, pm, **pkw), J.tune(jspec, jm, **jkw)
    assert json.dumps(_body(got), sort_keys=True) == json.dumps(_body(want), sort_keys=True)
    assert got.to_json() == P.tune(spec, pm, **pkw).to_json()


def _jax_tool():
    path = os.path.join(REPO, "tools", "autotune_compiled.py")
    spec = importlib.util.spec_from_file_location("jax_autotune_compiled", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--program", "mlp3", "--local", "4"],
    ["--program", "transformer", "--local", "4", "--cross", "2", "--samples", "8"],
    ["--program", "transformer", "--local", "4", "--wire", "f32", "--samples", "6",
     "--zero1"],
], ids=["mlp3", "transformer-two-level", "transformer-f32-zero1"])
def test_autotune_tool_writes_the_reference_bytes(argv, tmp_path, monkeypatch, capsys):
    from horovod_tpu_torch.tools import autotune_compiled as ttool

    outs = [str(tmp_path / f) for f in ("a.json", "b.json", "jax.json")]
    assert ttool.main(argv + ["--out", outs[0]]) == 0
    assert ttool.main(argv + ["--out", outs[1]]) == 0
    monkeypatch.setattr(sys, "argv", ["autotune_compiled.py", *argv, "--out", outs[2]])
    assert _jax_tool().main() == 0
    a, b, j = (open(p).read() for p in outs)
    assert a == b
    got, want = json.loads(a), json.loads(j)
    assert got.pop("signature") != want.pop("signature")
    assert got == want
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert printed["knobs"] == want["knobs"]


def test_autotune_tool_exits_5_when_a_plan_cannot_be_verified(tmp_path, monkeypatch):
    from horovod_tpu_torch.analysis import plan_verify
    from horovod_tpu_torch.tools import autotune_compiled as ttool

    finding = plan_verify.Finding("PV1", "error", "a refuted schedule", "test")
    monkeypatch.setattr(plan_verify, "verify_plan", lambda *a, **k: [finding])
    assert ttool.main(["--program", "mlp3", "--local", "4", "--samples", "4",
                       "--out", str(tmp_path / "t.json")]) == 5
    assert not (tmp_path / "t.json").exists()


def test_spec_from_params_equals_the_reference_on_the_carried_weights():
    """The port's GPT carrying the flax weights: the same top-level layers
    and bytes as the JAX package's spec of the flax tree."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.utils.convert import flatten, load_flax_params

    _, params, _, _ = gpt_setup()
    model = TransformerLM(**GPT_DIMS, device="cpu")
    load_flax_params(model, flatten(params))
    got = P.spec_from_params("gpt", model, mesh={"data": 2})
    # The flax tree as jax.tree.map (any jit boundary, eval_shape) returns it,
    # keys sorted: the JAX package labels its sorted children with the
    # dict's own key order (the port with each child's key: ROADMAP's
    # deliberate differences).
    import jax

    want = J.spec_from_params("gpt", jax.tree.map(lambda x: x, params), mesh={"data": 2})
    assert got.layers == want.layers and len(got.layers) == GPT_DIMS["n_layers"] + 4
    meta = P.spec_from_params("gpt", TransformerLM(**GPT_DIMS, device="meta"), mesh={"data": 2})
    assert meta.layers == got.layers and meta.signature == got.signature
    # The leaves are numpy-named and in the JAX leaf order; the hash is the
    # port's own.
    assert all(leaf[-1] == "float32" for leaf in got.signature["leaves"])
    assert got.signature["treedef"].startswith("torch-params(block_0.attention.key.kernel")
    assert got.signature["hash"] != want.signature["hash"]
    bf = P.step_signature({"w": torch.zeros(2, 3, dtype=torch.bfloat16)}, mesh={"data": 1})
    assert bf["leaves"] == [[2, 3, "bfloat16"]]


# --- the mapping and the step -----------------------------------------------------


@pytest.mark.parametrize("knobs", [
    dict(KNOBS), dict(KNOBS, topo_algorithm="flat", wire_dtype="int8"),
    dict(KNOBS, topo_algorithm="two-level", wire_dtype="bf16"),
    dict(KNOBS, topo_algorithm="split", tp_chunks=4), dict(KNOBS, tp_chunks=0)])
def test_tuned_step_kwargs_equal_the_reference(knobs):
    mk = dict(signature={}, objectives={}, baseline={})
    assert P.tuned_step_kwargs(P.TunedConfig(knobs=dict(knobs), **mk)) == \
        J.tuned_step_kwargs(J.TunedConfig(knobs=dict(knobs), **mk))


def test_resolve_tuned_types(tmp_path, monkeypatch):
    cfg = P.TunedConfig(knobs=dict(KNOBS), signature={"hash": "beef"}, objectives={},
                        baseline={})
    path = str(tmp_path / "t.json")
    P.save_tuned(cfg, path)
    assert P.resolve_tuned(False) == (None, "none")
    assert P.resolve_tuned(None) == (None, "none")
    assert P.resolve_tuned(cfg)[1] == "arg" and P.resolve_tuned(cfg.to_dict())[1] == "arg"
    assert P.resolve_tuned(path)[0].knobs == KNOBS
    monkeypatch.setenv("HOROVOD_TUNED_FILE", path)
    assert P.resolve_tuned(None)[1] == "env"
    assert P.current_tuned_source() == {"source": "env", "signature": "beef",
                                        "matched": False, "where": "-"}
    monkeypatch.setenv("HOROVOD_TUNED_FILE", str(tmp_path / "missing.json"))
    assert P.resolve_tuned(None) == (None, "none")
    with pytest.raises(TypeError, match="tuned="):
        P.resolve_tuned(True)


@pytest.fixture
def one_rank(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _gpt():
    from horovod_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(**GPT_DIMS, device="cpu", seed=0)


def _run(hvd, steps=3, **kw):
    from horovod_tpu_torch.models.transformer import lm_loss

    model = _gpt()
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt, overlap=True, **kw)
    rng = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rng.randint(0, GPT_DIMS["vocab_size"], (2, 32)))
                  for _ in range(2))
    losses = [float(step(model, batch)) for _ in range(steps)]
    o = step.optimizer
    return losses, (o._threshold, o._first_bucket, o._quantized)


def _pin(mesh, knobs=KNOBS):
    return P.TunedConfig(knobs=dict(knobs), signature=P.step_signature(_gpt(), mesh=mesh),
                         objectives={}, baseline={}, program="gpt")


def test_tuned_step_is_the_hand_set_step(one_rank, tmp_path, monkeypatch, caplog):
    """A matched pin, by argument, path and env knob: the hand-set knobs'
    losses bitwise, the pin's threshold and first bucket built, the gauge
    ``matched=1``. A pin keyed on another mesh: the FALLING BACK warning,
    the untuned step's losses and knobs, ``matched=0``."""
    hvd = one_rank
    cfg = _pin({"data": 1})
    path = str(tmp_path / "tuned.json")
    P.save_tuned(cfg, path)
    hand = _run(hvd, tuned=False, **P.tuned_step_kwargs(cfg))
    assert hand[1] == (2 << 20, 256 << 10, False)
    tmetrics.install(True)
    try:
        assert _run(hvd, tuned=cfg) == hand
        assert P.applied_tuned_info() == {"source": "arg", "signature": cfg.signature_hash,
                                          "matched": True, "where": "make_train_step"}
        assert _run(hvd, tuned=path) == hand and P.applied_tuned_info()["source"] == "file"
        monkeypatch.setenv("HOROVOD_TUNED_FILE", path)
        assert _run(hvd) == hand and P.applied_tuned_info()["source"] == "env"
        monkeypatch.delenv("HOROVOD_TUNED_FILE")
        assert any('matched="1"' in k for k in tmetrics.flat() if "hvd_tuned_info" in k)
        untuned = _run(hvd, tuned=False)
        with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
            assert _run(hvd, tuned=_pin({"data": 4})) == untuned
        assert any("FALLING BACK" in r.message for r in caplog.records)
        assert P.applied_tuned_info()["matched"] is False
        assert any('matched="0"' in k for k in tmetrics.flat() if "hvd_tuned_info" in k)
    finally:
        tmetrics.install(False)
    # The pin fills only what the caller left unset.
    assert _run(hvd, steps=1, tuned=cfg, fusion_threshold_bytes=1 << 20)[1] == \
        (1 << 20, 256 << 10, False)
    with pytest.raises(TypeError, match="tuned="):
        hvd.make_train_step(lambda p, b: p.sum(), torch.optim.SGD(_gpt().parameters(), lr=0.1),
                            tuned=True)


def test_composed_step_takes_the_threshold_and_first_bucket(one_rank, caplog):
    """``make_train_step(rules="gpt", tuned=...)`` on a (data 1, model 1)
    mesh: the pin keyed on the local tree and the mesh gives the threshold
    and the first bucket (the JAX composed builder's two knobs), the losses
    the hand-set knobs'; a pin keyed on another mesh warns and keeps them."""
    import jax

    from horovod_tpu_torch.models.transformer import make_gpt_loss_fn
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.rules import named_tree_paths
    from horovod_tpu_torch.utils.convert import flatten, local_params_from_flax

    hvd = one_rank
    _, params, tokens, labels = gpt_setup()
    flat = {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, params)).items()}
    mesh = build_mesh({"data": 1, "model": 1})
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    loss_fn = make_gpt_loss_fn(GPT_DIMS["n_heads"], model_axis="model", dtype=torch.float32)

    def run(**kw):
        tree = local_params_from_flax(flat, "gpt", mesh, device="cpu")
        leaves = [t for _, t in named_tree_paths(tree)]
        step = hvd.make_train_step(loss_fn, torch.optim.AdamW(leaves, lr=1e-3), mesh=mesh,
                                   rules="gpt", overlap=True, **kw)
        losses = [float(step(tree, batch)) for _ in range(2)]
        return losses, (step.optimizer._threshold, step.optimizer._first_bucket)

    tree = local_params_from_flax(flat, "gpt", mesh, device="cpu")
    cfg = P.TunedConfig(knobs=dict(KNOBS), signature=P.step_signature(tree, mesh=mesh),
                        objectives={}, baseline={})
    hand = run(tuned=False, fusion_threshold_bytes=2 << 20, first_bucket_bytes=256 << 10)
    assert run(tuned=cfg) == hand and hand[1] == (2 << 20, 256 << 10)
    assert P.applied_tuned_info()["where"] == "make_train_step(rules=...)"
    stale = P.TunedConfig(knobs=dict(KNOBS), signature=P.step_signature(tree, mesh={"data": 2}),
                          objectives={}, baseline={})
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        assert run(tuned=stale)[1] == (None, None)
    assert any("FALLING BACK" in r.message for r in caplog.records)


def test_a_reference_keyed_pin_is_refused_on_a_port_step(one_rank, caplog):
    """The deliberate difference (ROADMAP): the JAX package keys its
    signature on jax's PyTreeDef, so its pin for the same model and mesh
    warns and runs untuned on the port's step."""
    _, params, _, _ = gpt_setup()
    jcfg = J.TunedConfig(knobs=dict(KNOBS), signature=J.step_signature(params, mesh={"data": 1}),
                         objectives={}, baseline={}, program="gpt")
    cfg = P.TunedConfig.from_dict(json.loads(jcfg.to_json()))
    assert P.params_match(cfg.signature, _pin({"data": 1}).signature) is False
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        assert _run(one_rank, steps=1, tuned=cfg) == _run(one_rank, steps=1, tuned=False)
    assert any("FALLING BACK" in r.message for r in caplog.records)


def test_distributed_optimizer_matches_on_the_params_half(one_rank, caplog):
    hvd = one_rank
    model = _gpt()
    # The mesh half differs: the optimizer sees none, so the pin applies.
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                   named_parameters=model.named_parameters(), overlap=True,
                                   tuned=_pin({"data": 8}))
    assert (opt._threshold, opt._first_bucket) == (2 << 20, 256 << 10)
    assert P.applied_tuned_info()["where"] == "DistributedOptimizer"
    # Unnamed at first, matched once make_train_step binds the module.
    P._applied_info = None
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                   tuned=_pin({"data": 1}))
    assert opt._threshold is None and P.applied_tuned_info() is None   # not decided yet
    opt.bind_module(model)
    assert opt._threshold == 2 << 20 and P.applied_tuned_info()["matched"]
    stale = P.TunedConfig(knobs=dict(KNOBS), objectives={}, baseline={},
                          signature=P.step_signature({"w": torch.zeros(2)}))
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                       named_parameters=model.named_parameters(), tuned=stale)
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(), zero1=True,
                                 tuned=_pin({"data": 1}))
    assert opt._threshold is None
    assert any("FALLING BACK" in r.message for r in caplog.records)
    assert any("ignores tuned=" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="tuned="):
        hvd.make_train_step(lambda m, b: m(b).sum(), opt, tuned=_pin({"data": 1}))


def test_executor_stamps_tuned_info_into_the_verdict(one_rank, tmp_path, monkeypatch):
    from horovod_tpu_torch.common.topology import Topology
    from horovod_tpu_torch.common.types import TensorTableEntry
    from horovod_tpu_torch.core.nccl_executor import NcclPlanExecutor

    cfg = P.TunedConfig(knobs=dict(KNOBS), signature={"hash": "feed0123"}, objectives={},
                        baseline={})
    path = str(tmp_path / "t.json")
    P.save_tuned(cfg, path)
    monkeypatch.setenv("HOROVOD_TUNED_FILE", path)
    topo = Topology(rank=0, size=1, local_rank=0, local_size=1, cross_rank=0, cross_size=1)
    ex = NcclPlanExecutor(topo, torch.device("cpu"))
    assert ex.tuned_info() == {"source": "env", "signature": "feed0123", "matched": False,
                               "where": "-"}
    plan = {"type": 0, "op": int(ReduceOp.SUM), "participants": 1}
    out = ex.execute(plan, [TensorTableEntry(name="t", tensor=torch.ones(4))], topo)
    assert torch.equal(torch.as_tensor(out["t"]), torch.ones(4))
    assert plan["tuned_info"]["source"] == "env" and plan["tuned_info"]["signature"] == "feed0123"
