"""The port's elastic resharding (``horovod_tpu_torch/parallel/reshard.py``)
against the JAX package's.

- The planning half is the reference's own code, copied: the reference's
  planning tests (``tests/test_reshard.py``) run against the port's module
  (``run_reference_test`` with ``R`` swapped), a manifest's JSON is the same
  bytes in both packages, and a manifest written by one parses in the other.
- The execution half works on the port's rank-local ``Zero1State``s,
  gathered (``Zero1Rows``): the same fills as the reference's
  ``_filled_state`` (SGD momentum / Adam x f32 / int8 wire, 4 -> {2, 3, 6} ->
  4) give gathered vectors bitwise equal to the reference's reshard, and the
  same dropped error-feedback mass.
"""

import json

import numpy as np
import pytest
import torch

import jax
import optax

from horovod_tpu.parallel import reshard as JR

import horovod_tpu_torch.parallel.reshard as R
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.ops import fusion as F
from horovod_tpu_torch.parallel import zero as Z

import test_reshard as ref_tests
from torch_port_harness import run_reference_test


@pytest.mark.parametrize("name", [
    "test_transfer_plan_moves_every_element_once",
    "test_layout_roundtrip_relayout_and_mismatch",
    "test_resize_redistribution_identity_and_scaling", "test_rank_coords_row_major",
    "test_leaf_slices_match_manual_slicing", "test_manifest_json_roundtrip_and_torn_refusal",
])
def test_reference_planning_test_holds_for_the_port(name, request):
    """The reference's planning tests with ``R`` bound to the port's
    module (its manifest test builds from jnp leaves, which the port's
    ``build_manifest`` takes as arrays)."""
    run_reference_test(ref_tests, name, {"R": R}, request)


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_shard_intervals_test_holds_for_the_port(quantized, monkeypatch):
    """``test_shard_intervals_cover_and_disjoint`` (parametrized, so called
    here with its parameter) with ``R`` bound to the port's module."""
    monkeypatch.setattr(ref_tests, "R", R)
    ref_tests.test_shard_intervals_cover_and_disjoint(quantized)


def _torch_params(params):
    return {k: _torch_params(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in params.items()}


def test_manifest_json_is_the_same_bytes_and_crosses_packages():
    params = ref_tests._params()
    lay = JR.zero1_layout_from_params(params, 4, threshold_bytes=1, first_bucket_bytes=1)
    port_lay = R.zero1_layout_from_params(_torch_params(params), 4, threshold_bytes=1,
                                          first_bucket_bytes=1)
    assert port_lay.to_dict() == lay.to_dict()
    kw = dict(specs={"a/w": jax.sharding.PartitionSpec("data")}, step=7)
    jman = JR.build_manifest(params, [("data", 4)], **kw)
    pman = R.build_manifest(_torch_params(params), [("data", 4)], specs={"a/w": ("data",)},
                            step=7)
    assert pman.to_json() == jman.to_json()
    assert pman.axes_hash == jman.axes_hash
    assert JR.LayoutManifest.from_json(pman.to_json()).to_json() == jman.to_json()
    assert R.LayoutManifest.from_json(jman.to_json()).to_json() == pman.to_json()
    doc = json.loads(pman.to_json())
    doc["mesh_axes"] = [["data", 2]]
    with pytest.raises(ValueError, match="torn or hand-edited"):
        JR.LayoutManifest.from_json(json.dumps(doc))


def test_zero1_layout_matches_the_reference_quantized_and_shard_len():
    params = ref_tests._params(d=40)
    for n in (1, 3, 4, 6):
        want = JR.zero1_layout_from_params(params, n, threshold_bytes=1, first_bucket_bytes=1,
                                           quantized=True)
        got = R.zero1_layout_from_params(_torch_params(params), n, threshold_bytes=1,
                                         first_bucket_bytes=1, quantized=True)
        assert got.to_dict() == want.to_dict()
        for total in (1, 100, 1000, 257):
            assert R.shard_len(total, n, True) == F.zero1_shard_len(total, n, True)
            assert R.shard_len(total, n) == F.zero1_shard_len(total, n, False)


# --- the execution half ---------------------------------------------------------

OPTS = {"sgdm": (lambda: optax.sgd(0.05, momentum=0.9),
                 lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9)),
        "adam": (lambda: optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3))}


def port_rows(jstate, layout, opt_name, params):
    """The port's gathered form of the reference's filled stacked state:
    optax's leaves of a bucket as the torch optimizer's state (count as
    ``step``, mu/nu as ``exp_avg``/``exp_avg_sq``, the momentum trace as
    ``momentum_buffer``), the residual rows as they are, and the parameter
    shards of ``params``."""
    n = layout.n_shards
    tparams = _torch_params(params)
    states = Z.init_zero1_stream_states(OPTS[opt_name][1]([torch.zeros(1)]), tparams, n,
                                        threshold_bytes=1, first_bucket_bytes=1,
                                        quantized=jstate.ef is not None)
    rows = R.stack_zero1_states(states)
    keys = ["step", "exp_avg", "exp_avg_sq"] if opt_name == "adam" else ["momentum_buffer"]
    state = {}
    for g in rows.shards:
        state[g] = {}
        for b in rows.shards[g]:
            leaves = [torch.from_numpy(np.asarray(l).copy())
                      for l in jax.tree.leaves(jstate.opt[g][b])]
            state[g][b] = {k: (v.to(torch.float32) if k == "step" else v)
                           for k, v in zip(keys, leaves)}
    ef = None if jstate.ef is None else {
        g: {b: torch.from_numpy(np.asarray(jstate.ef[g][b]).copy()) for b in sub}
        for g, sub in jstate.ef.items()}
    return rows._replace(state=state, ef=ef)


def port_gather(rows, layout):
    """``ref_tests._gather`` of the port's gathered form, in the same order."""
    out = []
    for g, b, bl in layout.bucket_items():
        for v in rows.state[g][b].values():
            a = v.numpy()
            if a.ndim >= 2:
                out.append(a.reshape(-1)[:bl.total])
            else:
                assert (a == a[0]).all()
                out.append(a[:1])
        if rows.ef is not None:
            out.append(rows.ef[g][b].numpy().reshape(-1)[:bl.total])
    return out


@pytest.mark.parametrize("opt_name", ["sgdm", "adam"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_mid", [2, 3, 6])
def test_reshard_gathered_vectors_match_the_reference(opt_name, quantized, n_mid):
    params = ref_tests._params()
    jstate, lay4 = ref_tests._filled_state(OPTS[opt_name][0](), params, 4, quantized=quantized)
    rows = port_rows(jstate, lay4, opt_name, params)
    ref = ref_tests._gather(jstate, lay4)
    np.testing.assert_array_equal(np.concatenate([a.astype(np.float64) for a in ref]),
                                  np.concatenate([a.astype(np.float64)
                                                  for a in port_gather(rows, lay4)]))
    jmid, jrep = JR.reshard_zero1_state(jstate, n_mid, layout=lay4)
    mid, rep = R.reshard_zero1_state(rows, n_mid, layout=lay4)
    lay_mid = lay4.relayout(n_mid)
    for a, b in zip(ref_tests._gather(jmid, lay_mid), port_gather(mid, lay_mid)):
        np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64))
    assert {k: rep[k] for k in ("n_old", "n_new", "moved_bytes", "local_bytes",
                                "ef_dropped_elements")} == \
        {k: jrep[k] for k in ("n_old", "n_new", "moved_bytes", "local_bytes",
                              "ef_dropped_elements")}
    back, _ = R.reshard_zero1_state(mid, 4, layout=lay_mid)
    for x, y in zip(jax.tree.leaves(jstate.opt), [v for g in sorted(back.state)
                                                  for b in sorted(back.state[g])
                                                  for v in back.state[g][b].values()]):
        np.testing.assert_array_equal(np.asarray(x).astype(np.float64),
                                      y.numpy().astype(np.float64))


def test_reshard_of_per_rank_states_rebuilds_optimizers():
    """A list of every rank's ``Zero1State`` in, a list of the new ranks'
    out: fresh inner optimizers over new shard parameters, each holding its
    rows, that step."""
    params = ref_tests._params()
    jstate, lay4 = ref_tests._filled_state(OPTS["adam"][0](), params, 4)
    rows = port_rows(jstate, lay4, "adam", params)
    states = R.unstack_zero1_states(rows)
    new, rep = R.reshard_zero1_state(states, 2, layout=lay4)
    assert len(new) == 2 and rep["n_new"] == 2
    got = R.stack_zero1_states(new)
    want, _ = R.reshard_zero1_state(rows, 2, layout=lay4)
    for a, b in zip(port_gather(got, lay4.relayout(2)), port_gather(want, lay4.relayout(2))):
        np.testing.assert_array_equal(a, b)
    for z in new:
        shards = [s for g in z.shards.values() for s in g.values()]
        assert set(z.opt.state) == set(shards)
        for s in shards:
            s.grad = torch.ones_like(s)
        z.opt.step()


def test_reshard_refusals_and_ef_policies(caplog):
    import logging

    params = ref_tests._params()
    jstate, lay4 = ref_tests._filled_state(OPTS["sgdm"][0](), params, 4, quantized=True)
    rows = port_rows(jstate, lay4, "sgdm", params)
    with pytest.raises(ValueError, match="ef_policy"):
        R.reshard_zero1_state(rows, 2, layout=lay4, ef_policy="drop")
    with pytest.raises(TypeError, match="gathered form"):
        R.reshard_zero1_state({"not": "a state"}, 2, layout=lay4)
    with pytest.raises(ValueError, match="different world"):
        R.reshard_zero1_state(rows, 2, layout=lay4.relayout(3))
    # zero: the residuals reset and the discarded mass reported, as the
    # reference reports it.
    _, jrep = JR.reshard_zero1_state(jstate, 2, layout=lay4, ef_policy="zero")
    new, rep = R.reshard_zero1_state(rows, 2, layout=lay4, ef_policy="zero")
    assert rep["ef_dropped_elements"] == jrep["ef_dropped_elements"] > 0
    assert rep["ef_dropped_mass"] == pytest.approx(jrep["ef_dropped_mass"], rel=1e-6)
    assert not any(t.any() for sub in new.ef.values() for t in sub.values())
    # fold: pad-region mass has no parameter to ride with: dropped, counted.
    ef, poisoned = {}, 0
    for g, sub in rows.ef.items():
        ef[g] = {}
        for b, t in sub.items():
            bl = lay4.buckets[g][b]
            t = t.clone()
            for i, (s, e) in enumerate(R.shard_intervals(bl.total, 4, bl.k)):
                if e - s < bl.k:
                    t[i, e - s:] = 0.25
                    poisoned += bl.k - (e - s)
            ef[g][b] = t
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch.reshard"):
        _, rep = R.reshard_zero1_state(rows._replace(ef=ef), 2, layout=lay4)
    assert rep["ef_dropped_elements"] == poisoned > 0
    assert any("dropped" in r.message for r in caplog.records)
    # Per-row scalars must agree.
    jad, lay = ref_tests._filled_state(OPTS["adam"][0](), params, 4)
    arows = port_rows(jad, lay, "adam", params)
    g = sorted(arows.state)[0]
    b = sorted(arows.state[g])[0]
    arows.state[g][b]["step"][0] += 1
    with pytest.raises(ValueError, match=f"{g}/{b}"):
        R.reshard_zero1_state(arows, 2, layout=lay)


def test_reshard_tree_and_metrics():
    params = ref_tests._params()
    j1, lay1 = ref_tests._filled_state(OPTS["sgdm"][0](), params, 4, seed=1)
    j2, lay2 = ref_tests._filled_state(OPTS["sgdm"][0](), params, 4, seed=2)
    tree = {"x": port_rows(j1, lay1, "sgdm", params),
            "y": {"z": port_rows(j2, lay2, "sgdm", params)}}
    port_metrics.install(True)
    try:
        new, reports = R.reshard_zero1_tree(tree, 2, layouts={"x": lay1, "y/z": lay2},
                                            trigger="quarantine")
        flat = port_metrics.flat()
        assert flat['hvd_reshard_total{trigger="quarantine"}'] == 2.0
        assert flat['hvd_reshard_bytes_total{axis="data"}'] == float(
            sum(r["moved_bytes"] for r in reports))
    finally:
        port_metrics.install(False)
    assert sorted(r["path"] for r in reports) == ["x", "y/z"]
    jx, _ = JR.reshard_zero1_state(j1, 2, layout=lay1)
    for a, b in zip(ref_tests._gather(jx, lay1.relayout(2)),
                    port_gather(new["x"], lay1.relayout(2))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no layout recorded"):
        R.reshard_zero1_tree(tree, 2, layouts={"x": lay1})
