"""The port's symbolic plan verifier against the JAX package.

- ``verify_plan_grid`` gives the JAX package's findings and count over the
  default topology ladder and over the ``generic`` and ``v5p`` ladders
  (every candidate clean), and the port's ``h100`` plans verify clean too.
- Every mutation of a plan (a stage dropped, its bytes, axis, primitive,
  rounds or wire dtype changed, split buckets moved, a non-bijective
  permute round) gives the same findings, rule, location, message and
  details, as the JAX verifier's on the same mutation of the same plan.
- ``verify_zero1_stream_plans`` gives the same findings and plans.
- The JAX package's own verifier tests (``tests/test_plan_verify.py``) run
  against the port's modules (``run_reference_test``).
"""

import dataclasses

import pytest

import test_plan_verify as ref_pv
from horovod_tpu.analysis import plan_verify as jpv
from horovod_tpu.common.types import ReduceOp as JOp
from horovod_tpu.topo import compositor as jcomp
from horovod_tpu.topo import model as jmodel

from horovod_tpu_torch.analysis import plan_verify as tpv
from horovod_tpu_torch.analysis import verify_plan, verify_plan_grid
from horovod_tpu_torch.common.types import ReduceOp as TOp
from horovod_tpu_torch.topo import compositor as tcomp
from horovod_tpu_torch.topo import model as tmodel

from torch_port_harness import run_reference_test


def _ladder(generation):
    return [(name, sizes, jmodel.synthetic_model(generation=generation, **sizes),
             tmodel.synthetic_model(generation=generation, **sizes))
            for name, sizes in jpv.DEFAULT_TOPOLOGIES]


def _dicts(findings):
    return [f.to_dict() for f in findings]


@pytest.mark.parametrize("generation", [None, "generic", "v5p"])
def test_grid_equals_jax(generation):
    if generation is None:
        got, want = verify_plan_grid(), jpv.verify_plan_grid()
    else:
        ladder = _ladder(generation)
        got = verify_plan_grid([(n, t) for n, _, _, t in ladder])
        want = jpv.verify_plan_grid([(n, j) for n, _, j, _ in ladder])
    assert (_dicts(got[0]), got[1]) == (_dicts(want[0]), want[1])
    assert got[0] == [] and got[1] > 600


def test_h100_plans_verify_clean():
    findings, count = verify_plan_grid([(n, t) for n, _, _, t in _ladder("h100")])
    assert findings == [] and count > 600


def _mutations(comp, model, ops, flat8, two):
    """(name, plan, model, rounds_fn) for corrupted schedules of every kind."""
    out = []
    for coll in comp.COLLECTIVES:
        for alg, plan in comp.candidate_plans(model, coll, 1 << 20).items():
            if len(plan.stages) > 1:
                out.append((f"{coll}/{alg}/drop", dataclasses.replace(
                    plan, stages=plan.stages[:-1]), model, None))
            for i, st in enumerate(plan.stages):
                for field, value in (("bytes_on_wire", st.bytes_on_wire * 2 + 1),
                                     ("axis", "bogus"), ("primitive", "all_to_all"),
                                     ("rounds", st.rounds + 3), ("wire_dtype", "int8")):
                    stages = list(plan.stages)
                    stages[i] = dataclasses.replace(st, **{field: value})
                    out.append((f"{coll}/{alg}/{i}/{field}", dataclasses.replace(
                        plan, stages=tuple(stages)), model, None))
    split = comp.candidate_plans(two, "allreduce", 64 << 20, op=ops.SUM)["split"]
    out.append(("split", dataclasses.replace(split, split_bytes=(
        split.split_bytes[0] + 4096, split.split_bytes[1])), two, None))
    ring = comp.candidate_plans(flat8, "allreduce", 64 << 20)["ring"]

    def corrupt(primitive, size):
        rounds = comp.perm_rounds(primitive, size)
        if rounds:
            rounds = [list(r) for r in rounds]
            rounds[0][0] = (0, rounds[0][1][1])
        return rounds

    out.append(("bijection", ring, flat8, corrupt))
    return out


def test_mutations_give_the_jax_findings():
    jm = jmodel.synthetic_model(local=2, cross=2, pod=2, generation="v5e")
    tm = tmodel.synthetic_model(local=2, cross=2, pod=2, generation="v5e")
    jflat = jmodel.synthetic_model(local=8, generation="v5e")
    tflat = tmodel.synthetic_model(local=8, generation="v5e")
    want = _mutations(jcomp, jm, JOp, jflat, jmodel.synthetic_model(4, 2, generation="v5e"))
    got = _mutations(tcomp, tm, TOp, tflat, tmodel.synthetic_model(4, 2, generation="v5e"))
    assert [g[0] for g in got] == [w[0] for w in want]
    caught = 0
    for (name, plan, model, fn), (_, jplan, jmod, jfn) in zip(got, want):
        findings = _dicts(verify_plan(plan, model, rounds_fn=fn))
        assert findings == _dicts(jpv.verify_plan(jplan, jmod, rounds_fn=jfn)), name
        caught += bool(findings)
    assert caught > 0.9 * len(got)


@pytest.mark.parametrize("quantized", [False, True])
def test_zero1_stream_plans_equal_jax(quantized):
    buckets = [1 << 20, 3 << 20, 64 << 20, 12345]
    for sizes in (dict(local=8), dict(local=4, cross=2)):
        jm = jmodel.synthetic_model(generation="v5p", **sizes)
        tm = tmodel.synthetic_model(generation="v5p", **sizes)
        got = tpv.verify_zero1_stream_plans(tm, buckets, quantized=quantized)
        want = jpv.verify_zero1_stream_plans(jm, buckets, quantized=quantized)
        assert (_dicts(got[0]), got[1]) == (_dicts(want[0]), want[1])
        assert [(r.to_dict(), a.to_dict()) for r, a in
                tpv.zero1_bucket_plans(tm, buckets, quantized=quantized)] == \
            [(r.to_dict(), a.to_dict()) for r, a in
             jpv.zero1_bucket_plans(jm, buckets, quantized=quantized)]


# The JAX package's own verifier tests (the parametrized sweep has its
# counterpart in test_grid_equals_jax), against the port.
REF_TESTS = [
    "test_grid_verifies_clean", "test_selected_plan_is_a_verified_candidate",
    "test_ineligible_model_collapses_and_verifies", "test_stage_kind_decomposition",
    "test_perm_rounds_ring_and_halving", "test_dropped_stage_rejected",
    "test_dropped_stage_rejected_every_collective", "test_wrong_bytes_rejected",
    "test_wrong_axis_rejected", "test_wrong_primitive_rejected",
    "test_wrong_round_count_rejected", "test_non_bijective_permute_round_rejected",
    "test_corrupt_split_buckets_rejected", "test_hop_size_mismatch_rejected",
    "test_empty_schedule_rejected_multi_rank", "test_int8_candidates_verify_clean",
    "test_int8_rejected_for_non_additive_ops", "test_int8_stage_with_full_precision_bytes_rejected",
    "test_compressed_bytes_without_quantize_stage_rejected", "test_int8_wrong_op_stage_rejected",
    "test_unknown_wire_dtype_rejected", "test_grid_sweeps_int8_plans",
]
SWAPS = {"ReduceOp": TOp, "verify_plan": verify_plan, "verify_plan_grid": verify_plan_grid,
         "DEFAULT_PAYLOADS": tpv.DEFAULT_PAYLOADS, "DEFAULT_TOPOLOGIES": tpv.DEFAULT_TOPOLOGIES,
         "COLLECTIVES": tcomp.COLLECTIVES, "candidate_plans": tcomp.candidate_plans,
         "perm_rounds": tcomp.perm_rounds, "select_plan": tcomp.select_plan,
         "stage_kind": tcomp.stage_kind, "synthetic_model": tmodel.synthetic_model,
         "MODELS": [(n, tmodel.synthetic_model(generation="v5e", **s))
                    for n, s in tpv.DEFAULT_TOPOLOGIES],
         "TWO_LEVEL": tmodel.synthetic_model(local=4, cross=2, generation="v5e"),
         "THREE_LEVEL": tmodel.synthetic_model(local=2, cross=2, pod=2, generation="v5e")}


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_plan_verify_tests(name, request):
    run_reference_test(ref_pv, name, SWAPS, request)
