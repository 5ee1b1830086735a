"""The port's interconnect model and plan selection against the JAX package.

- Plans: ``candidate_plans(...)`` and ``select_plan(...).to_dict()`` equal
  the JAX package's exactly over the five collectives, payloads from 0 B
  to 1 GiB in powers of 4, SUM/AVERAGE/MIN/MAX/PRODUCT, the f32, bf16 and
  int8 wires, the ``generic`` and ``v5p`` generations, and synthetic 1-,
  2- and 3-level models and an ineligible one; a combination the JAX
  package refuses raises the same ``ValueError`` here.
- ``collective_matmul_cost_us`` and ``collective_matmul_plan`` equal the
  JAX package's.
- The JAX package's own model and planner tests (``tests/test_topo.py``)
  run against the port's modules (``run_reference_test``).
- ``detect_generation`` reads the TPU type as the JAX package does, and
  names a card whose name holds "H100" ``h100``; the ``h100`` entry keeps
  the hops' order.
- ``tools/topo_plan`` prints the JAX tool's bytes; ``model_for_axes``
  builds the JAX model of the same axis sizes.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

import test_topo as ref_topo
from horovod_tpu.common.types import ReduceOp as JOp
from horovod_tpu.topo import compositor as jcomp
from horovod_tpu.topo import model as jmodel

from horovod_tpu_torch.common.types import ReduceOp as TOp
from horovod_tpu_torch.topo import compositor as tcomp
from horovod_tpu_torch.topo import model as tmodel
from horovod_tpu_torch.tools import topo_plan as ttool

from torch_port_harness import REPO, run_reference_test

PAYLOADS = [0] + [4 ** k for k in range(16)]          # 0 B, 1 B, 4 B, ..., 1 GiB
OPS = ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT")
WIRES = ("f32", "bf16", "int8")
MODELS = {
    "1-level": dict(local=8),
    "1-level-6": dict(local=6),
    "2-level": dict(local=4, cross=2),
    "3-level": dict(local=2, cross=2, pod=2),
    "ragged": dict(local=4, cross=2, eligible=False),
}


def _both(sizes, generation):
    return (jmodel.synthetic_model(generation=generation, **sizes),
            tmodel.synthetic_model(generation=generation, **sizes))


def _outcome(fn):
    """A call's plans as dicts, or its ValueError's message."""
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("generation", ["generic", "v5p"])
def test_plans_equal_jax(generation, model):
    jm, tm = _both(MODELS[model], generation)
    assert tm.to_json() == jm.to_json()
    count = 0
    for coll in tcomp.COLLECTIVES:
        for op in OPS:
            for wire in WIRES:
                for nb in PAYLOADS:
                    def plans(comp, m, ops):
                        return lambda: {k: p.to_dict() for k, p in comp.candidate_plans(
                            m, coll, nb, op=ops[op], wire_dtype=wire).items()}

                    def best(comp, m, ops):
                        return lambda: comp.select_plan(m, coll, nb, op=ops[op],
                                                        wire_dtype=wire).to_dict()

                    want = _outcome(plans(jcomp, jm, JOp))
                    assert _outcome(plans(tcomp, tm, TOp)) == want, (coll, op, wire, nb)
                    assert _outcome(best(tcomp, tm, TOp)) == _outcome(best(jcomp, jm, JOp))
                    count += not isinstance(want, tuple)
    assert count > 500


@pytest.mark.parametrize("model", ["1-level", "2-level", "3-level"])
def test_collective_matmul_pricing_equals_jax(model):
    jm, tm = _both(MODELS[model], "v5p")
    for wire in WIRES:
        for chunks in (1, 2, 4):
            for compute in (0.0, 37.5, 4000.0):
                for nb in PAYLOADS[::3]:
                    kw = dict(chunks=chunks, compute_us=compute, wire_dtype=wire)
                    assert tcomp.collective_matmul_cost_us(tm, nb, **kw) == \
                        jcomp.collective_matmul_cost_us(jm, nb, **kw)
                    for flavor in tcomp.COLLECTIVE_MATMUL_FLAVORS:
                        got = _outcome(lambda: tcomp.collective_matmul_plan(
                            tm, flavor, nb, **kw).to_dict())
                        assert got == _outcome(lambda: jcomp.collective_matmul_plan(
                            jm, flavor, nb, **kw).to_dict())
    assert tcomp.split_fractions(tm) == jcomp.split_fractions(jm)
    assert [tcomp.ring_hops(n) for n in range(1, 9)] == [jcomp.ring_hops(n) for n in range(1, 9)]


# The JAX package's backend-free model and planner tests, against the port.
REF_TESTS = [
    "test_synthetic_model_shapes", "test_generation_defaults_order",
    "test_model_json_stable_and_roundtrips", "test_model_override_inline_json",
    "test_model_override_full_document", "test_model_override_unknown_hop_raises",
    "test_model_from_topology_homogeneity_gate", "test_plan_selection_by_payload",
    "test_plan_single_level_ring_vs_halving", "test_plan_hierarchical_dcn_bytes_below_flat",
    "test_plan_min_two_level_product_flat", "test_plan_ineligible_model_stays_flat",
    "test_plan_unknown_collective_raises",
]
SWAPS = {"GENERATION_DEFAULTS": tmodel.GENERATION_DEFAULTS,
         "InterconnectModel": tmodel.InterconnectModel, "apply_override": tmodel.apply_override,
         "model_from_topology": tmodel.model_from_topology, "select_plan": tcomp.select_plan,
         "synthetic_model": tmodel.synthetic_model, "K": tcomp, "ReduceOp": TOp}


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_topo_tests(name, request):
    run_reference_test(ref_topo, name, SWAPS, request)


def test_detect_generation(monkeypatch):
    import torch

    for raw, want in (("v5litepod-16", "v5e"), ("v4-32", "v4"), ("v6e-8", "v6e"),
                      ("v5p-128", "v5p")):
        monkeypatch.setenv("TPU_ACCELERATOR_TYPE", raw)
        assert tmodel.detect_generation() == jmodel.detect_generation() == want
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.delenv("TPU_TYPE", raising=False)
    assert tmodel.detect_generation() == jmodel.detect_generation() == "generic"
    # A card: its name decides; a TPU type still wins.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tmodel.detect_generation() == "h100"
    monkeypatch.setenv("TPU_TYPE", "v4-8")
    assert tmodel.detect_generation() == "v4"
    monkeypatch.delenv("TPU_TYPE")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA A100-SXM4-80GB")
    assert tmodel.detect_generation() == "generic"


def test_h100_entry_ranks_its_hops():
    """The card's entry keeps the ordering plan selection needs: NVLink
    faster and quicker than the network, the network's pod hop no faster
    than its node hop; the TPU rows are the JAX package's."""
    h = tmodel.GENERATION_DEFAULTS["h100"]
    assert h["ici"][0] > h["dcn"][0] >= h["dcn-pod"][0]
    assert h["ici"][1] < h["dcn"][1] < h["dcn-pod"][1]
    assert {k: v for k, v in tmodel.GENERATION_DEFAULTS.items() if k != "h100"} == \
        jmodel.GENERATION_DEFAULTS
    m = tmodel.synthetic_model(local=4, cross=2, generation="h100")
    assert [(x.name, x.axis) for x in m.hops] == [("dcn", "cross"), ("ici", "local")]
    # Small payloads stay two-level; large ones drive both links (split).
    assert tcomp.select_plan(m, "allreduce", 1024).algorithm == "two-level"
    assert tcomp.select_plan(m, "allreduce", 256 << 20).algorithm == "split"


@pytest.mark.parametrize("sizes", [(8,), (2, 4), (2, 2, 2), (2, 1)])
def test_model_for_axes_equals_jax(sizes, monkeypatch):
    """The sizes come from the levels; the model is the JAX package's for
    the same axis sizes (bound at trace time there), override included."""
    from horovod_tpu.common import compat

    names = ("pod", "cross", "local")[-len(sizes):]
    monkeypatch.setattr(compat, "axis_size", lambda a: dict(zip(names, sizes))[a])
    levels = tuple(SimpleNamespace(n=s, rank=0, exchange=None) for s in sizes)
    for override in ("", '{"ici": {"bandwidth_gbps": 77.0}}'):
        monkeypatch.setenv("HOROVOD_TOPOLOGY_MODEL", override)
        got = tcomp.model_for_axes(levels, generation="v5p")
        want = jcomp.model_for_axes(names, generation="v5p")
        assert got.to_json() == want.to_json()


def _jax_tool():
    spec = importlib.util.spec_from_file_location("ref_topo_plan",
                                                  os.path.join(REPO, "tools", "topo_plan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [dict(local=4, cross=2, generation="v5e", op="SUM"),
                                  dict(local=2, cross=2, pod=2, generation="generic", op="MIN"),
                                  dict(local=8, generation="v4", op="AVERAGE")])
def test_topo_plan_tool_equals_jax(args, tmp_path):
    ref = _jax_tool()
    sizes = {k: args[k] for k in ("local", "cross", "pod") if k in args}
    jm = jmodel.synthetic_model(generation=args["generation"], **sizes)
    want = ref.build_dump(jm, list(jcomp.COLLECTIVES), ref.DEFAULT_BYTES, JOp[args["op"]])
    out = tmp_path / "plans.json"
    argv = [f"--{k}={v}" for k, v in args.items()] + ["-o", str(out)]
    assert ttool.main(argv) == 0
    assert out.read_text() == json.dumps(want, sort_keys=True, indent=1) + "\n"
