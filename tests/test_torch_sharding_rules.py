"""Pass 5 in the port: ``horovod_tpu_torch.analysis.sharding_rules`` against
``horovod_tpu.analysis.sharding_rules``.

The JAX package's ``tests/test_sharding_rules.py`` cases, one parametrised
case each: the same rule tables, meshes and parameter tables through both
validators give the same findings (rule, severity, location, details and
message), and each case's own assertion holds on the port's. The port takes
a ``DeviceMesh`` too; its pre-flight raises the JAX package's
``CollectiveSafetyError``, always, at the composed step's call sites.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from horovod_tpu.analysis import findings as ref_findings
from horovod_tpu.analysis import sharding_rules as ref
from horovod_tpu_torch import analysis
from horovod_tpu_torch.analysis import preflight
from horovod_tpu_torch.analysis import sharding_rules as port
from horovod_tpu_torch.analysis.findings import (
    RULE_SHARDING_BAD_RULE,
    RULE_SHARDING_DUP_AXIS,
    RULE_SHARDING_INDIVISIBLE,
    RULE_SHARDING_SCALAR,
    RULE_SHARDING_UNKNOWN_AXIS,
    RULE_SHARDING_UNMATCHED,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data": 4, "model": 2}


def _key(fs):
    return [(f.rule, f.severity, f.location, f.details, f.message) for f in fs]


def _both(rules, mesh, params=None, suppress=None):
    """The port's findings, after checking they are the JAX package's."""
    got = port.validate_sharding_rules(rules, mesh, params, suppress=suppress)
    want = ref.validate_sharding_rules(rules, mesh, params, suppress=suppress)
    assert _key(got) == _key(want)
    return got


def _rules_of(fs):
    return [f.rule for f in fs]


def case_normalize_spec_shapes():
    for spec in (None, "model", (None, "model"), (("data", "model"), None), 42, (1, 2)):
        assert port.normalize_spec(spec) == ref.normalize_spec(spec)
    assert port.normalize_spec((("data", "model"), None)) == (("data", "model"), ())


def case_jax_partition_spec_duck_types():
    from jax.sharding import PartitionSpec as P

    assert port.normalize_spec(P(None, "model")) == ((), ("model",))
    assert _both([(r".*", P("data", "model"))], MESH, {"w": (8, 8)}) == []


def case_valid_dp_tp_table_accepted():
    assert port.EXAMPLE_GPT_RULES == ref.EXAMPLE_GPT_RULES
    assert port.example_gpt_params() == ref.example_gpt_params()
    assert _both(port.EXAMPLE_GPT_RULES, port.EXAMPLE_GPT_MESH, port.example_gpt_params()) == []
    # A DeviceMesh-shaped mesh reads the same.
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 2))
    assert port.validate_sharding_rules(port.EXAMPLE_GPT_RULES, mesh,
                                        port.example_gpt_params()) == []


def case_valid_dp_tp_table_accepted_via_preflight():
    assert preflight.check_sharding_rules("gpt", port.EXAMPLE_GPT_MESH,
                                          port.example_gpt_params()) == []


def case_cli_sharding_target_accepts_reference_table():
    port_doc = json.loads(subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.collective_lint", "--json", "sharding"],
        capture_output=True, text=True, cwd=REPO, timeout=120, check=True).stdout)
    ref_doc = json.loads(subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "collective_lint.py"), "--json", "sharding"],
        capture_output=True, text=True, cwd=REPO, timeout=120, check=True).stdout)
    assert port_doc == ref_doc
    assert port_doc["summary"]["total"] == 0 and port_doc["passes"] == ["sharding"]


def case_unknown_axis_rejected():
    fs = _both([(r".*kernel$", (None, "tensor")), (r".*", None)], MESH)
    assert _rules_of(fs) == [RULE_SHARDING_UNKNOWN_AXIS]
    assert fs[0].details["axis"] == "tensor" and fs[0].severity == "error"


def case_duplicate_axis_across_dims_rejected():
    fs = _both([(r".*", ("model", "model"))], MESH)
    assert _rules_of(fs) == [RULE_SHARDING_DUP_AXIS] and fs[0].details["dims"] == [0, 1]


def case_duplicate_axis_within_dim_rejected():
    assert _rules_of(_both([(r".*", (("model", "model"), None))], MESH)) == \
        [RULE_SHARDING_DUP_AXIS]


def case_non_divisible_dim_rejected():
    fs = _both([(r".*", (None, "model"))], {"data": 4, "model": 3}, {"w": (8, 10)})
    assert _rules_of(fs) == [RULE_SHARDING_INDIVISIBLE]
    assert fs[0].details == {"param": "w", "dim": 1, "size": 10, "factor": 3, "rule_index": 0}


def case_multi_axis_product_divisibility():
    rules = [(r".*", (("data", "model"), None))]
    assert _rules_of(_both(rules, MESH, {"w": (12, 4)})) == [RULE_SHARDING_INDIVISIBLE]
    assert _both(rules, MESH, {"w": (16, 4)}) == []


def case_spec_longer_than_rank_rejected():
    assert _rules_of(_both([(r".*", (None, None, "model"))], MESH, {"w": (8, 8)})) == \
        [RULE_SHARDING_INDIVISIBLE]


def case_unmatched_param_rejected():
    assert _rules_of(_both([(r"^only_this$", None)], MESH, {"w": (8, 8)})) == \
        [RULE_SHARDING_UNMATCHED]
    assert _both([(r"^only_this$", None)], MESH, {"step": ()}) == []


def case_sharded_scalar_warned():
    fs = _both([(r".*", ("model",))], MESH, {"step": ()})
    assert _rules_of(fs) == [RULE_SHARDING_SCALAR] and fs[0].severity == "warning"


def case_bad_regex_and_bad_spec_rejected():
    assert _rules_of(_both([(r"[unclosed", None)], MESH)) == [RULE_SHARDING_BAD_RULE]
    assert _rules_of(_both([(r".*", 42)], MESH)) == [RULE_SHARDING_BAD_RULE]


def case_first_match_wins_like_match_partition_rules():
    rules = [(r"kernel$", (None, "model")), (r".*", None)]
    assert _both(rules, MESH, {"mlp/kernel": (8, 8)}) == []
    assert _both(list(reversed(rules)), MESH, {"mlp/kernel": (8, 9)}) == []


def case_preflight_raises_on_errors():
    with pytest.raises(analysis.CollectiveSafetyError) as e:
        preflight.check_sharding_rules([(r".*", (None, "tensor"))], MESH)
    with pytest.raises(ref_findings.CollectiveSafetyError) as r:
        __import__("horovod_tpu.analysis.preflight", fromlist=["x"]).check_sharding_rules(
            [(r".*", (None, "tensor"))], MESH)
    assert str(e.value) == str(r.value)


def case_suppressions_apply():
    specs = [(r".*", (None, "tensor")), (r".*", None)]
    assert _both(specs, MESH, suppress=["sharding-unknown-axis"]) == []
    with analysis.suppressions("sharding-unknown-axis"):
        assert port.validate_sharding_rules(specs, MESH) == []


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharding_rules_case_matches_jax(name):
    CASES[name]()


def test_every_jax_case_is_ported():
    with open(os.path.join(REPO, "tests", "test_sharding_rules.py")) as f:
        names = {l.split("(")[0][len("def test_"):] for l in f if l.startswith("def test_")}
    assert names == set(CASES) and len(CASES) == 17
