"""Pass 2 in the port: ``horovod_tpu_torch.analysis.runtime_lint``.

The checker is the JAX package's, so ``lint_source`` gives the same findings
as ``horovod_tpu.analysis.runtime_lint.lint_source`` on the JAX tests'
seeded sources (class and module discipline, the suppression comment,
closures that do not inherit a lock). The port's own discipline table
covers its threaded state, every name it declares is in its source, and
``lint_runtime()`` over the port is clean: C6, the two findings it made on
the tree it was written against (the NCCL executor's process-set table and
the binding's pass counts written outside their lock), is repaired.
"""

import os
import re
import textwrap

import pytest

from horovod_tpu import analysis as ref
from horovod_tpu_torch import analysis as port
from horovod_tpu_torch.analysis import runtime_lint
from horovod_tpu_torch.analysis.findings import RULE_UNGUARDED

PKG = os.path.dirname(os.path.abspath(port.__file__)).rsplit(os.sep, 1)[0]


def _rules(mod, kind):
    if kind == "class":
        return {"Worker": mod.ClassRule(
            attrs={"_table": mod.AttrRule("_lock"),
                   "_loop_state": mod.AttrRule(None, confined_to=("run_loop",))},
            lock_aliases={"_cv": "_lock"})}
    return {mod.MODULE: mod.ClassRule(attrs={"_table": mod.AttrRule("_lock"),
                                             "ACTIVE": mod.AttrRule("_lock")})}


SOURCES = {
    "class_violations": ("class", """
        class Worker:
            def __init__(self):
                self._table = {}
                self._loop_state = 0

            def good(self, k, v):
                with self._lock:
                    self._table[k] = v

            def good_via_cv(self, k):
                with self._cv:
                    self._table.pop(k, None)

            def bad(self, k, v):
                self._table[k] = v

            def bad_mutator(self):
                self._table.clear()

            def run_loop(self):
                self._loop_state += 1

            def bad_confined(self):
                self._loop_state = 7
        """, {"bad", "bad_mutator", "bad_confined"}),
    "suppression_comment": ("class", """
        class Worker:
            def bad_but_known(self, k, v):
                self._table[k] = v  # hvd-analysis: ignore[unguarded-shared-state]

            def bad_above(self, k, v):
                # hvd-analysis: ignore
                self._table[k] = v

            def still_bad(self, k, v):
                self._table[k] = v  # hvd-analysis: ignore[some-other-rule]
        """, {"still_bad"}),
    "nested_function": ("class", """
        class Worker:
            def sneaky(self, k, v):
                with self._lock:
                    def later():
                        self._table[k] = v
                    return later
        """, {"sneaky"}),
    "module_globals": ("module", """
        import threading
        _lock = threading.Lock()
        _table = {}
        ACTIVE = False

        def good(v):
            global ACTIVE
            with _lock:
                _table["k"] = v
                ACTIVE = True

        def bad(v):
            global ACTIVE
            _table["k"] = v
            ACTIVE = True

        def local_shadow():
            ACTIVE = True  # local binding, not the module global
            return ACTIVE

        def bad_mutator():
            _table.clear()
        """, {"bad", "bad_mutator"}),
    "module_nested_def": ("module", """
        def sneaky():
            with _lock:
                def later():
                    _table.clear()
                return later
        """, {"sneaky"}),
}


def _key(fs):
    return [(f.rule, f.severity, f.location, f.details, f.message) for f in fs]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_lint_source_matches_jax(name):
    kind, src, methods = SOURCES[name]
    src = textwrap.dedent(src)
    got = port.lint_source(src, _rules(port, kind), "fixture.py")
    want = ref.lint_source(src, _rules(ref, kind), "fixture.py")
    assert _key(got) == _key(want)
    assert {f.rule for f in got} == {RULE_UNGUARDED}
    assert {f.details["method"] for f in got} == methods


def test_runtime_lint_over_the_port_is_clean():
    assert port.lint_runtime() == []
    assert len(runtime_lint.default_runtime_paths()) == len(port.DEFAULT_DISCIPLINE)


def test_discipline_covers_the_ports_threaded_state():
    disc = port.DEFAULT_DISCIPLINE
    for key in ("eager.py", "core/nccl_executor.py", "core/native_runtime.py",
                "fault/injector.py", "guard/__init__.py", "metrics/__init__.py",
                "run/journal.py", "run/store_host.py", "ops/fusion.py", "torch/__init__.py"):
        assert key in disc, key
    assert disc["ops/fusion.py"]["StreamedReduction"].attrs["_counts"].confined_to == \
        ("_on_grad", "_reset")
    assert disc["core/nccl_executor.py"]["NcclPlanExecutor"].attrs["_sets"].lock == "_lock"
    assert disc["topo/compositor.py"] == {} and disc["run/store_host.py"] == {}
    # Every file, class, attribute and lock the table names is in the source.
    for rel, classes in disc.items():
        with open(os.path.join(PKG, *rel.split("/"))) as f:
            src = f.read()
        for cls, rule in classes.items():
            if cls != port.MODULE:
                assert re.search(rf"^class {cls}\b", src, re.M), (rel, cls)
            for attr, a in rule.attrs.items():
                assert attr in src, (rel, attr)
                assert a.lock is None or a.lock in src, (rel, a.lock)


C6_SOURCES = {
    "core/nccl_executor.py": """
        class NcclPlanExecutor:
            def register_process_set(self, psid, ranks):
                self._sets[int(psid)] = ranks

            def remove_process_set(self, psid):
                self._sets.pop(int(psid), None)
        """,
    "torch/__init__.py": """
        class _DistributedOptimizer:
            def _register_hooks(self):
                for p in self._params:
                    self._passes[p] = 0
        """,
}


@pytest.mark.parametrize("rel", sorted(C6_SOURCES))
def test_c6_the_findings_it_repaired(rel, tmp_path):
    """C6: the forms these methods had before the repair are flagged by the
    port's discipline; the shipped forms lint clean."""
    path = tmp_path / rel.replace("/", "_")
    path.write_text(textwrap.dedent(C6_SOURCES[rel]))
    rules = port.DEFAULT_DISCIPLINE[rel]
    found = port.lint_file(str(path), rules)
    assert found and {f.rule for f in found} == {RULE_UNGUARDED}
    assert port.lint_file(os.path.join(PKG, *rel.split("/"))) == []


def test_lint_runtime_flags_a_seeded_defect(tmp_path):
    """The seeded runtime.py of the JAX CLI test, through the API the CLI
    uses: the discipline is found by the file's name."""
    bad = tmp_path / "runtime.py"
    bad.write_text(textwrap.dedent("""
        class TensorQueue:
            def add(self, k, v):
                self._table[k] = v
        """))
    assert [f.rule for f in port.lint_runtime([str(bad)])] == [RULE_UNGUARDED]
