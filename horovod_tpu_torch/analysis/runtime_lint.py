"""Pass 2: the lock-discipline lint over the port's threaded sources.

The port's copy of ``horovod_tpu/analysis/runtime_lint.py``, checker for
checker; only :data:`DEFAULT_DISCIPLINE` is the port's own. Its threaded
state: the eager API's module state and the native core's runtime
(``eager.py``, ``core/``), the NCCL executor whose thread runs the plans
(``core/nccl_executor.py``), the fault, guard and metrics tap singletons,
the elastic driver's journal, the store host, the streamed reduction whose
hooks run on autograd's device thread (``ops/fusion.py``) and the torch
binding's hook path (``torch/``).

 - :data:`DEFAULT_DISCIPLINE` declares, per source file (keyed by its
   package-relative path suffix), which attributes are shared state and
   which lock guards them, or which methods they are confined to. The
   pseudo-class name :data:`MODULE` declares the same for module-level
   globals (the tap singletons' ``ACTIVE``/``TAP`` flipped under a module
   ``_lock``);
 - the checker walks each method's (or module function's) AST, tracks the
   lexically held locks (``with self._lock:`` / ``with _lock:``, and
   aliases such as ``Condition(self._lock)`` as ``self._cv``) and flags any
   mutation of a guarded attribute outside its lock (:data:`RULE_UNGUARDED`);
 - a finding is suppressed in the source with
   ``# hvd-analysis: ignore[unguarded-shared-state]`` on the flagged line or
   the line above it.

Lexical, not dynamic: aliased mutations (``q = self._table[k]; q.pop()``)
and cross-object access are out of scope.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding, RULE_UNGUARDED, SEVERITY_ERROR

# Method names that mutate common containers in place.
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "clear", "update", "setdefault",
    "add", "discard", "sort", "reverse",
}

_SUPPRESS_RE = re.compile(
    r"#\s*hvd-analysis:\s*ignore(?:\[(?P<rules>[\w\s,-]+)\])?"
)


@dataclass
class AttrRule:
    """Discipline for one shared attribute: guarded by ``lock`` (an
    attribute name on the same object), and/or mutation-confined to the
    listed methods (single-thread confinement, e.g. coordinator-loop-only
    state). ``__init__`` is always exempt — construction is
    single-threaded."""

    lock: Optional[str] = None
    confined_to: Tuple[str, ...] = ()
    note: str = ""


@dataclass
class ClassRule:
    attrs: Dict[str, AttrRule]
    # Lock attributes that wrap/alias another (a Condition built on a
    # Lock): holding the alias counts as holding the canonical lock.
    lock_aliases: Dict[str, str] = field(default_factory=dict)

    def canonical(self, lock_name: str) -> str:
        return self.lock_aliases.get(lock_name, lock_name)

    def lock_names(self) -> Set[str]:
        names = {r.lock for r in self.attrs.values() if r.lock}
        names |= set(self.lock_aliases)
        names |= set(self.lock_aliases.values())
        return names


# Pseudo-class key declaring discipline for module-level globals.
MODULE = "<module>"

# The port's lock discipline, keyed by package-relative source path suffix
# (``core/runtime.py`` matches ``.../horovod_tpu_torch/core/runtime.py``).
# This table IS the documentation of which state is shared between threads
# and how it is protected. An entry with no rules (the ``topo/`` planning
# layer, the store host) records, machine-checkably, that the file is
# supposed to hold no shared mutable state.
DEFAULT_DISCIPLINE: Dict[str, Dict[str, ClassRule]] = {
    "core/runtime.py": {
        "TensorQueue": ClassRule(
            attrs={
                "_table": AttrRule("_lock"),
                "_pending": AttrRule("_lock"),
            },
        ),
        "HandleManager": ClassRule(
            attrs={
                "_results": AttrRule("_lock"),
                "_next": AttrRule("_lock"),
                "_names": AttrRule("_lock"),
            },
            lock_aliases={"_cv": "_lock"},
        ),
        "Runtime": ClassRule(
            attrs={
                # Mutated by user threads (register/remove) and read on the
                # background thread.
                "_process_sets": AttrRule("_state_lock"),
            },
        ),
        "StallInspector": ClassRule(
            attrs={
                # Coordinator-thread confined: only the cycle loop calls
                # these methods.
                "_first_seen": AttrRule(None, confined_to=("record", "clear", "check")),
                "_last_warned": AttrRule(None, confined_to=("record", "clear", "check")),
                "should_shutdown": AttrRule(None, confined_to=("check",)),
            },
        ),
    },
    "core/native_runtime.py": {
        "NativeRuntime": ClassRule(
            attrs={
                "_entries": AttrRule("_entries_lock"),
                "_outputs": AttrRule("_cv"),
                "_ticket_names": AttrRule("_cv"),
                "_done": AttrRule("_cv"),
                "_sync_waiters": AttrRule("_cv"),
            },
        ),
    },
    "core/nccl_executor.py": {
        "NcclPlanExecutor": ClassRule(
            attrs={
                # Registered from the caller's thread (add_process_set),
                # read by the executor thread's plans.
                "_sets": AttrRule("_lock"),
                # The executor thread's: plans run one at a time under
                # NativeRuntime._consumer_lock.
                "_done": AttrRule(None, confined_to=("then", "execute"),
                                  note="serialized by NativeRuntime._consumer_lock"),
            },
        ),
    },
    # The eager API's module state: process sets, the barrier sequence and
    # the auto-name counters, hit from every framework thread.
    "eager.py": {
        MODULE: ClassRule(
            attrs={
                "_process_sets": AttrRule("_lock"),
                "_ps_barrier_seq": AttrRule("_lock"),
                "_name_counters": AttrRule("_lock"),
            },
        ),
    },
    "fault/injector.py": {
        MODULE: ClassRule(
            attrs={
                # fault_point is called from framework threads, the
                # executor thread and the driver loop at once.
                "_plan": AttrRule("_lock"),
                "_counters": AttrRule("_lock"),
                "_events": AttrRule("_lock"),
                "_seq": AttrRule("_lock"),
                "ACTIVE": AttrRule("_lock"),
            },
        ),
    },
    "guard/__init__.py": {
        MODULE: ClassRule(
            attrs={
                "TAP": AttrRule("_lock"),
                "ACTIVE": AttrRule("_lock"),
                "_guard_event_hits": AttrRule("_event_lock"),
            },
        ),
    },
    "metrics/__init__.py": {
        MODULE: ClassRule(
            attrs={
                "TAP": AttrRule("_lock"),
                "ACTIVE": AttrRule("_lock"),
            },
        ),
    },
    "metrics/registry.py": {
        "Counter": ClassRule(attrs={"_series": AttrRule("_lock")}),
        "Gauge": ClassRule(attrs={"_series": AttrRule("_lock")}),
        "Histogram": ClassRule(attrs={"_series": AttrRule("_lock")}),
        "Registry": ClassRule(attrs={"_metrics": AttrRule("_lock")}),
    },
    "run/journal.py": {
        "DriverJournal": ClassRule(
            attrs={
                # The elastic driver's supervision loop records every
                # transition; its HTTP threads never touch the journal.
                "_state": AttrRule(None, confined_to=("record", "replay", "_write"),
                                   note="elastic-driver supervision loop only"),
                "writes": AttrRule(None, confined_to=("record", "_write"),
                                   note="elastic-driver supervision loop only"),
            },
        ),
    },
    # One process, one thread: the host polls the KV plane and keeps its
    # stores in locals.
    "run/store_host.py": {},
    # The streamed reduction's hooks run on autograd's device thread; the
    # caller's thread reads and resets the counts in finish(), after the
    # backward returned (its end is the happens-before edge).
    "ops/fusion.py": {
        "StreamedReduction": ClassRule(
            attrs={
                "_counts": AttrRule(None, confined_to=("_on_grad", "_reset"),
                                    note="autograd's thread in the backward"),
                "_ready": AttrRule(None, confined_to=("_on_grad", "_reset"),
                                   note="autograd's thread in the backward"),
                "_complete": AttrRule(None, confined_to=("_on_grad", "_reset"),
                                      note="autograd's thread in the backward"),
                "_results": AttrRule(None, confined_to=("_launch", "_reset"),
                                     note="autograd's thread in the backward"),
                "_next": AttrRule(None, confined_to=("_launch", "_reset"),
                                  note="autograd's thread in the backward"),
                "launched_in_backward": AttrRule(None, confined_to=("_launch", "_reset")),
                "launched_early": AttrRule(None, confined_to=("_launch", "_reset")),
                "_side": AttrRule(None, confined_to=("_launch",)),
                "_order": AttrRule(None, confined_to=("finish",)),
                "_ordered": AttrRule(None, confined_to=("finish",)),
                "_handles": AttrRule(None, confined_to=("remove",)),
                "closed": AttrRule(None, confined_to=("remove",)),
            },
        ),
    },
    # The torch binding's hooks enqueue from autograd's device thread.
    "torch/__init__.py": {
        "_DistributedOptimizer": ClassRule(
            attrs={
                "_handles": AttrRule("_lock"),
                "_passes": AttrRule("_lock"),
            },
        ),
    },
    "torch/mpi_ops.py": {
        MODULE: ClassRule(attrs={"_handle_meta": AttrRule("_meta_lock")}),
    },
    "topo/model.py": {},
    "topo/compositor.py": {},
}


def _base_self_attr(node: ast.AST) -> Optional[str]:
    """Resolve an expression chain (self.X.method(...).other[...]) down to
    the ``self.X`` base attribute name, or None."""
    while True:
        if isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return node.attr
            node = node.value
        elif isinstance(node, (ast.Subscript, ast.Starred)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def _direct_self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _MethodChecker(ast.NodeVisitor):
    """Walks one method body tracking lexically-held locks."""

    def __init__(self, cls_name: str, method: str, rule: ClassRule,
                 filename: str, src_lines: Sequence[str]):
        self.cls_name = cls_name
        self.method = method
        self.rule = rule
        self.filename = filename
        self.src_lines = src_lines
        self.held: Set[str] = set()
        self.findings: List[Finding] = []

    # -- lock tracking --
    def visit_With(self, node: ast.With) -> None:
        acquired: Set[str] = set()
        for item in node.items:
            attr = _direct_self_attr(item.context_expr)
            if attr is not None and attr in self.rule.lock_names():
                acquired.add(self.rule.canonical(attr))
                acquired.add(attr)
        newly = acquired - self.held
        self.held |= newly
        for stmt in node.body:
            self.visit(stmt)
        self.held -= newly

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A nested def runs later, on whatever thread calls it: locks held
        # at definition time are NOT held at call time.
        saved, self.held = self.held, set()
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # -- mutation detection --
    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_target(target, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_target(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            self._check_target(target, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            attr = _base_self_attr(func.value)
            if attr is not None:
                self._flag_if_unguarded(attr, node, f".{func.attr}(...)")
        self.generic_visit(node)

    def _check_target(self, target: ast.AST, node: ast.AST) -> None:
        attr = _direct_self_attr(target)
        how = "assignment"
        if attr is None and isinstance(target, ast.Subscript):
            attr = _base_self_attr(target.value)
            how = "item assignment"
        if attr is None and isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt, node)
            return
        if attr is not None:
            self._flag_if_unguarded(attr, node, how)

    def _flag_if_unguarded(self, attr: str, node: ast.AST,
                           how: str) -> None:
        arule = self.rule.attrs.get(attr)
        if arule is None:
            return
        if self.method == "__init__":
            return
        if arule.confined_to and self.method in arule.confined_to:
            return
        if arule.lock and self.rule.canonical(arule.lock) in {
            self.rule.canonical(h) for h in self.held
        }:
            return
        if arule.lock is None and not arule.confined_to:
            return
        line = getattr(node, "lineno", 0)
        if self._suppressed(line):
            return
        if arule.lock:
            expectation = f"must hold self.{arule.lock}"
        else:
            expectation = (
                "mutation is confined to "
                + "/".join(arule.confined_to)
                + (f" ({arule.note})" if arule.note else "")
            )
        self.findings.append(
            Finding(
                rule=RULE_UNGUARDED,
                severity=SEVERITY_ERROR,
                message=(
                    f"unguarded mutation of shared state "
                    f"self.{attr} ({how}) in "
                    f"{self.cls_name}.{self.method}: {expectation}"
                ),
                location=f"{self.filename}:{line}",
                details={
                    "class": self.cls_name,
                    "method": self.method,
                    "attribute": attr,
                    "expected_lock": arule.lock or "",
                },
            )
        )

    def _suppressed(self, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.src_lines):
                m = _SUPPRESS_RE.search(self.src_lines[ln - 1])
                if m:
                    rules = m.group("rules")
                    if rules is None:
                        return True
                    wanted = {r.strip() for r in rules.split(",")}
                    if RULE_UNGUARDED in wanted:
                        return True
        return False


class _ModuleChecker(ast.NodeVisitor):
    """Walks one module-level function tracking lexically-held module
    locks (``with _lock:``) and mutations of declared module globals —
    the tap-singleton discipline of ``fault/injector.py`` and friends.
    A bare-name *assignment* only counts as a global mutation when the
    function declares ``global name`` (else it binds a local); in-place
    mutator calls / item assignments on a declared name always count
    unless the name was rebound locally first."""

    def __init__(self, func: str, rule: ClassRule, filename: str,
                 src_lines: Sequence[str]):
        self.func = func
        self.rule = rule
        self.filename = filename
        self.src_lines = src_lines
        self.held: Set[str] = set()
        self.globals: Set[str] = set()
        self.locals: Set[str] = set()
        self.findings: List[Finding] = []

    def visit_Global(self, node: ast.Global) -> None:
        self.globals.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        acquired: Set[str] = set()
        for item in node.items:
            expr = item.context_expr
            if (isinstance(expr, ast.Name)
                    and expr.id in self.rule.lock_names()):
                acquired.add(self.rule.canonical(expr.id))
                acquired.add(expr.id)
        newly = acquired - self.held
        self.held |= newly
        for stmt in node.body:
            self.visit(stmt)
        self.held -= newly

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A nested def runs later, on whatever thread calls it.
        saved, self.held = self.held, set()
        saved_g, self.globals = self.globals, set()
        for stmt in node.body:
            self.visit(stmt)
        self.held, self.globals = saved, saved_g

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_target(target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            self._check_target(target)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            base = func.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if (isinstance(base, ast.Name)
                    and base.id not in self.locals):
                self._flag_if_unguarded(
                    base.id, node, f".{func.attr}(...)"
                )
        self.generic_visit(node)

    def _check_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            if target.id in self.globals:
                self._flag_if_unguarded(target.id, target, "assignment")
            else:
                self.locals.add(target.id)
        elif isinstance(target, ast.Subscript):
            base = target.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and base.id not in self.locals:
                self._flag_if_unguarded(base.id, target, "item assignment")
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt)

    def _flag_if_unguarded(self, name: str, node: ast.AST,
                           how: str) -> None:
        arule = self.rule.attrs.get(name)
        if arule is None:
            return
        if arule.confined_to and self.func in arule.confined_to:
            return
        if arule.lock and self.rule.canonical(arule.lock) in {
            self.rule.canonical(h) for h in self.held
        }:
            return
        if arule.lock is None and not arule.confined_to:
            return
        line = getattr(node, "lineno", 0)
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.src_lines):
                m = _SUPPRESS_RE.search(self.src_lines[ln - 1])
                if m:
                    rules = m.group("rules")
                    if rules is None or RULE_UNGUARDED in {
                        r.strip() for r in rules.split(",")
                    }:
                        return
        if arule.lock:
            expectation = f"must hold {arule.lock}"
        else:
            expectation = (
                "mutation is confined to "
                + "/".join(arule.confined_to)
                + (f" ({arule.note})" if arule.note else "")
            )
        self.findings.append(
            Finding(
                rule=RULE_UNGUARDED,
                severity=SEVERITY_ERROR,
                message=(
                    f"unguarded mutation of module state {name} ({how}) "
                    f"in {self.func}: {expectation}"
                ),
                location=f"{self.filename}:{line}",
                details={
                    "class": MODULE,
                    "method": self.func,
                    "attribute": name,
                    "expected_lock": arule.lock or "",
                },
            )
        )


def lint_source(
    src: str,
    rules: Dict[str, ClassRule],
    filename: str = "<memory>",
) -> List[Finding]:
    """Lint python source text against a class→discipline mapping (the
    pseudo-class :data:`MODULE` checks module-level functions against a
    module-globals discipline)."""
    tree = ast.parse(src, filename=filename)
    src_lines = src.splitlines()
    findings: List[Finding] = []
    module_rule = rules.get(MODULE)
    if module_rule is not None:
        for item in tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                checker = _ModuleChecker(
                    item.name, module_rule, filename, src_lines
                )
                for stmt in item.body:
                    checker.visit(stmt)
                findings.extend(checker.findings)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        rule = rules.get(node.name)
        if rule is None:
            continue
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                checker = _MethodChecker(
                    node.name, item.name, rule, filename, src_lines
                )
                for stmt in item.body:
                    checker.visit(stmt)
                findings.extend(checker.findings)
    return findings


def _discipline_for(path: str) -> Dict[str, ClassRule]:
    """Match ``path`` against the discipline table by posix path suffix
    (longest key wins, so ``metrics/__init__.py`` never collides with
    ``guard/__init__.py``)."""
    norm = os.path.abspath(path).replace(os.sep, "/")
    best: Dict[str, ClassRule] = {}
    best_len = -1
    for key, rules in DEFAULT_DISCIPLINE.items():
        if norm.endswith("/" + key) or norm == key:
            if len(key) > best_len:
                best, best_len = rules, len(key)
    if best_len >= 0:
        return best
    # Fallback: unique-basename match, so ad-hoc copies (tests linting a
    # seeded tmp/runtime.py) still pick up their discipline. Ambiguous
    # basenames (the __init__.py entries) never fall back.
    base = os.path.basename(norm)
    candidates = [
        rules for key, rules in DEFAULT_DISCIPLINE.items()
        if os.path.basename(key) == base
    ]
    if len(candidates) == 1:
        return candidates[0]
    return {}


def lint_file(
    path: str, rules: Optional[Dict[str, ClassRule]] = None
) -> List[Finding]:
    if rules is None:
        rules = _discipline_for(path)
    if not rules:
        return []
    with open(path, "r") as f:
        src = f.read()
    return lint_source(src, rules, filename=os.path.basename(path))


def default_runtime_paths() -> List[str]:
    """Every file :data:`DEFAULT_DISCIPLINE` declares, in the package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(pkg, *rel.split("/")) for rel in DEFAULT_DISCIPLINE]


def lint_runtime(paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the lock-discipline check over the port's threaded sources
    (every file of :data:`DEFAULT_DISCIPLINE` by default)."""
    findings: List[Finding] = []
    for path in paths or default_runtime_paths():
        findings.extend(lint_file(path))
    return findings
