"""``python -m horovod_tpu_torch.tools.collective_lint``: the port of
``tools/collective_lint.py``.

``all`` exits 0 on the tree with zero findings, ``schema_version`` 2 and the
JAX CLI's pass inventory: the example copies' steps and every shipped step
variant (DP post hoc, overlap, hierarchical "auto", guard skip, quantized
and ZeRO-1 overlap, composed DP x TP, SP, PP, EP) recorded on 4 gloo ranks
lint clean. The ``plans`` document equals the JAX CLI's byte for byte (the
``sharding`` one is held in ``test_torch_sharding_rules.py``); a bad target
exits 2, distinct from findings (1).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(*argv, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.tools.collective_lint",
                           *argv], capture_output=True, text=True, cwd=REPO, timeout=timeout,
                          env=env)


def test_cli_all_is_clean_on_the_tree():
    proc = _port("--json", "all")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["summary"] == {"total": 0, "errors": 0, "warnings": 0}
    assert (doc["target"], doc["schema_version"]) == ("all", 2)
    assert doc["passes"] == ["divergence", "examples", "plans", "runtime", "sharding"]
    assert doc["plans_verified"] > 100


def test_cli_plans_document_equals_jax():
    port = _port("--json", "plans")
    ref = subprocess.run([sys.executable, os.path.join(REPO, "tools", "collective_lint.py"),
                          "--json", "plans"], capture_output=True, text=True, cwd=REPO,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout


def test_cli_exit_codes():
    assert _port("no-such-target").returncode == 2
    text = _port("sharding")
    assert text.returncode == 0
    assert text.stdout.strip().splitlines()[-1] == "collective_lint[sharding]: 0 finding(s)"
