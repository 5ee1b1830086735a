"""Abstract step signatures: the key a pinned ``tuned.json`` is valid for.

The port of ``horovod_tpu/tune/signature.py``. A tuned configuration is only
meaningful for the program it was tuned on: the parameter tree decides the
stream-group partition, the leaf shapes and dtypes decide bucket payloads,
and the mesh decides which lowerings exist. The signature captures exactly
those inputs and nothing else (no values, no devices, no hostnames):

- ``treedef``: the port's own canonical string of the parameter names, in
  the order the step walks them (``ops/fusion.tree_leaves`` of the nested
  name tree, the JAX package's leaf order that ``DistributedOptimizer``
  reduces in);
- ``leaves``: per leaf ``[*shape, dtype]`` in that order, with numpy dtype
  names (``"float32"``, ``"bfloat16"``);
- ``mesh``: the step's axis sizes (a ``DeviceMesh``'s named axes or an
  ``{axis: size}`` dict; a flat DP step with no mesh is ``{"data": world
  size}``), or the interconnect model's ``(hop name, size)`` ladder.

The JAX package keys ``treedef`` on ``str(jax.tree.structure(params))``,
which the port cannot reproduce, so the hashes of one model differ between
the packages: a ``tuned.json`` pinned by one package's tuner warns and runs
untuned on the other's step (a deliberate difference, ROADMAP).
``signature_hash``, ``mesh_axes_hash``, ``params_match`` and
``signatures_match`` are the JAX package's, verbatim.

Works on tensors of any device, ``meta`` included, and on any leaf with a
``shape`` and a ``dtype``: the tuner never has to touch a device to key its
output.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

SIGNATURE_VERSION = 1

# The treedef's prefix: it names the keying scheme, so no port hash can
# equal a JAX one by accident.
TREEDEF_PREFIX = "torch-params"


def _mesh_component(mesh: Any = None, model: Any = None) -> Dict:
    if mesh is not None:
        names = getattr(mesh, "mesh_dim_names", None)
        if names is not None:      # a torch DeviceMesh
            sizes = tuple(mesh.shape)
            return {"axes": {str(k): int(v) for k, v in zip(names, sizes)}}
        return {"axes": {str(k): int(v) for k, v in dict(mesh).items()}}
    if model is not None:
        return {"hops": [[h.name, int(h.size)] for h in model.hops]}
    return {}


def _is_leaf(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def named_leaves(params: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in the order the step walks them: a module's
    parameters by name, or a tree (nested dicts, lists, tuples) of leaves,
    both in the JAX package's leaf order (dict keys sorted level by level).
    Paths are ``.``-joined."""
    from ..ops.fusion import named_tree

    if hasattr(params, "named_parameters"):
        params = named_tree(list(params.named_parameters()))
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, prefix: str) -> None:
        if _is_leaf(node):
            out.append((prefix, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}" if prefix else str(i))

    walk(params, "")
    return out


def dtype_name(dtype: Any) -> str:
    """numpy's name of a dtype: ``torch.bfloat16`` -> ``"bfloat16"``."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def step_signature(params: Any, mesh: Any = None, model: Any = None) -> Dict:
    """Signature dict for a parameter tree or module on a mesh (a
    ``DeviceMesh``, an ``{axis: size}`` dict, or None) or an interconnect
    model."""
    leaves = named_leaves(params)
    sig = {
        "version": SIGNATURE_VERSION,
        "treedef": f"{TREEDEF_PREFIX}({', '.join(p for p, _ in leaves)})",
        "leaves": [[*(int(d) for d in l.shape), dtype_name(l.dtype)] for _, l in leaves],
        "mesh": _mesh_component(mesh, model),
    }
    sig["hash"] = signature_hash(sig)
    return sig


def signature_hash(sig: Dict) -> str:
    """Stable 16-hex-digit key over the signature's canonical JSON (the
    ``hash`` field itself excluded)."""
    body = {k: v for k, v in sig.items() if k != "hash"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def mesh_axes_hash(sig: Optional[Dict]) -> str:
    """16-hex key over ONLY the mesh component of a signature: it lets a
    consumer say WHY a match failed (the same program pinned on another
    mesh, or another program). The bench refuses ``--quantized --tuned``
    when this half differs (the wire-dtype verdict is a function of the
    mesh's hop ladder)."""
    body = (sig or {}).get("mesh") or {}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def params_match(tuned_sig: Optional[Dict], live_sig: Dict) -> bool:
    """Whether only the params half (treedef + leaves) agrees."""
    return signatures_match(tuned_sig, live_sig, require_mesh=False)


def signatures_match(tuned_sig: Optional[Dict], live_sig: Dict,
                     require_mesh: bool = True) -> bool:
    """Whether a pinned signature covers the live program. Hash equality
    is the fast path; ``require_mesh=False`` compares only the params
    component (``DistributedOptimizer`` sees gradients but no mesh, so it
    cannot hold the tuning to the mesh half of the key)."""
    if not tuned_sig:
        return False
    if require_mesh:
        return tuned_sig.get("hash") == live_sig.get("hash")
    a = {"treedef": tuned_sig.get("treedef"),
         "leaves": tuned_sig.get("leaves")}
    b = {"treedef": live_sig.get("treedef"),
         "leaves": live_sig.get("leaves")}
    return a == b
