"""Pass 5: validation of a sharding-rule table against a mesh.

The port's copy of ``horovod_tpu/analysis/sharding_rules.py``. An ordered
table of ``(regex, spec)`` rules places each parameter of the composed
DP×TP step by its ``/``-joined path (``parallel/rules.py``): the first hit
decides. A typo'd axis name, a doubled mesh axis or a dim the mesh cannot
divide would otherwise surface deep inside the step; this validator rejects
the table before anything runs.

A spec is the port's form (``parallel/rules.py``): None (replicated), an
axis name, or a sequence whose entries are None, an axis name or a tuple of
axis names, one entry per dim. A mesh is a ``DeviceMesh``, a ``{name:
size}`` mapping or a sequence of ``(name, size)`` pairs.

Rules checked (the JAX package's ids, ``findings.py``):

 - :data:`RULE_SHARDING_BAD_RULE`: a rule's regex does not compile or its
   spec is not spec-shaped;
 - :data:`RULE_SHARDING_UNKNOWN_AXIS`: a spec names an axis the mesh does
   not have;
 - :data:`RULE_SHARDING_DUP_AXIS`: one spec uses the same mesh axis for
   two dims, or twice within one dim;
 - :data:`RULE_SHARDING_INDIVISIBLE`: with a parameter table, a matched
   dim's size is not divisible by the product of its axes' sizes, or the
   spec has more entries than the parameter has dims;
 - :data:`RULE_SHARDING_UNMATCHED`: with a parameter table, a non-scalar
   parameter that no rule matches;
 - :data:`RULE_SHARDING_SCALAR` (warning): a rule shards a scalar
   parameter, which is always replicated.
"""

from __future__ import annotations

import re
from typing import (
    Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union,
)

from ..parallel.rules import GPT_RULES, normalize_spec
from .findings import (
    Finding,
    RULE_SHARDING_BAD_RULE,
    RULE_SHARDING_DUP_AXIS,
    RULE_SHARDING_INDIVISIBLE,
    RULE_SHARDING_SCALAR,
    RULE_SHARDING_UNKNOWN_AXIS,
    RULE_SHARDING_UNMATCHED,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    apply_suppressions,
)

SpecEntry = Union[None, str, Sequence[str]]
Spec = Union[None, str, Sequence[SpecEntry]]
Rule = Tuple[str, Spec]


def _mesh_axes(mesh: Any) -> Dict[str, int]:
    """Name -> size of a ``DeviceMesh``, a ``{name: size}`` mapping or a
    sequence of ``(name, size)`` pairs (None: no axes)."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(k): int(v) for k, v in zip(names, mesh.shape)}
    try:
        return {str(k): int(v) for k, v in mesh}
    except (TypeError, ValueError):
        raise TypeError(f"cannot read axis sizes from mesh spec {mesh!r}") from None


def _spec_repr(spec: Spec) -> str:
    norm = normalize_spec(spec)
    if norm is None:
        return repr(spec)
    return "P(" + ", ".join(
        "None" if not axes else (repr(axes[0]) if len(axes) == 1
                                 else repr(tuple(axes)))
        for axes in norm
    ) + ")"


def _is_scalar(shape: Sequence[int]) -> bool:
    n = 1
    for d in shape:
        n *= int(d)
    return len(shape) == 0 or n == 1


def validate_sharding_rules(
    rules: Sequence[Rule],
    mesh: Any,
    params: Optional[Mapping[str, Sequence[int]]] = None,
    *,
    suppress: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Validate a regex -> PartitionSpec rule table against ``mesh``
    (name -> size), and — when ``params`` maps param names to shapes —
    against the concrete tree the table is meant to place."""
    axes = _mesh_axes(mesh)
    findings: List[Finding] = []
    compiled: List[Tuple[int, Any, Tuple[Tuple[str, ...], ...]]] = []

    for idx, rule in enumerate(rules):
        try:
            pattern, spec = rule
        except (TypeError, ValueError):
            findings.append(Finding(
                rule=RULE_SHARDING_BAD_RULE,
                severity=SEVERITY_ERROR,
                message=f"rule #{idx} is not a (pattern, spec) pair: "
                        f"{rule!r}",
                location=f"sharding:rule[{idx}]",
                details={"rule_index": idx},
            ))
            continue
        loc = f"sharding:rule[{idx}]:{pattern}"
        try:
            rx = re.compile(pattern)
        except re.error as exc:
            findings.append(Finding(
                rule=RULE_SHARDING_BAD_RULE,
                severity=SEVERITY_ERROR,
                message=f"rule #{idx} pattern {pattern!r} does not "
                        f"compile: {exc}",
                location=loc,
                details={"rule_index": idx, "pattern": str(pattern)},
            ))
            continue
        norm = normalize_spec(spec)
        if norm is None:
            findings.append(Finding(
                rule=RULE_SHARDING_BAD_RULE,
                severity=SEVERITY_ERROR,
                message=f"rule #{idx} spec {spec!r} is not "
                        f"PartitionSpec-shaped",
                location=loc,
                details={"rule_index": idx},
            ))
            continue
        used: Dict[str, int] = {}
        for dim, dim_axes in enumerate(norm):
            for a in dim_axes:
                if a not in axes:
                    findings.append(Finding(
                        rule=RULE_SHARDING_UNKNOWN_AXIS,
                        severity=SEVERITY_ERROR,
                        message=(
                            f"rule #{idx} ({pattern!r}) shards dim {dim} "
                            f"over axis {a!r} which is not a mesh axis "
                            f"(mesh: {sorted(axes) or 'empty'})"
                        ),
                        location=loc,
                        details={"rule_index": idx, "axis": a,
                                 "mesh_axes": sorted(axes)},
                    ))
                elif a in used and used[a] != dim:
                    findings.append(Finding(
                        rule=RULE_SHARDING_DUP_AXIS,
                        severity=SEVERITY_ERROR,
                        message=(
                            f"rule #{idx} ({pattern!r}) uses mesh axis "
                            f"{a!r} for both dim {used[a]} and dim "
                            f"{dim} — an axis can shard at most one dim "
                            f"of one leaf"
                        ),
                        location=loc,
                        details={"rule_index": idx, "axis": a,
                                 "dims": [used[a], dim]},
                    ))
                elif a in used:
                    findings.append(Finding(
                        rule=RULE_SHARDING_DUP_AXIS,
                        severity=SEVERITY_ERROR,
                        message=(
                            f"rule #{idx} ({pattern!r}) repeats mesh "
                            f"axis {a!r} within dim {dim}"
                        ),
                        location=loc,
                        details={"rule_index": idx, "axis": a,
                                 "dims": [dim]},
                    ))
                else:
                    used[a] = dim
        compiled.append((idx, rx, norm))

    if params is not None:
        for name in sorted(params):
            shape = tuple(int(d) for d in params[name])
            scalar = _is_scalar(shape)
            match = None
            for idx, rx, norm in compiled:
                if rx.search(name) is not None:
                    match = (idx, norm)
                    break
            if match is None:
                if not scalar:
                    findings.append(Finding(
                        rule=RULE_SHARDING_UNMATCHED,
                        severity=SEVERITY_ERROR,
                        message=(
                            f"param {name!r} (shape {shape}) matches no "
                            f"rule — the engine would raise mid-init; "
                            f"add a rule or a catch-all replicate"
                        ),
                        location=f"sharding:param:{name}",
                        details={"param": name, "shape": list(shape)},
                    ))
                continue
            idx, norm = match
            loc = f"sharding:param:{name}"
            if scalar:
                if any(norm[d] for d in range(len(norm))):
                    findings.append(Finding(
                        rule=RULE_SHARDING_SCALAR,
                        severity=SEVERITY_WARNING,
                        message=(
                            f"rule #{idx} shards scalar param {name!r}; "
                            f"scalars are always replicated (the engine "
                            f"ignores the spec)"
                        ),
                        location=loc,
                        details={"param": name, "rule_index": idx},
                    ))
                continue
            if len(norm) > len(shape):
                findings.append(Finding(
                    rule=RULE_SHARDING_INDIVISIBLE,
                    severity=SEVERITY_ERROR,
                    message=(
                        f"rule #{idx} spec has {len(norm)} entries but "
                        f"param {name!r} has {len(shape)} dims"
                    ),
                    location=loc,
                    details={"param": name, "rule_index": idx,
                             "shape": list(shape)},
                ))
                continue
            for dim, dim_axes in enumerate(norm):
                factor = 1
                for a in dim_axes:
                    factor *= int(axes.get(a, 1))
                if factor > 1 and shape[dim] % factor:
                    findings.append(Finding(
                        rule=RULE_SHARDING_INDIVISIBLE,
                        severity=SEVERITY_ERROR,
                        message=(
                            f"param {name!r} dim {dim} (size "
                            f"{shape[dim]}) is not divisible by "
                            f"{'x'.join(dim_axes)} = {factor} "
                            f"(rule #{idx})"
                        ),
                        location=loc,
                        details={"param": name, "dim": dim,
                                 "size": shape[dim], "factor": factor,
                                 "rule_index": idx},
                    ))
    return apply_suppressions(findings, suppress)


# --- the reference DP x TP table (the CLI's ``sharding`` target, the tests) ------
#
# The shipped GPT table, ``parallel/rules.GPT_RULES``, which the composed
# step trains ``models/transformer.py``'s TransformerLM with on a
# {"data": D, "model": T} mesh; ``example_gpt_params`` is that model's
# parameter-shape table under the flax names the port keeps.

EXAMPLE_GPT_MESH: Dict[str, int] = {"data": 4, "model": 2}

EXAMPLE_GPT_RULES: Tuple[Rule, ...] = GPT_RULES


def example_gpt_params(
    d_model: int = 128, n_heads: int = 4, n_layers: int = 2,
    vocab: int = 384, max_len: int = 128, mlp_ratio: int = 4,
) -> Dict[str, Tuple[int, ...]]:
    """The ``models/transformer.py`` parameter-shape table (name -> shape,
    flax names) the reference rule table must place cleanly."""
    d_ff = mlp_ratio * d_model
    out: Dict[str, Tuple[int, ...]] = {
        "embeddings/embedding": (vocab, d_model),
        "pos_embeddings/embedding": (max_len, d_model),
        "ln_f/scale": (d_model,),
        "ln_f/bias": (d_model,),
        "lm_head/kernel": (d_model, vocab),
    }
    for i in range(n_layers):
        b = f"block_{i}"
        out.update({
            f"{b}/ln_1/scale": (d_model,),
            f"{b}/ln_1/bias": (d_model,),
            f"{b}/attention/query/kernel": (d_model, d_model),
            f"{b}/attention/key/kernel": (d_model, d_model),
            f"{b}/attention/value/kernel": (d_model, d_model),
            f"{b}/attention/out/kernel": (d_model, d_model),
            f"{b}/ln_2/scale": (d_model,),
            f"{b}/ln_2/bias": (d_model,),
            f"{b}/mlp/up/kernel": (d_model, d_ff),
            f"{b}/mlp/up/bias": (d_ff,),
            f"{b}/mlp/down/kernel": (d_ff, d_model),
            f"{b}/mlp/down/bias": (d_model,),
        })
    return out
