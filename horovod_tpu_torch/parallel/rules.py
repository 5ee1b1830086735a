"""Sharding rules: regex -> partition-spec tables for the composed DP×TP step.

The counterpart of ``horovod_tpu/parallel/rules.py``. An ordered table of
``(regex, spec)`` rules is matched against each parameter's ``/``-joined
tree path (``block_0/attention/query/kernel``) and the FIRST hit decides how
the leaf is split over the mesh. Scalars always replicate; a non-scalar leaf
that no rule matches is an error.

A spec is a tuple with one entry per dim: None (the dim is whole on every
rank), an axis name, or a tuple of axis names. ``None`` for the whole spec,
or ``()``, replicates the leaf. :func:`match_partition_rules` returns the
normalised form, which equals ``tuple(PartitionSpec)`` of the JAX
package's result leaf for leaf.

The JAX package checks a table with its Pass 5 validator
(``analysis/sharding_rules.py``); the port's :func:`preflight_rules` checks
the two faults that would otherwise surface deep inside the step (an axis
the mesh lacks, a dim the axis does not divide) and raises ``ValueError``
naming the parameter. Its own copies of ``Rule``, ``normalize_spec`` and the
shipped GPT table live here, because the JAX package's module imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

SpecEntry = Union[None, str, Sequence[str]]
Spec = Union[None, str, Sequence[SpecEntry]]
Rule = Tuple[str, Spec]

# The DP×TP GPT table (``EXAMPLE_GPT_RULES`` of the JAX package's
# analysis/sharding_rules.py): q/k/v and the MLP up-projection are
# column-parallel (feature dim over "model": a contiguous slice is whole
# heads), the attention out- and MLP down-projections row-parallel (their
# biases shard with the output and are scattered inside the reduction),
# norms, embeddings and the lm head replicate.
GPT_RULES: Tuple[Rule, ...] = (
    (r"(^|/)embeddings/embedding$", None),
    (r"(^|/)pos_embeddings/embedding$", None),
    (r"attention/(query|key|value)/kernel$", (None, "model")),
    (r"attention/out/kernel$", ("model", None)),
    (r"mlp/up/kernel$", (None, "model")),
    (r"mlp/up/bias$", ("model",)),
    (r"mlp/down/kernel$", ("model", None)),
    (r"mlp/down/bias$", ("model",)),
    (r"(ln|layernorm|norm)[^/]*/(scale|bias)$", None),
    (r"lm_head/kernel$", None),
    (r"bias$", None),
    (r".*", None),  # catch-all: replicate
)

NAMED_RULES: Dict[str, Tuple[Rule, ...]] = {"gpt": GPT_RULES}

NormSpec = Tuple[Tuple[str, ...], ...]


def normalize_spec(spec: Spec) -> Optional[NormSpec]:
    """One axis tuple per dim; None when ``spec`` is not spec-shaped.
    ``None``/empty -> ``()`` (replicated), ``"x"`` -> ``(("x",),)``."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return ((spec,),)
    try:
        entries = tuple(spec)
    except TypeError:
        return None
    out: List[Tuple[str, ...]] = []
    for e in entries:
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            try:
                axes = tuple(e)
            except TypeError:
                return None
            if not all(isinstance(a, str) for a in axes):
                return None
            out.append(axes)
    return tuple(out)


def _to_spec(norm: NormSpec) -> Tuple[SpecEntry, ...]:
    """The PartitionSpec-shaped form of a normalised spec."""
    return tuple(None if not axes else (axes[0] if len(axes) == 1 else axes)
                 for axes in norm)


def resolve_rules(rules: Any) -> Sequence[Rule]:
    """A rule table, or the name of a shipped one (``"gpt"``)."""
    if isinstance(rules, str):
        try:
            return NAMED_RULES[rules]
        except KeyError:
            raise ValueError(
                f"unknown named rule table {rules!r}; shipped tables: "
                f"{sorted(NAMED_RULES)}"
            ) from None
    return rules


def named_tree_paths(tree: Mapping[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(/-joined path, leaf)]`` of a nested dict in ``jax.tree.leaves``
    order: keys sorted at every level."""
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.extend(named_tree_paths(value, path + "/"))
        else:
            out.append((path, value))
    return out


def _map_tree(fn, tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    return {key: (_map_tree(fn, value, f"{prefix}{key}/") if isinstance(value, Mapping)
                  else fn(f"{prefix}{key}", value))
            for key, value in tree.items()}


def _is_scalar(shape: Sequence[int]) -> bool:
    n = 1
    for d in shape:
        n *= int(d)
    return len(shape) == 0 or n == 1


def _compile(rules: Any) -> List[Tuple[str, Any, NormSpec]]:
    compiled = []
    for pattern, spec in resolve_rules(rules):
        norm = normalize_spec(spec)
        if norm is None:
            raise ValueError(f"rule {pattern!r} spec {spec!r} is not PartitionSpec-shaped")
        compiled.append((pattern, re.compile(pattern), norm))
    return compiled


def _match(compiled, name: str, shape: Sequence[int]) -> NormSpec:
    if _is_scalar(shape):
        return ()
    for _, rx, norm in compiled:
        if rx.search(name) is not None:
            return norm
    raise ValueError(
        f"no sharding rule matches param {name!r} (shape {tuple(shape)}); add a "
        f"rule or a catch-all ('.*', None)"
    )


def match_partition_rules(rules: Any, tree: Mapping[str, Any]) -> Dict[str, Any]:
    """First-match-wins placement: a nested dict of specs mirroring
    ``tree`` (each the tuple form of a ``PartitionSpec``). Scalars
    replicate; a non-scalar leaf no rule matches raises."""
    compiled = _compile(rules)
    return _map_tree(lambda name, leaf: _to_spec(_match(compiled, name, tuple(leaf.shape))),
                     tree)


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Name -> size of a ``DeviceMesh`` or a ``{name: size}`` mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(k): int(v) for k, v in zip(mesh.mesh_dim_names, mesh.shape)}


def preflight_rules(rules: Any, mesh: Any, shapes: Mapping[str, Sequence[int]]) -> None:
    """Check ``rules`` against the mesh and the GLOBAL shapes of the tree
    (``{/-joined name: shape}``): every leaf matches a rule, every axis a
    spec names is a mesh axis, and every sharded dim divides by the product
    of its axes' sizes. Raises ``ValueError`` naming the parameter (and the
    rule) at the first fault."""
    axes = mesh_axes(mesh)
    compiled = _compile(rules)
    for name in sorted(shapes):
        shape = tuple(int(d) for d in shapes[name])
        norm = _match(compiled, name, shape)
        if len(norm) > len(shape):
            raise ValueError(
                f"param {name!r} has {len(shape)} dims but its rule's spec "
                f"{_to_spec(norm)} has {len(norm)} entries"
            )
        for dim, dim_axes in enumerate(norm):
            factor = 1
            for a in dim_axes:
                if a not in axes:
                    raise ValueError(
                        f"param {name!r}: its rule shards dim {dim} over axis {a!r}, "
                        f"which is not a mesh axis (mesh: {sorted(axes)})"
                    )
                factor *= axes[a]
            if shape[dim] % factor:
                raise ValueError(
                    f"param {name!r} dim {dim} (size {shape[dim]}) is not divisible "
                    f"by {'x'.join(dim_axes)} = {factor}"
                )


def local_shard_tree(
    tree: Mapping[str, Any],
    specs: Mapping[str, Any],
    coords: Mapping[str, Tuple[int, int]],
) -> Dict[str, Any]:
    """The view of ONE mesh coordinate's shards: for each leaf, slice every
    dim its spec shards over an axis named in ``coords`` (``{axis: (index,
    size)}``) to that coordinate's chunk; dims over axes not in ``coords``,
    and replicated leaves, pass through. A dim sharded over a mix of named
    and unnamed axes is rejected. Works on numpy arrays and tensors."""
    flat_specs = dict(named_tree_paths(specs)) if specs else {}

    def slice_leaf(name, leaf):
        norm = normalize_spec(flat_specs.get(name)) or ()
        out = leaf
        for dim, dim_axes in enumerate(norm):
            hit = [a for a in dim_axes if a in coords]
            if not hit:
                continue
            if len(hit) != len(dim_axes):
                raise ValueError(
                    f"{name!r} dim {dim} shards over {dim_axes}: a mix of sliced "
                    f"({hit}) and unsliced axes has no well-defined local chunk"
                )
            idx, total = 0, 1
            for a in dim_axes:
                i, sz = coords[a]
                idx = idx * int(sz) + int(i)
                total *= int(sz)
            size = int(leaf.shape[dim])
            if size % total:
                raise ValueError(f"{name!r} dim {dim} (size {size}) is not divisible by {total}")
            k = size // total
            sl = [slice(None)] * leaf.ndim
            sl[dim] = slice(idx * k, (idx + 1) * k)
            out = out[tuple(sl)]
        return out

    return _map_tree(slice_leaf, tree)


def mesh_coords(mesh: Any) -> Dict[str, Tuple[int, int]]:
    """``{axis: (this rank's index, size)}`` over every axis of a
    ``DeviceMesh``, the ``coords`` of :func:`local_shard_tree`."""
    return {name: (mesh.get_local_rank(name), size)
            for name, size in mesh_axes(mesh).items()}


def global_shapes(tree: Mapping[str, Any], specs: Mapping[str, Any],
                  mesh: Any) -> Dict[str, Tuple[int, ...]]:
    """The whole leaves' shapes from this rank's local shards: each sharded
    dim times the product of its axes' sizes."""
    axes = mesh_axes(mesh)
    flat_specs = dict(named_tree_paths(specs))
    out = {}
    for name, leaf in named_tree_paths(tree):
        shape = list(leaf.shape)
        for dim, dim_axes in enumerate(normalize_spec(flat_specs[name]) or ()):
            for a in dim_axes:
                shape[dim] *= axes.get(a, 1)
        out[name] = tuple(shape)
    return out
