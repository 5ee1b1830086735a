"""Carry parameters between the flax tree and the port.

A flax parameter tree travels as numpy arrays keyed by the ``/``-joined
path (``block_0/attention/query/kernel``, the naming of the JAX package's
``parallel/rules.py:named_tree_paths``). The port keeps the flax layout
(Dense kernels ``[in, out]``), so conversion is a rename: ``/`` in the
flat names, ``.`` in ``nn.Module`` names, nesting in the functional tree.
Two leaves change on the way: a convolution kernel (the only 4-D leaf of
the model zoo) goes from flax's HWIO to torch's OIHW, and a CNN's
``batch_stats`` (BatchNorm's ``mean`` and ``var``) become the module's
buffers of those names.

For tensor parallelism, :func:`local_params_from_flax` cuts a whole flax
tree to this rank's shards by a rule table (``parallel/rules.py``), and
:func:`gather_params` puts the whole tree back together from every rank's
shards. A serving decode state (the paged KV cache) crosses over through
:func:`decode_state_from_numpy` and :func:`decode_state_to_numpy`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..common.basics import resolve_device


def nest(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split(sep)
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def flatten(tree: Mapping[str, Any], sep: str = "/", prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`nest`."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, sep, path + sep))
        else:
            flat[path] = value
    return flat


def params_from_flax(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, Any]:
    """The functional parameter tree (nested dict of tensors, as
    :func:`~horovod_tpu_torch.models.transformer.tp_apply` takes it) from a
    flat ``/``-keyed dict of numpy arrays. ``device=None`` means the card."""
    device = resolve_device(device)
    return nest({path: torch.tensor(np.asarray(a), device=device)
                 for path, a in flat.items()})


def local_params_from_flax(flat: Mapping[str, np.ndarray], rules: Any, mesh,
                           device=None) -> Dict[str, Any]:
    """This rank's shards of a whole flax tree (flat ``/``-keyed numpy
    arrays), as the nested tree the composed step trains: each leaf is
    sliced at this rank's mesh coordinates by the spec ``rules`` gives it
    (``rules.local_shard_tree``), moved to ``device`` (None: the card) and
    made a leaf that requires grad. The rules are preflighted against the
    whole shapes first."""
    from ..analysis.preflight import check_sharding_rules
    from ..parallel import rules as _rules

    device = resolve_device(device)
    tree = nest({path: np.asarray(a) for path, a in flat.items()})
    check_sharding_rules(rules, mesh, {path: np.shape(a) for path, a in flat.items()})
    specs = _rules.match_partition_rules(rules, tree)
    local = _rules.local_shard_tree(tree, specs, _rules.mesh_coords(mesh))
    return nest({path: torch.tensor(np.ascontiguousarray(a), device=device).requires_grad_()
                 for path, a in flatten(local).items()})


def gather_params(tree: Mapping[str, Any], rules: Any, mesh) -> Dict[str, Any]:
    """The whole parameter tree from every rank's shards: each leaf sharded
    along a dim over one mesh axis is all-gathered along that dim over the
    axis's group (every rank of the mesh must call it). Replicated leaves
    are returned as they are. Detached."""
    from ..ops.collectives import allgather
    from ..parallel import rules as _rules

    specs = dict(_rules.named_tree_paths(_rules.match_partition_rules(rules, tree)))
    out = {}
    for path, leaf in _rules.named_tree_paths(tree):
        leaf = leaf.detach()
        for dim, axes in enumerate(_rules.normalize_spec(specs[path]) or ()):
            if len(axes) > 1:
                raise NotImplementedError(f"{path!r} dim {dim} shards over several axes {axes}")
            if axes:
                leaf = allgather(leaf, group=mesh.get_group(axes[0]), dim=dim)
        out[path] = leaf
    return nest(out)


def _to_torch_layout(a) -> torch.Tensor:
    t = torch.tensor(np.asarray(a))
    return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t


def _to_flax_layout(t: torch.Tensor) -> np.ndarray:
    """A copy (never a view of the module's storage, which the next step
    updates in place), conv kernels back to HWIO."""
    t = t.detach().to("cpu", torch.float32, copy=True)
    return (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).contiguous().numpy()


def load_flax_params(module: nn.Module, flat: Mapping[str, np.ndarray],
                     batch_stats: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """Copy a flat ``/``-keyed flax tree into a module's parameters, and a
    flat ``batch_stats`` tree into its buffers, in place. Conv kernels go
    from HWIO to OIHW. Every parameter and buffer must be given, and
    nothing else."""
    state = {path.replace("/", "."): _to_torch_layout(a)
             for path, a in {**flat, **(batch_stats or {})}.items()}
    module.load_state_dict(state, strict=True)


def param_tree(module: nn.Module) -> Dict[str, Any]:
    """A module's parameters as the nested tree ``tp_apply`` takes; the
    leaves are the module's own ``Parameter`` objects."""
    return nest(dict(module.named_parameters()), sep=".")


def params_to_numpy(params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """A flat ``/``-keyed dict of f32 numpy arrays in flax's layout (conv
    kernels HWIO) from a module or a nested parameter tree."""
    if isinstance(params, nn.Module):
        flat = {n.replace(".", "/"): p for n, p in params.named_parameters()}
    else:
        flat = flatten(params)
    return {n: _to_flax_layout(t) for n, t in flat.items()}


def batch_stats_to_numpy(module: nn.Module) -> Dict[str, np.ndarray]:
    """A module's buffers (a CNN's BatchNorm ``mean`` and ``var``) as the
    flat ``/``-keyed numpy tree of flax's ``batch_stats``."""
    return {n.replace(".", "/"): _to_flax_layout(b) for n, b in module.named_buffers()}


# --- pipeline and expert parallelism ------------------------------------------


def _leaf(a, device) -> torch.Tensor:
    t = a.detach().clone() if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
    return t.to(device).contiguous().requires_grad_()


def stacked_row(tree: Mapping[str, Any], index: int, device=None) -> Dict[str, Any]:
    """Row ``index`` of an ``[n, ...]``-stacked tree (nested dicts of numpy
    arrays or tensors, the JAX package's PP layout) as this rank's stage
    parameters: leaf tensors that require grad on ``device`` (None: the
    card)."""
    device = resolve_device(device)
    return nest({path: _leaf(a[index], device) for path, a in flatten(tree).items()})


def moe_params_from_numpy(params: Any, *, n_shards: int = 1, index: int = 0, device=None):
    """A JAX ``MoEParams`` (or any ``(w_router, w_in, w_out)`` of numpy
    arrays or tensors, the experts' dim global) as the port's, with the expert
    rows of shard ``index`` of ``n_shards`` (the defaults: every expert);
    leaves that require grad on ``device`` (None: the card)."""
    from ..parallel.ep import MoEParams

    device = resolve_device(device)
    w_router, w_in, w_out = params
    e_total = np.shape(w_in)[0]
    if e_total % n_shards:
        raise ValueError(f"{e_total} experts do not split over {n_shards} shards")
    rows = slice(index * (e_total // n_shards), (index + 1) * (e_total // n_shards))
    return MoEParams(_leaf(w_router, device), _leaf(w_in[rows], device),
                     _leaf(w_out[rows], device))


_GPT_EMBED = ("embeddings", "pos_embeddings")
_GPT_HEAD = ("ln_f", "lm_head")


def pp_params_from_flax(flat: Mapping[str, np.ndarray], n_stages: int, stage: int,
                        device=None) -> Dict[str, Any]:
    """A flax GPT tree (``params_from_flax``'s ``/``-keyed numpy arrays) as
    the pipeline's ``{"embed", "stages", "head"}`` for stage ``stage`` of
    ``n_stages``: the two embedding tables, this stage's blocks (block i of
    L goes to stage ``i // (L / n_stages)``, renumbered ``block_0..`` within
    the stage) and ``ln_f`` with ``lm_head``; leaves that require grad on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    tree = nest(dict(flat))
    n_layers = sum(1 for k in tree if k.startswith("block_"))
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} blocks do not split evenly over {n_stages} stages")
    per = n_layers // n_stages

    def part(sub):
        return nest({path: _leaf(a, device) for path, a in flatten(sub).items()})

    return {
        "embed": part({k: tree[k] for k in _GPT_EMBED}),
        "stages": part({f"block_{j}": tree[f"block_{stage * per + j}"] for j in range(per)}),
        "head": part({k: tree[k] for k in _GPT_HEAD}),
    }


def pp_params_to_flax(params: Mapping[str, Any], n_stages: int, stage: int,
                      n_layers: int) -> Dict[str, np.ndarray]:
    """The inverse of :func:`pp_params_from_flax` for one stage: the flax
    ``/``-keyed numpy arrays of the embed, head and this stage's blocks under
    their global block numbers."""
    per = n_layers // n_stages
    out = {**params_to_numpy(params["embed"]), **params_to_numpy(params["head"])}
    for path, a in params_to_numpy(params["stages"]).items():
        block, rest = path.split("/", 1)
        out[f"block_{stage * per + int(block[len('block_'):])}/{rest}"] = a
    return out


# --- serving ------------------------------------------------------------------


def decode_state_from_numpy(tree: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """A decode state (``serve/kvcache.make_decode_state``'s tree) from
    numpy arrays, nested or flat ``/``-keyed (``block_0/attention/cache_k``),
    as tensors of the arrays' dtype on ``device`` (None: the card)."""
    device = resolve_device(device)
    return nest({path: torch.tensor(np.asarray(a), device=device)
                 for path, a in flatten(tree).items()})


def decode_state_to_numpy(cache: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A decode state as a flat ``/``-keyed dict of f32 numpy arrays (a
    copy: the decode step writes the cache in place)."""
    return {path: t.detach().to("cpu", torch.float32, copy=True).numpy()
            for path, t in flatten(cache).items()}
