"""Carry parameters between the flax tree and the port.

A flax parameter tree travels as numpy arrays keyed by the ``/``-joined
path (``block_0/attention/query/kernel``, the naming of the JAX package's
``parallel/rules.py:named_tree_paths``). The port keeps the flax layout
(Dense kernels ``[in, out]``), so conversion is a rename: ``/`` in the
flat names, ``.`` in ``nn.Module`` names, nesting in the functional tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

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


def load_flax_params(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy a flat ``/``-keyed flax tree into a module's parameters, in
    place. Every parameter must be given, and nothing else."""
    module.load_state_dict(
        {path.replace("/", "."): torch.tensor(np.asarray(a)) for path, a in flat.items()},
        strict=True,
    )


def param_tree(module: nn.Module) -> Dict[str, Any]:
    """A module's parameters as the nested tree ``tp_apply`` takes; the
    leaves are the module's own ``Parameter`` objects."""
    return nest(dict(module.named_parameters()), sep=".")


def params_to_numpy(params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """A flat ``/``-keyed dict of f32 numpy arrays from a module or a
    nested parameter tree."""
    if isinstance(params, nn.Module):
        flat = {n.replace(".", "/"): p for n, p in params.named_parameters()}
    else:
        flat = flatten(params)
    return {n: t.detach().float().cpu().numpy() for n, t in flat.items()}
