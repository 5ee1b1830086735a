"""The weights of a run, drawn from the seed on the device in one call and
handed to the program and to the reference alike.

A family lists its leaves as ``(name, shape, init, role)``: ``init`` is
``("normal", std)`` or ``("const", value)``, ``role`` "param" or "buffer".
Every normal leaf is a slice of one ``torch.randn`` draw, taken in the
list's order, so a seed gives the same tensors to both sides. Imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .common import derived_seed

Leaf = Tuple[str, Tuple[int, ...], Tuple[str, float], str]


def draw(spec: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Name -> float32 tensor on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 0))
    total = sum(math.prod(shape) for _, shape, (kind, _), *_ in spec if kind == "normal")
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, (kind, arg), *_ in spec:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = z[off:off + n].view(shape).mul_(arg)
            off += n
        elif kind == "const":
            out[name] = torch.full(shape, float(arg), device=device, dtype=torch.float32)
        else:
            raise ValueError(f"unknown init {kind!r} for {name}")
    return out


def write_into(targets: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into the tensors of the same names, in place; the two
    sets of names must agree."""
    if set(targets) != set(values):
        missing, extra = sorted(set(values) - set(targets)), sorted(set(targets) - set(values))
        raise ValueError(f"weight names disagree: not in the model {missing[:5]}, "
                         f"not drawn {extra[:5]}")
    with torch.no_grad():
        for name, t in targets.items():
            if tuple(t.shape) != tuple(values[name].shape):
                raise ValueError(f"{name}: model shape {tuple(t.shape)}, drawn "
                                 f"{tuple(values[name].shape)}")
            t.copy_(values[name])
