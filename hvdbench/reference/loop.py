"""The reference's training steps and its readings, shared by the families.

``train`` runs ``steps`` steps of a family's reference from the weights
``w0`` on one batch (the whole batch of every rank) and returns what the
program's run is compared with: each step's loss, each leaf's norm of the
first gradient, and each leaf's norm of its change after the steps (the
buffers' too). ``precision="f64"`` runs it all in float64, a witness of
what float32's own round-off gives; ``tamper`` breaks the gradients after
each backward, for a fault planted in the reference put in the program's
place.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from . import lowp, optim


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm, summed in float64."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def train(ref, w0: Dict[str, torch.Tensor], buffer_names: Iterable[str], batch, config: dict,
          steps: int = 3, precision: str = "f32",
          tamper: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None) -> dict:
    lowp.set_fp32_math()
    if precision == "f64":
        w0 = {k: v.double() for k, v in w0.items()}
        batch = tuple(t.double() if t.is_floating_point() else t for t in batch)
        precision = "f32"
    prods = lowp.Products(precision)
    buffer_names = set(buffer_names)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()
              if k not in buffer_names}
    buffers = {k: w0[k].detach().clone() for k in buffer_names}
    opt = optim.build(config["optimizer"])
    losses, grad = [], {}
    for step in range(steps):
        for p in params.values():
            p.grad = None
        losses.append(ref.loss_and_backward(params, buffers, batch, config, prods))
        if tamper is not None:
            tamper(params)
        if step == 0:
            grad = norms({k: p.grad for k, p in params.items()})
        opt.update(params)
    change = norms({k: v.detach() - w0[k] for k, v in {**params, **buffers}.items()})
    return {"loss": losses, "grad": grad, "change": change}
