"""The program's side of the comparison: the inner optimizer a cell
builds, its state put back to the seed's start, and the readings taken
from the program's own state during the first steps.

The first gradient is read as the optimizer got it, from its state after
one step: AdamW's first moment is (1 − β1) · g, SGD's momentum buffer is g.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from .reference.loop import norms


def build_optimizer(opt_cfg: dict, params, capturable: bool = False):
    kw = {k: v for k, v in opt_cfg.items() if k != "name"}
    if opt_cfg["name"] == "AdamW":
        kw["betas"] = tuple(kw.get("betas", (0.9, 0.999)))
        return torch.optim.AdamW(params, capturable=capturable, **kw)
    if opt_cfg["name"] == "SGD":
        return torch.optim.SGD(params, **kw)
    raise ValueError(f"no optimizer {opt_cfg['name']!r}")


@torch.no_grad()
def reset(optimizer) -> None:
    """Every state tensor (moments, momentum buffers, step counts) back to
    zero, in place, so a captured graph keeps its addresses; a zero
    momentum buffer makes SGD's next step its first."""
    for st in optimizer.state.values():
        for v in st.values():
            if torch.is_tensor(v):
                v.zero_()


def first_grad(opt_cfg: dict, st: dict) -> torch.Tensor:
    if opt_cfg["name"] == "AdamW":
        return st["exp_avg"] / (1.0 - tuple(opt_cfg.get("betas", (0.9, 0.999)))[0])
    return st["momentum_buffer"]


CHECK_STEPS = 3
CALIBRATION_STEPS = 2


class Readings:
    """Takes the program's readings around the first steps of a run:
    :meth:`start` before the first, :meth:`after_first` after it,
    :meth:`finish` after the last checked step."""

    def __init__(self, named: Dict[str, torch.Tensor], optimizer, opt_cfg: dict):
        self.named, self.optimizer, self.opt_cfg = named, optimizer, opt_cfg
        self.loss, self.grad, self.change = [], {}, {}
        self._init = None

    def start(self) -> None:
        self._init = {k: v.detach().clone() for k, v in self.named.items()}

    def after_first(self) -> None:
        params = {k: v for k, v in self.named.items() if isinstance(v, torch.nn.Parameter)}
        self.grad = norms({k: first_grad(self.opt_cfg, self.optimizer.state[p])
                           if self.optimizer.state.get(p) else torch.zeros_like(p)
                           for k, p in params.items()})

    def finish(self) -> None:
        self.change = norms({k: v.detach() - self._init[k] for k, v in self.named.items()})
        self._init = None

    def as_dict(self) -> dict:
        return {"loss": list(self.loss), "grad": dict(self.grad), "change": dict(self.change)}


def first_steps(call: Callable, named: Dict[str, torch.Tensor], optimizer,
                opt_cfg: dict) -> Readings:
    """Zero the optimizer's state (the weights are the seed's already),
    then run :data:`CHECK_STEPS` steps through ``call``, the window's own
    call, reading the program as they go."""
    reset(optimizer)
    readings = Readings(named, optimizer, opt_cfg)
    readings.start()
    for i in range(CHECK_STEPS):
        readings.loss.append(float(call()))
        if i == 0:
            readings.after_first()
    readings.finish()
    return readings


def window_steps(call: Callable, seconds: float, min_steps: int, sync: Callable) -> int:
    """The whole steps that fill ``seconds``, from :data:`CALIBRATION_STEPS`
    steps timed between synchronizes."""
    sync()
    t = time.perf_counter()
    for _ in range(CALIBRATION_STEPS):
        call()
    sync()
    per_step = (time.perf_counter() - t) / CALIBRATION_STEPS
    return max(min_steps, round(seconds / per_step))
