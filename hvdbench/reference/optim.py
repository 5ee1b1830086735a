"""The optimizers' updates, written out in float32 as PyTorch's ``AdamW``
and ``SGD`` define them, so the reference shares no optimizer code with
the program."""

from __future__ import annotations

import math
from typing import Dict

import torch


class AdamW:
    def __init__(self, lr: float, weight_decay: float = 0.0, eps: float = 1e-8,
                 betas=(0.9, 0.999), **_):
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, p in params.items():
            g = p.grad
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


class SGD:
    def __init__(self, lr: float, momentum: float = 0.0, **_):
        self.lr, self.momentum = lr, momentum
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]) -> None:
        for name, p in params.items():
            g = p.grad
            if self.momentum:
                buf = self.buf.get(name)
                buf = g.clone() if buf is None else buf.mul_(self.momentum).add_(g)
                self.buf[name] = buf
                g = buf
            p.add_(g, alpha=-self.lr)


def build(opt_cfg: dict):
    kinds = {"AdamW": AdamW, "SGD": SGD}
    return kinds[opt_cfg["name"]](**{k: v for k, v in opt_cfg.items() if k != "name"})
