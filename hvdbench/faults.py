"""Faults planted under the timed path, for the tests that see ``correct``
come out false (``tests/test_hvdbench_cells.py``); a run of the benchmark
plants none.

- ``unchanged``: the optimizer's step does nothing;
- ``half``: the loss over the first half of the rank's rows only;
- ``no_exchange``: the hook-driven optimizer reduces nothing across ranks;
- ``wgrad_double``: the weight gradient of every bottleneck block's 3×3
  convolution (``Conv_1``) doubled, as a backward that accumulates twice
  gives it.
"""

from __future__ import annotations

from typing import Callable, Optional


TAMPERED = ".Conv_1.kernel"


def plant(fault: Optional[str], inner, loss_fn: Callable, batch, dist_opt=None,
          model=None) -> Callable:
    """Break what ``fault`` names in place; returns the loss to use."""
    if fault is None:
        return loss_fn
    if fault == "unchanged":
        inner.step = lambda closure=None: None
    elif fault == "half":
        half = batch[0].shape[0] // 2
        return lambda m, b: loss_fn(m, (b[0][:half], b[1][:half]))
    elif fault == "no_exchange" and dist_opt is not None:
        dist_opt._allreduce_grad_async = lambda p: None
        dist_opt.synchronize = lambda: None
    elif fault == "wgrad_double" and model is not None:
        for name, p in model.named_parameters():
            if name.endswith(TAMPERED):
                p.register_hook(lambda g: g * 2.0)
    else:
        raise ValueError(f"no fault {fault!r} on this path")
    return loss_fn
