"""Many training steps in one call: the counterpart of the JAX bench's
``scan_steps`` (``bench.py``), which folds an iteration's steps into one
on-device ``lax.scan`` so that no host round-trip falls between them.

    run = capture_step(step, model, batch, length=50, warmup=4)
    run.capture()          # the warm-up steps, then the capture (optional)
    loss = run()           # 50 steps; the last step's loss

``step(params, batch)`` is a training step that updates ``params`` in place
and returns its loss (``make_train_step``'s, or a tuple of tensors), and
``batch`` stays the same tensors from step to step, as the scan's does.

On the card the step is captured once into a ``torch.cuda.CUDAGraph``:
forward, backward, ``DistributedOptimizer.step()`` with its NCCL bucket
all-reduces, the BatchNorm buffers' average and the loss average, every
kernel of them on the capture stream or on a stream forked from it (the
streamed reduction's side stream). Each call then replays that one graph
``length`` times, so the host launches one graph a step in place of the
step's kernels. Before the capture ``warmup`` eager steps run on a side
stream: they create what the step makes lazily (the optimizer's state, the
NCCL communicators, the kernel builds, cuDNN's autotuned algorithms, the
fusion plans and the streamed reduction's agreed launch order). What runs
on the host inside the step (the taps, the plan caches) runs once, at the
capture, as the JAX step's runs once, when it is traced. An optimizer must
be able to run under capture: ``torch.optim.AdamW(capturable=True)``; SGD
as it is.

On the CPU, where the caller asked for it (the tests), each call runs the
same ``length`` steps eagerly in a loop: the plain version of the graph,
as interpret mode is a Pallas kernel's. Both forms run the same number of
steps, so a seeded run ends on the same loss either way.

There is no fallback: on the card a capture that fails raises with the
CUDA error, and nothing runs eagerly in its place.

A graph that holds NCCL collectives keeps its communicators' resources
until the graph is destroyed, and a job across cards whose process group
was destroyed under a live graph hung at exit (one rank's collectives are
local and did not). :meth:`StepGraph.release` drops the graph, and
``hvd.shutdown()`` releases every live one before it destroys the process
group.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Optional

import torch

# The step graphs not yet released (``release_all``).
_LIVE: "weakref.WeakSet[StepGraph]" = weakref.WeakSet()


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the hand-written kernels (B1's forward and
    backward pairs, B3, B4), as their wrappers keep them."""
    from ..ops import collective_matmul as cm
    from ..ops import flash_attention as fa

    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd": fa.BWD_LAUNCHES,
            "ag_matmul": cm.AGMM_LAUNCHES, "matmul_reduce_scatter": cm.MRS_LAUNCHES}


def _device_of(params: Any) -> torch.device:
    if isinstance(params, torch.nn.Module):
        return next(params.parameters()).device
    from ..ops.fusion import tree_leaves

    return tree_leaves(params)[0].device


def _clone(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(o) for o in out)
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return out


class StepGraph:
    """``length`` steps of ``step(params, batch)`` a call (see the module).

    ``graph`` is the captured ``torch.cuda.CUDAGraph`` (None on the CPU and
    before the capture); ``launches`` the hand-written kernels' launches the
    capture recorded, one step's, which every replay repeats (the wrappers'
    counts move only at the capture); ``replays`` the graph's replays so
    far."""

    def __init__(self, step: Callable, params: Any, batch: Any, *, length: int,
                 warmup: int = 3):
        if length < 1 or warmup < 0:
            raise ValueError(f"length must be >= 1 and warmup >= 0; got {length}, {warmup}")
        self.step, self.params, self.batch = step, params, batch
        self.length, self.warmup = int(length), int(warmup)
        self.device = _device_of(params)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Optional[Dict[str, int]] = None
        self.replays = 0
        self._out: Any = None
        self._warm = False
        self._released = False

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def form(self) -> str:
        """What a call runs, as the bench reports it."""
        if self.on_card:
            return "cuda-graph: one captured step replayed length times a call"
        return "eager loop: the graph's plain version on the CPU"

    def capture(self) -> Any:
        """The warm-up steps, then on the card the capture of one step
        (which runs nothing). Returns the last warm-up step's loss, or None
        without one. Runs once; a call runs it first where it has not."""
        if self._warm:
            return None
        self._warm = True
        out = None
        if not self.on_card:
            for _ in range(self.warmup):
                out = self.step(self.params, self.batch)
            return out
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                out = self.step(self.params, self.batch)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        try:
            with torch.cuda.graph(graph):
                self._out = self.step(self.params, self.batch)
        except Exception as exc:
            raise RuntimeError(
                f"capturing the training step into a CUDA graph failed: "
                f"{type(exc).__name__}: {exc}") from exc
        after = kernel_launches()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph
        _LIVE.add(self)
        return out

    def release(self) -> None:
        """Destroy the captured graph and its static output, so that the
        communicators it used can be torn down; a later call raises."""
        if self.graph is None:
            return
        torch.cuda.synchronize(self.device)
        self.graph.reset()
        self.graph, self._out = None, None
        self._released = True
        _LIVE.discard(self)

    def __call__(self) -> Any:
        if self._released:
            raise RuntimeError("this step graph was released; capture the step anew")
        self.capture()
        if not self.on_card:
            out = None
            for _ in range(self.length):
                out = self.step(self.params, self.batch)
            return out
        for _ in range(self.length):
            self.graph.replay()
        self.replays += self.length
        return _clone(self._out)


def capture_step(step: Callable, params: Any, batch: Any, *, length: int,
                 warmup: int = 3) -> StepGraph:
    """A callable that runs ``length`` steps of ``step(params, batch)`` a
    call and returns the last step's loss: on the card by replaying one
    captured CUDA graph of the step, after ``warmup`` eager steps on a side
    stream; on the CPU by running the steps eagerly. See the module."""
    return StepGraph(step, params, batch, length=length, warmup=warmup)


def release_all() -> None:
    """Release every live step graph (``hvd.shutdown()`` calls this before
    it destroys the process group)."""
    for graph in list(_LIVE):
        graph.release()

