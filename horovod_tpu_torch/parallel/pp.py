"""Pipeline (stage) parallelism: GPipe microbatch pipelining over a
``stage`` mesh axis.

The counterpart of ``horovod_tpu/parallel/pp.py``. Each rank owns one
pipeline stage's parameters (its row of the ``[n_stages, ...]``-stacked
tree); microbatches flow stage -> stage over NCCL point-to-point in an
explicit loop of ``n_micro + n_stages - 1`` forward ticks (fill, steady,
drain), the loop that ``_gpipe_scan`` runs as a ``lax.scan`` over
``ppermute``:

- at tick t, stage s runs microbatch ``t - s`` when it exists. Ticks
  outside that range are bubble ticks: the JAX scan computes on clamped
  garbage there that never reaches an emit slot, so skipping them changes
  no value and no gradient;
- at the end of each tick every stage posts, in ONE ``batch_isend_irecv``,
  the send of its output to stage s + 1 and the receive of stage s - 1's.
  The hop n-1 -> 0 is dropped, as the JAX permutation drops it; the end
  stages post one side only, and a stage with nothing to move posts
  nothing.

JAX derives the backward pipeline by differentiating through the
``ppermute`` transpose. Here it is an explicit reverse loop over the same
ticks: the last stage backpropagates its loss to the outputs it emitted;
each stage runs ``torch.autograd.backward(y, grad_y)`` for its microbatch
and sends its input's gradient to stage s - 1 on the same pattern reversed.
No NCCL call runs inside autograd: autograd runs CUDA backward on its device
thread, in an order that need not match across ranks. ``remat=True`` keeps
only each tick's input and recomputes the stage's forward in its backward
tick (the memory role of ``jax.checkpoint`` per tick).

Two APIs, as in the JAX package:

- :func:`make_pp_train_step`: homogeneous stages (each maps one activation
  shape to itself), the loss on the last stage's outputs;
- :func:`make_pp_lm_train_step`: heterogeneous ends. ``embed_fn`` runs on
  stage 0, ``head_loss_fn`` on the last stage, and only the hidden
  activation crosses the wire.

The stage axis is given as a process group, or as anything with ``rank``,
``n``, ``post``, ``wait`` and ``broadcast`` (:class:`StageLine` is the
group's; ``chip_smoke.py`` plays four stages on one card through threads
with one of its own). The functions that take it are value-and-grad
functions: with grad mode on they leave the gradients in the parameters'
``.grad``, with it off they only compute the value.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..common import basics
from ..common.types import ReduceOp
from ..ops import collectives, fusion
from ..ops.collectives import Group
from ._stacked import (apply_stacked_update, init_stacked_state, stacked_train_update,
                       summed_grads)
from .mesh import DATA_AXIS, flatten_group

STAGE_AXIS = "stage"


class StageLine:
    """The stage axis over a process group (or every rank), as the schedule
    uses it: ``rank`` and ``n`` on the axis, :meth:`post` for one tick's
    hop, :meth:`wait` for what arrived, :meth:`broadcast` to share a value.

    Building one runs a collective on the group: NCCL takes a
    point-to-point batch that only some of the group's ranks join once the
    group's communicator exists (``ops/collectives.p2p_exchange``), and the
    first tick of a pipeline is such a batch."""

    def __init__(self, group: Group = None):
        self.group = group or dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if self.n > 1:
            dist.all_reduce(torch.zeros(1, device=basics.device()), group=self.group)

    def post(self, send: Optional[torch.Tensor], recv_like: Optional[torch.Tensor], step: int):
        """Send ``send`` to stage rank + step and receive a tensor shaped
        like ``recv_like`` from rank - step, both in one batch; None skips
        that side. Returns a handle for :meth:`wait`."""
        buf = torch.empty_like(recv_like) if recv_like is not None else None
        works = collectives.p2p_exchange(
            [(send.contiguous(), self.rank + step)] if send is not None else (),
            [(buf, self.rank - step)] if buf is not None else (), self.group)
        return buf, works

    @staticmethod
    def wait(handle) -> Optional[torch.Tensor]:
        """The received tensor (None if the tick received nothing). On the
        card the current stream, not the host, waits for the transfers."""
        buf, works = handle
        for work in works:
            work.wait()
        return buf

    def broadcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        return collectives.broadcast(x, root_rank=root, group=self.group)


def _as_line(axis_name) -> Any:
    return axis_name if hasattr(axis_name, "post") else StageLine(axis_name)


def _forward_ticks(line, n_micro: int, feed: Callable, stage_apply: Callable,
                   hidden_like: torch.Tensor, remat: bool):
    """The forward ticks. Returns the last stage's outputs by microbatch
    (other stages: empty) and, with grad mode on, what each tick keeps for
    its backward: (input, output), the output None under ``remat``."""
    s, n = line.rank, line.n
    train = torch.is_grad_enabled()
    outs: Dict[int, torch.Tensor] = {}
    saved: Dict[int, tuple] = {}
    handle = None
    for t in range(n_micro + n - 1):
        incoming = line.wait(handle) if handle is not None else None
        i = t - s
        y = None
        if 0 <= i < n_micro:
            if s == 0:
                x_in = feed(i)
            else:
                x_in = incoming.requires_grad_(train)
            with torch.set_grad_enabled(train and not remat):
                y = stage_apply(x_in, s)
            if train:
                saved[i] = (x_in, None if remat else y)
            if s == n - 1:
                outs[i] = y
        wants = s > 0 and 0 <= t + 1 - s < n_micro
        handle = line.post(y.detach() if y is not None and s < n - 1 else None,
                           hidden_like if wants else None, 1)
    line.wait(handle)
    return outs, saved


def _backward_ticks(line, n_micro: int, saved: Dict[int, tuple], stage_apply: Callable,
                    grads_out: Dict[int, torch.Tensor], hidden_like: torch.Tensor) -> None:
    """The backward ticks, in reverse: each stage backpropagates its
    microbatch's output gradient (the last stage's from ``grads_out``, the
    others' from stage s + 1) into its parameters and its input, and sends
    the input's gradient to stage s - 1."""
    s, n = line.rank, line.n
    handle = None
    for t in reversed(range(n_micro + n - 1)):
        incoming = line.wait(handle) if handle is not None else None
        i = t - s
        dx = None
        if 0 <= i < n_micro:
            g = grads_out[i] if s == n - 1 else incoming
            x_in, y = saved.pop(i)
            if y is None:
                y = stage_apply(x_in, s)
            torch.autograd.backward(y, g)
            if s > 0:
                dx = x_in.grad
        wants = s < n - 1 and 0 <= t - 1 - s < n_micro
        handle = line.post(dx, hidden_like if wants else None, -1)
    line.wait(handle)


def _pipeline(line, n_micro: int, feed: Callable, stage_apply: Callable,
              hidden_like: torch.Tensor, loss_of_outputs: Callable, remat: bool) -> torch.Tensor:
    """Forward ticks, the loss on the last stage (``loss_of_outputs(leaves)``
    over its outputs as leaves that require grad), its backward, the
    backward ticks; the loss shared with every stage (the JAX package's
    ``psum_replicated_grad``: the value everywhere, the gradient from the
    last stage only)."""
    outs, saved = _forward_ticks(line, n_micro, feed, stage_apply, hidden_like, remat)
    last = line.rank == line.n - 1
    if last:
        leaves = {i: y.detach().requires_grad_(torch.is_grad_enabled()) for i, y in outs.items()}
        loss = loss_of_outputs([leaves[i] for i in range(n_micro)])
    if torch.is_grad_enabled():
        if last:
            loss.backward()
        _backward_ticks(line, n_micro, saved, stage_apply,
                        {i: y.grad for i, y in leaves.items()} if last else {}, hidden_like)
    value = loss.detach().float() if last else hidden_like.new_zeros((), dtype=torch.float32)
    return line.broadcast(value, line.n - 1)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x_micro: torch.Tensor, *,
                   axis_name=None) -> torch.Tensor:
    """Run microbatches through the pipeline (the forward only; no
    gradient). ``stage_fn(params, x, stage_index)`` maps ``[mb, ...]`` to
    ``[mb, ...]`` with this rank's stage parameters; ``x_micro`` is
    ``[n_micro, mb, ...]``, the whole input (stage 0 ingests it). Returns
    the last stage's outputs ``[n_micro, mb, ...]``, zeros on the other
    stages, as the JAX function does. ``axis_name``: the stage group (None:
    every rank) or a line."""
    line = _as_line(axis_name)
    with torch.no_grad():
        outs, _ = _forward_ticks(line, x_micro.shape[0], lambda i: x_micro[i],
                                 lambda h, s: stage_fn(stage_params, h, s), x_micro[0], False)
    if line.rank != line.n - 1:
        return torch.zeros_like(x_micro)
    return torch.stack([outs[i] for i in range(x_micro.shape[0])])


def _mesh_groups(mesh, stage_axis: str, data_axis: str):
    """The stage group, the data group and the group over both (embed and
    head gradients sum there)."""
    names = tuple(mesh.mesh_dim_names)
    for axis in (stage_axis, data_axis):
        if axis not in names:
            raise ValueError(f"the pipeline step needs mesh axes ({stage_axis!r}, "
                             f"{data_axis!r}); mesh has {names}")
    both = tuple(a for a in names if a in (stage_axis, data_axis))
    return mesh.get_group(stage_axis), mesh.get_group(data_axis), flatten_group(mesh, both)


def _data_rows(t: torch.Tensor, data_group) -> torch.Tensor:
    """This data rank's rows of dim 1 (batches are ``[n_micro, mb, ...]``,
    dim 1 sharded over data)."""
    d, nd = collectives.group_rank_size(data_group)
    if t.shape[1] % nd:
        raise ValueError(f"microbatch of {t.shape[1]} does not split over {nd} data ranks")
    per = t.shape[1] // nd
    return t[:, d * per:(d + 1) * per]


def make_pp_train_step(loss_fn: Callable, stage_fn: Callable, optimizer, mesh, *,
                       stage_axis: str = STAGE_AXIS, data_axis: str = DATA_AXIS):
    """The DP×PP step over homogeneous stages, ``step(params, x_micro,
    y_micro) -> loss``.

    ``stage_fn(params, x, stage_index)`` is one stage's forward;
    ``loss_fn(y_micro_out, labels_micro) -> scalar`` runs on the last stage's
    outputs ``[n_micro, mb, ...]``. ``params`` is this rank's stage row
    (``utils.convert.stacked_row``), updated in place by ``optimizer`` (a
    torch optimizer over its leaves: :func:`init_pp_state`). Batches are
    ``[n_micro, mb, ...]`` with dim 1 the global microbatch, sharded over
    ``data`` (the step takes this rank's rows). The loss's value is every
    stage's, its gradient the last stage's; the stage gradients sum over data
    and divide by the data size. Returns the loss averaged over data."""
    stage_group, data_group, _ = _mesh_groups(mesh, stage_axis, data_axis)
    line = StageLine(stage_group)

    def step(params, x_micro, y_micro):
        x, y = _data_rows(x_micro, data_group), _data_rows(y_micro, data_group)

        def value_and_grad(row):
            return _pipeline(line, x.shape[0], lambda i: x[i], lambda h, s: stage_fn(row, h, s),
                             x[0], lambda outs: loss_fn(torch.stack(outs), y), remat=False)

        loss = stacked_train_update(optimizer, params, value_and_grad, data_group)
        return collectives.allreduce(loss, op=ReduceOp.AVERAGE, group=data_group)

    return step


init_pp_state = init_stacked_state


# ---------------------------------------------------------------------------
# Heterogeneous pipelines: embed / body / head as first-class stages
# ---------------------------------------------------------------------------


def pipeline_lm_loss(embed_fn: Callable, stage_fn: Callable, head_loss_fn: Callable,
                     embed_params: Any, stage_params_local: Any, head_params: Any,
                     tokens_micro: torch.Tensor, labels_micro: torch.Tensor, *,
                     axis_name=None, remat: bool = True) -> torch.Tensor:
    """The pipelined forward and loss with heterogeneous ends, and with grad
    mode on its backward: the gradients land in the parameters' ``.grad``
    (stage 0's embed, this stage's row, the last stage's head; nothing on
    the other stages' embed and head).

    - ``embed_fn(embed_params, tokens_mb) -> h`` on stage 0;
    - ``stage_fn(stage_params, h, stage_index) -> h``, shape-preserving;
    - ``head_loss_fn(head_params, h, labels_mb) -> scalar`` on the last stage.

    Only the hidden activation ``[mb, ...]`` crosses the wire, in the dtype
    ``embed_fn`` gives it. Returns ``losses.mean()`` over the microbatches,
    the same value on every stage. ``axis_name``: the stage group (None:
    every rank) or a line."""
    line = _as_line(axis_name)
    n_micro = tokens_micro.shape[0]
    with torch.no_grad():
        hidden_like = embed_fn(embed_params, tokens_micro[0])

    def loss_of_outputs(hs):
        return torch.stack([head_loss_fn(head_params, h, labels_micro[i]).float()
                            for i, h in enumerate(hs)]).mean()

    return _pipeline(line, n_micro, lambda i: embed_fn(embed_params, tokens_micro[i]),
                     lambda h, s: stage_fn(stage_params_local, h, s), hidden_like,
                     loss_of_outputs, remat)


def init_pp_lm_state(make_optimizer: Callable, params: Dict[str, Any]) -> Dict[str, Any]:
    """The optimizers of the heterogeneous layout ``{"embed", "stages",
    "head"}``: ``make_optimizer`` over each part's leaves. The embed and head
    states are replicated like their parameters; the stage state is this
    rank's row."""
    return {
        "embed": make_optimizer(fusion.tree_leaves(params["embed"])),
        "stages": init_stacked_state(make_optimizer, params["stages"]),
        "head": make_optimizer(fusion.tree_leaves(params["head"])),
    }


def make_pp_lm_train_step(embed_fn: Callable, stage_fn: Callable, head_loss_fn: Callable,
                          optimizer: Dict[str, Any], mesh, *, stage_axis: str = STAGE_AXIS,
                          data_axis: str = DATA_AXIS, remat: bool = True):
    """The DP×PP step over a heterogeneous pipeline, ``step(params,
    tokens_micro, labels_micro) -> loss``.

    ``params`` is ``{"embed", "stages", "head"}``: the embed and head trees
    replicated on every rank, ``stages`` this rank's row (leaves that
    require grad, updated in place); ``optimizer`` is
    :func:`init_pp_lm_state`'s. Batches are ``[n_micro, mb, ...]`` with dim 1
    sharded over ``data``. The gradients scale as the JAX step's: embed and
    head sum over stage and data (only the owning stage's is nonzero), stage
    gradients over data, and all divide by the data size; embed and head then
    update identically on every rank. Returns the loss averaged over data."""
    stage_group, data_group, both = _mesh_groups(mesh, stage_axis, data_axis)
    line = StageLine(stage_group)
    nd = collectives.group_rank_size(data_group)[1]

    def step(params, tokens_micro, labels_micro):
        tok, lab = _data_rows(tokens_micro, data_group), _data_rows(labels_micro, data_group)
        parts = {k: fusion.tree_leaves(params[k]) for k in ("embed", "stages", "head")}
        for leaves in parts.values():
            for leaf in leaves:
                leaf.grad = None
        loss = pipeline_lm_loss(embed_fn, stage_fn, head_loss_fn, params["embed"],
                                params["stages"], params["head"], tok, lab,
                                axis_name=line, remat=remat)
        grads = {"embed": summed_grads(parts["embed"], both, nd),
                 "stages": summed_grads(parts["stages"], data_group, nd),
                 "head": summed_grads(parts["head"], both, nd)}
        for k in ("embed", "stages", "head"):
            apply_stacked_update(optimizer[k], params[k], grads[k])
        return collectives.allreduce(loss, op=ReduceOp.AVERAGE, group=data_group)

    return step
