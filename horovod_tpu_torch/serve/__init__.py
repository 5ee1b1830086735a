"""Serving: batched greedy decode over a paged KV cache, behind HTTP.

The counterpart of ``horovod_tpu/serve/``:

- **Placement**: with a mesh, the model is tensor-parallel by the same
  rule tables that place it for training (``parallel/rules.py``) and the
  paged KV cache by ``GPT_CACHE_RULES``, both preflighted before the first
  step.
- **Compute**: ``train.make_decode_step``, one batched one-token decode
  (``models/transformer.tp_decode_apply``: one all-reduce per half-block
  under tensor parallelism, as ``tp_apply``).
- **Scheduling**: a pure continuous batcher (:mod:`.batcher`) feeds DP
  replica threads (:mod:`.engine`), each with its own cache and page pool
  (:mod:`.kvcache`) and, on the card, its own CUDA stream.
- **Request plane**: :class:`ServeFrontend` (:mod:`.frontend`).

The JAX decode step is one program over every device of the mesh. Here each
rank of the model group is its own process, so every one must run the same
steps in the same order: the group's rank 0 owns the engine (batcher, page
pools, frontend) and before each step broadcasts one int header over the
model group (stop flag, replica index, tokens, positions, page table); the
other ranks run :func:`serve` as a follower loop that replays each header
through the same step on its own shards and returns at the stop flag. With
several replicas the leader issues the steps one at a time, so the
collectives of two replicas never interleave.

The engine records its ``hvd_request_*``/``hvd_serve_*`` metrics and
request spans through the live taps (``HOROVOD_METRICS``,
``HOROVOD_TRACE``); ``python -m horovod_tpu_torch.run --serve`` launches
the demo. A fault plan (``HOROVOD_FAULT_PLAN``) drives the ``request`` and
``replica`` taps. A ``scale_policy`` (``run/selfdrive.ServeScalePolicy``)
drives :meth:`ServeEngine.autoscale_beat`; the serving simulator is
``sim.simulate_serve`` (``python -m horovod_tpu_torch.tools.fleet_sim
--serve``), which plays this batcher under a virtual clock.

Entry points: :func:`serve` (in process), ``python -m
horovod_tpu_torch.serve`` (the HTTP demo).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from .batcher import BatchDecision, ContinuousBatcher
from .engine import Completion, Request, ServeEngine
from .frontend import ServeFrontend
from .kvcache import (
    PagePool,
    PagePoolExhausted,
    decode_state_specs,
    make_decode_state,
    preflight_decode_state,
)

__all__ = [
    "BatchDecision",
    "Completion",
    "ContinuousBatcher",
    "PagePool",
    "PagePoolExhausted",
    "Request",
    "ServeEngine",
    "ServeFrontend",
    "ServeHandle",
    "decode_state_specs",
    "make_decode_state",
    "preflight_decode_state",
    "serve",
]

_HEADER = 2  # stop flag, replica index


class ServeHandle:
    """What :func:`serve` returns: the engine and its HTTP frontend, with
    delegating conveniences (``handle.submit(...); handle.result(...)``).
    On a follower rank of a tensor-parallel server ``engine`` is None and
    ``follower_steps`` counts the steps it replayed."""

    def __init__(self, engine: Optional[ServeEngine],
                 frontend: Optional[ServeFrontend] = None,
                 leader: Optional["_Leader"] = None,
                 follower_steps: Optional[int] = None):
        self.engine = engine
        self.frontend = frontend
        self.leader = leader
        self.follower_steps = follower_steps

    @property
    def port(self) -> Optional[int]:
        return None if self.frontend is None else self.frontend.port

    def submit(self, prompt, max_tokens: int = 16,
               request_id: Optional[str] = None) -> str:
        return self.engine.submit(
            prompt, max_tokens=max_tokens, request_id=request_id
        )

    def result(self, request_id: str,
               timeout: Optional[float] = None) -> Completion:
        return self.engine.result(request_id, timeout=timeout)

    def drain(self, timeout: float = 60.0) -> None:
        self.engine.drain(timeout=timeout)

    def request_log(self):
        return self.engine.request_log()

    def stop(self) -> None:
        """Stop the frontend and the engine, then release the followers."""
        if self.frontend is not None:
            self.frontend.stop()
        if self.engine is not None:
            self.engine.stop()
        if self.leader is not None:
            self.leader.stop()

    def __enter__(self) -> "ServeHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class _Leader:
    """The engine's decode step on the model group's rank 0: each call
    broadcasts the step's header over the group, then runs the step on
    this rank's shards. One lock issues the steps of every replica in turn.
    The header names the replica by its index in the engine's
    ``replica_caches()``, and a follower replays it on its own cache of
    that index. A cache that is no replica's, or inputs that do not fill
    the header the followers read, raise before anything is broadcast."""

    def __init__(self, step, group, src: int, device: torch.device, header_size: int):
        self._step, self._group, self._src, self._device = step, group, src, device
        self._header_size = header_size
        self._lock = threading.Lock()
        self.engine: Optional[ServeEngine] = None  # set by serve() before the engine starts
        self.steps = 0

    def __call__(self, params, cache, tokens, positions, page_table):
        import torch.distributed as dist

        from ..train import decode_inputs

        with self._lock:
            idx = next((i for i, c in enumerate(self.engine.replica_caches()) if c is cache),
                       None)
            if idx is None:
                raise ValueError("the tensor-parallel decode step takes only the caches of "
                                 "the engine's replicas: the followers hold no other")
            header, inputs = decode_inputs(tokens, positions, page_table, self._device,
                                           prefix=(0, idx))
            if header.numel() != self._header_size:
                raise ValueError(
                    f"the step's header holds {header.numel()} ints where the followers read "
                    f"{self._header_size}: the page table must be the engine's "
                    f"{self.engine.table_width} pages wide at batch {self.engine.max_batch_size}")
            dist.broadcast(header, self._src, group=self._group)
            self.steps += 1
            return self._step(params, cache, *inputs)

    def stop(self) -> None:
        """Broadcast the stop flag (the header's other fields unread)."""
        import torch.distributed as dist

        with self._lock:
            header = torch.zeros(self._header_size, dtype=torch.int64, device=self._device)
            header[0] = 1
            dist.broadcast(header, self._src, group=self._group)


def _follow(step, params, group, src: int, device: torch.device, header_size: int,
            batch: int, new_cache) -> int:
    """A follower rank: replay the leader's steps on this rank's shards,
    one cache per replica index, until the stop flag. Returns the steps
    replayed."""
    import torch.distributed as dist

    from ..train import split_decode_inputs

    caches = []
    header = torch.empty(header_size, dtype=torch.int64, device=device)
    steps = 0
    while True:
        dist.broadcast(header, src, group=group)
        stop, idx = header[:_HEADER].tolist()
        if stop:
            return steps
        while len(caches) <= idx:
            caches.append(new_cache())
        _, caches[idx] = step(params, caches[idx],
                              *split_decode_inputs(header[_HEADER:], batch))
        steps += 1


def serve(
    params: Any,
    *,
    n_heads: int,
    mesh: Any = None,
    rules: Any = None,
    cache_rules: Any = None,
    config: Any = None,
    dtype: Any = None,
    scale_policy: Any = None,
    http: bool = False,
    request_timeout_s: float = 120.0,
    device=None,
) -> ServeHandle:
    """Stand up a serving engine over a ``TransformerLM`` parameter tree
    (a nested dict of tensors, ``tp_apply``'s form). The geometry (layers,
    head dim, context) is read off the tree; the serving knobs come from
    the ``HOROVOD_SERVE_*`` environment through ``Config.from_env()``, or
    from ``config``. ``dtype`` is the compute and cache dtype (f32 by
    default, the reference's). ``device`` (None: the card) holds the
    caches; the parameters are moved there.

    With ``mesh`` and ``rules`` the step is tensor-parallel over the
    mesh's "model" axis: ``params`` are this rank's shards
    (``utils.convert.local_params_from_flax``), every rank of the model
    group calls :func:`serve`, and only the group's rank 0 gets an engine
    (and, with ``http=True``, the frontend on ``config.serve_port``; 0
    picks a free port). The other ranks follow its steps inside this call
    and return a handle without an engine once the leader's handle is
    stopped."""
    from ..common.basics import resolve_device
    from ..common.env import Config
    from ..models.transformer import transformer_n_layers
    from ..parallel.tp import MODEL_AXIS
    from ..train import make_decode_step

    cfg = config if config is not None else Config.from_env()
    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    params = _to_device(params, device)
    emb = params["embeddings"]["embedding"]
    device = emb.device  # with its index
    pos = params["pos_embeddings"]["embedding"]
    d_model = int(emb.shape[-1])
    if d_model % int(n_heads):
        raise ValueError(
            f"d_model {d_model} not divisible by n_heads {n_heads}"
        )
    head_dim = d_model // int(n_heads)
    max_context = min(
        int(pos.shape[0]),
        (int(cfg.serve_kv_pages) - 1) * int(cfg.serve_page_size),
    )
    # The step checks the mesh and rules (and the model axis) first.
    step = make_decode_step(
        n_heads=int(n_heads), mesh=mesh, rules=rules,
        cache_rules=cache_rules, model_axis=MODEL_AXIS, dtype=dtype,
    )
    local_heads, group, src, leader = int(n_heads), None, 0, True
    if mesh is not None:
        import torch.distributed as dist

        group = mesh.get_group(MODEL_AXIS)
        n_model = dist.get_world_size(group)
        if n_heads % n_model:
            raise ValueError(f"n_heads {n_heads} does not divide over the {n_model} ranks "
                             f"of the model axis")
        local_heads = n_heads // n_model
        src = dist.get_global_rank(group, 0)
        leader = dist.get_rank(group) == 0
    geometry = dict(
        n_layers=transformer_n_layers(params), n_heads=local_heads, head_dim=head_dim,
        num_pages=cfg.serve_kv_pages, page_size=cfg.serve_page_size,
    )
    batch = int(cfg.serve_max_batch)
    # The header: the flag and the replica, then the step's inputs
    # (ServeEngine's page table is max_context / page_size pages wide).
    header_size = _HEADER + batch * (2 + max(1, -(-max_context // int(cfg.serve_page_size))))
    if not leader:
        kvkw = dict(geometry, dtype=dtype, device=device)
        steps = _follow(step, params, group, src, device, header_size, batch,
                        lambda: make_decode_state(**kvkw))
        return ServeHandle(None, follower_steps=steps)
    lead = None
    if group is not None:
        step = lead = _Leader(step, group, src, device, header_size)
    engine = ServeEngine(
        params, step, **geometry,
        max_batch_size=batch,
        max_wait_us=cfg.serve_max_wait_us,
        queue_bound=cfg.serve_queue_bound,
        max_context=max_context,
        replicas=cfg.serve_replicas,
        slo_ms=cfg.serve_slo_ms,
        scale_policy=scale_policy,
        cache_dtype=dtype,
        device=device,
    )
    if lead is not None:
        lead.engine = engine
    engine.start()
    frontend = None
    if http:
        frontend = ServeFrontend(
            engine, port=cfg.serve_port,
            request_timeout_s=request_timeout_s,
        )
        frontend.start()
    return ServeHandle(engine, frontend, lead)


def _to_device(tree, device):
    return {k: (v.detach().to(device) if isinstance(v, torch.Tensor) else _to_device(v, device))
            for k, v in tree.items()}
