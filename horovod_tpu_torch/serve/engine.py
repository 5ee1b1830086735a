"""The serving engine: data-parallel decode replicas over one continuous batcher.

The counterpart of ``horovod_tpu/serve/engine.py``. ONE admission queue
(the pure :class:`~.batcher.ContinuousBatcher` under the engine's condition
variable) feeds N replica threads. Each replica owns a whole decode state
(its own paged KV cache, :func:`~.kvcache.make_decode_state`, allocated
once on the engine's device) and :class:`~.kvcache.PagePool`, and runs the
decode step (``train.make_decode_step``: tensor-parallel where a mesh is
given). Replicas race on the shared queue, which is what makes the death
of one mid-batch survivable.

Exactly-once is the engine's core invariant, held by one rule: a request's
completion is recorded under the engine lock the moment its last token is
produced, into a ledger that refuses duplicates. A replica that raises
:class:`~horovod_tpu_torch.fault.ReplicaKilled` frees its batch's pages,
re-queues every member not yet recorded at the queue front with its
original admission time, and retires; a survivor takes the work up.

Batches are padded to ``max_batch_size``, so the step always sees one
shape: padded slots feed token 0 at position 0 through an all-zeros
page-table row, i.e. into the pool's scratch page, which no live request
holds.

On the card each replica thread binds the engine's device and runs its
steps on its own CUDA stream, so replicas do not serialize on the default
stream. The step's inputs go up in one pinned, non-blocking copy; the one
host synchronization a step is the read-back of the ``[B]`` next tokens.

The metrics (``hvd_request_*``, ``hvd_serve_*``), trace (``hvd_request``
spans) and fault (``request``, ``replica``) taps sit at the reference's
sites, each live when its knob is set (``HOROVOD_FAULT_PLAN`` for the
fault plan).

The autoscaler: every completion is held to ``slo_ms``, and
:meth:`ServeEngine.autoscale_beat` feeds the queue depth and the SLO
violations since the last beat to a ``run/selfdrive.ServeScalePolicy``,
then applies its verdict through ``elastic.apply_serve_scale``: scale-out
adds a replica (:meth:`add_replica`, a cache and a CUDA stream of its own),
scale-in retires the newest (:meth:`retire_replica`: it finishes its batch,
then leaves).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import metrics as _metrics
from .. import trace as _trace
from ..common.basics import resolve_device
from ..fault import injector as _fault
from ..fault.injector import InjectedFault, ReplicaKilled
from .batcher import ContinuousBatcher
from .kvcache import PagePool, PagePoolExhausted, make_decode_state


@dataclass
class Request:
    """One admitted request (engine-internal bookkeeping)."""

    id: str
    prompt: Tuple[int, ...]
    max_tokens: int
    submit_t: float
    enqueued_us: int
    requeues: int = 0


@dataclass(frozen=True)
class Completion:
    """The answer ledgered for one request, recorded exactly once."""

    id: str
    prompt: Tuple[int, ...]
    tokens: Tuple[int, ...]
    outcome: str  # "ok" | "dropped" | "rejected"
    latency_s: float
    replica: Optional[int] = None


class _Replica:
    """One DP serving replica: its own KV cache, page pool, loop and (on
    the card) CUDA stream."""

    def __init__(self, idx: int, cache: Any, pool: PagePool, stream=None):
        self.idx = idx
        self.cache = cache
        self.pool = pool
        self.stream = stream
        self.pages: Dict[str, List[int]] = {}
        self.thread: Optional[threading.Thread] = None
        self.retired = False  # killed, or retired by a scale-in
        self.alive = True


class ServeEngine:
    """Continuous-batching inference engine over DP decode replicas.

    ``decode_step(params, cache, tokens, positions, page_table)`` returns
    ``(next_tokens [B], cache)``. ``n_heads`` is the head count of each
    replica's cache: under tensor parallelism, this rank's local heads.
    ``device`` (None: the card) holds the caches."""

    def __init__(
        self,
        params: Any,
        decode_step: Any,
        *,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        num_pages: int = 256,
        page_size: int = 16,
        max_batch_size: int = 8,
        max_wait_us: int = 2000,
        queue_bound: int = 1024,
        max_context: int = 128,
        replicas: int = 1,
        slo_ms: float = 500.0,
        scale_policy: Any = None,
        cache_dtype: Any = None,
        device=None,
    ):
        self.params = params
        self.decode_step = decode_step
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._cache_kw = dict(
            n_layers=int(n_layers), num_pages=int(num_pages),
            page_size=int(page_size), n_heads=int(n_heads),
            head_dim=int(head_dim), dtype=cache_dtype, device=self.device,
        )
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_batch_size = int(max_batch_size)
        self.max_context = int(max_context)
        self.slo_s = float(slo_ms) / 1000.0
        self.scale_policy = scale_policy
        # The width of a batch's page table (the step's input).
        self.table_width = max(
            1, -(-self.max_context // self.page_size)
        )
        self._cond = threading.Condition()
        self._batcher = ContinuousBatcher(
            max_batch_size=max_batch_size, max_wait_us=max_wait_us,
            queue_bound=queue_bound,
        )
        self._requests: Dict[str, Request] = {}
        self._done: Dict[str, Completion] = {}
        self._done_events: Dict[str, threading.Event] = {}
        self._replicas: List[_Replica] = []
        self._n_initial = max(int(replicas), 1)
        self._next_id = 0
        self._stopping = False
        self._t0 = time.monotonic()
        # Autoscale beat accumulators (drained by autoscale_beat()).
        self._slo_violations_since = 0
        self._completions_since = 0
        # Chaos observability: requests re-queued by a dead replica.
        self.requeues = 0
        # Occupancy accounting (bench --serve reports the mean) and the
        # decode steps run.
        self.batches = 0
        self.batched_requests = 0
        self.steps = 0

    # --------------------------------------------------------- lifecycle
    def start(self) -> "ServeEngine":
        for _ in range(self._n_initial):
            self.add_replica()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for rep in list(self._replicas):
            if rep.thread is not None:
                rep.thread.join(timeout=30)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def add_replica(self) -> int:
        """Spawn one more DP replica: its cache is allocated here, once,
        on the engine's device, with a CUDA stream of its own on the
        card."""
        cache = make_decode_state(**self._cache_kw)
        stream = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            # The zeros were written on this thread's stream.
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._cond:
            idx = len(self._replicas)
            rep = _Replica(idx, cache, PagePool(self.num_pages, self.page_size), stream)
            self._replicas.append(rep)
        rep.thread = threading.Thread(
            target=self._replica_loop, args=(rep,),
            name=f"hvd_serve_replica{idx}", daemon=True,
        )
        rep.thread.start()
        self._set_replica_gauge()
        return idx

    def retire_replica(self) -> Optional[int]:
        """Gracefully retire the newest live replica (the autoscaler's
        scale-in verb): it finishes its current batch, then exits.
        Refuses to retire the last replica."""
        with self._cond:
            live = [r for r in self._replicas if r.alive and not r.retired]
            if len(live) <= 1:
                return None
            rep = live[-1]
            rep.retired = True
            self._cond.notify_all()
            return rep.idx

    def replica_caches(self) -> List[Any]:
        """Each replica's decode state, by replica index."""
        with self._cond:
            return [r.cache for r in self._replicas]

    def live_replicas(self) -> int:
        with self._cond:
            return sum(
                1 for r in self._replicas if r.alive and not r.retired
            )

    # -------------------------------------------------------- admission
    def _now_us(self) -> int:
        return int((time.monotonic() - self._t0) * 1e6)

    def submit(self, prompt: Sequence[int],
               max_tokens: int = 16,
               request_id: Optional[str] = None) -> str:
        """Admit one request. Always returns the request id; a refused
        request (queue bound: ``rejected``, injected fault: ``dropped``)
        is ledgered at once with that outcome, so every submitted id
        resolves through :meth:`result` exactly once."""
        prompt = tuple(int(t) for t in prompt)
        max_tokens = int(max_tokens)
        if not prompt:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if len(prompt) + max_tokens > self.max_context:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds max_context {self.max_context}"
            )
        with self._cond:
            if request_id is None:
                request_id = f"req{self._next_id}"
                self._next_id += 1
            rid = str(request_id)
            if rid in self._requests:
                raise ValueError(f"duplicate request id {rid!r}")
            req = Request(
                id=rid, prompt=prompt, max_tokens=max_tokens,
                submit_t=time.time(), enqueued_us=self._now_us(),
            )
            self._requests[rid] = req
            self._done_events[rid] = threading.Event()
        if _fault.ACTIVE:
            try:
                # The 'request' site: a delay sleeps here, a drop discards
                # the request, which is still answered ("dropped").
                _fault.fault_point("request", rid)
            except InjectedFault:
                self._finish(None, req, (), "dropped")
                return rid
        with self._cond:
            admitted = self._batcher.offer(rid, req.enqueued_us)
            if admitted:
                self._cond.notify_all()
            self._gauge("hvd_serve_queue_depth", self._batcher.depth())
        if not admitted:
            self._finish(None, req, (), "rejected")
        return rid

    def result(self, request_id: str,
               timeout: Optional[float] = None) -> Completion:
        ev = self._done_events[str(request_id)]
        if not ev.wait(timeout):
            raise TimeoutError(f"request {request_id!r} not finished")
        return self._done[str(request_id)]

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every submitted request is ledgered."""
        deadline = time.monotonic() + timeout
        for rid, ev in list(self._done_events.items()):
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"request {rid!r} not finished")

    def request_log(self) -> Dict[str, Dict[str, Any]]:
        """The request ledger without timing: completions keyed by id."""
        with self._cond:
            return {
                rid: {
                    "prompt": list(c.prompt),
                    "completion": list(c.tokens),
                    "outcome": c.outcome,
                }
                for rid, c in sorted(self._done.items())
            }

    # ------------------------------------------------------ replica loop
    def _replica_loop(self, rep: _Replica) -> None:
        if rep.stream is None:
            self._serve_loop(rep)
            return
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(rep.stream):
            self._serve_loop(rep)

    def _serve_loop(self, rep: _Replica) -> None:
        try:
            while True:
                with self._cond:
                    if self._stopping or rep.retired:
                        break
                    now = self._now_us()
                    decision = self._batcher.poll(now)
                    if not decision.ready:
                        wait_s = 0.005
                        if decision.reason == "waiting":
                            dl = self._batcher.next_deadline_us()
                            if dl is not None:
                                wait_s = max((dl - now) / 1e6, 0.0005)
                        self._cond.wait(wait_s)
                        continue
                    batch, starved = self._admit_pages(
                        rep, decision.request_ids
                    )
                    self._gauge(
                        "hvd_serve_queue_depth", self._batcher.depth()
                    )
                if not batch:
                    if starved:
                        # Pool exhausted: wait for completions to free
                        # pages rather than spinning on the same head.
                        with self._cond:
                            self._cond.wait(0.002)
                    continue
                try:
                    if _fault.ACTIVE:
                        # The 'replica' site, one hit per dispatched
                        # batch: kill_replica aborts this replica mid-batch.
                        _fault.fault_point("replica", f"replica{rep.idx}")
                    self._run_batch(rep, batch)
                except ReplicaKilled:
                    self._on_replica_killed(rep, batch)
                    return
        finally:
            with self._cond:
                rep.alive = False
                self._cond.notify_all()
            self._set_replica_gauge()

    def _admit_pages(
        self, rep: _Replica, ids: Tuple[str, ...]
    ) -> Tuple[List[Request], bool]:
        """Grant KV pages for a dequeued batch (caller holds the lock).
        Members the pool cannot cover go back to the queue front in
        order: back-pressure, never loss."""
        batch: List[Request] = []
        starved: List[Request] = []
        for rid in ids:
            req = self._requests[rid]
            need = len(req.prompt) + req.max_tokens
            try:
                rep.pages[rid] = rep.pool.alloc(need, owner=rid)
                batch.append(req)
            except PagePoolExhausted:
                starved.append(req)
        for req in reversed(starved):
            self._batcher.requeue(req.id, req.enqueued_us)
        self._gauge("hvd_serve_kv_pages_in_use", self._pages_in_use())
        return batch, bool(starved)

    def _run_batch(self, rep: _Replica, batch: List[Request]) -> None:
        import numpy as np

        B = self.max_batch_size
        page_table = np.zeros((B, self.table_width), dtype=np.int32)
        tokens = np.zeros((B,), dtype=np.int32)
        positions = np.zeros((B,), dtype=np.int32)
        seqs = [list(r.prompt) for r in batch]
        pos = [0] * len(batch)
        active = [True] * len(batch)
        for i, r in enumerate(batch):
            pages = rep.pages[r.id]
            page_table[i, : len(pages)] = pages
        with self._cond:
            self.batches += 1
            self.batched_requests += len(batch)
        if _metrics.ACTIVE:
            _metrics.TAP.set("hvd_serve_batch_occupancy", len(batch))
        while any(active):
            for i in range(len(batch)):
                tokens[i] = seqs[i][pos[i]] if active[i] else 0
                positions[i] = pos[i] if active[i] else 0
            out, rep.cache = self.decode_step(
                self.params, rep.cache, tokens, positions, page_table
            )
            out = out.cpu().numpy()  # the step's one host synchronization
            with self._cond:
                self.steps += 1
            for i, r in enumerate(batch):
                if not active[i]:
                    continue
                if pos[i] == len(seqs[i]) - 1:
                    seqs[i].append(int(out[i]))
                pos[i] += 1
                if len(seqs[i]) - len(r.prompt) >= r.max_tokens:
                    active[i] = False
                    page_table[i, :] = 0  # slot back to scratch
                    self._finish(
                        rep, r, tuple(seqs[i][len(r.prompt):]), "ok"
                    )

    def _on_replica_killed(self, rep: _Replica,
                           batch: List[Request]) -> None:
        """Free the dead batch's pages, re-queue every member whose
        answer is NOT yet ledgered at the queue front (original
        timestamps), retire the replica."""
        with self._cond:
            back = [r for r in batch if r.id not in self._done]
            for r in batch:
                pages = rep.pages.pop(r.id, None)
                if pages is not None:
                    rep.pool.free(pages)
            for r in reversed(back):
                r.requeues += 1
                self._batcher.requeue(r.id, r.enqueued_us)
            self.requeues += len(back)
            rep.retired = True
            self._cond.notify_all()
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_serve_requeues_total", len(back))
        if _trace.ACTIVE:
            _trace.TAP.event(
                "hvd_serve_replica_killed", cat="serve",
                replica=rep.idx, requeued=len(back),
            )
        self._set_replica_gauge()

    # --------------------------------------------------------- recording
    def _finish(self, rep: Optional[_Replica], req: Request,
                tokens: Tuple[int, ...], outcome: str) -> None:
        with self._cond:
            if req.id in self._done:
                return  # exactly-once: a duplicate answer is dropped here
            if rep is not None:
                pages = rep.pages.pop(req.id, None)
                if pages is not None:
                    rep.pool.free(pages)
            latency = time.time() - req.submit_t
            comp = Completion(
                id=req.id, prompt=req.prompt, tokens=tokens,
                outcome=outcome, latency_s=latency,
                replica=None if rep is None else rep.idx,
            )
            self._done[req.id] = comp
            if outcome == "ok":
                self._completions_since += 1
                if latency > self.slo_s:
                    self._slo_violations_since += 1
            self._cond.notify_all()
        if _metrics.ACTIVE:
            _metrics.TAP.observe("hvd_request_latency_seconds", latency)
            _metrics.TAP.inc("hvd_request_total", outcome=outcome)
            if tokens:
                _metrics.TAP.inc("hvd_serve_tokens_total", len(tokens))
            _metrics.TAP.set(
                "hvd_serve_kv_pages_in_use", self._pages_in_use()
            )
        if _trace.ACTIVE:
            _trace.TAP.event(
                "hvd_request", ph="X", cat="request", ts=req.submit_t,
                dur=latency, request_id=req.id, outcome=outcome,
                tokens=len(tokens), requeues=req.requeues,
            )
        self._done_events[req.id].set()

    # ------------------------------------------------------------ gauges
    def _pages_in_use(self) -> int:
        return sum(r.pool.pages_in_use for r in self._replicas if r.alive)

    def _set_replica_gauge(self) -> None:
        if _metrics.ACTIVE:
            _metrics.TAP.set("hvd_serve_replicas", self.live_replicas())

    def _gauge(self, name: str, value: float) -> None:
        if _metrics.ACTIVE:
            _metrics.TAP.set(name, value)

    # --------------------------------------------------------- autoscale
    def autoscale_beat(self) -> Optional[Any]:
        """Feed one beat to the ``ServeScalePolicy`` (queue depth, SLO
        burn since the last beat) and APPLY its verdict: scale-out adds a
        replica, scale-in retires one. Returns the decision (None without
        a policy or a verdict)."""
        if self.scale_policy is None:
            return None
        with self._cond:
            depth = self._batcher.depth()
            viol, comps = self._slo_violations_since, self._completions_since
            self._slo_violations_since = 0
            self._completions_since = 0
        self.scale_policy.observe(depth, viol, comps)
        decision = self.scale_policy.decide(self.live_replicas())
        if decision is None:
            return None
        if _metrics.ACTIVE:
            _metrics.TAP.inc(
                "hvd_serve_scale_decisions_total", action=decision.action
            )
        # Applied through the elastic verbs, so serving resizes land in the
        # same event ledger as training membership changes.
        from .. import elastic as _elastic

        _elastic.apply_serve_scale(self, decision)
        return decision
