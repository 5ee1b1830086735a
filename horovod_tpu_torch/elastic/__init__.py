"""Elastic training: fault tolerance and a membership that changes.

The port of ``horovod_tpu/elastic/__init__.py`` (upstream
``horovod.elastic``): a training loop wrapped in ``@hvd.elastic.run``
survives a lost worker or a changed host set by rolling back to the last
committed :class:`State` (or keeping it, on a graceful change) and
re-forming the world with the workers that are left or new.

Generation-based re-formation, as in the JAX package:

- The elastic driver (``run/elastic_driver.py``) publishes each world GENERATION in its HTTP KV store (``elastic/world``):
  the membership, each worker's ranks, and a FRESH ``torch.distributed``
  rendezvous, the generation's ``TCPStore`` as ``master_addr`` and
  ``master_port`` (the JAX package's document carries its coordinator as
  ``jax_coordinator`` instead).
- A worker re-forms IN PROCESS (``rejoin_mode() == "inprocess"``, the
  default): it stops the eager runtime, leaves the process group (aborting
  it after a failure: a dead peer's NCCL communicator is never waited on),
  points ``HOROVOD_*``, ``MASTER_ADDR``/``MASTER_PORT`` and
  ``TORCHELASTIC_USE_AGENT_STORE`` at the new generation, and calls
  ``init()`` again on the card it was bound to. The CUDA context outlives
  the process group, so the committed state stays on the card. With
  ``HOROVOD_ELASTIC_REJOIN_MODE=respawn`` the worker instead persists its
  last commit (CPU tensors, under ``HOROVOD_ELASTIC_STATE_DIR``) and exits
  with :data:`REJOIN_EXIT_CODE`; the respawned slot resumes from it.
- ``State.check_host_updates()`` agrees across ranks with a 4-byte eager
  ``Max`` allreduce, so every live rank raises at the same commit.

Failure semantics: a crashed peer surfaces on the survivors as
``HorovodInternalError`` (the native core losing the peer, the stall
shutdown) or as ``torch.distributed``'s own failure (``DistBackendError``,
a gloo or NCCL error that names a peer or an aborted communicator):
``run`` restores the last commit and rejoins. A graceful change
(``HostsUpdatedInterrupt``, ``PreemptionInterrupt``) keeps the in-memory
state and re-syncs it from the generation's sync root.

ZeRO-1 state is rank-local here: each rank holds only its own rows
(``parallel/zero.py``). A graceful resize all-gathers the rows over the
old world before leaving it, reshards them (``parallel/reshard.py``) and
keeps the new rank's. After a crash the dead rank's rows are gone, so a
change of size or of rank refuses, naming the sharded checkpoint
(``utils/checkpoint.py``) as the way back.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from .. import guard as _guard
from .. import metrics as _metrics
from ..common import basics
from .. import trace as _trace
from ..fault import injector as _fault_injector
from ..fault import preemption as _preemption
from ..fault.preemption import PreemptionInterrupt  # noqa: F401 (re-export)

logger = logging.getLogger("horovod_tpu_torch.elastic")

__all__ = [
    "run",
    "State",
    "ObjectState",
    "TensorState",
    "TorchState",
    "HostsUpdatedInterrupt",
    "PlanUpdatedInterrupt",
    "PreemptionInterrupt",
    "adopted_replan",
    "adopted_step_kwargs",
    "apply_serve_scale",
    "note_zero1_layout",
]


class HostsUpdatedInterrupt(Exception):
    """Raised inside the training function when the driver published a new
    world generation (a host added or removed). The in-memory state is
    kept; ``run`` re-forms the world and re-syncs it."""


class PlanUpdatedInterrupt(Exception):
    """Raised on EVERY rank at the same commit when the driver published a
    live re-plan notice the fleet agreed to adopt. The world is unchanged:
    no rollback, no re-formation; ``run`` re-enters the training function
    so it rebuilds its step."""

    def __init__(self, notice: Dict[str, Any]):
        self.notice = dict(notice)
        super().__init__(f"live re-plan #{notice.get('id')} adopted: {notice.get('config')}")


# --------------------------------------------------------------- context
class _ElasticContext:
    """The worker's view of the elastic rendezvous (the driver's KV store)."""

    def __init__(self) -> None:
        from ..run.http_server import KVStoreClient

        self.worker_id = os.environ["HOROVOD_ELASTIC_WORKER_ID"]
        self.gen = int(os.environ.get("HOROVOD_ELASTIC_GEN", "1"))
        # The incarnation of the driver that spawned this worker: a resumed
        # driver presents a higher epoch, a lower one is a stale driver.
        try:
            self.epoch = int(os.environ.get("HOROVOD_DRIVER_EPOCH", "0"))
        except ValueError:
            self.epoch = 0
        # The rank holding the authoritative state of the generation (a
        # survivor after a re-formation): from the environment at spawn,
        # then from each world document apply() joins.
        self.sync_root = int(os.environ.get("HOROVOD_ELASTIC_SYNC_ROOT", "0"))
        self._kv = KVStoreClient(os.environ["HOROVOD_ELASTIC_KV_ADDR"],
                                 int(os.environ["HOROVOD_ELASTIC_KV_PORT"]))
        self.timeout = float(os.environ.get("HOROVOD_ELASTIC_TIMEOUT", "600"))
        self._probe_failures = 0
        try:
            self.lost_threshold = max(1, int(os.environ.get("HOROVOD_DRIVER_LOST_PROBES", "3")))
        except ValueError:
            self.lost_threshold = 3
        self._parks = 0
        # The device argument of this process's re-formed inits (``run``
        # sets it from the first): "cpu", a named card, or None (the local
        # rank's card, which ``basics`` checks is the one first bound).
        self.device: Optional[str] = None
        self.replan_id = 0
        self._replan_seen = 0
        self._pending_replan: Optional[Dict[str, Any]] = None

    def _doc(self, key: str, strict: bool) -> Optional[Dict[str, Any]]:
        raw = self._kv.get("elastic", key, strict=strict)
        return None if raw is None else json.loads(raw.decode())

    def fetch_world(self, strict: bool = False) -> Optional[Dict[str, Any]]:
        return self._doc("world", strict)

    def fetch_driver(self, strict: bool = False) -> Optional[Dict[str, Any]]:
        """The driver's identity document: epoch (fencing token),
        generation, liveness beat."""
        return self._doc("driver", strict)

    def fetch_replan(self, strict: bool = False) -> Optional[Dict[str, Any]]:
        doc = self._doc("replan", strict)
        return doc if isinstance(doc, dict) else None

    def check_replan(self) -> bool:
        """Examine the published re-plan notice (one KV read a commit). A
        fresh, valid notice is kept for the commit's agreement; a stale one
        (an epoch below this worker's baseline, or an older generation) is
        rejected once, loudly. True while a valid notice awaits adoption."""
        try:
            doc = self.fetch_replan()
        except Exception:  # noqa: BLE001 - driver briefly unreachable
            return self._pending_replan is not None
        if not doc:
            return self._pending_replan is not None
        try:
            nid = int(doc.get("id", 0))
            epoch = int(doc.get("epoch", 0) or 0)
            gen = int(doc.get("gen", -1))
        except (TypeError, ValueError):
            return self._pending_replan is not None
        if nid <= self.replan_id or nid <= self._replan_seen or gen > self.gen:
            return self._pending_replan is not None
        reason = "stale-epoch" if epoch < self.epoch else (
            "stale-generation" if gen < self.gen else None)
        self._replan_seen = nid
        if reason is not None:
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_replan_rejected_total", reason=reason)
            logger.error("elastic: rejecting re-plan notice #%s (%s: notice epoch %s / gen %s "
                         "vs acknowledged epoch %s / current gen %s)", nid, reason, epoch, gen,
                         self.epoch, self.gen)
            return self._pending_replan is not None
        self._pending_replan = doc
        return True

    def take_pending_replan(self) -> Dict[str, Any]:
        """The notice to adopt once the fleet agreed. A rank whose own read
        raced the publish fetches it again; one it cannot fetch degrades to
        the rollback path."""
        doc = self._pending_replan
        if doc is None:
            for _ in range(3):
                try:
                    doc = self.fetch_replan(strict=True)
                except Exception:  # noqa: BLE001 - retried below
                    doc = None
                if doc:
                    break
                time.sleep(0.2)
        if doc is None:
            raise basics.HorovodInternalError(
                "elastic: the fleet agreed to adopt a re-plan notice this rank cannot fetch; "
                "rolling back to stay consistent")
        self._pending_replan = None
        self.replan_id = max(self.replan_id, int(doc.get("id", 0)))
        return doc

    def probe_driver(self):
        """``(driver_doc, world_doc)``, or ``(None, None)`` while the driver
        is unreachable."""
        try:
            return self.fetch_driver(strict=True), self.fetch_world(strict=True)
        except Exception:  # noqa: BLE001 - endpoint down
            return None, None

    def commit_probe(self):
        """The commit's probe of the control plane: ``(updated,
        driver_lost, new_epoch)``. ``updated``, a newer generation is
        published; ``driver_lost``, ``lost_threshold`` probes failed in a
        row or a stale epoch answers; ``new_epoch``, the driver restarted
        and republished the SAME generation (reattach in place)."""
        try:
            world = self.fetch_world(strict=True)
            driver = self.fetch_driver(strict=True)
        except Exception:  # noqa: BLE001 - endpoint down
            self._probe_failures += 1
            return False, self._probe_failures >= self.lost_threshold, None
        self._probe_failures = 0
        updated = bool(world) and int(world["gen"]) > self.gen
        if driver is not None:
            try:
                epoch = int(driver.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                epoch = 0
            if epoch < self.epoch:
                if _metrics.ACTIVE:
                    _metrics.TAP.inc("hvd_worker_driver_fenced_total")
                return False, True, None
            if (epoch > self.epoch and not updated and world is not None
                    and int(world["gen"]) == self.gen):
                return False, False, epoch
        return updated, False, None

    def reattach(self, epoch: int) -> None:
        """Adopt the resumed driver's (higher) epoch and re-register: the
        same generation, the same process, no rollback."""
        self.epoch = int(epoch)
        self._probe_failures = 0
        self.signal_attach()
        if _trace.ACTIVE:
            _trace.TAP.event("hvd_worker_reattach", cat="elastic", gen=self.gen,
                             epoch=self.epoch)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_worker_reattaches_total")
        if _fault_injector.ACTIVE:
            _fault_injector.record_event("driver", 1, "reattach",
                                         f"gen={self.gen} epoch={self.epoch}")
        logger.warning("elastic: reattached to resumed driver (generation %s, epoch %s)",
                       self.gen, self.epoch)

    def _signal(self, key: str, value: str) -> None:
        try:
            self._kv.put("elastic", f"{key}.{self.worker_id}", value.encode())
        except Exception:  # noqa: BLE001 - advisory signal
            pass

    def signal_attach(self) -> None:
        self._signal("attach", f"{self.gen}:{self.epoch}:{os.getpid()}")

    def signal_done(self) -> None:
        """The training function returned (a resumed driver cannot see
        this process exit)."""
        self._signal("done", str(self.gen))

    def confirm_joined(self) -> None:
        """This worker finished a sync in its generation: it holds live
        state and may be a later generation's sync root."""
        self._signal("joined", str(self.gen))

    def signal_rejoin(self) -> None:
        """This worker abandoned its generation; the driver answers by
        publishing the next one even if the membership did not change."""
        self._signal("rejoin", str(self.gen))

    def apply(self, world: Dict[str, Any]) -> bool:
        """Point the environment at this generation's assignment (False when
        this worker is not a member). Does not advance ``self.gen``: the
        caller commits the generation once ``init`` succeeded."""
        a = world["assignments"].get(self.worker_id)
        if a is None:
            return False
        os.environ.update(_world_env(world, a))
        self.sync_root = int(world.get("sync_root", 0))
        try:
            self.epoch = max(self.epoch, int(world.get("epoch", 0) or 0))
        except (TypeError, ValueError):
            pass
        return True


def _world_env(world: Dict[str, Any], a: Dict[str, Any]) -> Dict[str, str]:
    """The environment of one assignment of a world document: the
    ``HOROVOD_*`` topology and controller, and the generation's TCPStore as
    the launcher exports its own (``run/launcher.py:build_rank_env``)."""
    return {
        "HOROVOD_RANK": str(a["rank"]),
        "HOROVOD_SIZE": str(world["size"]),
        "HOROVOD_LOCAL_RANK": str(a["local_rank"]),
        "HOROVOD_LOCAL_SIZE": str(a["local_size"]),
        "HOROVOD_CROSS_RANK": str(a["cross_rank"]),
        "HOROVOD_CROSS_SIZE": str(a["cross_size"]),
        "HOROVOD_CONTROLLER_ADDR": str(world.get("controller_addr", "")),
        "HOROVOD_CONTROLLER_PORT": str(world.get("controller_port", 0)),
        "MASTER_ADDR": str(world["master_addr"]),
        "MASTER_PORT": str(world["master_port"]),
        "TORCHELASTIC_USE_AGENT_STORE": "True",
        "TORCHELASTIC_RESTART_COUNT": "0",
        "HOROVOD_ELASTIC_GEN": str(world["gen"]),
    }


_context: Optional[_ElasticContext] = None


def _ctx() -> Optional[_ElasticContext]:
    global _context
    if _context is None and os.environ.get("HOROVOD_ELASTIC") == "1":
        _context = _ElasticContext()
    return _context


# ------------------------------------------- driver-loss park/reattach
class DriverWatch:
    """What a parked rank does next, from what it sees on the KV plane:
    ``wait`` (no driver, or no world yet), ``fenced`` (a driver answering
    with an epoch below one already acknowledged), ``reattach`` (a current
    or newer epoch republished this rank's generation; ``epoch_seen`` is
    the epoch to adopt) or ``rejoin`` (a different generation)."""

    def __init__(self, gen: int, epoch: int):
        self.gen = int(gen)
        self.epoch = int(epoch)
        self.epoch_seen: Optional[int] = None
        self.fenced = 0

    def classify(self, driver_doc, world_doc) -> str:
        if not isinstance(driver_doc, dict):
            return "wait"
        try:
            epoch = int(driver_doc.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            return "wait"
        if epoch < self.epoch:
            self.fenced += 1
            return "fenced"
        if not isinstance(world_doc, dict):
            return "wait"
        try:
            gen = int(world_doc.get("gen", -1))
        except (TypeError, ValueError):
            return "wait"
        if gen == self.gen:
            self.epoch_seen = epoch
            return "reattach"
        return "rejoin"


# Cross-rank outcome codes, by severity: the fleet adopts the MAX, so no
# rank resumes into a world a peer abandoned.
PARK_OUTCOMES = {"reattach": 0, "rejoin": 1, "dead": 2}


def _park_and_reattach(ctx: _ElasticContext) -> None:
    """Driver loss, agreed at a commit: hold the state, poll the KV plane
    with bounded backoff until a current-epoch driver answers, then agree
    the outcome (reattach in place, rejoin, or fail for the rollback)."""
    import numpy as np

    from .. import eager
    from ..common.types import ReduceOp
    from ..fault.backoff import Backoff

    ctx._parks += 1
    if _trace.ACTIVE:
        _trace.TAP.event("hvd_worker_park", cat="elastic", gen=ctx.gen, epoch=ctx.epoch)
    if _metrics.ACTIVE:
        _metrics.TAP.inc("hvd_worker_parks_total")
    if _fault_injector.ACTIVE:
        _fault_injector.record_event("driver", ctx._parks, "park", f"gen={ctx.gen}")
    logger.warning("elastic: driver unreachable; parked at the commit boundary (state held, "
                   "collectives quiesced; gen %s, epoch %s)", ctx.gen, ctx.epoch)
    watch = DriverWatch(ctx.gen, ctx.epoch)
    backoff = Backoff.from_env()
    deadline = time.monotonic() + ctx.timeout
    attempt, fenced_logged, outcome = 0, False, "dead"
    while time.monotonic() <= deadline:
        driver_doc, world_doc = ctx.probe_driver()
        got = watch.classify(driver_doc, world_doc)
        if got in ("reattach", "rejoin"):
            outcome = got
            break
        if got == "fenced":
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_worker_driver_fenced_total")
            if not fenced_logged:
                fenced_logged = True
                if _fault_injector.ACTIVE:
                    _fault_injector.record_event(
                        "driver", ctx._parks, "fenced",
                        f"epoch={driver_doc.get('epoch')}<{ctx.epoch}")
                logger.error("elastic: rejecting stale driver (epoch %s < acknowledged %s); "
                             "waiting for a current one", driver_doc.get("epoch"), ctx.epoch)
        time.sleep(backoff.delay(min(attempt, 5)))
        attempt += 1
    code = PARK_OUTCOMES[outcome]
    if basics.is_initialized() and basics.size() > 1:
        agreed = int(np.asarray(eager.allreduce(
            np.asarray([code], np.int32), op=ReduceOp.MAX, name="hvd.elastic.parkagree"))[0])
    else:
        agreed = code
    if agreed == PARK_OUTCOMES["reattach"]:
        ctx.reattach(watch.epoch_seen if watch.epoch_seen is not None else ctx.epoch)
        return
    if agreed == PARK_OUTCOMES["rejoin"]:
        raise HostsUpdatedInterrupt("driver resumed with a new world generation; rejoining")
    raise basics.HorovodInternalError(
        f"elastic: no current driver within {ctx.timeout:g}s of parking (last known "
        f"generation {ctx.gen}, epoch {ctx.epoch})")


# ------------------------------------------------------- live re-plan
_adopted_replan: Optional[Dict[str, Any]] = None


def _adopt_replan(ctx: _ElasticContext) -> None:
    """Adopt the agreed re-plan notice at the commit and interrupt the
    training function so it rebuilds its step (state kept)."""
    global _adopted_replan
    doc = ctx.take_pending_replan()
    _adopted_replan = doc
    if _metrics.ACTIVE:
        _metrics.TAP.inc("hvd_replan_adoptions_total")
    if _trace.ACTIVE:
        _trace.TAP.event("hvd_replan_adopt", cat="elastic", id=int(doc.get("id", 0)),
                         gen=ctx.gen)
        _trace.TAP.note_plan(topo_algorithm=doc.get("config", {}).get("topo_algorithm"),
                             wire_dtype=doc.get("config", {}).get("wire_dtype"))
    if _fault_injector.ACTIVE:
        _fault_injector.record_event("driver", int(doc.get("id", 0)), "replan-adopt",
                                     f"id={doc.get('id')}")
    logger.warning("elastic: adopting live re-plan #%s at the commit boundary (%s); "
                   "rebuilding the train step", doc.get("id"), doc.get("config"))
    raise PlanUpdatedInterrupt(doc)


def adopted_replan() -> Optional[Dict[str, Any]]:
    """The last live re-plan notice this worker adopted (None before any)."""
    return dict(_adopted_replan) if _adopted_replan else None


def adopted_step_kwargs() -> Optional[Dict[str, Any]]:
    """The ``make_train_step`` knobs the adopted re-plan maps to, through
    the same ``tune.tuned_step_kwargs`` a pinned ``tuned.json`` takes, so a
    re-planned step is bitwise the same knobs passed by hand. None before
    any adoption; a training loop splats it when it (re)builds its step,
    closing the step it replaces (an ``overlap=True`` step's hooks come off
    the parameters; a new streamed build over them would take them off by
    itself, and the old step raises if it is called again)::

        kwargs = hvd.elastic.adopted_step_kwargs() or {}
        if step is not None:
            step.close()
        step = hvd.make_train_step(loss_fn, opt, **kwargs)
    """
    if _adopted_replan is None:
        return None
    from ..tune import TunedConfig, tuned_step_kwargs

    cfg = TunedConfig(knobs=dict(_adopted_replan.get("config") or {}), signature={},
                      objectives={}, baseline={}, program="live-replan")
    return tuned_step_kwargs(cfg)


# --------------------------------------------------------- hot spares
SPARE_POLL_S = 0.5


def maybe_wait_as_spare() -> bool:
    """The spare gate: a worker spawned with ``HOROVOD_ELASTIC_SPARE=1``
    holds here, before any process group or topology exists, heartbeating
    ``spare.<wid>`` on the KV plane until the driver's ``promote.<wid>``
    names a generation whose published world assigns this worker. It then
    applies the assignment's environment and returns True; ``init`` goes on
    as a normal member. It exits 0 when the driver stops answering for the
    elastic timeout, or when a newer driver epoch appears."""
    if os.environ.get("HOROVOD_ELASTIC_SPARE") != "1":
        return False
    from ..run.http_server import KVStoreClient

    wid = os.environ["HOROVOD_ELASTIC_WORKER_ID"]
    try:
        spawn_epoch = int(os.environ.get("HOROVOD_DRIVER_EPOCH", "0") or 0)
    except ValueError:
        spawn_epoch = 0
    try:
        timeout = float(os.environ.get("HOROVOD_ELASTIC_TIMEOUT", "600"))
    except ValueError:
        timeout = 600.0
    kv = KVStoreClient(os.environ["HOROVOD_ELASTIC_KV_ADDR"],
                       int(os.environ["HOROVOD_ELASTIC_KV_PORT"]))
    logger.warning("elastic: spare %s parked at the spare gate (awaiting promotion)", wid)
    beat, last_seen = 0, time.monotonic()
    while True:
        world = driver = promote_gen = None
        try:
            raw = kv.get("elastic", "world")
            world = json.loads(raw.decode()) if raw else None
            raw = kv.get("elastic", "driver")
            driver = json.loads(raw.decode()) if raw else None
            raw = kv.get("elastic", f"promote.{wid}")
            if raw:
                promote_gen = int(raw.decode())
        except Exception:  # noqa: BLE001 - driver briefly unreachable
            pass
        if driver is not None:
            last_seen = time.monotonic()
            try:
                epoch = int(driver.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                epoch = 0
            if spawn_epoch and epoch > spawn_epoch:
                logger.warning("elastic: spare %s superseded (driver epoch %s > spawn epoch "
                               "%s); exiting", wid, epoch, spawn_epoch)
                sys.exit(0)
        elif time.monotonic() - last_seen > timeout:
            logger.warning("elastic: spare %s saw no driver for %gs; exiting", wid, timeout)
            sys.exit(0)
        assignments = (world or {}).get("assignments") or {}
        if (promote_gen is not None and wid in assignments
                and int((world or {}).get("gen", -1)) == promote_gen):
            os.environ.update(_world_env(world, assignments[wid]))
            os.environ["HOROVOD_ELASTIC_SYNC_ROOT"] = str(world.get("sync_root", 0))
            os.environ["HOROVOD_DRIVER_EPOCH"] = str(world.get("epoch", spawn_epoch))
            os.environ.pop("HOROVOD_ELASTIC_SPARE", None)
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_spare_activations_total")
            if _fault_injector.ACTIVE:
                _fault_injector.record_event("driver", int(world["gen"]), "spare-adopt",
                                             f"worker={wid}")
            logger.warning("elastic: spare %s promoted into generation %s as rank %s", wid,
                           world["gen"], assignments[wid]["rank"])
            return True
        beat += 1
        try:
            kv.put("elastic", f"spare.{wid}", str(beat).encode())
        except Exception:  # noqa: BLE001 - advisory heartbeat
            pass
        time.sleep(SPARE_POLL_S)


def apply_serve_scale(engine, decision):
    """Apply a serving autoscale verdict with the elastic verbs: scale-out
    is the spare-promotion verb (a fresh DP serving replica joins) and
    scale-in the quarantine-shrink verb (the newest replica drains its
    batch and retires). Event-logged through the fault injector's ledger
    like every other membership change (``replica`` site, actions
    ``serve-promote``/``serve-retire``). Returns the replica index added or
    retired, or None when the engine refused (retiring the last replica)."""
    if decision is None:
        return None
    if decision.action == "scale-out":
        idx = engine.add_replica()
        verb = "serve-promote"
    else:
        idx = engine.retire_replica()
        verb = "serve-retire"
    if idx is None:
        return None
    if _fault_injector.ACTIVE:
        _fault_injector.record_event(
            "replica", idx, verb,
            f"reason={decision.reason} depth={decision.depth:.1f} "
            f"burn={decision.slo_burn:.3f}")
    logger.warning("elastic: serving %s replica %s (%s: depth=%.1f burn=%.3f)",
                   "scale-out to" if verb == "serve-promote" else "scale-in of", idx,
                   decision.reason, decision.depth, decision.slo_burn)
    return idx


# ------------------------------------------------- rejoin-mode selection
# The exit status a worker asks the driver for a fresh process with (the
# JAX package's run/elastic_driver.py REJOIN_EXIT_CODE).
REJOIN_EXIT_CODE = 79

_rejoin_mode: Optional[str] = None


def _inprocess_rejoin_supported() -> bool:
    """In-process re-formation needs ``torch.distributed`` to leave a group
    and form another in the same process: ``destroy_process_group``, and
    ``distributed_c10d._abort_process_group`` for a group a dead peer
    broke (never waited on)."""
    try:
        import torch.distributed as dist
        from torch.distributed import distributed_c10d as c10d
    except Exception:  # noqa: BLE001 - a torch without distributed
        return False
    return bool(dist.is_available() and callable(getattr(dist, "destroy_process_group", None))
                and callable(getattr(c10d, "_abort_process_group", None)))


def rejoin_mode() -> str:
    """``'inprocess'`` (re-form the world in this process; the default
    where :func:`_inprocess_rejoin_supported`) or ``'respawn'`` (persist
    the last commit and exit with :data:`REJOIN_EXIT_CODE` for the driver
    to respawn the slot). ``HOROVOD_ELASTIC_REJOIN_MODE`` forces either;
    ``inprocess`` without the torch surfaces degrades to ``respawn``."""
    global _rejoin_mode
    if _rejoin_mode is None:
        forced = os.environ.get("HOROVOD_ELASTIC_REJOIN_MODE", "auto").lower()
        supported = _inprocess_rejoin_supported()
        if forced == "inprocess" and not supported:
            logger.warning("elastic: HOROVOD_ELASTIC_REJOIN_MODE=inprocess but this torch "
                           "cannot abort a process group; falling back to 'respawn'")
            _rejoin_mode = "respawn"
        elif forced in ("inprocess", "respawn"):
            _rejoin_mode = forced
        else:
            _rejoin_mode = "inprocess" if supported else "respawn"
        logger.info("elastic: rejoin mode '%s'", _rejoin_mode)
    return _rejoin_mode


# ------------------------------------------------------ respawn snapshots
def _persist_path() -> Optional[str]:
    """The slot's snapshot file in the driver-shared state directory, keyed
    by worker id, so a respawn of the same slot finds its predecessor's
    last commit."""
    d = os.environ.get("HOROVOD_ELASTIC_STATE_DIR")
    wid = os.environ.get("HOROVOD_ELASTIC_WORKER_ID")
    if not d or not wid:
        return None
    return os.path.join(d, f"{wid.replace(':', '_').replace('/', '_')}.state.pkl")


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor moved to the CPU: a snapshot on disk holds
    CPU tensors (a ``state_dict`` restores onto its parameters' devices)."""
    import torch

    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, _Zero1Snapshot):
        return _Zero1Snapshot(_to_host(obj.shards), _to_host(obj.ef), _to_host(obj.opt_state))
    return obj


def _persist_state_and_exit(state: "State", ctx: _ElasticContext) -> None:
    """Respawn mode: snapshot the state to disk, signal the driver, exit
    with the rejoin status. Never returns."""
    import pickle

    path = _persist_path()
    if path is not None:
        try:
            state.save()
            payload = _persist_payload(state)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(_to_host(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except Exception as exc:  # noqa: BLE001 - degrade, don't hang
            logger.warning("elastic: could not persist state (%s); the respawn will re-sync "
                           "from a peer's snapshot instead", exc)
    else:
        logger.warning("elastic: no HOROVOD_ELASTIC_STATE_DIR/WORKER_ID; respawn resumes from "
                       "peers' snapshots only")
    ctx.signal_rejoin()
    logger.info("elastic: exiting for respawn (status %d)", REJOIN_EXIT_CODE)
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001
        pass
    # os._exit: the world is half dead; an orderly interpreter exit can
    # hang joining threads blocked on dead peers.
    os._exit(REJOIN_EXIT_CODE)


def _load_snapshot(path: str) -> Any:
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def _maybe_restore_persisted(state: "State") -> bool:
    """Respawn-mode start: resume from this slot's persisted last commit,
    if any, before the first sync (so a restored snapshot is what a sync
    root broadcasts). An unreadable snapshot is quarantined aside
    (``.corrupt``), never re-read. True when one was restored."""
    path = _persist_path()
    if path is None or not os.path.exists(path):
        return False
    try:
        payload = _load_snapshot(path)
    except Exception as exc:  # noqa: BLE001 - torn write, stale format
        quarantined = f"{path}.corrupt"
        try:
            os.replace(path, quarantined)
            logger.error("elastic: unreadable persisted state (%s); quarantined to %s; this "
                         "slot resumes from a peer's snapshot", exc, quarantined)
        except OSError as mv_exc:
            logger.warning("elastic: unreadable persisted state (%s); could not quarantine it "
                           "either (%s)", exc, mv_exc)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_elastic_snapshot_quarantined_total")
        return False
    payload = _preflight_snapshot_layout(state, payload, path)
    _apply_payload(state, payload)
    state.restore()
    logger.info("elastic: restored persisted state from %s", path)
    return True


def _warn_if_unrestored(restored_any: bool) -> None:
    """A restart at generation > 1 with no snapshot on ANY rank starts over
    from step 0: log it, or fail with ``HOROVOD_ELASTIC_REQUIRE_SNAPSHOT``."""
    if restored_any:
        return
    try:
        gen = int(os.environ.get("HOROVOD_ELASTIC_GEN", "1") or 1)
    except ValueError:
        gen = 1
    if gen <= 1:
        return
    msg = (f"elastic: restart generation {gen} found no restored snapshot on ANY rank; "
           "training resumes from step 0 and all progress since the last commit is LOST. "
           "Check that HOROVOD_ELASTIC_STATE_DIR survives respawns.")
    if os.environ.get("HOROVOD_ELASTIC_REQUIRE_SNAPSHOT", "").strip().lower() in (
            "1", "true", "yes", "on"):
        raise RuntimeError(msg + " Failing because HOROVOD_ELASTIC_REQUIRE_SNAPSHOT is set.")
    logger.error(msg)
    if _metrics.ACTIVE:
        _metrics.TAP.inc("hvd_elastic_unrestored_restarts_total")


def _elect_restored_sync_root(ctx: _ElasticContext, restored: bool) -> None:
    """Respawn mode: move the sync root onto the first rank that restored a
    snapshot (the same choice on every rank), keeping the driver's only
    when nobody restored."""
    from .. import eager

    if basics.size() <= 1:
        _warn_if_unrestored(restored)
        return
    flags = eager.allgather_object(bool(restored), name="hvd.elastic.snap")
    _warn_if_unrestored(any(flags))
    if not flags[ctx.sync_root] and any(flags):
        new_root = flags.index(True)
        logger.info("elastic: sync root %d has no snapshot; re-electing rank %d (restored)",
                    ctx.sync_root, new_root)
        ctx.sync_root = new_root


def _persist_payload(state: "State") -> Dict[str, Any]:
    """Everything a ``save()`` produced (every ``_saved*`` attribute),
    stamped with its world layout (``__layout__``: the world size and any
    ZeRO-1 bucket layouts) for the restore's preflight."""
    payload = {k: v for k, v in vars(state).items() if k.startswith("_saved")}
    payload["__layout__"] = _snapshot_layout_stamp(state)
    return payload


def _zero1_shard_dims(payload: Dict[str, Any]) -> Dict[str, int]:
    """``{payload_key/tree_path: shard count}`` of every ZeRO-1 node in the
    ``_saved*`` values: the count a gathered node (``Zero1Rows``) holds, or
    the world it was saved in (the stamp's) for a rank's own rows."""
    from ..parallel.reshard import Zero1Rows
    from ..parallel.zero import Zero1State

    world = (payload.get("__layout__") or {}).get("world")
    dims: Dict[str, int] = {}

    def scan(prefix: str, node: Any) -> None:
        if isinstance(node, Zero1Rows):
            dims[prefix] = node.n_shards
        elif isinstance(node, (Zero1State, _Zero1Snapshot)):
            dims[prefix] = int(world if world is not None else os.environ.get("HOROVOD_SIZE", 1))
        elif isinstance(node, dict):
            for k, v in node.items():
                scan(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                scan(f"{prefix}/{i}" if prefix else str(i), v)

    for key, value in payload.items():
        if key.startswith("_saved"):
            scan(key, value)
    return dims


def _snapshot_layout_stamp(state: "State") -> Dict[str, Any]:
    try:
        world = int(os.environ.get("HOROVOD_SIZE", "1") or 1)
    except ValueError:
        world = 1
    layouts = getattr(state, "zero1_layout", None) or {}
    return {"world": world, "zero1_layout": {
        str(a): (lay.to_dict() if hasattr(lay, "to_dict") else dict(lay))
        for a, lay in dict(layouts).items()}}


def note_zero1_layout(state: "State", attr: str, layout: Any) -> None:
    """Attach the ZeRO-1 bucket layout of tracked attribute ``attr`` (from
    ``parallel/reshard.zero1_layout_from_params``; ``"optimizer"`` for a
    ``TorchState``'s ZeRO-1 optimizer) so a resize can reshard it. Without
    a layout, a resize with sharded state refuses loudly."""
    layouts = getattr(state, "zero1_layout", None)
    if layouts is None:
        layouts = {}
        state.zero1_layout = layouts
    layouts[str(attr)] = layout


def _preflight_snapshot_layout(state: "State", payload: Dict[str, Any],
                               path: str) -> Dict[str, Any]:
    """Respawn-mode layout preflight, before any state is applied: a
    snapshot of ZeRO-1 state taken at another world size is resharded when
    it holds the gathered rows (``Zero1Rows``) and a bucket layout was
    recorded, and otherwise refused with an error naming both layouts.
    A rank's own rows (a ``Zero1State``) cannot be resharded alone: the
    refusal names the sharded checkpoint."""
    from ..parallel.reshard import Zero1Rows

    dims = _zero1_shard_dims(payload)
    stamp = payload.get("__layout__") or {}
    snap_world = stamp.get("world")
    try:
        cur = int(os.environ.get("HOROVOD_SIZE", "1") or 1)
    except ValueError:
        cur = 1
    mismatched = {k: n for k, n in dims.items() if n != cur}
    if not mismatched:
        return payload
    layouts = dict(stamp.get("zero1_layout") or {})
    if not layouts:
        raise RuntimeError(
            f"elastic: snapshot {path} holds ZeRO-1 state sharded for a different world: "
            f"snapshot layout (world={snap_world if snap_world is not None else '?'}, shards "
            f"{dims}) vs new generation layout (world={cur}), and no bucket layout was "
            f"recorded to reshard it. Attach one with hvd.elastic.note_zero1_layout(state, "
            f"attr, zero1_layout_from_params(...)) before the first commit, or restore from a "
            f"sharded checkpoint (utils/checkpoint.py).")
    from ..parallel import reshard as _reshard

    out = dict(payload)
    for key in list(out):
        value = out[key]
        if not key.startswith("_saved") or not isinstance(value, dict):
            continue
        new_value = dict(value)
        for attr, sub in value.items():
            attr_dims = _zero1_shard_dims({"_saved": {attr: sub}, "__layout__": stamp})
            if not attr_dims or all(n == cur for n in attr_dims.values()):
                continue
            lay = layouts.get(str(attr))
            if lay is None:
                raise RuntimeError(
                    f"elastic: snapshot {path} attr {attr!r} holds ZeRO-1 state sharded "
                    f"{sorted(set(attr_dims.values()))} ways (snapshot world="
                    f"{snap_world if snap_world is not None else '?'}) but the new generation "
                    f"has world={cur} and no bucket layout was recorded for {attr!r} (known: "
                    f"{sorted(layouts)}): attach one with hvd.elastic.note_zero1_layout.")
            if not isinstance(sub, Zero1Rows):
                raise RuntimeError(
                    f"elastic: snapshot {path} attr {attr!r} holds this rank's ZeRO-1 rows of "
                    f"a world of {snap_world} ranks; the new generation has world={cur}, and "
                    f"the other ranks' rows are not in this snapshot: restore from a sharded "
                    f"checkpoint (utils/checkpoint.py save_checkpoint(..., manifest=...)).")
            new_value[attr], reports = _reshard.reshard_zero1_tree(
                sub, cur, layouts={"": lay}, trigger="snapshot-restore")
            for rep in reports:
                logger.info("elastic: resharded snapshot attr %r zero1 state %d->%d shards "
                            "(%d bytes)", attr, rep["n_old"], rep["n_new"], rep["moved_bytes"])
        out[key] = new_value
    new_layouts = {a: _reshard.Zero1Layout.from_dict(l).relayout(cur).to_dict()
                   for a, l in layouts.items()}
    out["__layout__"] = {"world": cur, "zero1_layout": new_layouts}
    state.zero1_layout = {a: _reshard.Zero1Layout.from_dict(l) for a, l in new_layouts.items()}
    return out


def _apply_payload(state: "State", payload: Dict[str, Any]) -> None:
    if "tracked" in payload and "_saved" not in payload:
        payload = dict(payload)
        payload["_saved"] = payload.pop("tracked")  # the JAX package's pre-r5 layout
    for k, v in payload.items():
        if k.startswith("_saved"):
            setattr(state, k, v)


def _clear_persisted() -> None:
    path = _persist_path()
    if path is not None and os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            pass


# ------------------------------------------------------------- re-formation
def _leave_world(broken: bool) -> None:
    """Stop the eager runtime and leave the process group; after a failure
    the group is aborted, never waited on (``basics.shutdown(abort=...)``)."""
    try:
        basics.shutdown(abort=broken)
    except Exception as exc:  # noqa: BLE001 - already torn down
        logger.info("elastic: leaving the world reported %s", exc)


def _rejoin(ctx: _ElasticContext, broken: bool = False) -> None:
    """Leave the current (broken or stale) world and join the next
    generation: wait for the driver to publish gen > current with this
    worker in it, then ``init`` again. A worker dropped from the new world
    exits 0."""
    ctx.signal_rejoin()
    _leave_world(broken)
    deadline = time.monotonic() + ctx.timeout
    while True:
        if time.monotonic() > deadline:
            raise RuntimeError(f"elastic: no usable world generation within {ctx.timeout}s "
                               f"(last known gen {ctx.gen})")
        world = None
        try:
            world = ctx.fetch_world()
        except Exception:  # noqa: BLE001 - driver briefly unreachable
            pass
        if not world or int(world["gen"]) <= ctx.gen:
            time.sleep(0.05)
            continue
        if not ctx.apply(world):
            logger.info("elastic: worker %s not in generation %s; exiting", ctx.worker_id,
                        world["gen"])
            sys.exit(0)
        try:
            basics.init(device=ctx.device)
            ctx.gen = int(world["gen"])  # committed only on success
            if _trace.ACTIVE:
                _trace.TAP.reset_steps()
            ctx._pending_replan = None
            ctx.signal_attach()
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_elastic_rejoins_total")
            return
        except Exception as exc:  # noqa: BLE001 - racing another bump
            logger.warning("elastic: init at gen %s failed (%s); retrying", world["gen"], exc)
            _leave_world(True)
            time.sleep(0.5)


_sync_root_override: Optional[int] = None


def _sync_root() -> int:
    """The rank whose state is authoritative for the current generation: a
    survivor of the previous world (published by the driver), or the
    digest guard's transient reference (``_sync_root_as``)."""
    if _sync_root_override is not None:
        return _sync_root_override
    ctx = _ctx()
    return ctx.sync_root if ctx is not None else 0


@contextlib.contextmanager
def _sync_root_as(root: int):
    """Force the sync root for a heal; every rank enters with the SAME root,
    so the broadcasts stay collective."""
    global _sync_root_override
    prev = _sync_root_override
    _sync_root_override = int(root)
    try:
        yield
    finally:
        _sync_root_override = prev


# ----------------------------------------------------------------- state
class State:
    """Base class of elastic state (upstream ``horovod.elastic.State``):
    ``commit()`` snapshots and checks for membership changes, ``restore()``
    rolls back to the last commit, ``sync()`` aligns every rank with the
    sync root's state after a re-formation."""

    def __init__(self) -> None:
        self._reset_callbacks: List[Callable[[], None]] = []
        self._guard_commits = 0
        # One entry a re-formation, appended by ``run`` before the reset
        # callbacks: ``kind`` (``rollback``, ``hosts``, ``preempt``), the
        # generation joined, its size, and the wall-clock seconds the
        # interrupt or failure was caught and the new ``init`` returned.
        self.reformations: List[Dict[str, Any]] = []
        # The ZeRO-1 rows the last graceful re-formation gathered over the
        # old world (``{holder: Zero1Rows}``).
        self.zero1_gathered: Dict[str, Any] = {}

    def register_reset_callbacks(self, callbacks: List[Callable[[], None]]) -> None:
        """Callbacks run after each re-formation (learning-rate rescale,
        dataset re-partition, ...)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def commit(self) -> None:
        if _trace.ACTIVE:
            _trace.TAP.commit_step()
        if _fault_injector.ACTIVE:
            # One commit is one training step for the plans' step site.
            _fault_injector.fault_point("step")
        if _guard.ACTIVE:
            # Digest agreement BEFORE save(): a diverged replica must never
            # become the rollback point.
            self._guard_check_digest()
        self.save()
        self.check_host_updates()

    def _guard_check_digest(self) -> None:
        """Every ``HOROVOD_GUARD_DIGEST_STEPS`` commits: hash the tracked
        state, allgather the digests, and on a mismatch heal from the
        agreeing quorum's reference rank or raise for the rollback."""
        steps = _guard.digest_steps()
        if steps <= 0:
            return
        self._guard_commits += 1
        if self._guard_commits % steps:
            return
        if not basics.is_initialized() or basics.size() <= 1:
            return
        from .. import eager
        from ..guard import digest as _digest

        digests = eager.allgather_object(_digest.state_digest(self), name="hvd.guard.digest")
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_guard_digest_checks_total")
        ok, ref, outliers = _digest.find_quorum(
            digests, no_quorum=_guard.no_quorum_action(), sync_root=_sync_root())
        if ok:
            return
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_guard_digest_mismatches_total")
        if ref is None:
            _guard.record_guard_event("digest-rollback", f"outliers={outliers}")
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_guard_rollbacks_total")
            raise basics.HorovodInternalError(
                f"parameter digest mismatch across ranks {outliers} with no agreeing quorum "
                "(HOROVOD_GUARD_DIGEST_STEPS guard); rolling back to the last commit")
        _guard.record_guard_event("digest-heal", f"ref={ref} outliers={outliers}")
        logger.error("digest guard: ranks %s diverged from the quorum; healing by re-broadcast "
                     "from rank %d", outliers, ref)
        with _sync_root_as(ref):
            self.sync()
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_guard_heals_total")

    # Vote bits of the commit's agreement allreduce (op Max), by severity.
    _REPLAN_BIT = 1
    _UPDATED_BIT = 2
    _PREEMPT_BIT = 4
    _LOST_BIT = 8

    def check_host_updates(self) -> None:
        """Raise ``HostsUpdatedInterrupt`` on EVERY rank when any rank saw a
        newer generation, agreed by a 4-byte eager ``Max`` allreduce. A
        preemption notice rides the same agreement (the preempted rank
        raises ``PreemptionInterrupt``, its peers a membership interrupt);
        a lost driver parks every rank; a pending re-plan is adopted."""
        ctx = _ctx()
        if ctx is None:
            return
        import numpy as np

        from .. import eager
        from ..common.types import ReduceOp

        preempted = _preemption.preemption_requested()
        updated, lost, new_epoch = ctx.commit_probe()
        replan = ctx.check_replan()
        if new_epoch is not None and not (lost or updated or preempted):
            ctx.reattach(new_epoch)
        flag = np.asarray([(self._LOST_BIT if lost else 0)
                           | (self._PREEMPT_BIT if preempted else 0)
                           | (self._UPDATED_BIT if updated else 0)
                           | (self._REPLAN_BIT if replan else 0)], np.int32)
        if basics.size() > 1:
            flag = np.asarray(eager.allreduce(flag, op=ReduceOp.MAX,
                                              name="hvd.elastic.hostcheck"))
        agreed = int(flag[0])
        if preempted:
            raise PreemptionInterrupt(_preemption.preemption_reason() or "preemption notice")
        if agreed >= self._LOST_BIT:
            _park_and_reattach(ctx)
            return
        if agreed >= self._PREEMPT_BIT:
            raise HostsUpdatedInterrupt(
                "a peer rank received a preemption notice; re-forming the world")
        if agreed >= self._UPDATED_BIT:
            raise HostsUpdatedInterrupt("host membership changed; re-forming the world")
        if agreed >= self._REPLAN_BIT:
            _adopt_replan(ctx)

    # The ZeRO-1 holders of this state: {name: Zero1State}, and how to
    # install a new one (graceful resizes).
    def _zero1_nodes(self) -> Dict[str, Any]:
        from ..parallel.zero import Zero1State

        return {k: getattr(self, k) for k in getattr(self, "_tracked", [])
                if isinstance(getattr(self, k, None), Zero1State)}

    def _set_zero1(self, name: str, node: Any) -> None:
        setattr(self, name, node)

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class ObjectState(State):
    """State over picklable attributes (``ObjectState(batch=0, epoch=0)``);
    ``sync`` ships the sync root's values over the object wire."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._tracked = sorted(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        # Snapshot through the subclass's save(): a rollback can come before
        # the first commit (a peer dying during the first sync).
        self._saved: Dict[str, Any] = {}
        self.save()

    def save(self) -> None:
        self._saved = {k: copy.deepcopy(getattr(self, k)) for k in self._tracked}

    def restore(self) -> None:
        for k, v in self._saved.items():
            self._assign(k, copy.deepcopy(v))

    def _assign(self, key: str, new: Any) -> None:
        """Bind ``new`` to tracked attribute ``key``, mutating the existing
        object IN PLACE when it is a mutable container or a plain instance
        of the same class: outside references (a ``DataLoader`` holding the
        sampler) stay valid across rollbacks and re-formations. ``new`` is
        always a throwaway copy, so adopting its internals is safe."""
        import torch

        cur = getattr(self, key, None)
        if cur is new:
            return
        if torch.is_tensor(cur) and torch.is_tensor(new):
            # A tensor holds its values in storage, not in __dict__: written in
            # place where the shapes agree, else rebound.
            if cur.shape == new.shape and cur.dtype == new.dtype:
                with torch.no_grad():
                    cur.copy_(new)
                return
            setattr(self, key, new)
            return
        if cur is not None and type(cur) is type(new):
            if isinstance(cur, dict):
                cur.clear()
                cur.update(new)
                return
            if isinstance(cur, list):
                cur[:] = new
                return
            if isinstance(cur, set):
                cur.clear()
                cur.update(new)
                return
            d_cur = getattr(cur, "__dict__", None)
            d_new = getattr(new, "__dict__", None)
            if isinstance(d_cur, dict) and isinstance(d_new, dict):
                d_cur.clear()
                d_cur.update(d_new)
                return
        setattr(self, key, new)

    @staticmethod
    def _is_sampler(v: Any) -> bool:
        # A duck-typed ElasticSampler: its processed set is PER-RANK state
        # that unions across ranks, not the sync source's copy.
        return hasattr(v, "processed") and hasattr(v, "record_batch")

    def _object_keys(self) -> List[str]:
        return list(self._tracked)

    def _sync_objects(self, keys: List[str]) -> None:
        from .. import eager

        sampler_keys = [k for k in keys if self._is_sampler(getattr(self, k))]
        # Every rank's processed indices, captured BEFORE the broadcast
        # overwrites the samplers: each rank trained a disjoint shard.
        merged = (eager.allgather_object({k: sorted(getattr(self, k).processed)
                                          for k in sampler_keys}, name="hvd.elastic.sampsync")
                  if sampler_keys else [])
        synced = eager.broadcast_object({k: getattr(self, k) for k in keys},
                                        root_rank=_sync_root(), name="hvd.elastic.objsync")
        for k, v in synced.items():
            self._assign(k, v)
        for k in sampler_keys:
            s = getattr(self, k)
            s.processed = set().union(*[set(m[k]) for m in merged])
            s._local_order = []

    def sync(self) -> None:
        if basics.size() > 1:
            self._sync_objects(self._object_keys())
        self.save()


def _is_tensor_tree(v: Any) -> bool:
    import torch

    from ..guard.digest import tree_leaves

    leaves = tree_leaves(v, is_leaf=_is_rank_local_node)
    return bool(leaves) and all(torch.is_tensor(l) or _is_rank_local_node(l) for l in leaves)


def _is_rank_local_node(n: Any) -> bool:
    from ..ops.quantized import EFState
    from ..parallel.zero import Zero1State

    return isinstance(n, (Zero1State, EFState))


def _clone_tree(v: Any) -> Any:
    """A copy of a tree of tensors on their own devices (``Zero1State``s
    with their inner optimizer's state)."""
    import torch

    from ..guard.digest import tree_map
    from ..parallel.zero import Zero1State

    def one(x):
        if torch.is_tensor(x):
            return x.detach().clone()
        if isinstance(x, Zero1State):
            return _Zero1Snapshot.of(x)
        return copy.deepcopy(x)

    return tree_map(one, v, is_leaf=lambda x: torch.is_tensor(x) or isinstance(x, Zero1State))


class _Zero1Snapshot:
    """A ``Zero1State``'s rows copied for a commit: the shard and residual
    tensors and the inner optimizer's ``state_dict``, written back IN
    PLACE by :meth:`write`, so the optimizer and its shard parameters stay
    the objects the step holds."""

    def __init__(self, shards, ef, opt_state):
        self.shards, self.ef, self.opt_state = shards, ef, opt_state

    @classmethod
    def of(cls, z) -> "_Zero1Snapshot":
        return cls({g: {b: t.detach().clone() for b, t in sub.items()}
                    for g, sub in z.shards.items()},
                   None if z.ef is None else {g: {b: t.detach().clone() for b, t in sub.items()}
                                              for g, sub in z.ef.items()},
                   copy.deepcopy(z.opt.state_dict()))

    def write(self, z) -> None:
        import torch

        with torch.no_grad():
            for g, sub in self.shards.items():
                for b, t in sub.items():
                    z.shards[g][b].copy_(t)
            if self.ef is not None and z.ef is not None:
                for g, sub in self.ef.items():
                    for b, t in sub.items():
                        z.ef[g][b].copy_(t)
        z.opt.load_state_dict(copy.deepcopy(self.opt_state))


def _restore_tree(cur: Any, saved: Any) -> Any:
    """``saved`` written into ``cur`` in place where the structures match
    (tensors ``copy_``, ``Zero1State``s through their snapshot), else a
    fresh copy of ``saved``."""
    import torch

    if isinstance(saved, _Zero1Snapshot):
        saved.write(cur)
        return cur
    if torch.is_tensor(saved):
        if torch.is_tensor(cur) and cur.shape == saved.shape and cur.dtype == saved.dtype:
            with torch.no_grad():
                cur.copy_(saved)
            return cur
        return saved.clone()
    if isinstance(saved, dict) and isinstance(cur, dict):
        return {k: _restore_tree(cur.get(k), v) for k, v in saved.items()}
    if isinstance(saved, tuple) and hasattr(saved, "_fields") and type(cur) is type(saved):
        return type(saved)(*(_restore_tree(c, s) for c, s in zip(cur, saved)))
    if isinstance(saved, (list, tuple)) and isinstance(cur, (list, tuple)) and len(cur) == len(
            saved):
        return type(saved)(_restore_tree(c, s) for c, s in zip(cur, saved))
    return copy.deepcopy(saved)


def _broadcast_skipping_rank_local(tree: Any, root: int) -> None:
    """Broadcast a tree of tensors from ``root`` in place over the process
    group WITHOUT overwriting its rank-local nodes: a ``Zero1State``'s rows
    and an ``EFState``'s residual (its ``inner`` still syncs)."""
    import torch

    from ..guard.digest import tree_leaves
    from ..ops.quantized import EFState
    from ..train import _broadcast_value

    for leaf in tree_leaves(tree, is_leaf=_is_rank_local_node):
        if isinstance(leaf, EFState):
            _broadcast_skipping_rank_local(leaf.inner, root)
        elif torch.is_tensor(leaf):
            with torch.no_grad():
                leaf.copy_(_broadcast_value(leaf, root))


class TensorState(ObjectState):
    """State over trees of torch tensors (dicts, lists, tuples; ``EFState``
    and ``Zero1State`` nodes) plus plain counters: the port's ``JaxState``.
    ``save`` copies the tensors where they live (on the card, a card copy);
    ``restore`` writes them back in place; ``sync`` broadcasts the tensor
    trees from the sync root over the process group, skipping the
    rank-local nodes, and the rest over the object wire."""

    def save(self) -> None:
        self._saved = {k: _clone_tree(getattr(self, k)) for k in self._tracked}

    def restore(self) -> None:
        for k, v in self._saved.items():
            cur = getattr(self, k, None)
            if _is_tensor_tree(cur) or isinstance(v, _Zero1Snapshot):
                setattr(self, k, _restore_tree(cur, v))
            else:
                self._assign(k, copy.deepcopy(v))

    def sync(self) -> None:
        if basics.size() > 1:
            root = _sync_root()
            arrays = [k for k in self._tracked if _is_tensor_tree(getattr(self, k))]
            for k in sorted(arrays):
                _broadcast_skipping_rank_local(getattr(self, k), root)
            objects = [k for k in self._tracked if k not in arrays]
            if objects:
                self._sync_objects(objects)
        self.save()


class TorchState(ObjectState):
    """State over a torch model and optimizer plus plain counters (upstream
    ``horovod.torch.elastic.TorchState``). ``save`` deep-copies the
    ``state_dict``s (on the card they stay on the card); ``restore`` loads
    them back; ``sync`` broadcasts the sync root's parameters and optimizer
    state: the torch binding's ``broadcast_parameters``/
    ``broadcast_optimizer_state`` for its ``DistributedOptimizer``, the DP
    step's (over the process group) otherwise. The DP step's
    ``DistributedOptimizer`` rank-local state (its ZeRO-1 rows, its
    error-feedback residuals) is saved and restored but never broadcast."""

    def __init__(self, model=None, optimizer=None, **kwargs: Any) -> None:
        self.model = model
        self.optimizer = optimizer
        super().__init__(**kwargs)

    def _dp_optimizer(self):
        from ..train import DistributedOptimizer

        return self.optimizer if isinstance(self.optimizer, DistributedOptimizer) else None

    def _zero1_nodes(self) -> Dict[str, Any]:
        nodes = super()._zero1_nodes()
        dp = self._dp_optimizer()
        if dp is not None and dp._zero1:
            nodes["optimizer"] = dp.zero1_state
        return nodes

    def _set_zero1(self, name: str, node: Any) -> None:
        if name == "optimizer":
            dp = self._dp_optimizer()
            dp._zero1_state = node
            dp._zero1_shards = None
            return
        super()._set_zero1(name, node)

    def save(self) -> None:
        super().save()
        if self.model is not None:
            self._saved_model = copy.deepcopy(self.model.state_dict())
        if self.optimizer is not None:
            self._saved_opt = copy.deepcopy(self.optimizer.state_dict())
        dp = self._dp_optimizer()
        if dp is not None:
            if dp._zero1:
                self._saved_zero1 = _Zero1Snapshot.of(dp.zero1_state)
            if dp._residual:
                self._saved_residual = [r.detach().clone() for r in dp.residual]

    def _reset_optimizer_handles(self) -> None:
        # A DistributedOptimizer's in-flight handles belong to a dead world
        # after a rollback; the next zero_grad() would refuse them.
        reset = getattr(self.optimizer, "reset", None)
        if callable(reset):
            reset()

    def restore(self) -> None:
        import torch

        super().restore()
        self._reset_optimizer_handles()
        if self.model is not None:
            self.model.load_state_dict(self._saved_model)
        if self.optimizer is not None:
            self.optimizer.load_state_dict(self._saved_opt)
        dp = self._dp_optimizer()
        if dp is not None:
            if getattr(self, "_saved_zero1", None) is not None and dp._zero1:
                self._saved_zero1.write(dp.zero1_state)
            saved = getattr(self, "_saved_residual", None)
            if saved is not None:
                with torch.no_grad():
                    for r, s in zip(dp.residual, saved):
                        r.copy_(s)

    def sync(self) -> None:
        self._reset_optimizer_handles()
        if basics.size() > 1:
            root = _sync_root()
            if self._dp_optimizer() is not None or self.optimizer is None:
                from .. import train as sync_api
            else:
                from .. import torch as sync_api
            # The optimizer first: the binding's broadcast gives a fresh
            # optimizer its state by a dummy step, which a weight decay lets
            # move the parameters; the parameters' broadcast then undoes it.
            if self.optimizer is not None:
                sync_api.broadcast_optimizer_state(self.optimizer, root_rank=root)
            if self.model is not None:
                sync_api.broadcast_parameters(self.model.state_dict(), root_rank=root)
        super().sync()


# ----------------------------------------------------------- failure filter
# Messages of torch.distributed's failures that mean a peer is gone or the
# communicator is broken (gloo's transport, NCCL's watchdog and abort).
_PEER_FAILURES = (
    "Connection closed by peer", "Connection reset by peer", "Broken pipe",
    "NCCL communicator was aborted", "communicator was aborted", "NCCL error",
    "ncclRemoteError", "ncclSystemError", "Watchdog caught collective operation timeout",
    "timed out", "Timed out", "has been aborted", "process group has been destroyed",
    "Socket Timeout", "Connection refused",
)


def _is_collective_failure(exc: BaseException) -> bool:
    """True when ``exc`` is (or wraps) a failed collective: the port's
    ``HorovodInternalError``, ``torch.distributed``'s ``DistBackendError``,
    ``DistNetworkError`` and ``DistStoreError``, or a ``RuntimeError`` of a
    gloo or NCCL collective whose message names a lost peer or an aborted
    communicator. Anything else (a shape mismatch, a user error) surfaces."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, basics.HorovodInternalError):
            return True
        try:
            import torch.distributed as dist

            dist_errors = tuple(getattr(dist, n) for n in (
                "DistBackendError", "DistNetworkError", "DistStoreError") if hasattr(dist, n))
        except Exception:  # noqa: BLE001
            dist_errors = ()
        if dist_errors and isinstance(exc, dist_errors):
            return True
        if isinstance(exc, RuntimeError) and any(s in str(exc) for s in _PEER_FAILURES):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


# ------------------------------------------------------------------- run
def _gather_zero1(state: State) -> Dict[str, Any]:
    """Every ZeRO-1 holder's rows all-gathered over the live old world (a
    graceful change: every rank is at this commit)."""
    from ..parallel import reshard as _reshard

    nodes = state._zero1_nodes()
    if not nodes:
        return {}
    return {name: _reshard.gather_zero1_state(node) for name, node in sorted(nodes.items())}


def run(func: Callable) -> Callable:
    """Make ``func(state, *args)`` elastic (upstream ``hvd.elastic.run``).
    On a collective failure the state rolls back to the last commit; on
    ``HostsUpdatedInterrupt`` or ``PreemptionInterrupt`` it is kept. Either
    way the worker re-forms the world with the next generation, re-syncs
    from its sync root, runs the reset callbacks, and calls ``func`` again.
    Outside an elastic launch (``HOROVOD_ELASTIC`` unset) it is a plain
    call."""

    @functools.wraps(func)
    def wrapper(state: State, *args: Any, **kwargs: Any) -> Any:
        ctx = _ctx()
        if ctx is None:
            return func(state, *args, **kwargs)
        if ctx.device is None and basics.is_initialized():
            # The CPU stays the CPU; a card is named only where it is not
            # the local rank's.
            dev = basics.device()
            ctx.device = "cpu" if dev.type == "cpu" else (
                None if dev.index == basics.local_rank() else str(dev))
        mode = rejoin_mode()
        if os.environ.get("HOROVOD_PREEMPTION_GRACEFUL", "1").strip().lower() not in (
                "0", "false", "no", "off"):
            # SIGTERM is the platform's preemption notice: a graceful drain
            # at the next commit instead of an instant death.
            _preemption.install_sigterm_handler()
        if mode == "respawn":
            restored = _maybe_restore_persisted(state)
            _elect_restored_sync_root(ctx, restored)
        while True:
            gathered: Dict[str, Any] = {}
            broken = False
            kind = "hosts"
            old_rank = basics.rank() if basics.is_initialized() else None
            try:
                state.sync()
                ctx.confirm_joined()
                result = func(state, *args, **kwargs)
                ctx.signal_done()
                if mode == "respawn":
                    _clear_persisted()
                return result
            except PlanUpdatedInterrupt as exc:
                logger.warning("elastic: %s; re-entering the training function", exc)
                continue
            except HostsUpdatedInterrupt:
                if _metrics.ACTIVE:
                    _metrics.TAP.inc("hvd_elastic_host_interrupts_total")
                logger.info("elastic: membership change; rejoining with current state")
                gathered = _gather_zero1(state) if mode == "inprocess" else {}
            except PreemptionInterrupt as exc:
                # Observed inside commit(): the state is already saved.
                if _metrics.ACTIVE:
                    _metrics.TAP.inc("hvd_elastic_preemptions_total")
                logger.warning("elastic: preemption notice (%s); draining and rejoining with "
                               "the just-committed state", exc)
                _preemption.clear()
                kind = "preempt"
                gathered = _gather_zero1(state) if mode == "inprocess" else {}
            except Exception as exc:  # noqa: BLE001 - filtered below
                if not _is_collective_failure(exc):
                    raise
                if _metrics.ACTIVE:
                    _metrics.TAP.inc("hvd_elastic_rollbacks_total")
                logger.warning("elastic: collective failure (%s); rolling back to the last "
                               "commit and rejoining", exc)
                broken, kind = True, "rollback"
                state.restore()
            caught = time.time()
            if mode == "respawn":
                _persist_state_and_exit(state, ctx)  # never returns
            try:
                old_size = int(os.environ.get("HOROVOD_SIZE", "1") or 1)
            except ValueError:
                old_size = 1
            _rejoin(ctx, broken=broken)
            state.reformations.append({"kind": kind, "gen": ctx.gen, "size": basics.size(),
                                       "caught_t": caught, "rejoined_t": time.time()})
            state.zero1_gathered = gathered
            _reshard_state_for_world(state, old_size, basics.size(), gathered,
                                     crashed=broken, old_rank=old_rank)
            state.on_reset()

    return wrapper


def _reshard_state_for_world(state: State, old_size: int, new_size: int,
                             gathered: Optional[Dict[str, Any]] = None, *,
                             crashed: bool = False, old_rank: Optional[int] = None) -> None:
    """After a re-formation: reshard every ZeRO-1 holder of ``state`` from
    its rows ``gathered`` over the old world (:func:`_gather_zero1`) onto
    the new world, keep this rank's, and make them the rollback point. A
    holder whose rows were not gathered (a crash) stays as it was when the
    world kept its size and this rank its rank, and refuses otherwise: the
    lost rank's rows are gone. A resize needs the bucket layout
    (:func:`note_zero1_layout`); without one it refuses naming both
    layouts."""
    nodes = state._zero1_nodes()
    if not nodes:
        return
    new_rank = basics.rank() if basics.is_initialized() else 0
    gathered = gathered or {}
    missing = sorted(n for n in nodes if n not in gathered)
    if missing and (new_size != old_size or (old_rank is not None and new_rank != old_rank)):
        raise RuntimeError(
            f"elastic: the world re-formed {old_size}->{new_size} (this rank {old_rank}->"
            f"{new_rank}) after {'a crash' if crashed else 'a change'}, and the ZeRO-1 state "
            f"{missing} holds only each rank's own rows: a lost rank's rows cannot be rebuilt "
            f"in process. Restore from a sharded checkpoint (utils/checkpoint.py: "
            f"save_checkpoint(..., manifest=build_manifest(...)) at every rank, then "
            f"restore_checkpoint at the new world).")
    if not gathered:
        return
    layouts = dict(getattr(state, "zero1_layout", None) or {})
    from ..parallel import reshard as _reshard

    for name, rows in sorted(gathered.items()):
        lay = layouts.get(str(name))
        if lay is None:
            if rows.n_shards == new_size:
                lay = None
            else:
                raise RuntimeError(
                    f"elastic: world resized {old_size}->{new_size} but tracked state "
                    f"{name!r} holds ZeRO-1 shards laid out for {old_size} ranks and no bucket "
                    f"layout was attached to reshard them: call hvd.elastic.note_zero1_layout("
                    f"state, {name!r}, zero1_layout_from_params(...)) at setup.")
        if lay is not None and not hasattr(lay, "relayout"):
            lay = _reshard.Zero1Layout.from_dict(lay)
        if lay is not None and lay.n_shards != rows.n_shards:
            lay = lay.relayout(rows.n_shards)
        if rows.n_shards != new_size:
            rows, report = _reshard.reshard_zero1_state(rows, new_size, layout=lay,
                                                        trigger="resize")
            logger.info("elastic: resharded %r zero1 state %d->%d shards for the new "
                        "generation (%d bytes)", name, report["n_old"], report["n_new"],
                        report["moved_bytes"])
        state._set_zero1(name, _reshard.unstack_zero1_states(rows, ranks=[new_rank])[0])
        if lay is not None:
            layouts[str(name)] = lay.relayout(new_size)
    state.zero1_layout = layouts
    state.save()
