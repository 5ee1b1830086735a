"""Elastic job driver: discovery, generations, worker supervision.

The port of ``horovod_tpu/run/elastic_driver.py`` (upstream
``horovod/runner/elastic/driver.py`` + ``discovery.py``): ``python -m
horovod_tpu_torch.run --min-np/--max-np/--host-discovery-script``
supervises an elastic job instead of the fixed fan-out of
``launcher.launch_job``.

- The driver owns the HTTP KV rendezvous store. Each world *generation*,
  its membership, rank assignments and a FRESH ``torch.distributed``
  TCPStore on a port the OS picks, is published under ``elastic/world``
  (``master_addr``/``master_port``); workers poll it and re-form in
  process (``horovod_tpu_torch/elastic``). The stores are served by the
  job's store host (``store_host.py``), a process that outlives the
  driver, so a resumed driver finds the workers' process groups alive.
  The core's controller endpoint is agreed through the store at ``init``
  (rank 0 binds the port it picks), so no port is probed for another host.
- A host-discovery script (prints ``host:slots`` lines, the upstream
  ``--host-discovery-script`` contract) is polled every
  ``discovery_interval`` seconds; membership changes bump the generation.
- A worker process that dies bumps the generation too; its host accrues a
  failure count and is blacklisted at ``host_failure_threshold`` (with a
  cooldown that doubles on each relapse), otherwise the slot is re-spawned
  fresh, or taken by a parked hot spare (``--spares``).
- A slot is ``host:local_rank`` and keeps its local rank, so its card,
  across generations: ``init`` refuses to move a process to another card.
- The job fails when fewer than ``min_np`` slots remain; it caps at
  ``max_np`` even when discovery offers more.
- The control plane is journaled (:mod:`.journal`); ``--resume`` replays
  it and adopts the surviving fleet (:meth:`ElasticDriver._enter_adoption`).
- The live re-plan (``HOROVOD_REPLAN_DIVERGENCE``, ``HOROVOD_REPLAN_SKEW_S``;
  :meth:`ElasticDriver._maybe_replan`): on the supervision beat, a
  calibration (``HOROVOD_CALIBRATION_FILE``) that drifts from the
  generation defaults, or a sustained step skew, re-prices the tuner's free
  objectives on the drifted model; a strictly better, verified
  configuration is journaled, then published under ``elastic/replan`` for
  the workers to adopt at their next commit.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import signal

from . import journal as _journal_mod
from . import launcher, safe_shell_exec
from . import selfdrive as _selfdrive
from .. import metrics as _metrics
from .. import trace as _trace
from ..fault import injector as _fault
from ..fault.plan import DRIVER_KINDS
from .http_server import KVStoreServer
from .launcher import SlotInfo, _is_local


# Worker exit status meaning "respawn me": the worker cannot re-form the
# world in-process (elastic/__init__.py REJOIN_EXIT_CODE, kept as a
# literal on both sides). Not a failure in respawn mode: it does not count
# toward host blacklisting.
REJOIN_EXIT_CODE = 79


def _detection_window(env: Dict[str, str]) -> float:
    """Seconds a survivor may take to notice a lost peer: a dead peer's
    sockets close at once (the native core's control socket, gloo's and
    NCCL's transports), and a peer that hangs surfaces at the process
    group's timeout, the stall shutdown window, else the stall warning's,
    else 60 s (``common/basics.elastic_timeout``)."""
    for var, default in (("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
                         ("HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0)):
        try:
            seconds = float(env.get(var, "") or default)
        except ValueError:
            seconds = default
        if seconds > 0:
            return seconds
    return 60.0


def _respawn_drain_grace(env: Dict[str, str], base: float = 15.0) -> float:
    """Drain grace for a respawn-mode world restart, scaled to the
    failure-DETECTION window instead of a fixed constant: a survivor only
    persists-and-exits once its collectives fail, which takes up to the
    process group's timeout (:func:`_detection_window`), plus a
    persistence margin. A fixed 15 s grace under a 60 s group timeout
    would SIGTERM survivors mid-commit-persist and turn a clean restart
    into data loss."""
    return max(base, _detection_window(env) + 5.0)


def _inprocess_rejoin_supported() -> bool:
    """Mirror of ``horovod_tpu_torch.elastic._inprocess_rejoin_supported``:
    ``torch.distributed`` can leave a group (``destroy_process_group``) and
    abort one a dead peer broke (``_abort_process_group``). The driver
    resolves the rejoin mode once, from its own torch (workers share the
    image), and exports it, so driver orchestration and worker behavior
    always agree."""
    try:
        import torch.distributed as dist
        from torch.distributed import distributed_c10d as c10d
    except Exception:  # noqa: BLE001 - a torch without distributed
        return False
    return bool(dist.is_available()
                and callable(getattr(dist, "destroy_process_group", None))
                and callable(getattr(c10d, "_abort_process_group", None)))


STORE_HOST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "store_host.py")


class _GenerationStore:
    """One generation's ``torch.distributed`` TCPStore, served by the job's
    store host (``store_host.py``) on a port the OS picks; ``shutdown``
    takes its generation off the host's ``stores.want`` list."""

    def __init__(self, driver: "ElasticDriver", gen: int, addr: str, port: int):
        self.driver, self.gen, self.addr, self.port = driver, gen, addr, port

    def shutdown(self) -> None:
        self.driver._want_stores(drop=self.gen)


@dataclass
class _Worker:
    worker_id: str
    host: str
    proc: safe_shell_exec.ManagedProcess
    outfiles: Tuple
    done: bool = False
    spawned_at: float = 0.0


def _run_discovery_script(script: str) -> List[Tuple[str, int]]:
    """Run the host-discovery script; parse ``host`` / ``host:slots``
    lines (the upstream contract)."""
    import subprocess

    out = subprocess.run(
        [script], capture_output=True, text=True, timeout=60, check=True
    ).stdout
    hosts: List[Tuple[str, int]] = []
    for line in out.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":" in line:
            name, slots = line.rsplit(":", 1)
            hosts.append((name, int(slots)))
        else:
            hosts.append((line, 1))
    return hosts


class ElasticDriver:
    def __init__(
        self,
        command: List[str],
        min_np: int,
        max_np: int,
        hosts: Optional[List[Tuple[str, int]]] = None,
        discovery_script: Optional[str] = None,
        discovery_interval: float = 1.0,
        env: Optional[Dict[str, str]] = None,
        output_dir: Optional[str] = None,
        verbose: bool = False,
        host_failure_threshold: int = 3,
        ssh_port: Optional[int] = None,
        elastic_timeout: float = 600.0,
        nic_pinned: bool = False,
        probed_hostset: Optional[List[str]] = None,
        blacklist_cooldown: Optional[float] = None,
        resume: bool = False,
        spares: Optional[int] = None,
    ) -> None:
        if not hosts and not discovery_script:
            raise ValueError(
                "elastic mode needs -H/--hostfile or --host-discovery-script"
            )
        self._command = command
        self._min_np = min_np
        self._max_np = max_np
        self._static_hosts = hosts
        self._script = discovery_script
        self._interval = discovery_interval
        self._env = dict(env if env is not None else os.environ)
        self._output_dir = output_dir
        self._verbose = verbose
        self._failure_threshold = host_failure_threshold
        self._ssh_port = ssh_port
        self._elastic_timeout = elastic_timeout
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        # Recovery mode for the whole job: explicit
        # HOROVOD_ELASTIC_REJOIN_MODE wins, else probe whether torch can
        # leave and abort a process group in process. Exported to every
        # worker so both sides agree.
        forced = self._env.get("HOROVOD_ELASTIC_REJOIN_MODE", "").lower()
        if forced == "inprocess" and not _inprocess_rejoin_supported():
            # Honoring the pin would wedge the first re-formation;
            # degrade loudly instead, same policy as
            # elastic.rejoin_mode().
            self._log(
                "HOROVOD_ELASTIC_REJOIN_MODE=inprocess but this torch "
                "cannot abort a process group; falling back to "
                "'respawn'"
            )
            self._rejoin_mode = "respawn"
        elif forced in ("inprocess", "respawn"):
            self._rejoin_mode = forced
        else:
            self._rejoin_mode = (
                "inprocess" if _inprocess_rejoin_supported() else "respawn"
            )
        self._env["HOROVOD_ELASTIC_REJOIN_MODE"] = self._rejoin_mode
        # --- durable control-plane journal (docs/fault_tolerance.md
        # "Control-plane availability"): generation, membership,
        # blacklist, and the rendezvous-critical KV keys are
        # write-ahead-logged so a crashed driver can be resumed
        # (--resume) without losing the fleet. Opening the journal bumps
        # the driver EPOCH — the fencing token workers use to reject a
        # stale driver that lost a supervisor race.
        self._resume = bool(resume)
        self._resume_finished = False
        self._resume_world: Optional[Dict] = None
        jpath = _journal_mod.default_path(self._output_dir, self._env)
        if self._resume and jpath is None:
            raise ValueError(
                "--resume needs --output-dir (or HOROVOD_DRIVER_JOURNAL) "
                "to locate the driver journal"
            )
        self._journal = (
            _journal_mod.DriverJournal.open(jpath) if jpath else None
        )
        self._epoch = self._journal.epoch if self._journal else 1
        prior = self._journal.state if self._journal else {}
        if self._resume:
            if not prior.get("gen"):
                raise ValueError(
                    f"--resume: no resumable driver journal at {jpath}"
                )
            if prior.get("finished"):
                # The job completed before the crash-restart raced in;
                # nothing to resume — run() exits 0 without touching the
                # (long gone) fleet.
                self._resume_finished = True
            self._gen = int(prior.get("gen", 0))
            self._resume_world = prior.get("world")
            sd = prior.get("state_dir")
            if sd:
                # The predecessor's snapshot dir, NOT a fresh pid-keyed
                # one: a fallback respawn must find the fleet's last
                # persisted commits.
                self._env["HOROVOD_ELASTIC_STATE_DIR"] = sd
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_driver_journal_replays_total")
        # Per-host snapshot dir for respawn-mode resume (workers write
        # locally; a slot's respawn lands on the same host). The driver
        # pid keys the path so every generation of the job shares it.
        # Owned only when WE invented the path (pid-keyed tmp dir): a
        # user-provided HOROVOD_ELASTIC_STATE_DIR must survive driver
        # exit, ours must not outlive the pid that keys it.
        self._state_dir_owned = "HOROVOD_ELASTIC_STATE_DIR" not in self._env
        self._env.setdefault(
            "HOROVOD_ELASTIC_STATE_DIR",
            os.path.join(
                tempfile.gettempdir(), f"hvd_elastic_state_{os.getpid()}"
            ),
        )
        if self._resume:
            # Ownership (and the cleanup duty that comes with it)
            # transfers from the crashed predecessor.
            self._state_dir_owned = bool(prior.get("state_dir_owned"))
        # The KV rendezvous server doubles as the metrics endpoint
        # (GET /metrics, docs/metrics.md); HOROVOD_METRICS_PORT pins its
        # port so scrapers have a stable target. A resumed driver MUST
        # reclaim the journal-recorded port — every surviving worker
        # dialed it at spawn — so the bind waits out lingering TIME_WAIT
        # state instead of failing (SO_REUSEADDR + bounded retry).
        try:
            kv_port = int(self._env.get("HOROVOD_METRICS_PORT", "") or 0)
        except ValueError:
            kv_port = 0
        if self._resume and prior.get("kv_port"):
            kv_port = int(prior["kv_port"])
        self._kv = KVStoreServer(
            port=kv_port,
            reclaim_wait_s=10.0 if (self._resume and kv_port) else 0.0,
        )
        # --network-interfaces pin: never ring-probe, the user chose.
        self._nic_pinned = nic_pinned
        # Host set most recently ring-probed for NICs — seeded with the
        # set hvdrun probed at launch so the first reconcile doesn't
        # repeat it; None = never probed.
        self._probed_hostset = (
            sorted(probed_hostset) if probed_hostset else None
        )
        # Per-generation TCPStores as mutable
        # [gen, _GenerationStore, superseded_monotonic|None, window_s];
        # old generations are retired in _retire_services once their
        # drain grace window (two newer generations AND 2x the detection
        # window SINCE BEING SUPERSEDED) has passed.
        self._services: List[list] = []
        self._store_host: Optional[safe_shell_exec.ManagedProcess] = None
        self._last_hosts: List[Tuple[str, int]] = list(hosts or [])
        self._stop_discovery = threading.Event()
        if not self._resume:
            self._gen = 0
        self._workers: Dict[str, _Worker] = {}
        # Control-plane HA bookkeeping: the last published world doc (the
        # journal's authoritative membership record), the driver-doc beat
        # counter, and — after a resume — the adoption state machine for
        # workers that outlived the previous driver (no process handles;
        # supervised via KV attach/done signals and local pid probes).
        self._last_world: Optional[Dict] = None
        self._beat = 0
        self._adopting = bool(self._resume_world) and not self._resume_finished
        self._attached: Dict[str, int] = {}
        self._adopt_deadline: Optional[float] = None
        self._adopt_drain_pids: Optional[set] = None
        self._adopt_drain_deadline = 0.0
        self._driver_faults_fired: set = set()
        self._last_journaled_kv: Optional[Dict[str, str]] = None
        self._started_at = time.monotonic()
        # Workers dropped from the world, draining toward a voluntary
        # exit (they see the new generation and leave cleanly); value is
        # the terminate-anyway deadline.
        self._removing: List[Tuple[_Worker, float]] = []
        self._removal_grace = 15.0
        # Respawn-mode restarts wait for survivors to DETECT the failure
        # (the process group's timeout) before persisting and exiting, so
        # their drain grace scales with that window (see
        # _respawn_drain_grace) rather than reusing the fixed scale-down
        # grace above.
        self._restart_grace = _respawn_drain_grace(
            self._env, self._removal_grace
        )
        self._current_ids: List[str] = []
        # Slots whose worker died (not drained, not removed): a parked
        # spare on the same host takes such a slot's rank in the next
        # generation instead of a fresh spawn (_keep_cards).
        self._dead_slots: set = set()
        self._failures: Dict[str, int] = {}
        self._last_failure: Dict[str, float] = {}
        # Quarantine ledger (upstream's blacklist never forgives; here a
        # host that recovers is re-admitted): host -> readmit deadline
        # (None = permanent, when cooldown == 0). Each re-blacklisting of
        # the same host doubles its quarantine. ``_blacklist_reason``
        # distinguishes WHY a host is out ("dead" = worker failures,
        # "slow" = the StragglerPolicy's slowness quarantine), and the
        # two strike ledgers decay independently: a host that crashes is
        # not presumed slow, and vice versa.
        self._blacklist: Dict[str, Optional[float]] = {}
        self._blacklist_reason: Dict[str, str] = {}
        self._quarantine_strikes: Dict[str, int] = {}
        self._slow_strikes: Dict[str, int] = {}
        if blacklist_cooldown is None:
            try:
                blacklist_cooldown = float(
                    self._env.get("HOROVOD_BLACKLIST_COOLDOWN_S", "") or 300.0
                )
            except ValueError:
                blacklist_cooldown = 300.0
        self._blacklist_cooldown = blacklist_cooldown
        try:
            self._quarantine_cooldown = float(
                self._env.get(_selfdrive.QUARANTINE_COOLDOWN_ENV, "")
                or blacklist_cooldown
            )
        except ValueError:
            self._quarantine_cooldown = blacklist_cooldown
        # --- self-driving fleet: the slowness-quarantine policy over
        # straggler charges, the live re-plan and the hot-spare pool. All
        # three are opt-in (HOROVOD_QUARANTINE_STRIKES / HOROVOD_REPLAN_*
        # unset and --spares 0 keep the driver exactly as before).
        self._policy = _selfdrive.StragglerPolicy.from_env(self._env)
        self._replan_divergence = _selfdrive._env_float(
            self._env, _selfdrive.REPLAN_DIVERGENCE_ENV, 0.0
        )
        self._replan_skew_s = _selfdrive._env_float(
            self._env, _selfdrive.REPLAN_SKEW_ENV, 0.0
        )
        self._replan_check_s = max(_selfdrive._env_float(
            self._env, _selfdrive.REPLAN_CHECK_ENV, 5.0
        ), 0.5)
        self._last_replan_check = 0.0
        self._replan_doc: Optional[Dict] = None
        self._replan_calib_hash: Optional[str] = None
        # Recent per-step cross-rank skews for the trend trigger; one
        # skew-trend re-plan per generation (the deque clears on every
        # publish: fresh world, fresh evidence).
        from collections import deque as _deque

        self._skew_trend: "_deque[float]" = _deque(
            maxlen=max(self._policy.window, 8)
        )
        self._skew_replanned = False
        if spares is None:
            spares = _selfdrive._env_int(
                self._env, _selfdrive.SPARES_ENV, 0
            )
        self._spares_want = max(int(spares), 0)
        self._spares: Dict[str, _Worker] = {}
        self._spare_slots: Dict[str, SlotInfo] = {}
        if self._resume:
            # Quarantines journaled as wall-clock deadlines + remaining
            # budget come back onto THIS process's monotonic clock,
            # skew-clamped (see journal.blacklist_from_journal): healthy
            # hosts are not re-quarantined, active quarantines are not
            # forgotten.
            self._blacklist = _journal_mod.blacklist_from_journal(
                prior.get("blacklist") or {}
            )
            self._blacklist_reason = {
                h: str(r)
                for h, r in (prior.get("blacklist_reasons") or {}).items()
                if h in self._blacklist
            }
            self._quarantine_strikes = {
                h: int(n) for h, n in (prior.get("strikes") or {}).items()
            }
            self._slow_strikes = {
                h: int(n)
                for h, n in (prior.get("slow_strikes") or {}).items()
            }
            self._replan_doc = prior.get("replan") or None
            if self._replan_doc:
                self._replan_calib_hash = self._replan_doc.get("calib")
            self._failures = {
                h: int(n) for h, n in (prior.get("failures") or {}).items()
            }
            self._seed_kv(prior)
            # The predecessor's stores, still served by its store host.
            snap = self._kv.snapshot("elastic")
            for g in json.loads(snap.get("stores.want", b"[]").decode()):
                port = snap.get(f"stores.port.{g}")
                if port:
                    self._services.append([
                        int(g), _GenerationStore(self, int(g), "", int(port)),
                        time.monotonic(), _detection_window(self._env)])
            if self._replan_doc:
                # The journaled notice survives the resume, but workers
                # reject any epoch below their fencing baseline — which
                # just rose to THIS incarnation's. Refresh the stamp
                # (same id: already-adopted workers keep their config,
                # not-yet-adopted ones accept now).
                self._replan_doc = dict(self._replan_doc)
                self._replan_doc["epoch"] = self._epoch
                self._kv.put(
                    "elastic", "replan",
                    json.dumps(self._replan_doc, sort_keys=True).encode(),
                )
        self._finishing = False
        # Respawn mode: a world restart is queued behind the drain pool.
        self._restart_pending = False
        # One-shot ledger for fault-plan preemption notices.
        self._preempts_fired: set = set()
        # Deterministic fault injection (docs/fault_tolerance.md): the
        # injector armed itself from HOROVOD_FAULT_PLAN at import. The
        # driver owns the canonical artifacts: the resolved schedule
        # (byte-for-byte reproducible for a seed) and its own event log.
        # Neither path is exported to workers — self._env was snapshotted
        # above, so worker processes log to their own files only if the
        # user pointed them somewhere.
        plan = _fault.active_plan()
        if plan is not None and self._output_dir:
            sched_path = os.path.join(self._output_dir, "fault_schedule.json")
            try:
                with open(sched_path, "w") as f:
                    f.write(plan.canonical_schedule())
            except OSError:
                pass
            os.environ.setdefault(
                _fault.FAULT_EVENT_LOG_ENV,
                os.path.join(self._output_dir, "fault_events.driver.jsonl"),
            )
            self._log(f"fault plan armed (seed {plan.seed}): {sched_path}")
        # Fleet tracing (docs/timeline.md "Fleet tracing"): the driver
        # collects worker-pushed span windows off the KV plane, persists
        # them (+ its own elastic/HA events) next to the worker logs for
        # tools/trace_merge.py, and attributes per-step stragglers into
        # hvd_step_skew_seconds / hvd_straggler_total{rank}.
        self._trace_dir: Optional[str] = None
        self._skew = None
        if _trace.ACTIVE and self._output_dir:
            self._trace_dir = (
                self._env.get(_trace.TRACE_DIR_ENV, "")
                or os.path.join(self._output_dir, "trace")
            )
            os.makedirs(self._trace_dir, exist_ok=True)
            # Workers inherit the dir so flight-recorder dumps land
            # where the postmortem collection can find them (same-host
            # jobs; remote hosts keep their dumps locally).
            self._env.setdefault(_trace.TRACE_DIR_ENV, self._trace_dir)
            os.environ.setdefault(_trace.TRACE_DIR_ENV, self._trace_dir)
            from ..trace.pusher import StepSkewTracker

            self._skew = StepSkewTracker()
            self._trace_event(
                "hvd_driver_start",
                resume=bool(self._resume), epoch=self._epoch,
            )
            self._log(f"fleet trace: collecting into {self._trace_dir}")
        if _metrics.ACTIVE:
            _metrics.TAP.set("hvd_driver_epoch", float(self._epoch))
        if self._journal is not None:
            self._journal_sync(force=True)
            self._log(
                f"driver journal: {self._journal.path} "
                f"(epoch {self._epoch})"
            )
        self._log(f"rejoin mode: {self._rejoin_mode}")

    # ------------------------------------------------------------ pieces
    def _trace_event(self, name: str, **args) -> None:
        """One driver-lane fleet-trace event (generation publishes,
        blacklists, failures, straggler attributions) — rendered on the
        driver's own lane by tools/trace_merge.py. No-op when tracing is
        disabled."""
        if _trace.ACTIVE:
            _trace.TAP.event(name, cat="driver", **args)

    def _trace_collect(self, final: bool = False) -> None:
        """Collect worker-pushed trace windows off the KV plane: persist
        each rank's freshest window (and the driver's own lane) into the
        trace directory, and feed per-step end times into the straggler
        attribution. Runs on the supervision-loop beat; ``final`` also
        bundles surviving flight-recorder dumps."""
        if self._trace_dir is None:
            return
        from ..trace import pusher as _tpush
        from ..utils.checkpoint import _atomic_write

        windows: Dict[int, dict] = {}
        for key, payload in self._kv.snapshot(_trace.KV_SCOPE).items():
            if not key.startswith("rank."):
                continue
            suffix = key.split(".", 1)[1]
            if not suffix.isdigit():
                continue
            doc = _tpush.decode_window(payload)
            if doc is None:
                continue
            rank = int(suffix)
            windows[rank] = doc
            data = json.dumps(doc, sort_keys=True).encode()
            try:
                _atomic_write(
                    os.path.join(self._trace_dir, f"rank.{rank}.json"),
                    lambda f, d=data: f.write(d),
                )
            except OSError:
                pass
        if windows and _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_trace_collections_total")
        if self._skew is not None:
            for idx, skew, worst in self._skew.update(windows):
                charged = skew >= self._skew.threshold_s
                if _metrics.ACTIVE:
                    _metrics.TAP.observe("hvd_step_skew_seconds", skew)
                if charged:
                    if _metrics.ACTIVE:
                        _metrics.TAP.inc(
                            "hvd_straggler_total", rank=str(worst)
                        )
                    self._trace_event(
                        "hvd_straggler", step=idx, rank=worst,
                        skew_s=round(skew, 6),
                    )
                # Feed the self-driving quarantine policy: every emitted
                # step (charged or not) advances its sliding window, so
                # a rank that recovers decays out. The same emission feeds
                # the re-plan's skew-trend window.
                if self._policy.enabled:
                    self._policy.observe(idx, skew, worst, charged)
                self._skew_trend.append(skew)
        try:
            data = json.dumps(
                _trace.TAP.window(), sort_keys=True
            ).encode()
            _atomic_write(
                os.path.join(self._trace_dir, "driver.json"),
                lambda f: f.write(data),
            )
        except OSError:
            pass
        if final:
            self._collect_postmortem()

    def _collect_postmortem(self) -> None:
        """Bundle surviving per-rank flight-recorder dumps into
        ``postmortem.json`` — the artifact ``tools/trace_merge.py
        --postmortem`` renders as "the last N seconds before death, all
        ranks, aligned"."""
        import re as _re

        try:
            names = sorted(os.listdir(self._trace_dir))
        except OSError:
            return
        dumps = []
        for fn in names:
            if not _re.fullmatch(r"flight\.rank\d+\.json", fn):
                continue
            try:
                with open(os.path.join(self._trace_dir, fn)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(doc, dict):
                dumps.append(doc)
        if not dumps:
            return
        from ..utils.checkpoint import _atomic_write

        bundle = json.dumps(
            {"schema": 1, "collected_at": time.time(), "dumps": dumps},
            sort_keys=True,
        ).encode()
        try:
            _atomic_write(
                os.path.join(self._trace_dir, "postmortem.json"),
                lambda f: f.write(bundle),
            )
        except OSError:
            return
        self._log(
            f"fleet trace: collected {len(dumps)} flight-recorder "
            "dump(s) into postmortem.json"
        )

    def _log(self, msg: str) -> None:
        line = f"[hvdrun elastic] {msg}"
        print(line, file=sys.stderr, flush=True)
        # Postmortem artifact: with --output-dir, the generation history
        # (publishes, failures, blacklists, drains) persists next to the
        # per-worker logs instead of living only on the driver's stderr.
        # (Dir is created once in __init__; logging must never kill the
        # driver, hence the silent OSError.)
        if self._output_dir:
            try:
                with open(os.path.join(self._output_dir, "driver.log"),
                          "a") as f:
                    f.write(time.strftime("%H:%M:%S ") + line + "\n")
            except OSError:
                pass

    # ------------------------------------------------ control-plane HA
    def _journal_sync(self, force: bool = False) -> None:
        """Write-ahead journal the full control-plane state (atomic
        tmp+fsync+replace). Called with ``force`` at every driver-owned
        transition (publish, blacklist change, resume) and periodically
        from the supervision loop to pick up worker-written KV drift
        (``joined.*``/``rejoin.*`` signals); the periodic path only
        writes when the rendezvous scope actually changed."""
        # getattr: unit tests build bare drivers (__new__) around the
        # blacklist methods without the journal plumbing.
        if getattr(self, "_journal", None) is None:
            return
        kv_snap = {
            k: v.decode("utf-8", "replace")
            for k, v in self._kv.snapshot("elastic").items()
            # The driver doc's beat changes every second and is
            # re-derived on resume anyway — journaling it would turn the
            # change-detection below into an every-second rewrite.
            if k != "driver"
        }
        if not force and kv_snap == self._last_journaled_kv:
            return
        # DriverJournal.open carries prior state — including a completed
        # predecessor's finished=True — forward; every live sync must
        # overwrite it or a fresh job reusing the output dir would look
        # "finished" to --resume after a crash (and --auto-resume would
        # report success over an abandoned fleet). The one exception is
        # the finished-journal resume short-circuit, which must stay
        # finished so repeat resumes keep exiting 0 without touching the
        # (long gone) fleet. getattr: bare __new__ test drivers again.
        self._journal.record(
            finished=bool(getattr(self, "_resume_finished", False)),
            epoch=self._epoch,
            gen=self._gen,
            kv_port=self._kv.port,
            rejoin_mode=self._rejoin_mode,
            state_dir=self._env["HOROVOD_ELASTIC_STATE_DIR"],
            state_dir_owned=self._state_dir_owned,
            world=self._last_world,
            current_ids=list(self._current_ids),
            kv=kv_snap,
            blacklist=_journal_mod.blacklist_to_journal(self._blacklist),
            blacklist_reasons=dict(self._blacklist_reason),
            strikes=dict(self._quarantine_strikes),
            slow_strikes=dict(self._slow_strikes),
            replan=self._replan_doc,
            spare_ids=sorted(self._spares),
            failures=dict(self._failures),
        )
        self._last_journaled_kv = kv_snap
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_driver_journal_writes_total")

    def _seed_kv(self, prior: Dict) -> None:
        """Reload the journal's rendezvous-critical keys into the fresh
        KV store. ``attach.*`` signals are per-epoch (workers must
        re-register under the NEW epoch) and the ``world``/``driver``
        docs are re-stamped with it, so those are excluded/rewritten;
        everything else (``joined.*`` sync-root eligibility, pending
        ``rejoin.*``/``done.*`` signals) replays verbatim."""
        for k, v in (prior.get("kv") or {}).items():
            if k in ("world", "driver") or k.startswith("attach."):
                continue
            self._kv.put("elastic", k, v.encode())

    def _publish_driver_doc(self) -> None:
        """Advertise this driver's identity on the KV plane: the epoch
        (fencing token — workers reject anything lower than they have
        seen) plus the current generation and a liveness beat."""
        self._beat += 1
        self._kv.put(
            "elastic", "driver",
            json.dumps({
                "epoch": self._epoch,
                "gen": self._gen,
                "beat": self._beat,
            }).encode(),
        )

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except OSError:
            pass  # e.g. EPERM: exists but not ours
        try:
            # An exited process whose parent has not reaped it is not alive.
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except (OSError, IndexError):
            return True

    def _enter_adoption(self) -> None:
        """Resume path: re-enter the elastic loop at the journaled
        generation and ADOPT the surviving fleet instead of respawning
        it. The generation's TCPStore died with the old driver (it is
        hosted here in both modes), while the workers' process groups,
        formed at ``init``, need nothing more from it. In in-process mode
        a FRESH generation (a new store) is published and the parked
        survivors re-form through it with their committed state, a rejoin
        and never a respawn of live processes. In respawn mode, which
        cannot re-form in process, the recorded world is republished AS
        IS (same generation, new epoch) and the parked workers reattach
        in place; a worker whose group does fail exits for respawn and
        the adoption degrades to a restart from the persisted
        snapshots."""
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_driver_restarts_total")
            _metrics.TAP.set("hvd_driver_epoch", float(self._epoch))
        if self._rejoin_mode == "respawn":
            world = dict(self._resume_world)
            world["epoch"] = self._epoch
            self._last_world = world
            self._current_ids = list(world.get("assignments", {}))
            self._journal_sync(force=True)  # WAL before workers can see it
            self._kv.put("elastic", "world", json.dumps(world).encode())
            if _metrics.ACTIVE:
                _metrics.TAP.set(
                    "hvd_elastic_generation", float(self._gen)
                )
                _metrics.TAP.set(
                    "hvd_elastic_world_size",
                    float(len(self._current_ids)),
                )
        else:
            slots = self._slots_from_world(self._resume_world)
            self._publish(slots)  # gen+1, a fresh store
            self._current_ids = [self._worker_id(s) for s in slots]
        self._publish_driver_doc()
        self._adopt_deadline = time.monotonic() + max(
            30.0, self._restart_grace
        )
        if _fault.ACTIVE:
            _fault.record_event(
                "driver", 1, "resume",
                f"gen={self._gen} epoch={self._epoch}",
            )
        self._log(
            f"resumed at generation {self._gen} (epoch {self._epoch}); "
            f"awaiting reattach of {sorted(self._current_ids)}"
        )

    @staticmethod
    def _slots_from_world(world: Dict) -> List[SlotInfo]:
        """Rebuild the slot allocation from a journaled world doc (the
        in-process resume path needs real slots to publish fresh
        endpoints for)."""
        slots = []
        for wid, a in (world.get("assignments") or {}).items():
            host = wid.rsplit(":", 1)[0]
            slots.append(SlotInfo(
                hostname=host,
                rank=int(a["rank"]),
                size=int(world.get("size", len(world["assignments"]))),
                local_rank=int(a["local_rank"]),
                local_size=int(a["local_size"]),
                cross_rank=int(a["cross_rank"]),
                cross_size=int(a["cross_size"]),
            ))
        slots.sort(key=lambda s: s.rank)
        return slots

    def _poll_adopted(self) -> Optional[int]:
        """Supervise adopted workers (no process handles — the previous
        driver owned those): reattach via ``attach.<wid>`` KV signals
        stamped with this epoch, completion via ``done.<wid>``, failure
        via ``rejoin.<wid>`` signals, local pid probes, and the
        reattach grace deadline. Returns an exit code when the job is
        finished, else None."""
        snap = self._kv.snapshot("elastic")
        gen_s = str(self._gen)
        for wid in self._current_ids:
            if wid in self._attached:
                continue
            raw = snap.get(f"attach.{wid}")
            if not raw:
                continue
            try:
                a_gen, a_epoch, a_pid = raw.decode().split(":")
            except ValueError:
                continue
            if a_gen == gen_s and int(a_epoch) == self._epoch:
                self._attached[wid] = int(a_pid)
                if _metrics.ACTIVE:
                    _metrics.TAP.inc("hvd_driver_worker_reattaches_total")
                self._log(
                    f"worker {wid} reattached "
                    f"(pid {a_pid}, epoch {self._epoch})"
                )
        done = {
            wid for wid in self._current_ids
            if (snap.get(f"done.{wid}") or b"").decode() == gen_s
        }
        if self._current_ids and done >= set(self._current_ids):
            self._log("all adopted workers completed; job finished")
            return 0
        if any(
            k.startswith("rejoin.") and v.decode() == gen_s
            for k, v in snap.items()
        ):
            self._abandon_adoption(
                "a worker abandoned the adopted generation"
            )
            return None
        dead = [
            wid for wid, pid in self._attached.items()
            if wid not in done and _is_local(wid.rsplit(":", 1)[0])
            and not self._pid_alive(pid)
        ]
        if dead:
            for wid in dead:
                self._record_failure(wid.rsplit(":", 1)[0])
                self._log(f"adopted worker {wid} died")
            self._abandon_adoption(f"adopted workers died: {dead}")
            return None
        if (len(self._attached) < len(self._current_ids)
                and self._adopt_deadline is not None
                and time.monotonic() > self._adopt_deadline):
            missing = sorted(
                set(self._current_ids) - set(self._attached)
            )
            self._abandon_adoption(
                f"workers never reattached within grace: {missing}"
            )
        return None

    def _abandon_adoption(self, why: str) -> None:
        """Adoption failed (a worker died while the driver was down, or
        survivors never reattached): degrade to the existing
        respawn-from-snapshots restart. Attached workers get a SIGTERM
        (their graceful-preemption path persists the last commit) and a
        drain window before the fresh generation is published, so their
        snapshots land before the replacements read them."""
        self._log(
            f"adoption abandoned: {why}; restarting the world from "
            "persisted snapshots"
        )
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_elastic_restarts_total")
        drain = set()
        for wid, pid in self._attached.items():
            if not _is_local(wid.rsplit(":", 1)[0]):
                continue
            if self._pid_alive(pid):
                try:
                    os.kill(pid, signal.SIGTERM)
                    drain.add(pid)
                except OSError:
                    pass
        self._adopting = False
        self._attached = {}
        self._current_ids = []
        self._adopt_drain_pids = drain
        self._adopt_drain_deadline = time.monotonic() + self._restart_grace
        self._journal_sync(force=True)

    def _maybe_fire_driver_faults(self) -> None:
        """Scheduled control-plane faults (docs/fault_tolerance.md):
        ``kill_driver`` hard-exits this process ``after_s`` seconds into
        the run (resume via ``--resume``/supervisor); ``restart_driver``
        runs the full crash-restart cycle in-process. Both fire once,
        and only in the driver incarnation the action's ``epoch``
        selector names (default: the first), so a resumed driver never
        replays its own death."""
        plan = _fault.active_plan()
        if plan is None:
            return
        now = time.monotonic()
        for action in plan.actions:
            if action.kind not in DRIVER_KINDS or action.after_s is None:
                continue
            if not action.matches_driver_epoch(self._epoch):
                continue
            if action.gen is not None and action.gen != self._gen:
                continue
            if action.index in self._driver_faults_fired:
                continue
            if now - self._started_at < action.after_s:
                continue
            self._driver_faults_fired.add(action.index)
            _fault.record_event(
                "driver", 1, action.kind,
                f"gen={self._gen} epoch={self._epoch}",
            )
            if action.kind == "kill_driver":
                self._log(
                    "fault plan: killing driver "
                    f"(exit {action.exit_code}) at unix {time.time():.3f}"
                )
                sys.stderr.flush()
                os._exit(action.exit_code)
            else:
                self._simulated_restart()

    def _simulated_restart(self) -> None:
        """The ``restart_driver`` fault: a full crash-restart cycle
        without process death — KV blackout (workers observe driver
        loss and park), journal replay as a fresh driver would perform
        it, epoch bump, rendezvous-port reclaim, republish. Exercises
        every resume mechanism a real ``--resume`` uses, in one
        process, deterministically."""
        if self._journal is None:
            self._log(
                "restart_driver fault ignored: journaling disabled "
                "(no --output-dir and no HOROVOD_DRIVER_JOURNAL)"
            )
            return
        self._log("fault plan: simulating driver crash-restart")
        port = self._kv.port
        self._journal_sync(force=True)
        self._kv.stop()
        try:
            blackout = float(self._env.get(
                "HOROVOD_FAULT_DRIVER_BLACKOUT_S", "") or 3.0)
        except ValueError:
            blackout = 3.0
        time.sleep(blackout)
        self._journal = _journal_mod.DriverJournal.open(self._journal.path)
        prior = self._journal.state
        self._epoch = self._journal.epoch
        self._gen = int(prior.get("gen", self._gen))
        self._blacklist = _journal_mod.blacklist_from_journal(
            prior.get("blacklist") or {}
        )
        self._quarantine_strikes = {
            h: int(n) for h, n in (prior.get("strikes") or {}).items()
        }
        self._slow_strikes = {
            h: int(n) for h, n in (prior.get("slow_strikes") or {}).items()
        }
        self._blacklist_reason = {
            h: str(r)
            for h, r in (prior.get("blacklist_reasons") or {}).items()
            if h in self._blacklist
        }
        self._replan_doc = prior.get("replan") or None
        if self._replan_doc:
            self._replan_calib_hash = self._replan_doc.get("calib")
        self._failures = {
            h: int(n) for h, n in (prior.get("failures") or {}).items()
        }
        self._kv = KVStoreServer(port=port, reclaim_wait_s=10.0)
        self._kv.start()
        self._seed_kv(prior)
        if self._replan_doc:
            # Same epoch refresh as a real --resume (see __init__).
            self._replan_doc = dict(self._replan_doc)
            self._replan_doc["epoch"] = self._epoch
            self._kv.put(
                "elastic", "replan",
                json.dumps(self._replan_doc, sort_keys=True).encode(),
            )
        world = prior.get("world")
        if world:
            world = dict(world)
            world["epoch"] = self._epoch
            self._last_world = world
            self._kv.put("elastic", "world", json.dumps(world).encode())
        self._publish_driver_doc()
        self._journal_sync(force=True)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_driver_restarts_total")
            _metrics.TAP.inc("hvd_driver_journal_replays_total")
            _metrics.TAP.set("hvd_driver_epoch", float(self._epoch))
        self._log(
            f"driver resumed in-process at generation {self._gen} "
            f"(epoch {self._epoch})"
        )

    def _discovery_loop(self) -> None:
        """Background discovery poller (upstream ElasticDriver runs its
        HostDiscovery on a thread for the same reason): a slow or hung
        discovery script must not stall worker reaping, drain-grace
        enforcement, or generation publishing. The supervision loop only
        ever reads the latest snapshot."""
        while not self._stop_discovery.is_set():
            try:
                self._last_hosts = _run_discovery_script(self._script)
            except Exception as exc:  # noqa: BLE001 - transient failure
                # A flaky discovery script must not take down a healthy
                # job: keep the last known host set and retry next poll.
                self._log(
                    f"host discovery failed ({exc}); keeping last known "
                    f"host set"
                )
            self._stop_discovery.wait(self._interval)

    def _expire_blacklist(self) -> None:
        """Re-admit hosts whose quarantine elapsed. The failure count is
        cleared — the host earned a fresh chance — but its strike count
        persists, so a relapse quarantines it for twice as long."""
        now = time.monotonic()
        changed = False
        for host, deadline in list(self._blacklist.items()):
            if deadline is not None and now >= deadline:
                del self._blacklist[host]
                reason = self._blacklist_reason.pop(host, "dead")
                self._failures.pop(host, None)
                self._last_failure.pop(host, None)
                changed = True
                if _metrics.ACTIVE:
                    _metrics.TAP.inc(
                        "hvd_elastic_readmissions_total", host=host
                    )
                strikes = (
                    self._slow_strikes if reason == "slow"
                    else self._quarantine_strikes
                )
                self._log(
                    f"re-admitting host {host} after {reason} quarantine "
                    f"(strike {strikes.get(host, 1)})"
                )
        if changed:
            self._journal_sync(force=True)

    def _record_failure(self, host: str) -> int:
        """Count one worker failure against ``host``, with decay: a count
        that has been quiet for a full cooldown window is forgiven before
        the new failure lands (old flakiness must not compound with a
        fresh, unrelated incident months later)."""
        now = time.monotonic()
        last = self._last_failure.get(host)
        if (last is not None and self._blacklist_cooldown > 0
                and now - last > self._blacklist_cooldown):
            self._failures[host] = 0
        self._failures[host] = self._failures.get(host, 0) + 1
        self._last_failure[host] = now
        if _metrics.ACTIVE:
            _metrics.TAP.inc(
                "hvd_elastic_worker_failures_total", host=host
            )
        self._journal_sync(force=True)
        return self._failures[host]

    def _blacklist_host(self, host: str) -> None:
        strikes = self._quarantine_strikes.get(host, 0) + 1
        self._quarantine_strikes[host] = strikes
        self._blacklist_reason[host] = "dead"
        self._trace_event("hvd_blacklist", host=host, strikes=strikes)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_elastic_blacklists_total", host=host)
            _metrics.TAP.inc("hvd_quarantine_total", reason="dead")
        if self._blacklist_cooldown > 0:
            quarantine = self._blacklist_cooldown * (2 ** (strikes - 1))
            self._blacklist[host] = time.monotonic() + quarantine
            self._log(
                f"blacklisted host {host} (strike {strikes}; quarantined "
                f"for {quarantine:g}s)"
            )
        else:
            self._blacklist[host] = None
            self._log(f"blacklisted host {host} (permanently)")
        self._journal_sync(force=True)

    # ---------------------------------------------- self-driving fleet
    def _quarantine_slow_host(
        self, decision: "_selfdrive.QuarantineDecision"
    ) -> None:
        """Quarantine ``decision.host`` for SLOWNESS: same cooldown/
        decay/relapse-doubling machinery as the death blacklist, but on
        the independent ``reason="slow"`` strike ledger — a chronically
        slow host's sentence doubles per slowness relapse without its
        crash history compounding it (and vice versa). Write-ahead
        journaled BEFORE the membership change can publish, so a driver
        crash between decision and publish resumes into the same
        verdict."""
        host = decision.host
        strikes = self._slow_strikes.get(host, 0) + 1
        self._slow_strikes[host] = strikes
        self._blacklist_reason[host] = "slow"
        self._trace_event(
            "hvd_quarantine", host=host, rank=decision.rank,
            strikes=strikes, charges=decision.charges,
            window=decision.window, reason="slow",
        )
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_quarantine_total", reason="slow")
        if self._quarantine_cooldown > 0:
            quarantine = self._quarantine_cooldown * (2 ** (strikes - 1))
            self._blacklist[host] = time.monotonic() + quarantine
            until = f"quarantined for {quarantine:g}s"
        else:
            self._blacklist[host] = None
            until = "quarantined permanently"
        if _fault.ACTIVE:
            # Detail carries only run-invariant fields: the charge count
            # at decision time depends on collection batching, so it
            # stays out of the byte-diffed event log (it is in the
            # driver log and the trace event above).
            _fault.record_event(
                "driver", strikes, "quarantine",
                f"host={host} reason=slow",
            )
        self._log(
            f"slowness quarantine: host {host} (rank {decision.rank} "
            f"charged straggler {decision.charges} of the last "
            f"{decision.window} steps; slow-strike {strikes}; {until}); "
            "re-forming the world without it"
        )
        self._journal_sync(force=True)  # WAL before the publish below

    def _maybe_quarantine_slow(self) -> bool:
        """Run the StragglerPolicy against the current world: at most
        one host per supervision beat, never below --min-np, only ranks
        of the CURRENT generation (the policy re-keys on every publish).
        Returns True when membership changed (caller reconciles)."""
        if not self._policy.enabled or self._adopting:
            return False
        world = self._last_world or {}
        rank_to_host = {
            int(a["rank"]): wid.rsplit(":", 1)[0]
            for wid, a in (world.get("assignments") or {}).items()
        }
        # The min-world veto counts AVAILABLE capacity (discovery minus
        # already-blacklisted hosts) — hot spares and unused slots on
        # healthy hosts are exactly what makes a quarantine affordable.
        slots_by_host = dict(self._discover())
        decision = self._policy.decide(
            rank_to_host, slots_by_host, self._min_np
        )
        if decision is None:
            return False
        if decision.host in self._blacklist:
            return False
        self._quarantine_slow_host(decision)
        return True

    def _maybe_replan(self) -> None:
        """Live re-plan check on the supervision beat, with two
        triggers: (a) the calibrated per-hop constants
        (HOROVOD_CALIBRATION_FILE — the artifact ``tools/fleet_sim.py
        --calibrate`` fits and ``--replay`` diffs) drift from the
        generation defaults beyond ``HOROVOD_REPLAN_DIVERGENCE``
        (one-shot per calibration signature), or (b) the
        ``StepSkewTracker`` trend — mean cross-rank skew over the
        recent window — stays above ``HOROVOD_REPLAN_SKEW_S`` (one-shot
        per generation). Either way the tuner's free objectives are
        re-priced on the best-available model, every implied plan is
        verified symbolically, the notice is journaled (WAL) and then
        published under ``elastic/replan`` for workers to adopt at
        their next commit boundary."""
        if self._adopting or (self._replan_divergence <= 0
                              and self._replan_skew_s <= 0):
            return
        now = time.monotonic()
        if now - self._last_replan_check < self._replan_check_s:
            return
        self._last_replan_check = now
        if not self._last_world:
            return
        try:
            from ..sim.calibrate import resolve_calibration

            calib = resolve_calibration(None)
        except Exception:  # noqa: BLE001 - a bad file must not kill the loop
            calib = None
        model = _selfdrive.model_for_world(self._last_world)
        trigger = None
        per_hop: Dict[str, float] = {}
        drift = 0.0
        priced_calib = None
        if (self._replan_divergence > 0 and calib is not None
                and calib.signature_hash != self._replan_calib_hash):
            from ..tune.objective import calibrated_model

            drifted, info = calibrated_model(
                model, calib, where="driver-replan"
            )
            if info.get("stale"):
                # Signature mismatch already warned loudly; don't retry
                # every beat against the same stale file.
                self._replan_calib_hash = calib.signature_hash
            else:
                ratios = _selfdrive.divergence_ratios(model, drifted)
                d = _selfdrive.max_divergence(ratios)
                if d >= self._replan_divergence:
                    trigger, per_hop, drift = "divergence", ratios, d
                    priced_calib = calib
                else:
                    self._replan_calib_hash = calib.signature_hash
        if (trigger is None and self._replan_skew_s > 0
                and not self._skew_replanned):
            trend = _selfdrive.skew_trend(self._skew_trend)
            if trend is not None and trend >= self._replan_skew_s:
                trigger, drift = "skew-trend", trend
                priced_calib = calib  # best available; None = defaults
        if trigger is None:
            return
        windows = {
            r: doc for r, doc in self._collected_windows().items()
        }
        try:
            spec = _selfdrive.spec_from_windows(windows)
        except Exception as exc:  # noqa: BLE001 - malformed override
            self._log(f"re-plan: unusable program spec ({exc}); skipping")
            if trigger == "divergence":
                self._replan_calib_hash = calib.signature_hash
            else:
                self._skew_replanned = True
            return
        if spec is None:
            return  # nothing observed to price yet; retry next beat
        current = dict(
            (self._replan_doc or {}).get("config") or {}
        ) or self._current_plan_config(windows)
        proposal = _selfdrive.propose_replan(
            spec, model, current, priced_calib,
            trigger=trigger, per_hop=per_hop, drift=drift,
        )
        if trigger == "divergence":
            self._replan_calib_hash = calib.signature_hash
        else:
            self._skew_replanned = True
        if proposal is None:
            self._log(
                f"re-plan ({trigger}, drift {drift:g}): the current "
                "configuration is already optimal on the observed "
                "model; keeping it"
            )
            return
        findings = _selfdrive.verify_replan(
            spec, proposal.config, model, priced_calib
        )
        if findings:
            self._log(
                f"re-plan REFUSED: {len(findings)} plan-verification "
                f"finding(s) on the proposed configuration "
                f"({findings[0].render() if findings else ''})"
            )
            if _metrics.ACTIVE:
                _metrics.TAP.inc(
                    "hvd_replan_total", trigger="refused-verification"
                )
            return
        notice_id = int((self._replan_doc or {}).get("id", 0)) + 1
        doc = proposal.to_notice(notice_id, self._gen, self._epoch)
        doc["calib"] = (
            priced_calib.signature_hash if priced_calib is not None
            else None
        )
        self._replan_doc = doc
        self._journal_sync(force=True)  # WAL before workers can see it
        self._kv.put(
            "elastic", "replan",
            json.dumps(doc, sort_keys=True).encode(),
        )
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_replan_total", trigger=proposal.trigger)
        self._trace_event(
            "hvd_replan", id=notice_id, trigger=proposal.trigger,
            drift=round(drift, 6), config=dict(proposal.config),
        )
        if _fault.ACTIVE:
            _fault.record_event(
                "driver", notice_id, "replan",
                f"trigger={proposal.trigger} "
                f"wire={proposal.config['wire_dtype']} "
                f"topo={proposal.config['topo_algorithm']}",
            )
        self._log(
            f"re-plan #{notice_id} published (trigger "
            f"{proposal.trigger}, drift {drift:g}): "
            f"{proposal.current} -> {proposal.config}; modeled exposed "
            f"{proposal.current_exposed_us:g}us -> "
            f"{proposal.replanned_exposed_us:g}us"
        )

    def _collected_windows(self) -> Dict[int, dict]:
        """Freshest worker trace windows off the KV plane (current
        generation only — stale-generation windows carry renumbered
        ranks)."""
        from ..trace import pusher as _tpush

        out: Dict[int, dict] = {}
        for key, payload in self._kv.snapshot(_trace.KV_SCOPE).items():
            if not key.startswith("rank."):
                continue
            suffix = key.split(".", 1)[1]
            if not suffix.isdigit():
                continue
            doc = _tpush.decode_window(payload)
            if doc is None:
                continue
            if int(doc.get("gen", 0) or 0) not in (0, self._gen):
                continue
            out[int(suffix)] = doc
        return out

    def _current_plan_config(self, windows: Dict[int, dict]) -> Dict:
        """The fleet's current lowering knobs as the workers reported
        them (trace-tap ``note_plan`` correlation ids); absent fields
        fall back to env/config defaults inside the policy layer."""
        cfg: Dict = {}
        for _, doc in sorted(windows.items()):
            plan = doc.get("plan") or {}
            for src, dst in (("topo_algorithm", "topo_algorithm"),
                             ("wire_dtype", "wire_dtype")):
                if plan.get(src) and dst not in cfg:
                    cfg[dst] = plan[src]
        return cfg

    def _discover(self) -> List[Tuple[str, int]]:
        self._expire_blacklist()
        if _metrics.ACTIVE:
            _metrics.TAP.set(
                "hvd_elastic_blacklisted_hosts", float(len(self._blacklist))
            )
        hosts = (
            self._last_hosts if self._script
            else list(self._static_hosts or [])
        )
        return [(h, c) for h, c in hosts if h not in self._blacklist]

    def _desired_slots(self) -> Optional[List[SlotInfo]]:
        """Allocation over currently-available, non-blacklisted hosts;
        None when below min_np."""
        hosts = self._discover()
        total = sum(c for _, c in hosts)
        if total < self._min_np:
            return None
        return self._keep_cards(launcher.allocate(hosts, min(total, self._max_np)))

    def _keep_cards(self, slots: List[SlotInfo]) -> List[SlotInfo]:
        """Hand a dead slot's rank to a parked spare on the same host, in
        the same generation bump, instead of a fresh spawn (the
        ``--spares`` contract: a quarantine OR a death promotes one). A
        slot is ``host:local_rank`` and keeps its local rank, so the
        spare keeps its own card: the world's local ranks may then skip
        the dead slot's, and a host's ``local_size`` is its highest local
        rank + 1, so every local rank stays below it. In respawn mode the
        swap waits for the post-drain restart, as promotion does."""
        if not self._dead_slots or (self._rejoin_mode == "respawn" and self._workers):
            return slots
        parked = [wid for wid, w in self._spares.items() if w.proc.poll() is None]
        chosen = {self._worker_id(s) for s in slots}
        cards = [(s.hostname, s.local_rank) for s in slots]
        for i, s in enumerate(slots):
            wid = self._worker_id(s)
            if wid not in self._dead_slots:
                continue
            spare = next((x for x in parked if x.rsplit(":", 1)[0] == s.hostname
                          and x not in chosen), None)
            if spare is None:
                continue
            chosen.discard(wid)
            chosen.add(spare)
            cards[i] = (s.hostname, int(spare.rsplit(":", 1)[1]))
        if cards == [(s.hostname, s.local_rank) for s in slots]:
            return slots
        local_size: Dict[str, int] = {}
        for host, card in cards:
            local_size[host] = max(local_size.get(host, 0), card + 1)
        cross: Dict[int, List[int]] = {}
        for rank, (_, card) in enumerate(cards):
            cross.setdefault(card, []).append(rank)
        return [SlotInfo(hostname=host, rank=rank, size=len(cards), local_rank=card,
                         local_size=local_size[host], cross_rank=cross[card].index(rank),
                         cross_size=len(cross[card]))
                for rank, (host, card) in enumerate(cards)]

    @staticmethod
    def _worker_id(slot: SlotInfo) -> str:
        return f"{slot.hostname}:{slot.local_rank}"

    def _ensure_store_host(self) -> int:
        """The job's store host (``store_host.py``), started once, in a
        session of its own so that it outlives this driver; a resumed
        driver adopts the one its predecessor started (its pid is on the
        KV plane, ``stores.host``)."""
        raw = self._kv.snapshot("elastic").get("stores.host")
        if raw and self._pid_alive(int(raw)):
            return int(raw)
        env = {k: v for k, v in self._env.items()
               if not k.startswith(("HOROVOD_", "MASTER_", "TORCHELASTIC_"))}
        # Not the driver's own output: a pipe the driver's caller reads
        # must close when the driver dies.
        log = open(os.path.join(self._output_dir, "store_host.log") if self._output_dir
                   else os.devnull, "ab")
        try:
            host = safe_shell_exec.ManagedProcess(
                [sys.executable, STORE_HOST, "127.0.0.1", str(self._kv.port),
                 str(self._elastic_timeout)], env=env, stdout=log, stderr=log)
        finally:
            log.close()
        self._store_host = host
        self._kv.put("elastic", "stores.host", str(host.pid).encode())
        return host.pid

    def _stop_store_host(self) -> None:
        """The job ended: the store host drops its stores and exits (it
        polls ``stores.done``), or is terminated after a grace."""
        raw = self._kv.snapshot("elastic").get("stores.host")
        if not raw:
            return
        pid = int(raw)
        self._kv.put("elastic", "stores.done", b"1")
        deadline = time.monotonic() + 5.0
        while self._pid_alive(pid) and time.monotonic() < deadline:
            if self._store_host is not None and self._store_host.poll() is not None:
                break
            time.sleep(0.02)
        if self._store_host is not None:
            if self._store_host.poll() is None:
                self._store_host.terminate()
        elif self._pid_alive(pid):
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass

    def _want_stores(self, add: Optional[int] = None, drop: Optional[int] = None) -> None:
        raw = self._kv.snapshot("elastic").get("stores.want")
        want = json.loads(raw.decode()) if raw else []
        if add is not None and add not in want:
            want.append(add)
        if drop is not None:
            want = [g for g in want if g != drop]
            self._kv.delete("elastic", f"stores.port.{drop}")
        self._kv.put("elastic", "stores.want", json.dumps(want).encode())

    def _start_store(self, slots: List[SlotInfo]) -> _GenerationStore:
        """This generation's TCPStore, in both rejoin modes: no worker is
        special, so any worker (generation rank 0 included) can die
        without collapsing the rendezvous. The job's store host serves it
        on a port the OS picks there (no port is probed on one host and
        bound on another) and outlives this driver, so a resumed driver
        finds the workers' groups alive. The previous two generations'
        stores stay up as the drain grace window (a straggler of a
        just-abandoned generation still reaching its store must not meet
        a refused connection); anything older is shut down."""
        pid = self._ensure_store_host()
        self._want_stores(add=self._gen)
        deadline = time.monotonic() + 120.0
        key = f"stores.port.{self._gen}"
        while not self._kv.snapshot("elastic").get(key):
            if time.monotonic() > deadline or not self._pid_alive(pid):
                raise RuntimeError(
                    f"the store host (pid {pid}) served no store for generation "
                    f"{self._gen} in 120 s")
            time.sleep(0.005)
        port = int(self._kv.snapshot("elastic")[key].decode())
        store = _GenerationStore(self, self._gen, launcher._store_addr(slots, self._env),
                                 port)
        if self._services:
            # The previous generation is superseded NOW: its drain grace
            # clock starts here, not at its creation.
            self._services[-1][2] = time.monotonic()
        self._services.append(
            [self._gen, store, None, _detection_window(self._env)]
        )
        self._retire_services(keep=2)
        return store

    def _drain_world_for_restart(self) -> None:
        """Respawn-mode restart: move every remaining live worker into
        the draining pool (grace first — a survivor needs time to persist
        its commit and exit with the rejoin status on its own; only then
        is it terminated) and re-form once the pool empties. Drained
        exits are reaped code-blind, so the follow-on aborts a peer death
        causes in a non-recoverable world never count toward
        blacklisting."""
        if not self._workers:
            self._restart_pending = True
            return
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_elastic_restarts_total")
        deadline = time.monotonic() + self._restart_grace
        for wid in list(self._workers):
            w = self._workers.pop(wid)
            self._removing.append((w, deadline))
            self._log(f"draining {wid} for world restart")
        self._current_ids = []
        self._restart_pending = True

    def _maybe_probe_nics(self, slots: List[SlotInfo]) -> None:
        """Ring NIC probe for elastic worlds whose host set came from (or
        changed through) the discovery script: hvdrun's launch-time probe
        only covers an initial ``-H`` set, so without this a
        discovery-only multi-NIC job would bind the default (possibly
        non-routable) interface. Best-effort, cached per host set; an
        explicit ``HOROVOD_IFACE`` (CLI pin or prior probe over the same
        set) wins."""
        hostnames = sorted({s.hostname for s in slots})
        if (self._nic_pinned
                or len(hostnames) < 2
                or all(_is_local(h) for h in hostnames)
                or hostnames == self._probed_hostset):
            return
        from . import network

        try:
            common = network.discover_common_interfaces(
                hostnames, ssh_port=self._ssh_port
            )
            if common:
                self._env["HOROVOD_IFACE"] = ",".join(common)
                self._log(f"routable interfaces for {hostnames}: {common}")
        except Exception as exc:  # noqa: BLE001 - probe is best-effort
            self._log(f"NIC probe failed ({exc}); continuing without")
        self._probed_hostset = hostnames

    def _maybe_fire_preemptions(self) -> None:
        """Deliver scheduled simulated maintenance notices: a fault-plan
        ``preempt`` action with ``after_s`` SIGTERMs the selected worker
        that long after its spawn — the platform's preemption notice,
        which the worker's graceful drain path turns into commit → drain
        → rejoin. One-shot per (action, worker incarnation)."""
        plan = _fault.active_plan()
        if plan is None:
            return
        now = time.monotonic()
        for action in plan.actions:
            if action.kind != "preempt" or action.after_s is None:
                continue
            if action.gen is not None and action.gen != self._gen:
                continue
            for wid, w in list(self._workers.items()):
                if action.worker is not None and action.worker != wid:
                    continue
                key = (action.index, wid, w.spawned_at)
                if key in self._preempts_fired:
                    continue
                if now - w.spawned_at < action.after_s:
                    continue
                self._preempts_fired.add(key)
                self._trace_event("hvd_preempt_notice", worker=wid)
                if _metrics.ACTIVE:
                    _metrics.TAP.inc("hvd_elastic_preempt_notices_total")
                _fault.record_event(
                    "driver", self._gen, "preempt-notice", wid
                )
                self._log(
                    f"delivering simulated preemption notice (SIGTERM) "
                    f"to {wid}"
                )
                try:
                    os.kill(w.proc.pid, signal.SIGTERM)
                except (ProcessLookupError, OSError):
                    pass

    def _retire_services(self, keep: int) -> None:
        """Shut down all but the newest store and ``keep`` prior
        generations (``keep=0`` drains everything, for driver exit).

        Generation count alone is not a safe drain signal: a failure
        cascade can publish several generations within seconds, while a
        gen-N straggler may legitimately reach the gen-N store for a
        whole detection window before noticing and re-rendezvousing. So a
        store is retired only when it is BOTH more than ``keep``
        generations behind AND twice the detection window has passed
        since it was SUPERSEDED (creation age is the wrong clock: a store
        hours old can still have stragglers abandoned seconds ago)."""
        limit = keep + 1 if keep else 0
        now = time.monotonic()
        while len(self._services) > limit:
            gen, svc, superseded, window = self._services[0]
            if keep and (superseded is None
                         or now - superseded < 2 * window):
                break  # list is supersession-ordered; nothing older
            self._services.pop(0)
            try:
                svc.shutdown()
            except Exception:  # noqa: BLE001
                pass
            self._log(f"retired generation-{gen} rendezvous store")

    def _publish(self, slots: List[SlotInfo]) -> Dict[str, str]:
        """Publish the next generation; returns env additions for spawns."""
        self._gen += 1
        # Rank 0 hosts the core's controller and binds the port it picks,
        # agreed through the generation's store (controller_port 0); a
        # remote rank 0 is reached at its hostname, a local one as the
        # launcher's ranks reach it (MASTER_ADDR).
        controller_addr = (
            "" if _is_local(slots[0].hostname) else slots[0].hostname
        )
        controller_port = 0
        store = self._start_store(slots)
        # Sync source for the new generation: a surviving worker that has
        # CONFIRMED completing a state sync (it holds live training
        # state) — never a fresh respawn, whose just-constructed state
        # would otherwise overwrite every survivor when it happened to
        # land on rank 0, and not even a running worker that crashed out
        # of its first generation before ever syncing. Fallback order:
        # confirmed survivor, then any running worker, then rank 0.
        joined = self._kv.snapshot("elastic")
        confirmed = {
            wid for wid in self._workers
            if f"joined.{wid}" in joined
        }
        sync_root = 0
        for pool in (confirmed, self._workers):
            chosen = next(
                (s.rank for s in slots if self._worker_id(s) in pool), None
            )
            if chosen is not None:
                sync_root = chosen
                break
        world = {
            "gen": self._gen,
            "epoch": self._epoch,
            "size": len(slots),
            "sync_root": sync_root,
            "master_addr": store.addr,
            "master_port": store.port,
            "controller_addr": controller_addr,
            "controller_port": controller_port,
            "assignments": {
                self._worker_id(s): {
                    "rank": s.rank,
                    "local_rank": s.local_rank,
                    "local_size": s.local_size,
                    "cross_rank": s.cross_rank,
                    "cross_size": s.cross_size,
                }
                for s in slots
            },
        }
        # A live re-plan notice outlives membership changes: it is
        # RE-STAMPED for the new generation (fresh id, gen, epoch) so a
        # late joiner — a promoted spare, a respawn — adopts the same
        # plan the survivors already run; mismatched lowering knobs
        # across ranks would break the collectives the plan configures.
        # Survivors re-adopt idempotently (same config).
        restamped = None
        if self._replan_doc is not None and int(
            self._replan_doc.get("gen", -1)
        ) != self._gen:
            restamped = dict(self._replan_doc)
            restamped["id"] = int(restamped.get("id", 0)) + 1
            restamped["gen"] = self._gen
            restamped["epoch"] = self._epoch
            self._replan_doc = restamped
        # Write-ahead: the journal records the generation BEFORE any
        # worker can observe it — a crash between the two replays a
        # state the fleet has not outrun.
        self._last_world = world
        self._journal_sync(force=True)
        self._kv.put("elastic", "world", json.dumps(world).encode())
        if restamped is not None:
            self._kv.put(
                "elastic", "replan",
                json.dumps(restamped, sort_keys=True).encode(),
            )
            if _fault.ACTIVE:
                _fault.record_event(
                    "driver", int(restamped["id"]), "replan-restamp",
                    f"id={restamped['id']} gen={self._gen}",
                )
        self._publish_driver_doc()
        # Ranks are renumbered in the new generation: re-key the skew
        # tracker and the quarantine policy (a parked or removed rank
        # must never be charged for the new world's steps) and drop the
        # old generation's pushed trace windows off the KV plane.
        if self._skew is not None:
            self._skew.reset_generation(self._gen)
        self._policy.reset_generation(self._gen)
        self._skew_trend.clear()
        self._skew_replanned = False
        for key in list(self._kv.snapshot(_trace.KV_SCOPE)):
            if key.startswith("rank."):
                self._kv.delete(_trace.KV_SCOPE, key)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_elastic_generations_total")
            _metrics.TAP.set("hvd_elastic_generation", float(self._gen))
            _metrics.TAP.set("hvd_elastic_world_size", float(len(slots)))
        self._log(
            f"generation {self._gen}: size {len(slots)} over "
            f"{sorted({s.hostname for s in slots})}"
        )
        self._trace_event(
            "hvd_generation_publish", gen=self._gen, size=len(slots),
            epoch=self._epoch, sync_root=sync_root,
        )
        return {
            "master_addr": store.addr,
            "master_port": str(store.port),
            "controller_addr": controller_addr,
            "sync_root": str(sync_root),
        }

    def _spawn(self, slot: SlotInfo, endpoints: Dict[str, str]) -> None:
        wid = self._worker_id(slot)
        rank_env = launcher.build_rank_env(
            slot,
            self._env,
            endpoints["master_addr"],
            int(endpoints["master_port"]),
        )
        if endpoints["controller_addr"]:
            rank_env["HOROVOD_CONTROLLER_ADDR"] = endpoints["controller_addr"]
        # The KV rendezvous lives in THIS driver process, not on rank 0's
        # host — remote workers dial the driver's hostname.
        kv_addr = (
            "127.0.0.1" if _is_local(slot.hostname)
            else socket.gethostname()
        )
        rank_env.update(
            {
                "HOROVOD_ELASTIC": "1",
                "HOROVOD_ELASTIC_WORKER_ID": wid,
                "HOROVOD_ELASTIC_GEN": str(self._gen),
                "HOROVOD_DRIVER_EPOCH": str(self._epoch),
                "HOROVOD_ELASTIC_SYNC_ROOT": endpoints["sync_root"],
                "HOROVOD_ELASTIC_KV_ADDR": kv_addr,
                "HOROVOD_ELASTIC_KV_PORT": str(self._kv.port),
                "HOROVOD_ELASTIC_TIMEOUT": str(self._elastic_timeout),
            }
        )
        if _is_local(slot.hostname):
            cmd = self._command
        else:
            cmd = launcher.build_remote_command(
                slot.hostname, rank_env, self._command, self._ssh_port
            )
        stdout = stderr = None
        outfiles: Tuple = ()
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            stdout = open(
                os.path.join(self._output_dir, f"worker.{wid}.out"), "ab"
            )
            stderr = open(
                os.path.join(self._output_dir, f"worker.{wid}.err"), "ab"
            )
            outfiles = (stdout, stderr)
        if self._verbose:
            self._log(f"spawn {wid} rank {slot.rank}: {cmd}")
        if _fault.ACTIVE:
            # Chaos tap: scheduled spawn delays (slow scheduler / image
            # pull); a 'preempt' action with after_s is handled by the
            # supervision loop via _maybe_fire_preemptions.
            _fault.fault_point("spawn", wid)
        # A fresh incarnation must earn its own joined-confirmation: a
        # stale key from a crashed predecessor under the same worker id
        # would otherwise mark this never-synced respawn as a valid
        # sync_root. Same for the HA signals (attach/done are gen- and
        # epoch-stamped, but a dangling value from a dead incarnation
        # has no business outliving it).
        self._kv.delete("elastic", f"joined.{wid}")
        self._kv.delete("elastic", f"rejoin.{wid}")
        self._kv.delete("elastic", f"attach.{wid}")
        self._kv.delete("elastic", f"done.{wid}")
        self._workers[wid] = _Worker(
            wid,
            slot.hostname,
            safe_shell_exec.ManagedProcess(
                cmd, env=rank_env, stdout=stdout, stderr=stderr
            ),
            outfiles,
            spawned_at=time.monotonic(),
        )

    def _reconcile(self, force: bool = False) -> bool:
        """Re-form the world when the desired membership differs from the
        running one — or unconditionally with ``force`` (surviving
        workers abandoned the current generation and need a fresh one
        even though membership is unchanged). Returns False when the job
        must fail (below min_np)."""
        slots = self._desired_slots()
        if slots is None:
            self._log(
                f"available slots fell below --min-np {self._min_np}; "
                "aborting"
            )
            return False
        desired = {self._worker_id(s): s for s in slots}
        desired_ids = [self._worker_id(s) for s in slots]
        if desired_ids == self._current_ids and not force:
            return True
        # A slot whose previous process is still draining must not be
        # re-assigned yet: two live processes claiming the same worker id
        # would both join the new generation as the same rank. Defer the
        # re-formation until the drain completes (exit or grace kill).
        draining = {w.worker_id for w, _ in self._removing}
        if draining & set(desired_ids):
            return True
        # Hot-spare promotion (docs/fault_tolerance.md "Self-driving
        # fleet"): a parked spare whose slot the new world claims joins
        # IN the same generation bump — one resize instead of a
        # respawn-from-snapshot. The spare only leaves its gate on the
        # explicit ``promote.<wid>`` signal (never on the world doc
        # alone), because in respawn mode the FIRST publish after a
        # membership change is only the drain NOTIFICATION — survivors
        # exit 79 and the world re-forms once more. Promotion therefore
        # defers in respawn mode while old-generation workers are still
        # live, and lands on the post-drain restart publish instead;
        # in-process mode promotes immediately (survivors rejoin the
        # same generation the spare enters). KV hygiene runs BEFORE the
        # publish so the promoted spare's attach/joined signals are
        # never clobbered.
        defer_spares = (
            self._rejoin_mode == "respawn" and bool(self._workers)
        )
        promoted = []
        if not defer_spares:
            for wid in desired_ids:
                w = self._spares.get(wid)
                if w is None:
                    continue
                if w.proc.poll() is None:
                    for key in ("joined", "rejoin", "attach", "done"):
                        self._kv.delete("elastic", f"{key}.{wid}")
                    promoted.append(wid)
                else:
                    # Died unnoticed while parked: a fresh spawn takes
                    # the slot below.
                    self._reap_spare(wid, w)
        self._maybe_probe_nics(slots)
        endpoints = self._publish(slots)
        for wid in promoted:
            self._workers[wid] = self._spares.pop(wid)
            self._spare_slots.pop(wid, None)
            self._kv.put(
                "elastic", f"promote.{wid}", str(self._gen).encode()
            )
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_spare_promotions_total")
                _metrics.TAP.set(
                    "hvd_spare_pool_size", float(len(self._spares))
                )
            self._trace_event("hvd_spare_promote", worker=wid,
                              gen=self._gen)
            if _fault.ACTIVE:
                _fault.record_event(
                    "driver", self._gen, "promote", f"worker={wid}"
                )
            self._log(
                f"promoted spare {wid} into generation {self._gen} "
                "(pre-attached: no respawn)"
            )
        # Dropped workers drain gracefully: they poll the KV store, see
        # they are not in the new generation, and exit 0 on their own —
        # SIGTERMing them here would break survivors' in-flight
        # collectives and force a needless rollback. Terminate only after
        # the grace window.
        for wid in list(self._workers):
            if wid not in desired:
                w = self._workers.pop(wid)
                self._removing.append(
                    (w, time.monotonic() + self._removal_grace)
                )
                self._log(f"removed {wid} (draining)")
        for wid, slot in desired.items():
            if wid not in self._workers:
                if wid in self._spares:
                    # Deferred promotion: the parked spare keeps its
                    # claimed slot reserved until the post-drain restart
                    # publish promotes it.
                    continue
                self._spawn(slot, endpoints)
        self._current_ids = desired_ids
        # A dead slot is now respawned or its rank handed to a spare; a
        # slot left free goes back to the spare pool below.
        self._dead_slots.clear()
        self._reconcile_spares(slots)
        return True

    # ------------------------------------------------------- hot spares
    def _reconcile_spares(self, world_slots: List[SlotInfo]) -> None:
        """Keep ``--spares`` workers spawned BEYOND the world: attached
        to the KV plane and heartbeating, but excluded from the mesh
        (their elastic context parks them before ``hvd.init`` until a
        generation claims their slot — ``elastic.maybe_wait_as_spare``).
        Spare slots are the next slots the allocator would hand out, so
        the pool shrinks honestly when capacity is tight."""
        if not self._spares_want and not self._spares:
            return
        hosts = self._discover()
        total = sum(c for _, c in hosts)
        want = min(self._spares_want, max(total - len(world_slots), 0))
        spare_slots: List[SlotInfo] = []
        if want > 0:
            # The first free slots in allocation order: the tail of the
            # world's allocation, or a dead slot whose rank a spare took.
            world_ids = {self._worker_id(s) for s in world_slots}
            spare_slots = [
                s for s in launcher.allocate(hosts, total)
                if self._worker_id(s) not in world_ids
            ][:want]
        desired = {self._worker_id(s): s for s in spare_slots}
        for wid in list(self._spares):
            if wid not in desired:
                if wid in self._current_ids:
                    # The world claimed this spare's slot but promotion
                    # was deferred (respawn-mode drain in flight): it
                    # is about to be promoted, not retired.
                    continue
                w = self._spares.pop(wid)
                self._spare_slots.pop(wid, None)
                if w.proc.poll() is None:
                    w.proc.terminate()
                for f in w.outfiles:
                    f.close()
                self._log(f"retired spare {wid}")
        for wid, slot in desired.items():
            if wid not in self._spares:
                self._spawn_spare(slot)
        if _metrics.ACTIVE:
            _metrics.TAP.set(
                "hvd_spare_pool_size", float(len(self._spares))
            )
        self._journal_sync(force=True)

    def _spawn_spare(self, slot: SlotInfo) -> None:
        """Spawn one spare: the training command with the elastic KV
        plumbing but NO rank assignment — ``HOROVOD_ELASTIC_SPARE=1``
        makes the worker-side elastic context hold it at the spare gate
        (heartbeating ``spare.<wid>``) until a published world claims
        its worker id."""
        wid = self._worker_id(slot)
        kv_addr = (
            "127.0.0.1" if _is_local(slot.hostname)
            else socket.gethostname()
        )
        env = dict(self._env)
        env.update({
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_ELASTIC_SPARE": "1",
            "HOROVOD_ELASTIC_WORKER_ID": wid,
            # The card it keeps (its slot's); promotion sets the rest.
            "HOROVOD_LOCAL_RANK": str(slot.local_rank),
            "HOROVOD_ELASTIC_GEN": "0",
            "HOROVOD_DRIVER_EPOCH": str(self._epoch),
            "HOROVOD_ELASTIC_SYNC_ROOT": "0",
            "HOROVOD_ELASTIC_KV_ADDR": kv_addr,
            "HOROVOD_ELASTIC_KV_PORT": str(self._kv.port),
            "HOROVOD_ELASTIC_TIMEOUT": str(self._elastic_timeout),
        })
        if _is_local(slot.hostname):
            cmd = self._command
        else:
            cmd = launcher.build_remote_command(
                slot.hostname, env, self._command, self._ssh_port
            )
        stdout = stderr = None
        outfiles: Tuple = ()
        if self._output_dir:
            stdout = open(
                os.path.join(self._output_dir, f"worker.{wid}.out"), "ab"
            )
            stderr = open(
                os.path.join(self._output_dir, f"worker.{wid}.err"), "ab"
            )
            outfiles = (stdout, stderr)
        for key in ("joined", "rejoin", "attach", "done", "promote",
                    "spare"):
            self._kv.delete("elastic", f"{key}.{wid}")
        self._spares[wid] = _Worker(
            wid,
            slot.hostname,
            safe_shell_exec.ManagedProcess(
                cmd, env=env, stdout=stdout, stderr=stderr
            ),
            outfiles,
            spawned_at=time.monotonic(),
        )
        self._spare_slots[wid] = slot
        self._log(f"spawned spare {wid} (parked until promoted)")

    def _reap_spare(self, wid: str, w: _Worker) -> None:
        """A spare died while parked: count it against its host (a
        crashing spare is still a host signal) and drop it from the
        pool; the supervision loop respawns it while the host stays
        healthy."""
        rc = w.proc.poll()
        self._spares.pop(wid, None)
        for f in w.outfiles:
            f.close()
        count = self._record_failure(w.host)
        if count >= self._failure_threshold:
            self._blacklist_host(w.host)
        self._log(
            f"spare {wid} died while parked (exit {rc}; host failures: "
            f"{count})"
        )
        if _metrics.ACTIVE:
            _metrics.TAP.set(
                "hvd_spare_pool_size", float(len(self._spares))
            )

    def _poll_spares(self) -> None:
        """Supervision-beat spare upkeep: reap dead spares and respawn
        them while their host is still admissible."""
        for wid, w in list(self._spares.items()):
            if w.proc.poll() is None:
                continue
            slot = self._spare_slots.get(wid)
            self._reap_spare(wid, w)
            if (slot is not None and w.host not in self._blacklist
                    and not self._finishing):
                self._spawn_spare(slot)
                if _metrics.ACTIVE:
                    _metrics.TAP.set(
                        "hvd_spare_pool_size", float(len(self._spares))
                    )

    # -------------------------------------------------------------- loop
    def run(self) -> int:
        if self._resume_finished:
            self._log(
                "journal records the job as finished; nothing to resume"
            )
            self._kv.close()
            return 0
        self._kv.start()
        if _metrics.ACTIVE:
            self._log(
                f"metrics: GET /metrics on port {self._kv.port} "
                "(rendezvous KV server)"
            )
        if self._script:
            # Seed synchronously (the first allocation needs hosts when
            # the script is the sole source), then poll on a thread.
            try:
                self._last_hosts = _run_discovery_script(self._script)
            except Exception as exc:  # noqa: BLE001
                self._log(f"initial host discovery failed: {exc}")
            threading.Thread(
                target=self._discovery_loop,
                name="hvd_elastic_discovery", daemon=True,
            ).start()
        try:
            rc = self._run()
            if self._journal is not None:
                try:
                    self._journal.record(finished=(rc == 0))
                except OSError:
                    pass
            return rc
        finally:
            self._stop_discovery.set()
            for w in (list(self._workers.values())
                      + list(self._spares.values())
                      + [w for w, _ in self._removing]):
                if w.proc.poll() is None:
                    w.proc.terminate()
                for f in w.outfiles:
                    f.close()
            # Final fleet-trace collection (the workers' shutdown push
            # landed by now) + the flight-dump postmortem bundle.
            try:
                self._trace_collect(final=True)
            except Exception:  # noqa: BLE001 - teardown must complete
                pass
            self._retire_services(keep=0)
            self._stop_store_host()
            self._kv.stop()
            # Local respawn snapshots are keyed by this driver's pid —
            # nothing can legitimately read them after it exits. (Remote
            # hosts' dirs are out of reach; they are tmp-reaped. A
            # user-provided dir is theirs to keep.)
            if self._state_dir_owned:
                import shutil

                shutil.rmtree(
                    self._env["HOROVOD_ELASTIC_STATE_DIR"],
                    ignore_errors=True,
                )

    def _run(self) -> int:
        self._started_at = time.monotonic()
        self._publish_driver_doc()
        if self._adopting:
            self._enter_adoption()
        elif not self._reconcile():
            return 1
        last_discovery = time.monotonic()
        last_beat = 0.0
        while True:
            time.sleep(0.1)
            changed = False
            now = time.monotonic()
            if now - last_beat >= 1.0:
                last_beat = now
                # Liveness beat for worker-side driver probes, plus the
                # periodic journal refresh of worker-written KV signals.
                self._publish_driver_doc()
                self._journal_sync()
                self._trace_collect()
                # Self-driving fleet: spare upkeep, the slowness-
                # quarantine decision over the charges _trace_collect
                # just fed, and the calibration-drift re-plan check.
                self._poll_spares()
                if self._maybe_quarantine_slow():
                    changed = True
                self._maybe_replan()
            # Reap draining removed workers (exit code irrelevant);
            # terminate stragglers past the grace window.
            still_removing = []
            for w, deadline in self._removing:
                rc = w.proc.poll()
                if rc is not None:
                    if rc not in (0, REJOIN_EXIT_CODE):
                        # Code-blind for blacklisting, but not for the
                        # postmortem log: a crash reaped during a world
                        # restart (its peer's rejoin exit won the reap
                        # race) must still be attributable in the driver
                        # log, same phrasing as a directly-reaped
                        # failure.
                        self._log(
                            f"{w.worker_id} failed with exit code {rc} "
                            "(reaped while draining for restart)"
                        )
                    for f in w.outfiles:
                        f.close()
                    continue
                if time.monotonic() > deadline:
                    w.proc.terminate()
                    for f in w.outfiles:
                        f.close()
                    continue
                still_removing.append((w, deadline))
            self._removing = still_removing
            # Drain superseded generation stores whose grace window
            # elapsed since the last publish (a cascade can outrun the
            # publish-time retirement's time guard).
            self._retire_services(keep=2)
            if _fault.ACTIVE:
                self._maybe_fire_preemptions()
                self._maybe_fire_driver_faults()
            if self._adopting:
                rc = self._poll_adopted()
                if rc is not None:
                    return rc
                continue
            if self._adopt_drain_pids is not None:
                # Post-adoption drain: wait for SIGTERMed survivors to
                # persist their commits and exit before the replacement
                # generation is spawned over their snapshots.
                alive = {
                    p for p in self._adopt_drain_pids if self._pid_alive(p)
                }
                if alive and time.monotonic() <= self._adopt_drain_deadline:
                    self._adopt_drain_pids = alive
                    continue
                self._adopt_drain_pids = None
                self._restart_pending = True
            if self._restart_pending and not self._removing:
                # Respawn-mode restart: the old generation has fully
                # drained; re-form even if no other event fires.
                self._restart_pending = False
                changed = True
            for wid in list(self._workers):
                # A respawn-mode restart earlier in this sweep drains the
                # dict mid-iteration; drained entries are reaped by the
                # _removing pool instead.
                w = self._workers.get(wid)
                if w is None:
                    continue
                rc = w.proc.poll()
                if rc is None or w.done:
                    continue
                if rc == 0:
                    w.done = True
                    # A clean exit means the training function returned —
                    # the job is completing; stop re-forming the world.
                    self._finishing = True
                    self._log(f"{wid} finished")
                else:
                    requested_respawn = (
                        rc == REJOIN_EXIT_CODE
                        and self._rejoin_mode == "respawn"
                    )
                    if requested_respawn:
                        # Worker-requested respawn (no in-process rejoin
                        # support): not a failure, no blacklist count.
                        # Only honored in respawn mode — the elastic
                        # runtime never emits 79 in-process, so there an
                        # exit 79 is a user program's own status and must
                        # count as a failure (not loop forever).
                        if _metrics.ACTIVE:
                            _metrics.TAP.inc(
                                "hvd_elastic_respawn_requests_total"
                            )
                        self._log(f"{wid} exited requesting respawn")
                    else:
                        count = self._record_failure(w.host)
                        self._log(
                            f"{wid} failed with exit code {rc} "
                            f"(host failures: {count})"
                        )
                        self._trace_event(
                            "hvd_worker_failure", worker=wid, rc=rc,
                            host_failures=count,
                        )
                    if self._finishing:
                        # A straggler crashing while the job winds down is
                        # a real failure — there is no world left to
                        # re-form it into.
                        return 1
                    if (not requested_respawn
                            and self._failures.get(w.host, 0)
                            >= self._failure_threshold):
                        self._blacklist_host(w.host)
                    del self._workers[wid]
                    if not requested_respawn:
                        self._dead_slots.add(wid)
                    for f in w.outfiles:
                        f.close()
                    self._current_ids = [
                        i for i in self._current_ids if i != wid
                    ]
                    changed = True
                    if self._rejoin_mode == "respawn":
                        # Any exit dooms the whole generation: peers
                        # cannot re-form in-process, so they will either
                        # persist-and-79 on their own or must be drained.
                        # Batch the restart — draining everyone before
                        # publishing keeps respawned workers from
                        # blocking on transient generations that half the
                        # world never joins.
                        self._drain_world_for_restart()
            if self._finishing:
                if all(w.done for w in self._workers.values()):
                    return 0
                continue
            now = time.monotonic()
            if self._script and now - last_discovery >= self._interval:
                last_discovery = now
                changed = True  # _reconcile no-ops when membership matches
            # Worker-initiated rejoin: a surviving worker abandoned the
            # CURRENT generation (rollback without any process dying —
            # stall shutdown, transient control-plane error). Bump the
            # generation even though membership is unchanged; signals for
            # older generations are stale.
            force = any(
                k.startswith("rejoin.") and v.decode() == str(self._gen)
                for k, v in self._kv.snapshot("elastic").items()
            )
            if force:
                self._log(
                    f"worker abandoned generation {self._gen}; re-forming"
                )
            if (changed or force) and not self._reconcile(force=force):
                return 1
