"""Deterministic, seeded fault plans.

The port's copy of ``horovod_tpu/fault/plan.py`` (the same plan text gives
the same :meth:`FaultPlan.canonical_schedule` bytes). A fault plan is a JSON
document (inline in ``HOROVOD_FAULT_PLAN`` or a path to a file) describing
*exactly which failures to inject where*:

.. code-block:: json

    {
      "seed": 1234,
      "faults": [
        {"kind": "kill",      "rank": 2, "at_step": 3, "exit_code": 43},
        {"kind": "delay",     "rank": 1, "site": "enqueue",
         "seconds": 0.05, "after": 2, "count": 20},
        {"kind": "drop",      "site": "kv",  "frac": 0.5,
         "after": 5, "count": 8},
        {"kind": "duplicate", "site": "rpc", "frac": 0.1},
        {"kind": "preempt",   "worker": "localhost:1", "after_s": 2.0},
        {"kind": "preempt",   "rank": 0, "at_step": 4}
      ]
    }

Determinism is the whole point: probabilistic actions (``frac``) draw from
a ``random.Random`` stream keyed by ``(seed, site, rank)``, so the n-th tap
hit at a site makes the same drop/keep decision in every run with the same
seed.  :meth:`FaultPlan.canonical_schedule` serializes the fully-resolved
plan — including the first decisions of every probabilistic stream — to
canonical bytes, which an elastic driver writes to its event log so two
runs with the same seed can be diffed byte-for-byte. The driver-side kinds
(``kill_driver``, ``restart_driver``, a ``preempt`` with ``after_s``) parse
and appear in the schedule here; only the elastic driver
(``run/elastic_driver.py``) fires them.

Action fields
-------------

``kind``
    ``kill`` | ``delay`` | ``drop`` | ``duplicate`` | ``preempt`` |
    ``corrupt`` | ``nan`` | ``kill_driver`` | ``restart_driver`` |
    ``kill_replica``.
    ``kill_replica`` is a *serving-plane* fault (docs/serving.md): it
    aborts a serving replica in the middle of a batch dispatch (site
    ``replica``), exercising the engine's exactly-once re-queue of
    every in-flight request.
    ``corrupt``/``nan`` are *payload* faults exercising the data-plane
    integrity guard (docs/fault_tolerance.md): ``corrupt`` bit-flips one
    element of a tensor payload (silent data corruption), ``nan``
    poisons one element of a floating-point gradient.
    ``kill_driver``/``restart_driver`` are *control-plane* faults
    executed by the elastic driver itself ``after_s`` seconds into its
    run: a hard ``os._exit`` of the driver process (resume with
    ``horovodrun --resume``) and an in-process simulated crash-restart
    (KV blackout → journal replay → epoch bump → port reclaim). Scoped
    by ``epoch`` (default: first driver incarnation only), so a resumed
    driver never re-executes its own death.
``site``
    Tap the action applies to: ``step`` (one training step, i.e. one
    ``State.commit``), ``enqueue``/``response`` (runtime collective
    submission/completion), ``rpc`` (launcher control-plane send),
    ``kv`` (rendezvous KV request), ``spawn`` (driver worker spawn),
    ``payload`` (a collective's INPUT tensor at submission — where a
    ``nan`` models a diverged kernel) and ``output`` (a collective's
    result on THIS rank only — where a ``corrupt`` models SDC that makes
    replicas silently diverge). Serving adds ``request`` (one inference
    request at admission; carries only ``drop``/``delay``) and
    ``replica`` (one batch dispatch on a serving replica; carries only
    ``kill_replica``).
    Defaults: kill/preempt → ``step``, delay → ``enqueue``,
    drop/duplicate → ``rpc``, nan → ``payload``, corrupt → ``output``,
    kill_replica → ``replica``.
``rank`` / ``worker`` / ``gen``
    Selectors; omitted means "any". ``rank`` matches ``HOROVOD_RANK``,
    ``worker`` matches ``HOROVOD_ELASTIC_WORKER_ID``, ``gen`` matches
    ``HOROVOD_ELASTIC_GEN`` (scoping a fault to the first world generation
    is the standard way to keep a kill from re-firing after recovery).
``at_step`` / ``after`` / ``count`` / ``frac``
    Trigger window over the site's hit counter: ``at_step`` fires exactly
    at that count (kill/preempt), ``after``+``count`` bound a window
    (delay/drop/duplicate), ``frac`` makes the action probabilistic inside
    its window.
``every`` / ``until``
    Chronic-slowness shape (``delay`` only): ``every`` fires the action
    on every N-th in-window hit (``every: 1`` = every hit — a persistent
    straggler; ``every: 3`` = periodic hiccups), ``until`` bounds the
    window by an absolute hit count (an alternative to ``count``, which
    is relative to ``after``). Both validated at parse time; the seeded
    decision stream advances only on firing hits, so the recurring form
    is exactly as byte-reproducible as the single-shot one.
``seconds`` / ``exit_code`` / ``after_s``
    Parameters: delay duration, kill exit status, and (driver-side
    preempt) seconds after spawn at which the driver delivers the
    simulated maintenance notice (SIGTERM) to the worker.
``element`` / ``bit`` / ``tensor``
    Payload-fault targeting: the flat element index to poison, (for
    ``corrupt``) which bit of that element to flip, and a tensor-name
    pattern (``fnmatch`` syntax, e.g. ``"grad"`` or ``"grad.*"``).
    ``element``/``bit`` omitted → drawn from the action's seeded decision
    stream, deterministic per (seed, action, rank) without hand-pinning.
    With ``tensor`` set, the trigger window counts only MATCHING payloads
    at the site (its own counter), so ``at_step`` means "the K-th time
    THIS tensor passes the tap" — internal collectives (digest
    agreement, elastic sync) don't perturb the schedule.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FAULT_PLAN_ENV = "HOROVOD_FAULT_PLAN"

_KINDS = ("kill", "delay", "drop", "duplicate", "preempt", "corrupt", "nan",
          "kill_driver", "restart_driver", "kill_replica")
_SITES = ("step", "enqueue", "response", "rpc", "kv", "spawn",
          "payload", "output", "driver", "request", "replica")
# Payload faults mutate tensors; only these sites carry one.
PAYLOAD_KINDS = ("corrupt", "nan")
PAYLOAD_SITES = ("payload", "output")
# Driver faults execute in the ELASTIC DRIVER's supervision loop (site
# ``driver``), never at worker taps: ``kill_driver`` hard-kills the
# driver process ``after_s`` seconds into its run (the control-plane
# SPOF model — resume via ``horovodrun --resume`` or a supervisor);
# ``restart_driver`` simulates the full crash-restart cycle in-process
# (KV blackout → journal replay → epoch bump → port reclaim →
# republish) so a single job exercises park/reattach. Both are scoped
# by the ``epoch`` selector (default: the FIRST driver incarnation
# only) so a resumed driver does not re-execute its own death.
DRIVER_KINDS = ("kill_driver", "restart_driver")
DRIVER_KILL_EXIT_CODE = 67
# Serving-plane faults (docs/serving.md "Chaos semantics"): the
# ``request`` site taps one inference request at admission (``drop`` =
# the request is discarded and answered as dropped, ``delay`` = queueing
# latency injected before batching), and the ``replica`` site taps one
# batch dispatch on a serving replica — ``kill_replica`` aborts the
# replica mid-batch, exercising the engine's exactly-once re-queue of
# every in-flight request. Validated kind<->site like driver faults so a
# plan cannot silently schedule a serving fault at a training tap.
REQUEST_KINDS = ("drop", "delay")
REPLICA_KINDS = ("kill_replica",)
_DEFAULT_SITE = {
    "kill": "step",
    "preempt": "step",
    "delay": "enqueue",
    "drop": "rpc",
    "duplicate": "rpc",
    "corrupt": "output",
    "nan": "payload",
    "kill_driver": "driver",
    "restart_driver": "driver",
    "kill_replica": "replica",
}
# How many leading decisions of each probabilistic stream the canonical
# schedule materializes (enough to make drop bursts diffable without
# unbounded output).
_SCHEDULE_DECISIONS = 64


@dataclass
class FaultAction:
    kind: str
    site: str
    rank: Optional[int] = None
    worker: Optional[str] = None
    gen: Optional[int] = None
    at_step: Optional[int] = None
    after: int = 0
    count: Optional[int] = None
    every: Optional[int] = None    # delay: fire on every N-th in-window hit
    until: Optional[int] = None    # delay: absolute last hit of the window
    frac: float = 1.0
    seconds: float = 0.0
    exit_code: int = 43
    after_s: Optional[float] = None
    element: Optional[int] = None  # payload faults: flat index to poison
    bit: Optional[int] = None      # corrupt: bit of that element to flip
    tensor: Optional[str] = None   # payload faults: name pattern (fnmatch)
    epoch: Optional[int] = None    # driver faults: driver incarnation
    index: int = 0  # position in the plan; part of the stream key

    @staticmethod
    def from_dict(d: Dict[str, Any], index: int) -> "FaultAction":
        kind = str(d.get("kind", "")).lower()
        if kind not in _KINDS:
            raise ValueError(
                f"fault plan action {index}: unknown kind {kind!r} "
                f"(expected one of {_KINDS})"
            )
        site = str(d.get("site", _DEFAULT_SITE[kind])).lower()
        if site not in _SITES:
            raise ValueError(
                f"fault plan action {index}: unknown site {site!r} "
                f"(expected one of {_SITES})"
            )
        if (kind in DRIVER_KINDS) != (site == "driver"):
            raise ValueError(
                f"fault plan action {index}: kind {kind!r} and site "
                f"{site!r} do not match — driver faults "
                f"({'/'.join(DRIVER_KINDS)}) execute only at the "
                "'driver' site (the elastic driver's supervision loop)"
            )
        if (kind in REPLICA_KINDS) != (site == "replica"):
            raise ValueError(
                f"fault plan action {index}: kind {kind!r} and site "
                f"{site!r} do not match — replica faults "
                f"({'/'.join(REPLICA_KINDS)}) execute only at the "
                "'replica' site (a serving replica's batch dispatch)"
            )
        if site == "request" and kind not in REQUEST_KINDS:
            raise ValueError(
                f"fault plan action {index}: kind {kind!r} is not a "
                f"request fault — the 'request' site (one inference "
                f"request at admission) carries only "
                f"{'/'.join(REQUEST_KINDS)}"
            )
        every = None if d.get("every") is None else int(d["every"])
        until = None if d.get("until") is None else int(d["until"])
        if (every is not None or until is not None) and kind != "delay":
            raise ValueError(
                f"fault plan action {index}: every/until describe the "
                f"chronic-slowness shape and apply only to 'delay' "
                f"actions, not {kind!r}"
            )
        if every is not None and every < 1:
            raise ValueError(
                f"fault plan action {index}: every must be >= 1 "
                f"(got {every})"
            )
        after = int(d.get("after", 0))
        if until is not None and until <= after:
            raise ValueError(
                f"fault plan action {index}: until ({until}) must be "
                f"> after ({after}) — the window would be empty"
            )
        return FaultAction(
            kind=kind,
            site=site,
            rank=None if d.get("rank") is None else int(d["rank"]),
            worker=d.get("worker"),
            gen=None if d.get("gen") is None else int(d["gen"]),
            at_step=(
                None if d.get("at_step") is None else int(d["at_step"])
            ),
            after=after,
            count=None if d.get("count") is None else int(d["count"]),
            every=every,
            until=until,
            frac=float(d.get("frac", 1.0)),
            seconds=float(d.get("seconds", 0.0)),
            exit_code=int(d.get(
                "exit_code",
                DRIVER_KILL_EXIT_CODE if kind == "kill_driver" else 43,
            )),
            after_s=(
                None if d.get("after_s") is None else float(d["after_s"])
            ),
            element=(
                None if d.get("element") is None else int(d["element"])
            ),
            bit=None if d.get("bit") is None else int(d["bit"]),
            tensor=d.get("tensor"),
            epoch=None if d.get("epoch") is None else int(d["epoch"]),
            index=index,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "site": self.site}
        for k in ("rank", "worker", "gen", "at_step", "count", "every",
                  "until", "after_s", "element", "bit", "tensor", "epoch"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.after:
            out["after"] = self.after
        if self.frac != 1.0:
            out["frac"] = self.frac
        if self.seconds:
            out["seconds"] = self.seconds
        if self.kind == "kill":
            out["exit_code"] = self.exit_code
        return out

    def matches_driver_epoch(self, epoch: int) -> bool:
        """Driver-fault scoping: an action with no explicit ``epoch``
        targets ONLY the first driver incarnation — otherwise a resumed
        driver, armed with the same plan from its environment, would
        faithfully re-execute the very crash it just recovered from."""
        return epoch == (self.epoch if self.epoch is not None else 1)

    def matches_process(self, rank: Optional[int], worker: Optional[str],
                        gen: Optional[int]) -> bool:
        if self.rank is not None and self.rank != rank:
            return False
        if self.worker is not None and self.worker != worker:
            return False
        if self.gen is not None and gen is not None and self.gen != gen:
            return False
        return True

    def in_window(self, hit: int) -> bool:
        """Window test over the site's 1-based hit counter. ``every``
        makes a hit in-window only on the action's period (the decision
        stream advances only on in-window hits, so the chronic form
        stays byte-reproducible), ``until`` closes the window at an
        absolute hit count."""
        if self.at_step is not None:
            return hit == self.at_step
        if hit <= self.after:
            return False
        if self.until is not None and hit > self.until:
            return False
        if self.count is not None and hit > self.after + self.count:
            return False
        if self.every is not None and (hit - self.after - 1) % self.every:
            return False
        return True


class FaultPlan:
    """A parsed plan plus its per-action deterministic decision streams."""

    def __init__(self, seed: int, actions: List[FaultAction]):
        self.seed = int(seed)
        self.actions = actions
        self._streams: Dict[tuple, random.Random] = {}

    # ------------------------------------------------------------- parse
    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError("fault plan must be a JSON object")
        actions = [
            FaultAction.from_dict(a, i)
            for i, a in enumerate(doc.get("faults", []))
        ]
        return FaultPlan(int(doc.get("seed", 0)), actions)

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> Optional["FaultPlan"]:
        """Load the plan named by ``HOROVOD_FAULT_PLAN`` (inline JSON when
        the value starts with ``{``, otherwise a file path). Returns None
        when the variable is unset/empty."""
        raw = (env or os.environ).get(FAULT_PLAN_ENV, "").strip()
        if not raw:
            return None
        if raw.startswith("{"):
            return FaultPlan.from_json(raw)
        with open(raw, "r") as f:
            return FaultPlan.from_json(f.read())

    # -------------------------------------------------------- decisions
    def _stream(self, action: FaultAction, rank: Optional[int]) -> random.Random:
        key = (action.index, action.site, rank if rank is not None else -1)
        rng = self._streams.get(key)
        if rng is None:
            rng = random.Random(
                f"{self.seed}:{action.index}:{action.site}:{key[2]}"
            )
            self._streams[key] = rng
        return rng

    def decide(self, action: FaultAction, rank: Optional[int]) -> bool:
        """Deterministic probabilistic decision for one in-window hit."""
        if action.frac >= 1.0:
            return True
        return self._stream(action, rank).random() < action.frac

    def decision_trace(self, action: FaultAction, rank: Optional[int],
                       n: int) -> List[bool]:
        """First ``n`` decisions of an action's stream for ``rank`` —
        computed on a FRESH stream so the trace is a pure function of
        (seed, action, rank), independent of how often ``decide`` ran."""
        rng = random.Random(
            f"{self.seed}:{action.index}:{action.site}:"
            f"{rank if rank is not None else -1}"
        )
        if action.frac >= 1.0:
            return [True] * n
        return [rng.random() < action.frac for _ in range(n)]

    # --------------------------------------------------------- schedule
    def canonical_schedule(self) -> str:
        """Fully-resolved schedule as canonical JSON text: the actions in
        plan order plus, for each probabilistic action, the first
        decisions of its stream for the ranks it can select. Byte-for-byte
        reproducible for a given plan — the driver writes these bytes to
        its event log, which is what the chaos suite diffs across runs."""
        resolved = []
        for a in self.actions:
            entry: Dict[str, Any] = a.to_dict()
            if a.frac < 1.0:
                ranks = [a.rank] if a.rank is not None else [None]
                entry["decisions"] = {
                    str(r if r is not None else "*"): [
                        1 if d else 0
                        for d in self.decision_trace(
                            a, r, _SCHEDULE_DECISIONS
                        )
                    ]
                    for r in ranks
                }
            resolved.append(entry)
        return json.dumps(
            {"seed": self.seed, "schedule": resolved},
            sort_keys=True, separators=(",", ":"),
        )
