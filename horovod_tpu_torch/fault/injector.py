"""Fault-injection taps.

The port of ``horovod_tpu/fault/injector.py``. The runtimes, the serving
engine, the KV client and the probe plane import this module and read
``injector.ACTIVE``, which :func:`install_plan` rebinds, so a plan
installed after import arms every site and :func:`reset` disarms them.
Payload faults take torch tensors (cloned and mutated on their own
device, no host sync) as well as numpy arrays.

``fault_point(site)`` is called from a handful of fixed places in the
runtime, the launcher control plane, and the elastic driver.  With no plan
loaded (the production default) the module-level :data:`ACTIVE` flag is
False and instrumented call sites skip the call entirely — zero overhead.
With ``HOROVOD_FAULT_PLAN`` set, each hit advances a per-site counter,
matches the plan's actions against (site, counter, rank, worker,
generation), and executes whatever the plan schedules: sleep, raise
:class:`InjectedFault`, deliver a preemption notice, or kill the process.

Every executed injection is appended to the event log — in memory always,
and to the file named by ``HOROVOD_FAULT_EVENT_LOG`` when set.  Event
lines carry only deterministic fields (sequence number, site, hit count,
action) so logs from two runs of the same plan can be compared directly.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .plan import (
    DRIVER_KINDS,
    FAULT_PLAN_ENV,
    FaultAction,
    FaultPlan,
    PAYLOAD_KINDS,
)

FAULT_EVENT_LOG_ENV = "HOROVOD_FAULT_EVENT_LOG"


class InjectedFault(ConnectionError):
    """A fault injected by the active plan (dropped control-plane message,
    severed connection).  Subclasses ConnectionError so the production
    retry/backoff paths treat it exactly like a real transport failure."""


class ReplicaKilled(InjectedFault):
    """A ``kill_replica`` fault: the serving replica that hit the
    ``replica`` tap mid-batch must abort. The serve engine catches this
    at the replica loop boundary, re-queues every in-flight request of
    the aborted batch, and retires the replica — the exactly-once
    invariant the serving tests assert."""


ACTIVE = False

_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_counters: Dict[str, int] = {}
_events: List[dict] = []
_seq = 0


def install_plan(plan: Optional[FaultPlan]) -> None:
    """Activate ``plan`` for this process (None deactivates)."""
    global ACTIVE, _plan, _seq
    with _lock:
        _plan = plan
        _counters.clear()
        _events.clear()
        _seq = 0
        ACTIVE = plan is not None


def activate_from_env() -> Optional[FaultPlan]:
    """(Re)load the plan from ``HOROVOD_FAULT_PLAN``; returns it."""
    install_plan(FaultPlan.from_env())
    return _plan


def reset() -> None:
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    return _plan


def events() -> List[dict]:
    with _lock:
        return list(_events)


def _identity() -> tuple:
    env = os.environ
    rank = env.get("HOROVOD_RANK")
    gen = env.get("HOROVOD_ELASTIC_GEN")
    return (
        int(rank) if rank is not None and rank.isdigit() else None,
        env.get("HOROVOD_ELASTIC_WORKER_ID"),
        int(gen) if gen is not None and gen.isdigit() else None,
    )


def record_event(site: str, hit: int, action: str, detail: str = "") -> dict:
    """Append one deterministic event line (also used by the driver for
    its own scheduled injections)."""
    global _seq
    rank, _, _ = _identity()
    with _lock:
        _seq += 1
        ev = {
            "seq": _seq,
            "site": site,
            "hit": hit,
            "action": action,
            "detail": detail,
            # Per-process identity: a shared event-log file interleaves
            # ranks nondeterministically, but each rank's OWN (rank, seq)
            # subsequence is deterministic — that's what chaos runs diff.
            "rank": rank,
        }
        _events.append(ev)
        path = os.environ.get(FAULT_EVENT_LOG_ENV, "")
        # The file append stays under the lock: released first, a second
        # thread could write its (higher-seq) line before this one, and
        # this rank's (rank, seq) subsequence in the shared log — the
        # thing chaos runs diff byte-for-byte — would invert.
        if path:
            try:
                with open(path, "a") as f:
                    f.write(json.dumps(ev, sort_keys=True) + "\n")
            except OSError:
                pass
    return ev


def _execute(action: FaultAction, site: str, hit: int,
             name: Optional[str]) -> Optional[str]:
    detail = name or ""
    if action.kind == "delay":
        record_event(site, hit, "delay", detail)
        time.sleep(action.seconds)
        return None
    if action.kind == "drop":
        record_event(site, hit, "drop", detail)
        raise InjectedFault(
            f"injected fault: dropped {site} message"
            + (f" ({name})" if name else "")
        )
    if action.kind == "duplicate":
        record_event(site, hit, "duplicate", detail)
        return "duplicate"
    if action.kind == "preempt":
        record_event(site, hit, "preempt", detail)
        from . import preemption

        preemption.request_preemption("fault plan: simulated maintenance")
        return None
    if action.kind == "kill_replica":
        record_event(site, hit, "kill_replica", detail)
        raise ReplicaKilled(
            f"injected fault: replica killed mid-batch ({site} hit {hit})"
        )
    if action.kind == "kill":
        record_event(site, hit, "kill", f"exit={action.exit_code}")
        # Flush anything buffered — the event log write above already
        # hit disk (opened in append mode per line).
        try:
            import sys

            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:  # noqa: BLE001
            pass
        os._exit(action.exit_code)
    return None


def fault_point(site: str, name: Optional[str] = None) -> Optional[str]:
    """Advance ``site``'s hit counter and execute any scheduled faults.

    Returns a directive string for actions the call site must implement
    itself (currently only ``"duplicate"``), else None.  Raises
    :class:`InjectedFault` for dropped messages and never returns for
    kills."""
    plan = _plan
    if plan is None:
        return None
    with _lock:
        hit = _counters.get(site, 0) + 1
        _counters[site] = hit
    rank, worker, gen = _identity()
    directive = None
    for action in plan.actions:
        if action.site != site:
            continue
        if action.kind in PAYLOAD_KINDS:
            continue  # payload faults run through payload_fault()
        if action.kind in DRIVER_KINDS:
            continue  # driver faults fire in the driver's own loop
        if not action.matches_process(rank, worker, gen):
            continue
        if not action.in_window(hit):
            continue
        if not plan.decide(action, rank):
            continue
        out = _execute(action, site, hit, name)
        directive = out or directive
    return directive


def _mutate_payload(plan: FaultPlan, action: FaultAction, site: str,
                    hit: int, name: str, tensor, rank):
    """Apply one corrupt/nan action to a tensor payload. Returns a mutated
    COPY, the input is never written through: a numpy array for numpy
    input (as the JAX package does), else a clone on the tensor's own
    device, mutated there. The element and the bit are drawn from the
    action's stream in the JAX package's order, so the event lines are the
    same bytes; nothing is read back to the host (no sync on the card)."""
    import torch

    if not torch.is_tensor(tensor):
        return _mutate_array(plan, action, site, hit, name, tensor, rank)
    n = tensor.numel()
    if n == 0:
        return tensor
    rng = plan._stream(action, rank)
    if action.kind == "nan":
        if not tensor.is_floating_point():
            return tensor  # integer payloads have no NaN to inject
        idx = (action.element if action.element is not None
               else rng.randrange(n)) % n
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        out.view(-1)[idx:idx + 1].fill_(float("nan"))
        record_event(site, hit, "nan", f"{name}[{idx}]")
        return out
    # corrupt: flip one bit of one element's raw bytes (little-endian, as
    # numpy's view), so exponent/sign corruption is possible.
    itemsize = tensor.element_size()
    idx = (action.element if action.element is not None
           else rng.randrange(n)) % n
    bit = (action.bit if action.bit is not None
           else rng.randrange(8 * itemsize)) % (8 * itemsize)
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    byte = idx * itemsize + bit // 8
    out.view(-1).view(torch.uint8)[byte:byte + 1].bitwise_xor_(1 << (bit % 8))
    record_event(site, hit, "corrupt", f"{name}[{idx}] bit {bit}")
    return out


def _mutate_array(plan: FaultPlan, action: FaultAction, site: str,
                  hit: int, name: str, tensor, rank):
    """:func:`_mutate_payload` for an array (the JAX package's numpy
    path)."""
    import numpy as np

    arr = np.array(np.asarray(tensor), copy=True)
    if arr.size == 0:
        return tensor
    rng = plan._stream(action, rank)
    if action.kind == "nan":
        if not np.issubdtype(arr.dtype, np.floating):
            return tensor  # integer payloads have no NaN to inject
        idx = (action.element if action.element is not None
               else rng.randrange(arr.size)) % arr.size
        arr.flat[idx] = np.nan
        record_event(site, hit, "nan", f"{name}[{idx}]")
        return arr
    itemsize = arr.dtype.itemsize
    idx = (action.element if action.element is not None
           else rng.randrange(arr.size)) % arr.size
    bit = (action.bit if action.bit is not None
           else rng.randrange(8 * itemsize)) % (8 * itemsize)
    view = arr.reshape(-1).view(np.uint8)
    view[idx * itemsize + bit // 8] ^= np.uint8(1 << (bit % 8))
    record_event(site, hit, "corrupt", f"{name}[{idx}] bit {bit}")
    return arr


def payload_fault(site: str, name: str, tensor):
    """Advance the payload hit counters and apply any scheduled payload
    mutations (``corrupt`` / ``nan``) to ``tensor``. Returns the tensor
    (a mutated copy when a fault fired, the original otherwise; a torch
    tensor comes back as a tensor on its own device).
    Call sites gate on :data:`ACTIVE`; sites: ``payload`` (collective
    input at submission), ``output`` (this rank's collective result).
    A torch tensor comes back as a tensor on its own device.

    An action with a ``tensor`` name pattern is windowed over its OWN
    (site, pattern) counter — it counts only matching payloads, so
    internal collectives (digest agreement, elastic sync) passing the
    same tap never shift the schedule. Patternless actions use the
    site-global counter."""
    import fnmatch

    plan = _plan
    if plan is None or tensor is None:
        return tensor
    patterns = sorted({
        a.tensor for a in plan.actions
        if a.kind in PAYLOAD_KINDS and a.site == site
        and a.tensor is not None
        and fnmatch.fnmatchcase(name, a.tensor)
    })
    with _lock:
        hit = _counters.get(site, 0) + 1
        _counters[site] = hit
        pattern_hits = {}
        for p in patterns:
            key = f"{site}|{p}"
            pattern_hits[p] = _counters.get(key, 0) + 1
            _counters[key] = pattern_hits[p]
    rank, worker, gen = _identity()
    out = tensor
    for action in plan.actions:
        if action.site != site or action.kind not in PAYLOAD_KINDS:
            continue
        if action.tensor is not None:
            if action.tensor not in pattern_hits:
                continue
            window_hit = pattern_hits[action.tensor]
        else:
            window_hit = hit
        if not action.matches_process(rank, worker, gen):
            continue
        if not action.in_window(window_hit):
            continue
        if not plan.decide(action, rank):
            continue
        out = _mutate_payload(
            plan, action, site, window_hit, name, out, rank
        )
    return out


def step(name: Optional[str] = None) -> None:
    """Mark one training step (``State.commit`` calls this; non-elastic
    loops may call it directly).  No-op without an active plan."""
    if ACTIVE:
        fault_point("step", name)


# Load at import so worker processes spawned with HOROVOD_FAULT_PLAN in
# their environment are armed without any code changes.
if os.environ.get(FAULT_PLAN_ENV, "").strip():
    try:
        activate_from_env()
    except Exception:  # noqa: BLE001 - a malformed plan must not
        # take down production init; it is surfaced by the chaos tools.
        import logging

        logging.getLogger("horovod_tpu_torch.fault").exception(
            "could not load %s", FAULT_PLAN_ENV
        )
