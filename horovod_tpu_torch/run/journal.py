"""Durable control-plane journal for the elastic driver.

The port of ``horovod_tpu/run/journal.py``, byte for byte in what it
writes: a journal written by either package's driver replays in the
other's.

Everything the :class:`~horovod_tpu_torch.run.elastic_driver.ElasticDriver`
needs to survive its own death lives ONLY in that process's memory: the
generation counter, world membership, blacklist/cooldown state, and the
rendezvous-critical keys of the HTTP KV store. This module write-ahead
journals that state to disk so ``python -m horovod_tpu_torch.run --resume`` (or the
``--auto-resume`` supervisor)
can replay it, rebind the rendezvous port, and re-enter the elastic loop
at the recorded generation instead of respawning an otherwise-healthy
fleet (docs/fault_tolerance.md "Control-plane availability").

Disciplines:

- **Atomicity** — every journal write goes through the same same-dir
  tmp + ``fsync`` + ``os.replace`` pattern as ``utils/checkpoint.py``:
  a driver killed mid-write leaves the previous complete journal, never
  a torn one. Replay is a pure function of the journal bytes, so
  resuming twice from the same journal yields identical state (the
  idempotence the chaos suite asserts).
- **Epoch fencing** — the journal carries a monotonically-increasing
  *driver epoch*. Every open of an existing journal (resume or not)
  bumps it, and the live driver advertises it on the KV plane
  (``elastic/driver``); workers reject any driver presenting an epoch
  LOWER than one they have already seen, so a stale driver that lost a
  supervisor race can never re-capture a fleet its successor owns.
- **Monotonic-safe deadlines** — blacklist quarantines are tracked on
  the monotonic clock in memory (immune to NTP steps) but serialized as
  absolute wall-clock deadlines PLUS the remaining quarantine at write
  time. Restore trusts the wall deadline only up to that remaining
  budget: a resume on a backwards-skewed clock cannot re-extend a
  quarantine, and a forwards skew (or genuine elapsed downtime) expires
  it — a resumed driver neither re-quarantines healthy hosts nor
  forgets active quarantines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

JOURNAL_BASENAME = "driver_journal.json"
JOURNAL_ENV = "HOROVOD_DRIVER_JOURNAL"

# Journal schema version: replay refuses documents from the future so a
# downgraded driver fails loudly instead of resuming with half a state.
# v2 (self-driving fleet, docs/fault_tolerance.md "Self-driving fleet")
# adds the slowness-quarantine ledger (``slow_strikes``,
# ``blacklist_reasons``), the published re-plan notice (``replan``), and
# the hot-spare pool (``spare_ids``).
_VERSION = 2

# Record keys introduced by v2. A document that CLAIMS an older version
# while carrying them is mixed state (e.g. an operator splicing new
# records into an old journal, or a partial downgrade-then-upgrade):
# replay refuses it loudly rather than silently dropping — or silently
# trusting — the new records.
_V2_KEYS = ("slow_strikes", "blacklist_reasons", "replan", "spare_ids")


def default_path(output_dir: Optional[str],
                 env: Optional[Dict[str, str]] = None) -> Optional[str]:
    """Journal location: explicit ``HOROVOD_DRIVER_JOURNAL`` wins, else
    the driver's ``--output-dir`` (where the rest of the postmortem
    artifacts live), else journaling is disabled (None)."""
    e = env if env is not None else os.environ
    explicit = e.get(JOURNAL_ENV, "").strip()
    if explicit:
        return explicit
    if output_dir:
        return os.path.join(output_dir, JOURNAL_BASENAME)
    return None


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Same discipline as utils/checkpoint.py: readers see the complete
    old document or the complete new one, never a torn journal."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


# ------------------------------------------------- blacklist (de)serialization
def blacklist_to_journal(
    blacklist: Dict[str, Optional[float]],
    *,
    now_mono: Optional[float] = None,
    now_wall: Optional[float] = None,
) -> Dict[str, Dict[str, Any]]:
    """Serialize monotonic quarantine deadlines as absolute wall-clock
    deadlines plus the remaining quarantine at write time (the clamp
    restore needs to be skew-safe). ``None`` deadlines (permanent
    blacklist) survive as-is."""
    now_mono = time.monotonic() if now_mono is None else now_mono
    now_wall = time.time() if now_wall is None else now_wall
    out: Dict[str, Dict[str, Any]] = {}
    for host, deadline in blacklist.items():
        if deadline is None:
            out[host] = {"permanent": True}
        else:
            remaining = max(0.0, deadline - now_mono)
            out[host] = {
                "deadline_unix": now_wall + remaining,
                "remaining_s": remaining,
            }
    return out


def blacklist_from_journal(
    doc: Dict[str, Dict[str, Any]],
    *,
    now_mono: Optional[float] = None,
    now_wall: Optional[float] = None,
) -> Dict[str, Optional[float]]:
    """Restore quarantine deadlines onto THIS process's monotonic clock.

    The wall-clock deadline is trusted only up to the remaining budget
    recorded at write time: ``remaining = clamp(deadline - now_wall,
    0, remaining_at_write)``. A clock skewed backwards across the
    restart (deadline appears far in the future) cannot quarantine a
    host for longer than it had left; a clock skewed forwards — or real
    elapsed downtime — shortens or expires it, which is the correct
    reading (the host served its time while the driver was down).
    Entries restored at zero remaining are dropped (re-admitted), never
    re-quarantined."""
    now_mono = time.monotonic() if now_mono is None else now_mono
    now_wall = time.time() if now_wall is None else now_wall
    out: Dict[str, Optional[float]] = {}
    for host, entry in doc.items():
        if entry.get("permanent"):
            out[host] = None
            continue
        try:
            deadline_unix = float(entry["deadline_unix"])
            budget = max(0.0, float(entry.get("remaining_s", 0.0)))
        except (KeyError, TypeError, ValueError):
            continue  # malformed entry: re-admit rather than wedge resume
        remaining = min(max(0.0, deadline_unix - now_wall), budget)
        if remaining > 0.0:
            out[host] = now_mono + remaining
    return out


class DriverJournal:
    """One JSON document, atomically rewritten on every control-plane
    state transition (generation publish, blacklist change, KV-scope
    change, epoch bump). ``replay()`` is side-effect free and pure in
    the journal bytes."""

    def __init__(self, path: str):
        self.path = path
        self._state: Dict[str, Any] = {"version": _VERSION, "epoch": 0}
        self.writes = 0

    # ------------------------------------------------------------- open
    @staticmethod
    def open(path: str) -> "DriverJournal":
        """Open (and fence) the journal at ``path``: any recorded epoch
        is bumped — whether this is a resume or a fresh job reusing the
        directory — so the new driver's epoch is strictly greater than
        every driver that ever wrote this journal. The bump is persisted
        immediately (write-ahead: the fence must be durable before the
        driver advertises itself)."""
        j = DriverJournal(path)
        prior = j.replay()
        if prior is not None:
            j._state = dict(prior)
        j._state["epoch"] = int(j._state.get("epoch", 0)) + 1
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        j._write()
        return j

    # ----------------------------------------------------------- replay
    def replay(self) -> Optional[Dict[str, Any]]:
        """Parse the journal from disk; None when absent or unreadable
        (a torn write is impossible by construction, but an operator-
        truncated file degrades to a fresh start, loudly at the
        caller)."""
        try:
            with open(self.path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        version = int(doc.get("version", 0))
        if version > _VERSION:
            raise RuntimeError(
                f"driver journal {self.path} is version "
                f"{doc.get('version')} but this build understands "
                f"<= {_VERSION}; refusing to resume with partial state"
            )
        if version < 2:
            present = sorted(k for k in _V2_KEYS if k in doc)
            if present:
                raise RuntimeError(
                    f"driver journal {self.path} claims version "
                    f"{version} but carries v2 records {present}; the "
                    "document is mixed state — refusing to resume "
                    "rather than silently dropping the newer records"
                )
        return doc

    # ----------------------------------------------------------- record
    @property
    def epoch(self) -> int:
        return int(self._state.get("epoch", 0))

    @property
    def state(self) -> Dict[str, Any]:
        return dict(self._state)

    def record(self, **updates: Any) -> None:
        """Merge ``updates`` into the journal state and persist
        atomically. This is the write-ahead point: callers journal a
        transition BEFORE exposing it to workers (KV publish), so a
        crash between the two replays a state the fleet has not yet
        outrun."""
        self._state.update(updates)
        self._write()

    def _write(self) -> None:
        self._state["version"] = _VERSION
        self._state["written_unix"] = time.time()
        data = json.dumps(
            self._state, sort_keys=True, separators=(",", ":")
        ).encode("utf-8")
        _atomic_write_bytes(self.path, data)
        self.writes += 1
