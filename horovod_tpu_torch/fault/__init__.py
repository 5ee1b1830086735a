"""Deterministic fault injection and the recovery machinery it exercises.

The port of ``horovod_tpu/fault`` (the same exports). Two halves:

- **Injection** (:mod:`.plan`, :mod:`.injector`): a seeded fault schedule
  from ``HOROVOD_FAULT_PLAN`` (kill worker N at step K, delay a rank's
  submissions, drop or duplicate control-plane messages, poison or flip a
  bit of a gradient, deliver a simulated maintenance notice), executed at
  fixed taps in the eager runtimes, the KV client, the probe plane and the
  serving engine. The call sites read :data:`injector.ACTIVE`: with the
  variable unset the check is the whole cost.
- **Recovery** (:mod:`.backoff`, :mod:`.preemption`): bounded retry with
  exponential backoff and seeded jitter for control-plane requests, and
  the preemption notice flag, which ``elastic.run`` consumes: it installs
  the SIGTERM handler, and the next ``State.commit`` drains and rejoins.
"""

from .backoff import (  # noqa: F401
    Backoff,
    retry_call,
    HOROVOD_FAULT_SEED,
    HOROVOD_RPC_BACKOFF_BASE_S,
    HOROVOD_RPC_BACKOFF_JITTER,
    HOROVOD_RPC_BACKOFF_MAX_S,
    HOROVOD_RPC_RETRIES,
)
from . import injector  # noqa: F401  (live ACTIVE flag: injector.ACTIVE)
from .injector import (  # noqa: F401
    FAULT_EVENT_LOG_ENV,
    InjectedFault,
    ReplicaKilled,
    activate_from_env,
    active_plan,
    events,
    fault_point,
    install_plan,
    payload_fault,
    record_event,
    reset,
    step,
)
from .plan import FAULT_PLAN_ENV, FaultAction, FaultPlan  # noqa: F401
from .preemption import (  # noqa: F401
    PreemptionInterrupt,
    clear as clear_preemption,
    install_sigterm_handler,
    preemption_requested,
    request_preemption,
)

__all__ = [
    "Backoff",
    "FAULT_EVENT_LOG_ENV",
    "FAULT_PLAN_ENV",
    "FaultAction",
    "FaultPlan",
    "InjectedFault",
    "PreemptionInterrupt",
    "activate_from_env",
    "active_plan",
    "clear_preemption",
    "events",
    "fault_point",
    "install_plan",
    "install_sigterm_handler",
    "payload_fault",
    "preemption_requested",
    "record_event",
    "request_preemption",
    "reset",
    "retry_call",
    "step",
]
