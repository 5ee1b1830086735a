"""Calibrated fleet simulator: the port of ``horovod_tpu/sim``.

It composes three models the package already trusts into one
deterministic discrete-event simulation of a training step (HiCCL-style
analytic modelling, arXiv:2408.05962):

- **Compute**: the backward is cut into the exact stream groups
  ``ops/fusion.plan_layer_groups`` registers, each segment freeing its
  group's gradients for the wire.
- **Communication**: every group's collective lowers through the
  compositor (``topo/compositor.py``): the selected plan's per-stage
  alpha-beta costs are replayed hop by hop, each hop a serially shared
  resource, so two-level, split, int8 and ZeRO-1 RS+AG price exactly as
  the planner prices them.
- **Faults**: stragglers come from seeded ``fault/plan.py`` schedules
  (``delay`` actions at the ``step`` site), drawn from the plan's
  per-(seed, action, rank) decision streams, so a simulated incident is
  byte-reproducible.

:mod:`sim.calibrate` fits per-hop alpha-beta constants from the
``trace_merge --stats`` summary of a real run into a signature-keyed
``calibration.json`` (a calibration for another hop ladder warns and falls
back to the generation defaults), and ``tools/fleet_sim --replay`` reports
the per-hop model-against-measured divergence as
``hvd_sim_divergence_ratio{hop}``. :func:`simulate_serve` plays an
open-loop Poisson arrival stream through the serving batcher.

Nothing here touches a device: two runs from one seed give the same bytes,
and the same bytes as the JAX package's simulator.
"""

from __future__ import annotations

from .calibrate import (  # noqa: F401
    Calibration,
    apply_calibration,
    divergence_report,
    fit_calibration,
    load_calibration,
    measured_from_stats,
    model_signature,
    resolve_calibration,
    save_calibration,
)
from .core import (  # noqa: F401
    ServeSimConfig,
    SimConfig,
    SimGroup,
    SimProgram,
    SimResult,
    program_from_layers,
    program_from_spec,
    simulate,
    simulate_serve,
    straggler_sensitivity,
    tp_fixed_comm_us,
)
