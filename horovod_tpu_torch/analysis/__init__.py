"""Collective-safety static checks.

The port of ``horovod_tpu/analysis`` so far: the finding model
(:mod:`.findings`), the cross-rank ordering lint over simulated or recorded
submission traces (:mod:`.ordering`), the grouped-collective checks
(:mod:`.groups`), the opt-in pre-flight of ``HOROVOD_TPU_STATIC_CHECKS``
(:mod:`.preflight`) and the symbolic verifier of the compositor's plans
(:mod:`.plan_verify`: :func:`verify_plan`, :func:`verify_plan_grid`). The
rest (sharding rules, the runtime lint, rank divergence, the graph lint and
the pre-flight's compiled half) is ROADMAP A13c.
"""

from .plan_verify import verify_plan, verify_plan_grid  # noqa: F401
