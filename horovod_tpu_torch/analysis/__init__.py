"""Collective-safety static checks of the eager API.

The eager half of ``horovod_tpu/analysis``: the finding model
(:mod:`.findings`), the cross-rank ordering lint over simulated or recorded
submission traces (:mod:`.ordering`), the grouped-collective checks
(:mod:`.groups`) and the opt-in pre-flight of ``HOROVOD_TPU_STATIC_CHECKS``
(:mod:`.preflight`). The compiled-mode passes (jaxpr lint, rank
divergence, the plan verifier, sharding rules) are ROADMAP A13.
"""
