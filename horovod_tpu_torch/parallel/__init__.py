"""Port of horovod_tpu/parallel: the mesh, and sequence, tensor, pipeline and
expert parallelism."""

from .ep import MoEParams, expert_sharding_specs, init_moe_params, make_ep_train_step, moe_ffn
from .pp import (STAGE_AXIS, init_pp_lm_state, init_pp_state, make_pp_lm_train_step,
                 make_pp_train_step, pipeline_apply, pipeline_lm_loss)

__all__ = ["MoEParams", "expert_sharding_specs", "init_moe_params", "make_ep_train_step",
           "moe_ffn", "STAGE_AXIS", "init_pp_lm_state", "init_pp_state",
           "make_pp_lm_train_step", "make_pp_train_step", "pipeline_apply", "pipeline_lm_loss"]
