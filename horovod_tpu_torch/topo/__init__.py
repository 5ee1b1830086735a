"""Topology-aware collective compositor (the port of ``horovod_tpu/topo``).

``topo.model`` — the machine-readable interconnect hierarchy (hops with
per-generation bandwidth/latency defaults, the card's ``h100`` entry
among them, the ``HOROVOD_TOPOLOGY_MODEL`` override, homogeneity-gated
eligibility).

``topo.compositor`` — hierarchical lowering plans for every collective
(allreduce, allgather, reduce-scatter, broadcast, alltoall), the alpha-beta
cost model selecting ring, recursive halving, two-level or split per
(model, payload bytes, op), and the lowerings over process groups that run
the selected plan.

Planning touches no device (``tools/topo_plan`` prints plans anywhere);
lowering runs over ``torch.distributed`` groups.
"""

from .model import (  # noqa: F401
    GENERATION_DEFAULTS,
    Hop,
    InterconnectModel,
    apply_override,
    detect_generation,
    model_from_mesh_shape,
    model_from_topology,
    resolve_model,
    synthetic_model,
)
from .compositor import (  # noqa: F401
    COLLECTIVES,
    Plan,
    Stage,
    auto_reduce_fn,
    candidate_plans,
    model_for_axes,
    lower_allgather,
    lower_allreduce,
    lower_alltoall,
    lower_broadcast,
    lower_reducescatter,
    perm_rounds,
    planned_reduce_fn,
    record_plan,
    select_plan,
    split_fractions,
    stage_kind,
)
