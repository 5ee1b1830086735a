"""horovod_tpu_torch: the PyTorch/CUDA port of the JAX package.

The JAX package ``horovod_tpu`` stays as the reference; this package does
the same work on ``torch.distributed`` (NCCL on the card) with kernels
written by hand for Hopper. It imports neither JAX nor anything of
``horovod_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``.

The top-level collectives (``allreduce``, ``allgather``, ``broadcast``,
``alltoall``, ``reducescatter``, the grouped and ``*_async`` forms, ``join``,
process sets) are the eager named operations of :mod:`.eager`, negotiated by
the native core ``init`` starts. The collectives on a process group, which
the training step uses, are in :mod:`.ops.collectives`.

Quick start (one process per GPU)::

    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    hvd.init()
    model = TransformerLM(32768, d_model=768, n_heads=12, n_layers=12)
    hvd.broadcast_parameters(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    step = hvd.make_train_step(
        lambda m, b: lm_loss(m(b[0]), b[1]), opt)
    loss = step(model, (tokens, labels))
"""

from .common.basics import (
    HorovodInternalError,
    cross_rank,
    cross_size,
    device,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from .common.compression import Compression
from .common.types import Adasum, Average, Max, Min, Product, ReduceOp, Status, Sum
from .eager import (
    ProcessSet,
    add_process_set,
    allgather,
    allgather_async,
    allgather_object,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    broadcast_object,
    broadcast_variables,
    collective_plan,
    ddl_built,
    global_process_set,
    gloo_built,
    gloo_enabled,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce,
    grouped_allreduce_async,
    grouped_reducescatter,
    grouped_reducescatter_async,
    join,
    mlsl_built,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    nccl_enabled,
    poll,
    reducescatter,
    reducescatter_async,
    remove_process_set,
    start_timeline,
    stop_timeline,
    synchronize,
    xla_built,
    xla_enabled,
)
from .ops.collectives import (
    hierarchical_allgather,
    hierarchical_allreduce,
    hierarchical_alltoall,
    hierarchical_broadcast,
    hierarchical_reducescatter,
)
from .ops.quantized import EFState
from .train import (
    DistributedOptimizer,
    GradientAccumulator,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
    error_feedback_state,
    init_composed_zero1_state,
    make_train_step,
)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device", "ReduceOp",
    "Average", "Sum", "Min", "Max", "Product", "Adasum", "Status", "Compression",
    "allreduce", "allreduce_async", "allgather", "allgather_async", "allgather_object",
    "broadcast", "broadcast_async", "broadcast_object", "broadcast_variables", "alltoall",
    "alltoall_async", "reducescatter", "reducescatter_async", "grouped_allreduce",
    "grouped_allreduce_async", "grouped_allgather", "grouped_allgather_async",
    "grouped_reducescatter", "grouped_reducescatter_async", "ProcessSet",
    "global_process_set", "add_process_set", "remove_process_set", "join", "barrier",
    "poll", "synchronize", "start_timeline", "stop_timeline", "collective_plan",
    "mpi_threads_supported", "mpi_built", "mpi_enabled", "gloo_built", "gloo_enabled",
    "nccl_built", "nccl_enabled", "ddl_built", "mlsl_built", "xla_built", "xla_enabled",
    "hierarchical_allreduce", "hierarchical_allgather", "hierarchical_reducescatter",
    "hierarchical_broadcast", "hierarchical_alltoall", "init_composed_zero1_state",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "make_train_step", "GradientAccumulator",
    "allreduce_gradients", "error_feedback_state", "EFState", "HorovodInternalError",
]
