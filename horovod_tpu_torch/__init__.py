"""horovod_tpu_torch: the PyTorch/CUDA port of the JAX package.

The JAX package ``horovod_tpu`` stays as the reference; this package does
the same work on ``torch.distributed`` (NCCL on the card) with kernels
written by hand for Hopper. It imports neither JAX nor anything of
``horovod_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``.

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
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from .common.compression import Compression
from .common.types import Adasum, Average, Max, Min, Product, ReduceOp, Sum
from .ops.collectives import (
    allgather,
    allreduce,
    broadcast,
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
    "local_size", "device", "ReduceOp", "Average", "Sum", "Min", "Max",
    "Product", "Adasum", "Compression", "allreduce", "allgather", "broadcast",
    "hierarchical_allreduce", "hierarchical_allgather", "hierarchical_reducescatter",
    "hierarchical_broadcast", "hierarchical_alltoall", "init_composed_zero1_state",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "make_train_step", "GradientAccumulator",
    "allreduce_gradients", "error_feedback_state", "EFState", "HorovodInternalError",
]
