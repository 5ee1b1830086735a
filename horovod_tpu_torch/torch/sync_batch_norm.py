"""Synchronized batch normalization: ``hvd.SyncBatchNorm``.

The port of ``horovod_tpu/torch/sync_batch_norm.py``: batch statistics
over the GLOBAL batch by the two-allreduce scheme. The forward allreduces
the per-channel ``[sum, sum of squares, count]`` (name
``syncbn.<n>.fwd``), the backward ``[sum dy, sum dy * (x - mean)]``
(``syncbn.<n>.bwd``) and applies the batch-norm gradient identity. The
statistics are computed and reduced in float32 (bf16 sums lose the mean,
f16 sums of squares overflow); only the output returns to the input's
dtype.

Unlike the JAX module, which moves the statistics through numpy on the
host, the statistics stay on the input's device: on the card they are
reduced by the eager allreduce on CUDA tensors, ordered on the stream
that produced them. Each layer blocks its forward and its backward on one
named negotiation.

Eval mode uses the running statistics (the same on every rank by
construction) and never communicates; at one rank the module is
``nn.BatchNorm`` (``_use_sync``). The weight and bias gradients stay local:
a DistributedOptimizer reduces them with the others.
"""

from __future__ import annotations

import itertools

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from .. import eager
from ..common import basics as _basics
from ..common.types import ReduceOp

_ids = itertools.count()


class _SyncBatchNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, tag):
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        count_local = x.numel() // c
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           torch.full((1,), float(count_local), device=x.device)])
        stats = eager.allreduce(stats, op=ReduceOp.SUM, name=f"{tag}.fwd")
        count = stats[-1]
        mean = stats[:c] / count
        var = stats[c:2 * c] / count - mean * mean
        invstd = torch.rsqrt(var + eps)
        shape = [1, c] + [1] * (x.dim() - 2)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        y = (xhat * weight.float().view(shape) + bias.float().view(shape)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.tag = tag
        return y, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        dyf = dy.float()
        xmu = x.float() - mean.view(shape)
        grad_stats = eager.allreduce(torch.cat([dyf.sum(dims), (dyf * xmu).sum(dims)]),
                                     op=ReduceOp.SUM, name=f"{ctx.tag}.bwd")
        sum_dy = grad_stats[:c] / count
        sum_dy_xmu = grad_stats[c:] / count
        # d/dx of (x - mean) * invstd * w (the batch-norm identity).
        dx = ((dyf - sum_dy.view(shape)
               - xmu * (invstd.view(shape) ** 2) * sum_dy_xmu.view(shape))
              * invstd.view(shape) * weight.float().view(shape)).to(x.dtype)
        dweight = (dyf * xmu * invstd.view(shape)).sum(dims).to(weight.dtype)
        dbias = dyf.sum(dims).to(weight.dtype)
        return dx, dweight, dbias, None, None


class SyncBatchNorm(_BatchNorm):
    """Batch norm over the global batch (all ranks); a drop-in for
    ``nn.BatchNorm1d/2d/3d``. In training mode the statistics are
    allreduced; the running statistics follow the usual momentum update
    (unbiased variance) and are the same on every rank. Every rank must
    create its SyncBatchNorm layers in the same order: the order names
    their collectives."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._tag = f"syncbn.{next(_ids)}"

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {x.dim()}D)")

    def _use_sync(self) -> bool:
        """Whether this forward reduces its statistics across ranks: in
        training mode on more than one rank."""
        return self.training and _basics.size() > 1

    def forward(self, x):
        self._check_input_dim(x)
        if not self._use_sync():
            return super().forward(x)
        # The momentum bookkeeping applies only with running statistics (as
        # in _BatchNorm.forward; num_batches_tracked is None without them).
        momentum = self.momentum
        if self.track_running_stats and self.momentum is None:
            self.num_batches_tracked += 1
            momentum = 1.0 / float(self.num_batches_tracked)
        weight = (self.weight if self.affine
                  else torch.ones(x.shape[1], dtype=x.dtype, device=x.device))
        bias = (self.bias if self.affine
                else torch.zeros(x.shape[1], dtype=x.dtype, device=x.device))
        y, mean, var, count = _SyncBatchNormFunction.apply(x, weight, bias, self.eps, self._tag)
        if self.track_running_stats:
            with torch.no_grad():
                unbiased = var * (count / (count - 1).clamp(min=1.0))
                self.running_mean.mul_(1 - momentum).add_(mean.detach(), alpha=momentum)
                self.running_var.mul_(1 - momentum).add_(unbiased.detach(), alpha=momentum)
                if self.momentum is not None:
                    self.num_batches_tracked += 1
        return y
