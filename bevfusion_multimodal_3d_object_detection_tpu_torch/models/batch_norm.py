"""BatchNorm that keeps flax's running statistics.

torch's BatchNorm updates ``running_var`` with the unbiased batch variance,
n/(n-1) · var; flax's ``nn.BatchNorm`` (momentum 0.9) with the biased one,
the variance both normalize with in training. `FlaxBatchNorm1d`,
`FlaxBatchNorm2d` and `FlaxBatchNorm3d` keep torch's parameters, buffers and
state_dict keys, and normalize as torch does; in training they update

    running = (1 - momentum) · running + momentum · batch statistic

with the batch mean and the biased variance, computed in at least f32
(momentum 0.1 here is flax's 0.9; flax has no cumulative average, so
``momentum=None`` is refused). Eval mode is torch's own forward.

Under data parallelism (`global_statistics`) the batch statistics are the
global batch's, as a jitted JAX step over a ``('data', 'view')`` mesh computes them
(`_GlobalBatchNorm`, an autograd function): the ranks' statistics are
combined over the group (on CUDA each rank's Welford mean and variance,
gathered; on the CPU each channel's sum and count, then its sum of squared
deviations from the global mean: where flax takes the mean of squares less
the squared mean, which cancels in f32 where a channel's spread is small
against its mean, and torch's own statistics do not), and the running
statistics take the global mean and biased variance. Its backward sums each
channel's gradient and gradient times the normalized input over the group,
the derivative through the global statistics. The input is kept in its own
dtype and the statistics in at least f32. The recomputation of an
activation checkpoint issues the same collectives on every rank, in the
same order.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm of `x` (N, C, ...) with the statistics of
    the global batch of `group`; returns (y, mean, biased variance). On
    CUDA it runs torch's fused batch-norm kernels (the ones
    ``nn.SyncBatchNorm`` runs: Welford statistics per rank combined across
    ranks, the input kept in its own dtype); on the CPU, plain tensor ops."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        c = x.shape[1]
        ctx.group = group
        if x.is_cuda:
            x = x.contiguous()
            mean, invstd = torch.batch_norm_stats(x, eps)
            local = torch.cat([mean, invstd, mean.new_full((1,), x.numel() // c)])
            gathered = local.new_empty(dist.get_world_size(group) * local.numel())
            dist.all_gather_into_tensor(gathered, local, group=group)
            gathered = gathered.view(-1, 2 * c + 1)
            counts = gathered[:, 2 * c]
            # scratch running statistics (torch's update, unbiased, is not
            # flax's): with them the counts may stay in the statistics' f32
            # where without them they would take a bf16 input's dtype
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, gathered[:, :c], gathered[:, c:2 * c], mean.new_zeros(c), mean.new_ones(c), 0.0, eps, counts)
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
            var = invstd.pow(-2) - eps
            ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        else:
            dims = [0] + list(range(2, x.ndim))
            shape = (1, -1) + (1,) * (x.ndim - 2)
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            total = torch.cat([xs.sum(dims), xs.new_full((1,), xs.numel() // c)])
            dist.all_reduce(total, group=group)
            count = total[-1]
            mean = total[:c] / count
            centred = xs - mean.view(shape)
            var = centred.square().sum(dims)
            dist.all_reduce(var, group=group)
            var = var / count
            invstd = torch.rsqrt(var + eps)
            scale = invstd if weight is None else invstd * weight
            y = centred.mul_(scale.view(shape))
            if bias is not None:
                y = y.add_(bias.view(shape))
            y = y.to(x.dtype)
            ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = mean.shape[0]
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        if x.is_cuda:
            grad = grad.contiguous()
            sum_g, sum_gx, grad_w, grad_b = torch.batch_norm_backward_reduce(
                grad, x, mean, invstd, weight, need_x, need_w, need_b)
            grad_x = None
            if need_x:
                total = torch.cat([sum_g, sum_gx])
                dist.all_reduce(total, group=ctx.group)
                grad_x = torch.batch_norm_backward_elemt(grad, x, mean, invstd, weight, total[:c], total[c:], count)
            return grad_x, grad_w, grad_b, None, None
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        g = grad.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        scale = invstd if weight is None else invstd * weight
        grad_x = (g - (total[:c] / count).view(shape) - xhat * (total[c:] / count).view(shape))
        grad_x = grad_x.mul_(scale.view(shape)).to(x.dtype)
        # the affine parameters' gradients stay this rank's share: the
        # train step sums them over the group with every other gradient
        return grad_x, local[c:] if need_w else None, local[:c] if need_b else None, None, None


class _FlaxStatistics:
    # False while an activation checkpoint recomputes the forward
    # (`frozen_statistics`): the recomputation must not update twice
    update_stats = True
    # the process group whose global batch the statistics are taken over
    # (`global_statistics`); None: this process's batch alone
    group = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.momentum is None:
            raise ValueError("flax's BatchNorm has no cumulative average: give a momentum")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if self.group is not None:
            return self._global_forward(x)
        if self.update_stats:
            dims = [0] + list(range(2, x.ndim))
            with torch.no_grad():
                xs = x.to(torch.promote_types(x.dtype, torch.float32))
                var, mean = torch.var_mean(xs, dim=dims, correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.group, self.eps)
        if self.update_stats:
            self._update_running(mean, var)
        return y


class FlaxBatchNorm1d(_FlaxStatistics, nn.BatchNorm1d):
    """BatchNorm1d over (N, C) or (N, C, L) with flax's running statistics."""


class FlaxBatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    """BatchNorm2d over (N, C, H, W) with flax's running statistics."""


class FlaxBatchNorm3d(_FlaxStatistics, nn.BatchNorm3d):
    """BatchNorm3d over (N, C, D, H, W) with flax's running statistics."""


def global_statistics(module: nn.Module, group, camera_group=None) -> nn.Module:
    """Take the train-mode batch statistics of every BatchNorm under
    `module` over the global batch of `group` (a process group; None: each
    process's own batch again), those under ``module.camera_encoder`` over
    `camera_group` where one is given: with a view axis the trunk sees
    distinct cameras on every rank of the world, the rest the rows that a
    view group shares. Returns `module`."""
    for m in module.modules():
        if isinstance(m, _FlaxStatistics):
            m.group = group
    if camera_group is not None and hasattr(module, "camera_encoder"):
        global_statistics(module.camera_encoder, camera_group)
    return module


@contextlib.contextmanager
def frozen_statistics(module: nn.Module) -> Iterator[None]:
    """Inside, the train-mode BatchNorms under `module` normalize with batch
    statistics but leave their running statistics as they are."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxStatistics)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True
