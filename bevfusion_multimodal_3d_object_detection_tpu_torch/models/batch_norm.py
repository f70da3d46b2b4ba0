"""BatchNorm that keeps flax's running statistics.

torch's BatchNorm updates ``running_var`` with the unbiased batch variance,
n/(n-1) · var; flax's ``nn.BatchNorm`` (momentum 0.9) with the biased one,
the variance both normalize with in training. `FlaxBatchNorm1d` and
`FlaxBatchNorm2d` keep torch's parameters, buffers and state_dict keys, and
normalize as torch does; in training they update

    running = (1 - momentum) · running + momentum · batch statistic

with the batch mean and the biased variance, computed in at least f32
(momentum 0.1 here is flax's 0.9; flax has no cumulative average, so
``momentum=None`` is refused). Eval mode is torch's own forward.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn


class _FlaxStatistics:
    # False while an activation checkpoint recomputes the forward
    # (`frozen_statistics`): the recomputation must not update twice
    update_stats = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.momentum is None:
            raise ValueError("flax's BatchNorm has no cumulative average: give a momentum")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if self.update_stats:
            dims = [0] + list(range(2, x.ndim))
            with torch.no_grad():
                xs = x.to(torch.promote_types(x.dtype, torch.float32))
                var, mean = torch.var_mean(xs, dim=dims, correction=0)
                self.num_batches_tracked.add_(1)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class FlaxBatchNorm1d(_FlaxStatistics, nn.BatchNorm1d):
    """BatchNorm1d over (N, C) or (N, C, L) with flax's running statistics."""


class FlaxBatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    """BatchNorm2d over (N, C, H, W) with flax's running statistics."""


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
