"""ResNet-18 trunk through layer3 (stride 16), NCHW.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/models/resnet.py:23-200``
without torchvision. Module names follow the flax tree (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv``...) so `utils.convert.load_jax_variables`
maps one onto the other by name. `fold_bn=True` builds the serving variant:
convs carry a bias and the BatchNorms are gone (weights pre-folded by
`utils.fold_bn`). `remat=True` checkpoints each residual block in training
(``jax.checkpoint`` in the JAX package): the backward recomputes the block's
forward with its BatchNorms' running statistics frozen, so they update once
per step, as flax's functional remat does. The space-to-depth stem is not
ported (off by default).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .batch_norm import FlaxBatchNorm2d, frozen_statistics


def batch_norm(channels: int) -> FlaxBatchNorm2d:
    # flax momentum 0.9 on the running average == torch momentum 0.1
    return FlaxBatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _recompute_contexts(block: nn.Module):
    return contextlib.nullcontext(), frozen_statistics(block)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + skip, final ReLU."""

    def __init__(self, in_channels: int, channels: int, strides: int = 1,
                 fold_bn: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        self.conv1 = nn.Conv2d(in_channels, channels, 3, strides, 1, bias=fold_bn)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=fold_bn)
        if not fold_bn:
            self.bn1 = batch_norm(channels)
            self.bn2 = batch_norm(channels)
        self.has_downsample = strides != 1 or in_channels != channels
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(
                in_channels, channels, 1, strides, 0, bias=fold_bn
            )
            if not fold_bn:
                self.downsample_bn = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        if not self.fold_bn:
            y = self.bn1(y)
        y = self.conv2(F.relu(y))
        if not self.fold_bn:
            y = self.bn2(y)
        residual = x
        if self.has_downsample:
            residual = self.downsample_conv(x)
            if not self.fold_bn:
                residual = self.downsample_bn(residual)
        return F.relu(y + residual)


class ResNet18Trunk(nn.Module):
    """(N, 3, H, W) -> (N, 256, H/16, W/16)."""

    stage_sizes = (2, 2, 2)
    stage_channels = (64, 128, 256)

    def __init__(self, fold_bn: bool = False, remat: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=fold_bn)
        if not fold_bn:
            self.bn1 = batch_norm(64)
        self.block_names = []
        in_ch = 64
        for s, (num_blocks, ch) in enumerate(zip(self.stage_sizes, self.stage_channels)):
            for i in range(num_blocks):
                strides = 2 if (s > 0 and i == 0) else 1
                name = f"layer{s + 1}_{i}"
                self.add_module(name, BasicBlock(in_ch, ch, strides, fold_bn))
                self.block_names.append(name)
                in_ch = ch
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        if not self.fold_bn:
            x = self.bn1(x)
        # torch MaxPool2d(3, stride=2, padding=1) pads with -inf, as flax does
        x = F.max_pool2d(F.relu(x), 3, 2, 1)
        for name in self.block_names:
            block = getattr(self, name)
            if self.remat and self.training and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=functools.partial(_recompute_contexts, block))
            else:
                x = block(x)
        return x
