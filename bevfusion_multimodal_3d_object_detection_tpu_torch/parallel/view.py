"""The camera-view axis: what a rank of a view group computes alone, and the
collectives that give every rank of the group the whole.

The JAX package shards ``camera_imgs`` over the mesh's ``'view'`` axis when
the camera axis divides by it (``parallel/mesh.py:72-97``) and, under
``parallel.bev_spatial``, pins the fused BEV map's rows to it
(``models/detector.py:139-142``); jit then runs each camera's trunk on one
device and the head's convs on row blocks. The numbers are those of the
unsharded program. The port runs one process per device, and the ranks of a
view group hold the same rows of the batch:

- `ViewShard.encode_cameras`: a rank runs the camera trunk on its block of
  cameras, and the features are all-gathered over the group along the
  camera axis (`_Gather`, whose backward returns this rank's slice of the
  incoming gradient). Everything downstream runs replicated on the group.
- `ViewShard.rows_with_halo` and `ViewShard.gather`: under ``bev_spatial`` a
  rank runs the CenterNet head on its block of BEV rows with one halo row on
  each side (zero at the map's edges, as the conv's padding). The fused map
  is replicated over the group, so a neighbour's boundary row is already on
  the rank: the halo is a slice of the local copy, and its backward sums the
  map's gradient over the group (each rank's block reaches only its own rows
  and halo). The head's outputs are then all-gathered along the rows.

So the camera trunk and, under ``bev_spatial``, the head get gradients from
this rank's part alone (`partial_modules`), summed over the world; every
other parameter gets its data row's whole gradient on each rank of the view
group, summed over the data axis only.

`LocalViews` is the single-process counterpart for the server: the cameras
of a part are split over a row of devices, one trunk replica each, and the
features gathered on the row's first device.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _Gather(torch.autograd.Function):
    """Every rank's equal block of `x` along `dim`, concatenated in group
    order; the backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim: int, view: "ViewShard"):
        ctx.dim, ctx.view = dim, view
        parts = [torch.empty_like(x) for _ in range(view.size)]
        dist.all_gather(parts, x.contiguous(), group=view.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.view.block(grad, ctx.dim).contiguous(), None, None


class _RowsWithHalo(torch.autograd.Function):
    """Rows ``[s - 1, e + 1)`` of a replicated NCHW map for this rank's
    block ``[s, e)`` (zero rows beyond the map); the backward scatters the
    block's gradient into the map and sums it over the group."""

    @staticmethod
    def forward(ctx, x, view: "ViewShard"):
        ctx.view, ctx.shape = view, x.shape
        s, e = view.bounds(x.shape[2])
        return F.pad(x, (0, 0, 1, 1))[:, :, s:e + 2]

    @staticmethod
    def backward(ctx, grad):
        s, e = ctx.view.bounds(ctx.shape[2])
        b, c, h, w = ctx.shape
        full = grad.new_zeros(b, c, h + 2, w)
        full[:, :, s:e + 2] = grad
        full = full[:, :, 1:-1].contiguous()
        dist.all_reduce(full, group=ctx.view.group)
        return full, None


@dataclass(frozen=True)
class ViewShard:
    """This rank's place on the view axis: `index` of the `size` ranks of
    its view `group`, which hold the same rows of the batch."""

    group: dist.ProcessGroup
    index: int
    size: int

    def splits(self, n: int) -> bool:
        return n % self.size == 0

    def bounds(self, n: int) -> Tuple[int, int]:
        m = n // self.size
        return self.index * m, (self.index + 1) * m

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        s, e = self.bounds(x.shape[dim])
        return x.narrow(dim, s, e - s)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim, self)

    def encode_cameras(self, encoder: nn.Module, imgs: torch.Tensor) -> torch.Tensor:
        """The features of every camera of (B, N_cam, 3, H, W), this rank's
        block computed here."""
        return self.gather(encoder(self.block(imgs, 1)), 1)

    def rows_with_halo(self, x: torch.Tensor) -> torch.Tensor:
        return _RowsWithHalo.apply(x, self)


class LocalViews:
    """The cameras of a batch split over `devices` in one process: block i
    through a replica of the trunk on device i (the model's own on the
    first), the features gathered on the first device. Inference only."""

    def __init__(self, encoder: nn.Module, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.size = len(self.devices)
        self.replicas: List[nn.Module] = [encoder] + [copy.deepcopy(encoder).to(d) for d in self.devices[1:]]

    def splits(self, n: int) -> bool:
        return n % self.size == 0

    def encode_cameras(self, encoder: nn.Module, imgs: torch.Tensor) -> torch.Tensor:
        blocks = imgs.chunk(self.size, 1)
        first = self.devices[0]
        feats = [enc(block.to(dev)).to(first) for enc, dev, block in zip(self.replicas, self.devices, blocks)]
        return torch.cat(feats, 1)


def partial_modules(model: nn.Module, n_cameras: int) -> List[nn.Module]:
    """The modules of `model` whose gradients are this rank's part alone
    under its view shard: the camera encoder when the view group splits
    `n_cameras`, and the head when it runs on row blocks."""
    view = getattr(model, "view", None)
    if not isinstance(view, ViewShard):
        return []
    out = []
    if model.spec.use_camera and view.splits(n_cameras):
        out.append(model.camera_encoder)
    if model.head_on_rows():
        out.append(model.det_head)
    return out
