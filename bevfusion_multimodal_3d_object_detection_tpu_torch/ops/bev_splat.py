"""Camera-to-BEV lift-splat: frustum geometry, the culled pair plans and
the splat formulations of the geometric path.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/bev_splat.py``:

- `precompute_frustum_cells` (``:59-102``, host numpy, the port's own copy):
  the flat BEV cell of every (depth, v, u) frustum point of one camera, -1
  out of range (and, the port's own, out of an optional z range). It
  depends on calibration only.
- `bev_scatter_add` (``:38-56``): a segmented scatter-add of (..., P, C) rows
  into (..., num_cells, C), ids outside [0, num_cells) dropped; `lift_splat`
  (``:106-128``) lifts through it (``splat_mode: scatter``).
- `lift_splat_matmul` (``:131-164``) and `lift_splat_matmul_rows`
  (``:494-507`` with `_splat_weights` ``:167-186``): a scalar scatter of the
  depth probabilities into per-pixel cell weights (X, HW, cells), then one
  batched matmul (``splat_mode: matmul``, and training under ``pallas``).
- `lift_splat_pallas_rows` (``:193-232``): depth softmax in the working
  dtype, weights in the plan's p = d * HW + pixel order, then kernel B2
  (`ops.bev_pool.bev_pool_weighted_rows`). Inference only.
- `precompute_culled_pairs` / `precompute_culled_pairs_batch` (``:235-388``,
  host numpy): the in-range frustum points grouped by their (cell, pixel)
  pair, sorted, padded to static capacities; `_pair_weights` (``:391-408``)
  and the culled splats `lift_splat_culled_rows` (``:411-455``, a scatter of
  the pair weights into a dense (cells, HW) matrix and a matmul) and
  `lift_splat_culled_gather_rows` (``:458-491``, a row gather and a
  segment-sum by cell) of ``splat_mode: culled``. Differentiable: training
  takes them too.

Features and depth logits come NCHW, (X, C, H', W') and (X, D, H', W'), so
the (D, H', W') flattening of the logits is the plans' p = d * HW + pixel,
and every splat returns (X, num_cells, C) as in the JAX package. Pads of a
plan never reach a real cell: a culled pair's pad lands in trash rows past
num_cells that are sliced off. On a CUDA tensor the scatters with repeated
ids (`bev_scatter_add`, the matmul splat's weights, the gather splat's
segment-sum) add in no fixed order: two launches may differ in the last
bits.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .bev_pool import DEFAULT_WINDOW, _round_up, bev_pool_weighted_rows


def bev_scatter_add(features: torch.Tensor, cell_ids: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Segmented scatter-add: (..., P, C) features + (..., P) int cell ids
    -> (..., num_cells, C) in the features' dtype. Ids outside
    [0, num_cells) go to a trash row that is dropped."""
    shape, c = features.shape, features.shape[-1]
    p = shape[-2]
    feats = features.reshape(-1, p, c)
    x = feats.shape[0]
    ids = cell_ids.reshape(x, p).long()
    ids = torch.where((ids >= 0) & (ids < num_cells), ids, torch.full_like(ids, num_cells))
    rows = ids + torch.arange(x, device=ids.device)[:, None] * (num_cells + 1)
    out = feats.new_zeros(x * (num_cells + 1), c).index_add(0, rows.reshape(-1), feats.reshape(-1, c))
    return out.reshape(x, num_cells + 1, c)[:, :num_cells].reshape(shape[:-2] + (num_cells, c))


def precompute_frustum_cells(
    intrinsics: np.ndarray,
    sensor2lidar_rot: np.ndarray,
    sensor2lidar_trans: np.ndarray,
    feat_hw: Tuple[int, int],
    image_hw: Tuple[int, int],
    depth_bins: np.ndarray,
    bev_hw: Tuple[int, int],
    pc_range: Tuple[float, ...],
    z_range: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """(3, 3) intrinsics at image resolution, camera->LiDAR rotation and
    translation, (D,) metric depths -> (D, H', W') int32 flat BEV cell ids
    (-1 = out of range: outside the grid's x and y, or with `z_range`
    (z_min, z_max) outside [z_min, z_max), as BEVFusion's one z bin)."""
    fh, fw = feat_hw
    ih, iw = image_hw
    # pixel centres of the feature grid, scaled to image coordinates
    us = (np.arange(fw) + 0.5) * (iw / fw)
    vs = (np.arange(fh) + 0.5) * (ih / fh)
    uu, vv = np.meshgrid(us, vs)  # (H', W')

    k_inv = np.linalg.inv(intrinsics)
    rays = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ k_inv.T  # (H', W', 3)
    pts = rays[None, :, :, :] * depth_bins[:, None, None, None]  # (D, H', W', 3)
    pts = pts @ sensor2lidar_rot.T + sensor2lidar_trans  # camera -> LiDAR

    x_min, y_min, _, x_max, y_max, _ = pc_range
    bh, bw = bev_hw
    vx = (x_max - x_min) / bw
    vy = (y_max - y_min) / bh
    ix = np.floor((pts[..., 0] - x_min) / vx).astype(np.int32)
    iy = np.floor((pts[..., 1] - y_min) / vy).astype(np.int32)
    valid = (ix >= 0) & (ix < bw) & (iy >= 0) & (iy < bh)
    if z_range is not None:
        valid &= (pts[..., 2] >= z_range[0]) & (pts[..., 2] < z_range[1])
    cells = np.where(valid, iy * bw + ix, -1)
    return cells.astype(np.int32)


def _rows(features: torch.Tensor) -> torch.Tensor:
    """(X, C, H', W') -> contiguous (X, HW, C)."""
    x, c = features.shape[:2]
    return features.permute(0, 2, 3, 1).reshape(x, -1, c).contiguous()


def lift_features(features: torch.Tensor, depth_logits: torch.Tensor) -> torch.Tensor:
    """The lifted tensor: features (X, C, H', W') weighted by each depth
    bin's probability -> (X, D*H'*W', C), rows in the p = d * HW + pixel
    order of the cell plans."""
    x, c = features.shape[:2]
    probs = torch.softmax(depth_logits, dim=1)
    lifted = torch.einsum("xchw,xdhw->xdhwc", features, probs)
    return lifted.reshape(x, -1, c)


def lift_splat(features: torch.Tensor, depth_logits: torch.Tensor, cell_ids: torch.Tensor,
               num_cells: int) -> torch.Tensor:
    """Lift-splat of a camera batch on one shared plan: features
    (B, C, H', W'), depth logits (B, D, H', W'), cell ids (D, H', W')
    -> (B, num_cells, C); -1 ids are dropped."""
    lifted = lift_features(features, depth_logits)
    ids = cell_ids.reshape(1, -1).expand(lifted.shape[0], -1)
    return bev_scatter_add(lifted, ids, num_cells)


def lift_splat_matmul(features: torch.Tensor, depth_logits: torch.Tensor, cell_ids: torch.Tensor,
                      num_cells: int) -> torch.Tensor:
    """`lift_splat` with the scatter and the matmul swapped: scalar depth
    probabilities scattered into per-pixel cell weights, the features
    contracted by one batched matmul. The same sums in another order."""
    ids = cell_ids.reshape(1, -1).expand(features.shape[0], -1)
    return lift_splat_matmul_rows(features, depth_logits, ids, num_cells)


def lift_splat_pallas_rows(
    features: torch.Tensor,
    depth_logits: torch.Tensor,
    point_idx: torch.Tensor,
    local_ids: torch.Tensor,
    block_idx: torch.Tensor,
    num_cells: int,
    num_cells_pad: int,
    window: int = DEFAULT_WINDOW,
) -> torch.Tensor:
    """Fused lift-splat through kernel B2: features (X, C, H', W'), depth
    logits (X, D, H', W') and per-row chunk plans -> (X, num_cells, C) f32."""
    x = depth_logits.shape[0]
    probs = torch.softmax(depth_logits, dim=1)  # in the working dtype
    return bev_pool_weighted_rows(
        _rows(features), probs.reshape(x, -1), point_idx, local_ids, block_idx,
        num_cells=num_cells, num_cells_pad=num_cells_pad, window=window,
    )


def _splat_weights(depth_probs: torch.Tensor, cell_ids: torch.Tensor, num_cells: int) -> torch.Tensor:
    """(X, D, H', W') probs + (X, D*H'*W') cells -> (X, HW, num_cells)
    per-pixel cell weights in the probs' dtype (-1 ids dropped)."""
    x, d = depth_probs.shape[:2]
    hw = depth_probs[0, 0].numel()
    ids = cell_ids.reshape(x, d, hw).long()
    ids = torch.where(ids < 0, torch.full_like(ids, num_cells), ids)  # trash column
    pix = torch.arange(hw, device=ids.device)
    flat = pix * (num_cells + 1) + ids  # (X, D, HW) into a (HW, num_cells + 1) matrix
    w = torch.zeros(x, hw * (num_cells + 1), dtype=depth_probs.dtype, device=depth_probs.device)
    w.scatter_add_(1, flat.reshape(x, -1), depth_probs.reshape(x, -1))
    return w.reshape(x, hw, num_cells + 1)[:, :, :num_cells]


def lift_splat_matmul_rows(
    features: torch.Tensor,
    depth_logits: torch.Tensor,
    cell_ids: torch.Tensor,
    num_cells: int,
) -> torch.Tensor:
    """Lift-splat as scatter + matmul: features (X, C, H', W'), depth logits
    (X, D, H', W'), cell ids (X, D*H'*W') -> (X, num_cells, C) in the
    features' dtype."""
    x, c = features.shape[:2]
    w = _splat_weights(torch.softmax(depth_logits, dim=1), cell_ids, num_cells)
    return torch.bmm(w.transpose(1, 2), features.reshape(x, c, -1).transpose(1, 2))


def precompute_culled_pairs(
    cell_ids: np.ndarray,
    hw: int,
    num_cells: int,
    point_capacity: int = 0,
    pair_capacity: int = 0,
    pad_multiple: int = 1024,
) -> Dict:
    """Calibration-time culling and (cell, pixel) grouping of one camera's
    frustum plan: keep the in-range points, group them by their unique
    (cell, pixel) pair and sort the pairs, so the runtime splat gathers T
    depth probabilities, sums them into U pair weights and splats U weights.

    cell_ids: (P,) int32 in the p = d * HW + pixel flattening (-1 = out of
    range); P a multiple of `hw`. Capacities 0 round the actual counts up
    to `pad_multiple`; a nonzero capacity the counts exceed raises
    ValueError. Returns numpy arrays of static shape:

      seg_idx (T_cap,): positions into the (P,) probabilities, sorted by
        their pair; pad = P (gathers an appended zero).
      seg_id (T_cap,): the pair of each point, non-decreasing; pads join the
        last pair (with zero weight).
      pair_cell, pair_pix (U_cap,): each pair's cell and pixel; pad k is
        (num_cells + k // hw, k % hw), distinct trash coordinates past
        every real cell.
      n_points, n_pairs: the actual counts.
    """
    p = len(cell_ids)
    if p % hw != 0:
        raise ValueError(f"len(cell_ids)={p} not a multiple of hw={hw}")
    valid = np.flatnonzero(cell_ids >= 0).astype(np.int32)
    cells = cell_ids[valid].astype(np.int64)
    pix = (valid % hw).astype(np.int64)
    # a lexicographic (cell, pixel) sort puts each pair's points together
    order = np.argsort(cells * hw + pix, kind="stable")
    valid, cells, pix = valid[order], cells[order], pix[order]
    key = cells * hw + pix
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    seg = np.cumsum(first) - 1
    n_points = len(valid)
    n_pairs = int(seg[-1]) + 1 if n_points else 0

    t_cap = point_capacity or _round_up(max(n_points, 1), pad_multiple)
    u_cap = pair_capacity or _round_up(max(n_pairs, 1), pad_multiple)
    if n_points > t_cap or n_pairs > u_cap:
        raise ValueError(
            f"culled plan needs {n_points} points / {n_pairs} pairs but capacity is {t_cap}/{u_cap} "
            f"— raise bev_fusion.splat_cull_points / splat_cull_pairs in the config"
        )
    seg_idx = np.full((t_cap,), p, np.int32)
    seg_idx[:n_points] = valid
    seg_id = np.full((t_cap,), max(n_pairs - 1, 0), np.int32)
    seg_id[:n_points] = seg
    pad_k = np.arange(u_cap - n_pairs)
    pair_cell = np.empty((u_cap,), np.int32)
    pair_pix = np.empty((u_cap,), np.int32)
    pair_cell[n_pairs:] = num_cells + pad_k // hw
    pair_pix[n_pairs:] = pad_k % hw
    if n_pairs:
        pair_cell[:n_pairs] = cells[first]
        pair_pix[:n_pairs] = pix[first]
    return {"seg_idx": seg_idx, "seg_id": seg_id, "pair_cell": pair_cell, "pair_pix": pair_pix,
            "n_points": n_points, "n_pairs": n_pairs}


def precompute_culled_pairs_batch(
    camera_cells: Iterable[np.ndarray],
    hw: int,
    num_cells: int,
    point_capacity: int = 0,
    pair_capacity: int = 0,
    headroom: float = 1.0,
    pad_multiple: int = 1024,
    sizes_only: bool = False,
) -> Tuple[Optional[Dict], Tuple[int, int]]:
    """Culled plans of a stack of cameras on shared capacities: a nonzero
    capacity given wins; else each is the largest actual count over the
    cameras times `headroom`, plus 1 (an exact fit keeps a pad), rounded up
    to `pad_multiple`. Returns (plans stacked along a new leading axis, or
    None with `sizes_only`; (t_cap, u_cap))."""
    rows = [np.asarray(c).reshape(-1) for c in camera_cells]
    if not (point_capacity and pair_capacity):
        sizes = [precompute_culled_pairs(r, hw, num_cells, pad_multiple=1) for r in rows]

        def cap(key: str) -> int:
            worst = max(s[key] for s in sizes)
            return _round_up(max(int(worst * headroom) + 1, 1), pad_multiple)

        point_capacity = point_capacity or cap("n_points")
        pair_capacity = pair_capacity or cap("n_pairs")
    if sizes_only:
        return None, (point_capacity, pair_capacity)
    plans = [precompute_culled_pairs(r, hw, num_cells, point_capacity=point_capacity,
                                     pair_capacity=pair_capacity) for r in rows]
    stacked = {k: np.stack([np.asarray(p[k]) for p in plans]) for k in plans[0]}
    return stacked, (point_capacity, pair_capacity)


def _pair_weights(depth_probs: torch.Tensor, seg_idx: torch.Tensor, seg_id: torch.Tensor,
                  num_pairs: int) -> torch.Tensor:
    """(X, D, H', W') probabilities + culled plan rows -> (X, num_pairs)
    pair weights: the surviving probabilities gathered (pads read an
    appended zero) and summed by pair."""
    x = depth_probs.shape[0]
    flat = depth_probs.reshape(x, -1)  # p = d * HW + pixel
    flat = torch.cat([flat, flat.new_zeros(x, 1)], dim=1)
    p_sel = torch.gather(flat, 1, seg_idx.long())
    return p_sel.new_zeros(x, num_pairs).scatter_add(1, seg_id.long(), p_sel)


def lift_splat_culled_rows(
    features: torch.Tensor,
    depth_logits: torch.Tensor,
    seg_idx: torch.Tensor,
    seg_id: torch.Tensor,
    pair_cell: torch.Tensor,
    pair_pix: torch.Tensor,
    num_cells: int,
) -> torch.Tensor:
    """Culled lift-splat: features (X, C, H', W'), depth logits
    (X, D, H', W'), plan rows (X, T_cap) / (X, U_cap) -> (X, num_cells, C).
    The pair weights fill a dense (cells, HW) matrix (each (cell, pixel)
    once: pairs and pads are distinct), and one batched matmul contracts
    the features."""
    x, c = features.shape[:2]
    hw = features[0, 0].numel()
    u_cap = pair_cell.shape[1]
    w_pair = _pair_weights(torch.softmax(depth_logits, dim=1), seg_idx, seg_id, u_cap)
    # pads sit at (num_cells + k // hw, k % hw): trash rows sized for the worst case
    trash_rows = 1 + (u_cap - 1) // hw
    flat = pair_cell.long() * hw + pair_pix.long()
    wt = w_pair.new_zeros(x, (num_cells + trash_rows) * hw).scatter_add(1, flat, w_pair)
    wt = wt[:, :num_cells * hw].reshape(x, num_cells, hw)
    return torch.bmm(wt, features.reshape(x, c, hw).transpose(1, 2))


def lift_splat_culled_gather_rows(
    features: torch.Tensor,
    depth_logits: torch.Tensor,
    seg_idx: torch.Tensor,
    seg_id: torch.Tensor,
    pair_cell: torch.Tensor,
    pair_pix: torch.Tensor,
    num_cells: int,
) -> torch.Tensor:
    """`lift_splat_culled_rows` as a row gather and a segment-sum: each
    pair's feature row, scaled by its weight, is added into its cell; pads
    (cells at or past num_cells) go to one trash row that is dropped."""
    x = features.shape[0]
    u_cap = pair_cell.shape[1]
    w_pair = _pair_weights(torch.softmax(depth_logits, dim=1), seg_idx, seg_id, u_cap)
    feats = _rows(features)  # (X, HW, C)
    rows = torch.gather(feats, 1, pair_pix.long()[:, :, None].expand(-1, -1, feats.shape[2]))
    rows = rows * w_pair[:, :, None]
    return bev_scatter_add(rows, pair_cell, num_cells)
