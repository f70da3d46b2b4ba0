"""BEV pools over a sorted chunk plan: kernels B2 and B3.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/bev_pool_pallas.py``:

- `precompute_bev_chunks` (host numpy, ``:55-128``): the port's own copy,
  with the same static shapes and pad conventions. Per camera row it sorts
  the frustum points by BEV cell and cuts the stream into chunks of at most
  T points inside one window of W cells: ``point_idx == P`` and
  ``local_ids == -1`` mark pads, `block_idx` is non-decreasing, and every
  window has at least one chunk, possibly empty.
- `bev_pool_weighted_rows` (B2, TPU kernel ``bev_pool_weighted`` ``:166``):
  ``out[cell, c] = sum_p w[p] * feat[p % HW, c]``, the whole lift-splat in
  one pass. Inference only.
- `bev_pool_rows` (B3, TPU kernel ``bev_pool_sorted`` ``:290``):
  ``out[cell, c] = sum_p feat[p, c]`` over per-point features.

Each has a plain PyTorch version beside it (`bev_pool_weighted_reference`,
`bev_pool_sorted_reference`: gather by the plan, weight, ``index_add_``).
A CPU tensor takes the plain version; a CUDA tensor launches the hand-written
kernel of ``csrc/bev_pool.cu`` (built by ``ops/_build.py``) or raises. Each
wrapper counts its launches in `.launches`. B3's kernel, which B2 also takes
for rows too long for shared memory, splits each row over warps and combines
the cells cut between them through a scratch tensor that the wrapper
allocates (`sorted_config`). Both return f32 and round each
weight to the feature dtype before the product, as the TPU kernel does
(``bev_pool_pallas.py:150``), so kernel and plain version differ only in
summation order. The kernel relies on the plan's sort (entries of a window
in cell order), which `precompute_bev_chunks` guarantees.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from . import _build

# Window W of the chunk plans and of the pools that read them: a plan's
# block_idx is valid only for a pool run with the same window.
DEFAULT_WINDOW = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def num_cells_padded(num_cells: int, window: int = DEFAULT_WINDOW) -> int:
    """num_cells rounded up to whole windows, as `precompute_bev_chunks`
    pads it."""
    return _round_up(max(num_cells, window), window)


def precompute_bev_chunks(
    cell_ids: np.ndarray,
    num_cells: int,
    chunk_points: int = 256,
    window: int = DEFAULT_WINDOW,
) -> Dict[str, np.ndarray]:
    """Host-side chunk plan of one camera row's (P,) flat cell ids (-1 = out
    of range). Returns point_idx (n_chunks, T) int32 (P = pad), local_ids
    (n_chunks, T) int32 in [0, W) (-1 = pad), block_idx (n_chunks,) int32,
    non-decreasing, and num_cells_pad, with n_chunks = num_cells_pad / W +
    ceil(P / T)."""
    p = len(cell_ids)
    t, w = chunk_points, window
    num_cells_pad = num_cells_padded(num_cells, w)
    num_blocks = num_cells_pad // w
    # worst case: one chunk per window + one extra cut per T points
    n_chunks = num_blocks + (p + t - 1) // t

    valid = cell_ids >= 0
    order = np.argsort(cell_ids[valid], kind="stable")
    pts = np.flatnonzero(valid)[order].astype(np.int32)
    ids = cell_ids[pts]

    point_idx = np.full((n_chunks, t), p, np.int32)
    local_ids = np.full((n_chunks, t), -1, np.int32)
    block_idx = np.zeros((n_chunks,), np.int32)

    # per-window point ranges in the sorted stream
    starts = np.searchsorted(ids, np.arange(num_blocks) * w, side="left")
    ends = np.searchsorted(ids, (np.arange(num_blocks) + 1) * w, side="left")

    ci = 0
    for b in range(num_blocks):
        i, end = int(starts[b]), int(ends[b])
        while True:  # at least one (possibly empty) chunk per window
            j = min(i + t, end)
            count = j - i
            assert ci < n_chunks
            point_idx[ci, :count] = pts[i:j]
            local_ids[ci, :count] = ids[i:j] - b * w
            block_idx[ci] = b
            ci += 1
            i = j
            if i >= end:
                break
    # the tail: empty revisits of the last window (block_idx stays sorted)
    block_idx[ci:] = num_blocks - 1
    return {
        "point_idx": point_idx,
        "local_ids": local_ids,
        "block_idx": block_idx,
        "num_cells_pad": num_cells_pad,
    }


def _pool_reference(features, weights, point_idx, local_ids, block_idx, num_cells, window):
    """Plain version of both pools: weights None = B3 (features per point),
    else B2 (features per pixel, p % HW)."""
    x, rows, c = features.shape
    n_points = rows if weights is None else weights.shape[1]
    lid = local_ids.long().reshape(x, -1)
    pidx = point_idx.long().reshape(x, -1)
    t = point_idx.shape[-1]
    cells = block_idx.long().repeat_interleave(t, dim=1) * window + lid
    valid = (lid >= 0) & (lid < window) & (pidx >= 0) & (pidx < n_points) & (cells < num_cells)
    pidx = torch.where(valid, pidx, torch.zeros_like(pidx))
    src = pidx if weights is None else pidx % rows
    gathered = torch.gather(features, 1, src[..., None].expand(-1, -1, c)).float()
    if weights is not None:
        w = torch.gather(weights.to(features.dtype), 1, pidx).float()
        gathered.mul_(w[..., None])
    # invalid entries go to one trash row per camera row, dropped at the end
    dest = torch.where(valid, cells, torch.full_like(cells, num_cells))
    dest = dest + torch.arange(x, device=dest.device)[:, None] * (num_cells + 1)
    out = torch.zeros(x * (num_cells + 1), c, dtype=torch.float32, device=features.device)
    out.index_add_(0, dest.reshape(-1), gathered.reshape(-1, c))
    return out.reshape(x, num_cells + 1, c)[:, :num_cells]


def bev_pool_weighted_reference(features, weights, point_idx, local_ids, block_idx,
                                num_cells, num_cells_pad=None, window=DEFAULT_WINDOW):
    """Plain PyTorch B2: (X, HW, C) features, (X, P) weights, plans
    (X, n_chunks, T) / (X, n_chunks) -> (X, num_cells, C) f32."""
    return _pool_reference(features, weights, point_idx, local_ids, block_idx, num_cells, window)


def bev_pool_sorted_reference(features, point_idx, local_ids, block_idx,
                              num_cells, num_cells_pad=None, window=DEFAULT_WINDOW):
    """Plain PyTorch B3: (X, P, C) features + plans -> (X, num_cells, C) f32."""
    return _pool_reference(features, None, point_idx, local_ids, block_idx, num_cells, window)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bev_pool_forward.argtypes = [
        i32, ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
    ]
    lib.bev_pool_forward.restype = i32
    lib.bev_pool_error_string.argtypes = [i32]
    lib.bev_pool_error_string.restype = ctypes.c_char_p
    lib.bev_pool_weighted_config.argtypes = [i32, i32, i32, i32, i32, ptr]
    lib.bev_pool_weighted_config.restype = i32
    lib.bev_pool_sorted_config.argtypes = [i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.bev_pool_sorted_config.restype = i32


def _check(features, weights, point_idx, local_ids, block_idx, num_cells, num_cells_pad, window):
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if features.ndim != 3 or min(features.shape) < 1:
        raise ValueError(f"features must be (X, rows, C), got {tuple(features.shape)}")
    x = features.shape[0]
    if point_idx.ndim != 3 or point_idx.shape[0] != x or local_ids.shape != point_idx.shape:
        raise ValueError(
            f"point_idx and local_ids must both be (X={x}, n_chunks, T), got "
            f"{tuple(point_idx.shape)} and {tuple(local_ids.shape)}"
        )
    if block_idx.shape != point_idx.shape[:2]:
        raise ValueError(f"block_idx must be {tuple(point_idx.shape[:2])}, got {tuple(block_idx.shape)}")
    tensors = [features, point_idx, local_ids, block_idx]
    if weights is not None:
        if weights.ndim != 2 or weights.shape[0] != x or not weights.is_floating_point():
            raise ValueError(f"weights must be float (X={x}, P), got {tuple(weights.shape)} {weights.dtype}")
        tensors.append(weights)
    for a in (point_idx, local_ids, block_idx):
        if a.dtype != torch.int32:
            raise TypeError(f"plan arrays must be int32, got {a.dtype}")
    if any(a.device != features.device for a in tensors):
        raise ValueError(f"every tensor must be on {features.device}")
    if window < 1 or num_cells < 1 or (num_cells_pad is not None and (
            num_cells_pad < num_cells or num_cells_pad % window)):
        raise ValueError(
            f"need num_cells >= 1 and num_cells_pad (>= num_cells) a multiple of the "
            f"window: num_cells={num_cells}, num_cells_pad={num_cells_pad}, window={window}"
        )
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bev pools run on cpu or cuda, not {features.device}")
    if features.device.type == "cuda":
        if not all(a.is_contiguous() for a in tensors):
            raise ValueError("bev pools need contiguous tensors on the GPU")
        vec = 16 // features.element_size()  # channels per 16-byte load of the kernel
        if features.shape[2] % vec or features.data_ptr() % 16:
            raise ValueError(
                f"the GPU bev pools need C a multiple of {vec} for {features.dtype} and "
                f"16-byte aligned features, got C={features.shape[2]}"
            )


def _launch(features, weights: Optional[torch.Tensor], point_idx, local_ids, block_idx,
            num_cells, window, scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    lib = _build.load("bev_pool", _declare)
    x, rows, c = features.shape
    n_chunks, t = point_idx.shape[1:]
    num_points = rows if weights is None else weights.shape[1]
    if scratch is None:
        nbytes = _sorted_config(lib, features.device.index, features.dtype == torch.bfloat16,
                                weights is not None, x, rows, n_chunks, t, c)["scratch_bytes"]
        if nbytes:
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=features.device)
    out = torch.empty((x, num_cells, c), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = lib.bev_pool_forward(
            int(features.dtype == torch.bfloat16), features.data_ptr(), rows,
            None if weights is None else weights.data_ptr(),
            point_idx.data_ptr(), local_ids.data_ptr(), block_idx.data_ptr(),
            x, n_chunks, t, window, num_cells, num_points, c, out.data_ptr(), stream,
            None if scratch is None else scratch.data_ptr(),
        )
    if err:
        raise RuntimeError("bev_pool launch failed: " + lib.bev_pool_error_string(err).decode())
    return out


@functools.lru_cache(maxsize=64)
def _sorted_config(lib, device_index, is_bf16, weighted, x, rows, n_chunks, t, c) -> Dict[str, int]:
    config = (ctypes.c_longlong * 5)()
    with torch.cuda.device(device_index):
        err = lib.bev_pool_sorted_config(int(is_bf16), int(weighted), x, rows, n_chunks, t, c,
                                         ctypes.addressof(config))
    if err:
        raise RuntimeError("bev_pool_sorted_config failed: " + lib.bev_pool_error_string(err).decode())
    return dict(zip(("warps", "blocks", "blocks_per_sm", "scratch_bytes", "slices"), config))


def sorted_config(features: torch.Tensor, n_chunks: int, chunk_points: int) -> Dict[str, int]:
    """How B3's kernel runs on (X, P, C) CUDA features with plans of
    `n_chunks` chunks of `chunk_points`, launching nothing: `warps` (segments
    a row, one per warp), `blocks` of the grid, `blocks_per_sm`,
    `scratch_bytes` (each block's sums of its first and last cell and their
    ids, then each segment's real entries, as `sorted_segments` reads them;
    allocated by the wrapper at each launch) and channel `slices`."""
    lib = _build.load("bev_pool", _declare)
    x, rows, c = features.shape
    return dict(_sorted_config(lib, features.device.index, features.dtype == torch.bfloat16, False,
                               x, rows, n_chunks, chunk_points, c))


def sorted_segments(features, point_idx, local_ids, block_idx, num_cells, window=DEFAULT_WINDOW):
    """How B3's kernel split each row, for inspection: launches it once on
    CUDA tensors (not counted in `bev_pool_rows.launches`) and returns the
    real entries each warp's segment summed, (X, warps) int32."""
    _check(features, None, point_idx, local_ids, block_idx, num_cells, None, window)
    x, _, c = features.shape
    config = sorted_config(features, *point_idx.shape[1:])
    scratch = torch.empty(config["scratch_bytes"], dtype=torch.uint8, device=features.device)
    _launch(features, None, point_idx, local_ids, block_idx, num_cells, window, scratch)
    return scratch[-x * config["warps"] * 4:].view(torch.int32).reshape(x, config["warps"])


def weighted_config(features: torch.Tensor, n_chunks: int) -> Dict[str, int]:
    """How B2's kernel runs on (X, HW, C) CUDA features with plans of
    `n_chunks` chunks, launching nothing: `slice_channels` (channels per
    block of the slice kernel; 0: B3's sorted kernel, for rows too long for
    shared memory), `blocks_per_sm`, `smem_bytes` per block and `blocks`."""
    lib = _build.load("bev_pool", _declare)
    x, rows, c = features.shape
    config = (ctypes.c_int * 4)()
    with torch.cuda.device(features.device):
        err = lib.bev_pool_weighted_config(int(features.dtype == torch.bfloat16), x, rows, n_chunks, c,
                                           ctypes.addressof(config))
    if err:
        raise RuntimeError("bev_pool_weighted_config failed: " + lib.bev_pool_error_string(err).decode())
    return dict(zip(("slice_channels", "blocks_per_sm", "smem_bytes", "blocks"), config))


def bev_pool_weighted_rows(features, weights, point_idx, local_ids, block_idx,
                           num_cells, num_cells_pad, window=DEFAULT_WINDOW):
    """B2, batched over camera rows: features (X, HW, C) per pixel, weights
    (X, P) per frustum point (p = d * HW + pixel), plans from
    `precompute_bev_chunks` stacked to (X, n_chunks, T) / (X, n_chunks)
    int32 -> (X, num_cells, C) f32."""
    _check(features, weights, point_idx, local_ids, block_idx, num_cells, num_cells_pad, window)
    if features.device.type == "cpu":
        return bev_pool_weighted_reference(
            features, weights, point_idx, local_ids, block_idx, num_cells, num_cells_pad, window)
    out = _launch(features, weights.to(features.dtype).contiguous(), point_idx, local_ids,
                  block_idx, num_cells, window)
    bev_pool_weighted_rows.launches += 1
    return out


def bev_pool_rows(features, point_idx, local_ids, block_idx,
                  num_cells, num_cells_pad, window=DEFAULT_WINDOW):
    """B3, batched over rows: features (X, P, C) per point + plans ->
    (X, num_cells, C) f32."""
    _check(features, None, point_idx, local_ids, block_idx, num_cells, num_cells_pad, window)
    if features.device.type == "cpu":
        return bev_pool_sorted_reference(
            features, point_idx, local_ids, block_idx, num_cells, num_cells_pad, window)
    out = _launch(features, None, point_idx, local_ids, block_idx, num_cells, window)
    bev_pool_rows.launches += 1
    return out


bev_pool_weighted_rows.launches = 0
bev_pool_rows.launches = 0
