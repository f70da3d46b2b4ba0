"""Fused PointNet: the whole shared-MLP chain + global max-pool in one pass.

Port of the TPU kernel `fused_pointnet`
(``bevfusion_multimodal_3d_object_detection_tpu/ops/pointnet_pallas.py:71-183``)
as hand-written CUDA C++ for Hopper (``csrc/pointnet_fused.cu``), built with
``nvcc`` for ``sm_90a`` at first use and loaded through ``ctypes``
(``ops/_build.py``).

- `pointnet_fused_reference`: the plain PyTorch version of the same function,
  including the rounding to the working dtype between layers. The CPU path
  and the kernel's oracle.
- `pointnet_fused`: the wrapper. It checks the arguments and calls the
  opaque custom op ``bmod_torch::pointnet_fused`` (`torch.library`), so that
  `torch.export` records the whole chain as one node and an exported serving
  graph runs the same function as the live one. The op's implementation takes
  the plain version for a CPU tensor and launches the kernel for a CUDA
  tensor, or raises; its fake implementation gives the (B, feat) output in
  the points' dtype. `pointnet_fused.launches` counts the kernel launches.
  An exported program that holds the op loads only in a process that has
  imported this module.
- `kernel_tile_points`: the kernel's points per tile (bf16: 128; f32: 64,
  32 or 16, the most whose activation buffers fit in shared memory).

The max runs over exactly the N points given. (The TPU wrapper pads N up to
a multiple of its block with zero rows, which join the max when
`mask_padding` is off; the encoder's own definition has no such rows.)
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

_NEG = -1e30  # masked-row sentinel, as in the TPU kernel
MAX_LAYERS = 8


def _declare(lib: ctypes.CDLL) -> None:
    lib.pointnet_fused_tile_points.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.pointnet_fused_tile_points.restype = ctypes.c_int
    lib.pointnet_fused_forward.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.pointnet_fused_forward.restype = ctypes.c_int
    lib.pointnet_fused_error_string.argtypes = [ctypes.c_int]
    lib.pointnet_fused_error_string.restype = ctypes.c_char_p


def pointnet_fused_reference(
    points: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    mask_padding: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: (B, N, C_in) -> (B, feat) in points' dtype.

    Each layer multiplies in f32 (bf16 x bf16 products are exact in f32),
    adds the f32 bias, applies ReLU and rounds to the working dtype, as the
    kernel does."""
    dtype = points.dtype
    x = points
    for w, b in zip(weights, biases):
        x = torch.relu(x.float() @ w.float() + b.float()).to(dtype)
    x = x.float()
    if mask_padding:
        valid = (points != 0).any(dim=-1, keepdim=True)
        x = torch.where(valid, x, torch.full_like(x, _NEG))
    out = x.amax(dim=1)
    return torch.where(out <= _NEG, torch.zeros_like(out), out).to(dtype)


def _check(points, weights, biases) -> None:
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"points must be float32 or bfloat16, got {points.dtype}")
    if points.ndim != 3 or points.shape[0] < 1 or points.shape[1] < 1:
        raise ValueError(f"points must be (B, N, C_in), got {tuple(points.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS or len(weights) != len(biases):
        raise ValueError(
            f"need 1..{MAX_LAYERS} layers with one bias each, got "
            f"{len(weights)} weights and {len(biases)} biases"
        )
    width = points.shape[2]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dtype != points.dtype or b.dtype != torch.float32:
            raise TypeError(
                f"layer {i}: weight must be {points.dtype} and bias float32, "
                f"got {w.dtype} and {b.dtype}"
            )
        if w.ndim != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer {i}: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                f"do not chain from width {width}"
            )
        if w.device != points.device or b.device != points.device:
            raise ValueError(f"layer {i}: weights are not on {points.device}")
        width = w.shape[1]


def pointnet_fused(
    points: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    mask_padding: bool = False,
) -> torch.Tensor:
    """(B, N, C_in) points -> (B, feat) global features, in points' dtype.

    `weights[i]`: (C_i, C_{i+1}) in points' dtype with inference BN folded
    in; `biases[i]`: (C_{i+1},) float32. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    _check(points, weights, biases)
    return _pointnet_fused_op(points, list(weights), list(biases), mask_padding)


@torch.library.custom_op("bmod_torch::pointnet_fused", mutates_args=())
def _pointnet_fused_op(
    points: torch.Tensor,
    weights: list[torch.Tensor],
    biases: list[torch.Tensor],
    mask_padding: bool,
) -> torch.Tensor:
    if points.device.type == "cpu":
        return pointnet_fused_reference(points, weights, biases, mask_padding)
    if points.device.type != "cuda":
        raise ValueError(f"pointnet_fused runs on cpu or cuda, not {points.device}")
    return _launch(points, weights, biases, mask_padding)


@_pointnet_fused_op.register_fake
def _(points, weights, biases, mask_padding):
    return points.new_empty((points.shape[0], weights[-1].shape[1]))


def _launch(points, weights, biases, mask_padding: bool) -> torch.Tensor:
    tensors = [points, *weights, *biases]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("pointnet_fused needs contiguous tensors")
    for w in weights:
        if w.data_ptr() % 32:
            raise ValueError("pointnet_fused needs 32-byte aligned weights")

    lib = _build.load("pointnet_fused", _declare)
    is_bf16 = int(points.dtype == torch.bfloat16)
    b, n, c_in = points.shape
    num_layers = len(weights)
    widths = (ctypes.c_int * (num_layers + 1))(c_in, *(w.shape[1] for w in weights))
    tile = lib.pointnet_fused_tile_points(is_bf16, num_layers, widths)
    tiles = -(-n // tile)
    feat = weights[-1].shape[1]
    partial = torch.empty((b, tiles, feat), dtype=torch.float32, device=points.device)
    out = torch.empty((b, feat), dtype=torch.float32, device=points.device)
    w_ptrs = (ctypes.c_void_p * num_layers)(*(w.data_ptr() for w in weights))
    b_ptrs = (ctypes.c_void_p * num_layers)(*(x.data_ptr() for x in biases))
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.pointnet_fused_forward(
            is_bf16, points.data_ptr(), b, n, num_layers, widths, w_ptrs,
            b_ptrs, int(mask_padding), partial.data_ptr(), out.data_ptr(),
            stream,
        )
    if err:
        raise RuntimeError(
            "pointnet_fused launch failed: "
            + lib.pointnet_fused_error_string(err).decode()
        )
    pointnet_fused.launches += 1
    return out.to(points.dtype)


pointnet_fused.launches = 0


def kernel_tile_points(dtype: torch.dtype, widths: Sequence[int]) -> int:
    """Points per tile of the kernel for this working type and chain of
    widths (C_in, C_1, ..., feat); builds and loads the library."""
    lib = _build.load("pointnet_fused", _declare)
    arr = (ctypes.c_int * len(widths))(*widths)
    return lib.pointnet_fused_tile_points(int(dtype == torch.bfloat16), len(widths) - 1, arr)


def pointnet_flops(batch: int, n: int, widths: Sequence[int]) -> int:
    """Multiply-add operations x 2 of the MLP chain over batch x n points."""
    return 2 * batch * n * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
