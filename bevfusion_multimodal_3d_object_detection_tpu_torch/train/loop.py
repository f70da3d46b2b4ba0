"""The evaluation step: forward + decode of one collated batch.

Port of the eval side of ``bevfusion_multimodal_3d_object_detection_tpu/
train/loop.py`` (``:91-128``, ``:242-291``). The batch is the JAX package's
dict of numpy arrays (`data.dataset.collate_fn`): uint8 cameras are
normalized on the device, and the geometric path's ``camera_cells`` and
chunk plans (``camera_point_idx``, ``camera_local_ids``,
``camera_block_idx``) go to the model as in the JAX package. The train step
is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CompatFlags, DetectorSpec
from ..models.detector import MultiModal3DDetector
from ..ops.decode import decode_centernet_predictions
from ..ops.preprocess import normalize_images
from ..utils.device import resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _model_inputs(spec: DetectorSpec, batch: Dict, device: torch.device,
                  dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], ...]:
    cams = lidar = radar = None
    if spec.use_camera:
        cams = _tensor(batch["camera_imgs"], device)
        if cams.dtype == torch.uint8:  # the uint8 wire: normalize on the device
            cams = normalize_images(cams, size=spec.camera.image_size)
        cams = cams.to(dtype)
    if spec.use_lidar:
        lidar = _tensor(batch["lidar_points"], device).to(dtype)
    if spec.use_radar:
        radar = _tensor(batch["radar_points"], device).to(dtype)
    return cams, lidar, radar


def _model_kwargs(spec: DetectorSpec, batch: Dict, device: torch.device) -> Dict:
    kwargs = {}
    if spec.use_camera and "camera_cells" in batch:
        kwargs["camera_cells"] = _tensor(batch["camera_cells"], device)
    if spec.use_camera and "camera_point_idx" in batch:
        # chunk plans of the fused splat (splat_mode: pallas, inference only)
        kwargs["camera_chunks"] = tuple(
            _tensor(batch[k], device)
            for k in ("camera_point_idx", "camera_local_ids", "camera_block_idx")
        )
    return kwargs


def make_eval_step(
    model: MultiModal3DDetector,
    compat: CompatFlags,
    max_detections: int = 100,
    eval_path_decode: bool = False,
    device=None,
) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns eval_step(batch) -> decoded {'boxes' (B, K, 7), 'scores',
    'labels', 'velocities'} on the device. The model moves to `device` (the
    GPU unless the caller names one) and into eval mode; it computes in the
    dtype of its parameters, and decode runs in f32.

    `eval_path_decode=True` decodes at voxel 0.512 when
    `compat.eval_decode_voxel_0512` (quirk Q3, the standalone eval and
    inference path); otherwise the voxel is the grid's own, per axis."""
    device = resolve_device(device)
    spec = model.spec
    if eval_path_decode and compat.eval_decode_voxel_0512:
        voxel_size = 0.512
    else:
        x_min, y_min, _, x_max, y_max, _ = spec.bev.pc_range
        voxel_size = ((x_max - x_min) / spec.bev.bev_w, (y_max - y_min) / spec.bev.bev_h)
    model.to(device).eval()
    # the head's: the point MLPs keep f32 parameters under a cast model
    dtype = next(model.det_head.parameters()).dtype

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        preds = model(*_model_inputs(spec, batch, device, dtype), **_model_kwargs(spec, batch, device))
        return decode_centernet_predictions(
            preds,
            max_detections=max_detections,
            voxel_size=voxel_size,
            pc_range=spec.bev.pc_range,
            class_always_zero=compat.decode_class_always_zero,
        )

    return eval_step
