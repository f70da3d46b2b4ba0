"""torchvision ResNet-18 weights into the camera trunk.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/utils/torch_convert.py:114-150``.
The reference initializes the trunk from torchvision's ImageNet weights
(ref: encoders.py:98 ``models.resnet18(pretrained=True)``); with no network,
`maybe_load_pretrained_camera` reads a local torchvision-layout state_dict
instead. The port's trunk keeps torch's OIHW layout, so only the names map:

  conv1/bn1            -> camera_encoder.trunk.conv1, .bn1
  layerL.B.convN/bnN   -> camera_encoder.trunk.layer{L}_{B}.convN, .bnN
  layerL.B.downsample  -> ....downsample_conv, .downsample_bn

(layers 1-3; ``layer4`` and ``fc`` are not part of the trunk).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

import torch
from torch import nn

_warned_missing_pretrained = False
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def trunk_key(torchvision_key: str):
    """The trunk's state_dict key of one torchvision ResNet-18 key, or None
    for keys outside the trunk (layer4, fc, num_batches_tracked)."""
    m = re.fullmatch(r"(?:layer([123])\.([01])\.)?(conv[12]|bn[12]|downsample\.[01])\.(\w+)",
                     torchvision_key)
    if not m or m.group(4) not in _BN_LEAVES:
        return None
    layer, block, part, leaf = m.groups()
    part = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}.get(part, part)
    if layer is None:
        return f"{part}.{leaf}" if part in ("conv1", "bn1") else None
    return f"layer{layer}_{block}.{part}.{leaf}"


def load_torch_resnet18_into(model: nn.Module, weights_path: str) -> nn.Module:
    """Copy a torch-saved torchvision ResNet-18 state_dict into the model's
    camera trunk (in place); every trunk tensor must be in the file."""
    state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    trunk = model.camera_encoder.trunk
    if trunk.fold_bn:
        raise ValueError("load the pretrained trunk before folding its BatchNorms")
    own = trunk.state_dict()
    new: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        target = trunk_key(key)
        if target is None:
            continue
        if tuple(value.shape) != tuple(own[target].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(own[target].shape)}")
        new[target] = value.to(own[target].dtype)
    missing = sorted(k for k in own if k not in new and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"{weights_path} leaves trunk keys unset: {missing}")
    trunk.load_state_dict({**own, **new}, strict=True)
    return model


def maybe_load_pretrained_camera(model: nn.Module, spec) -> bool:
    """Honor ``camera_encoder.pretrained`` at init: with the camera in use
    and ``pretrained: true``, load the trunk from
    ``camera_encoder.pretrained_path`` (default ``./weights/resnet18.pth``
    where that file exists) and return True. With no file, warn loudly once
    and leave the weights as they are (the reference downloads them, which
    no network here allows)."""
    global _warned_missing_pretrained
    cam = getattr(spec, "camera", None)
    if cam is None or not getattr(spec, "use_camera", False) or not cam.pretrained:
        return False
    path = cam.pretrained_path
    if path is None and Path("./weights/resnet18.pth").exists():
        path = "./weights/resnet18.pth"
    if path is None or not Path(path).exists():
        if not _warned_missing_pretrained:
            _warned_missing_pretrained = True
            print(
                "WARNING: camera_encoder.pretrained=true but no local "
                f"torchvision resnet18 state_dict found (pretrained_path="
                f"{cam.pretrained_path!r}); the camera trunk starts from "
                "RANDOM init. Set model.camera_encoder.pretrained_path to a "
                "local .pth to match the reference's ImageNet initialization."
            )
        return False
    load_torch_resnet18_into(model, str(path))
    print(f"Loaded pretrained camera trunk from {path}")
    return True
