"""Reference-checkpoint migration: torch `.pth` state_dicts of the reference
framework -> the JAX package's ``{"params", "batch_stats"}`` layout (numpy).

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/utils/reference_convert.py:111-293``:
the three encoders, the BEV, attention and late fusions and both heads. The
tree it returns is the one msgpack checkpoints carry, so it reaches the
port's modules the same way (`utils.convert.load_jax_variables`). The
VoxelNet LiDAR encoder has no reference key mapping in the JAX package
either: its leaves keep their values, as JAX's strict=False merge leaves
them.

Key layout of the reference:
  camera_encoder.conv1/bn1, camera_encoder.layer{1..3}.{0,1}.*,
  camera_encoder.channel_proj.{0=conv,1=bn}
  lidar_encoder.conv{1..5}/bn{1..5}
  radar_encoder.radar_encoder.conv{1..4}/bn{1..4}, radar_encoder.fusion_fc
  fusion.camera_proj.{0,1,3,4}, fusion.lidar_init.{0,2},
  fusion.lidar_upsample.{0,1,4,5}, fusion.radar_proj.0,
  fusion.radar_refine.{0,1,3,4}, fusion.bev_fusion.{0,1,3,4}
  attention: fusion.{camera,lidar,radar}_proj (no index),
  fusion.{cam,lidar,radar}_pos_embed,
  fusion.self_attention_layers.{i}.self_attn.{query,key,value,out},
  .ffn.{0,3}, .norm1, .norm2; fusion.output_proj.{0,3}
  late: fusion.fusion_mlp.{0,3}
  det_head.{heatmap,offset,size,rot,vel}_head.{0,2}; det_head.head.{0,3}
  (the MLP head)

Weight layouts: Conv2d (O, I, kH, kW) -> (kH, kW, I, O); Conv1d (O, I, 1)
and Linear (O, I) -> Dense (I, O); LayerNorm weight -> scale.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import numpy as np
import torch

def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _conv2d(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)


def _conv1d(w) -> np.ndarray:
    return np.asarray(w)[:, :, 0].T  # (O, I, 1) -> (I, O)


def _linear(w) -> np.ndarray:
    return np.asarray(w).T


def _sub(sd: Dict, prefix: str) -> Dict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def _bn(sd: Dict, prefix: str) -> Tuple[Dict, Dict]:
    return (
        {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])},
        {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
         "var": np.asarray(sd[f"{prefix}.running_var"])},
    )


def _conv_bn(sd: Dict, conv_key: str, bn_key: str, name: str, params, stats) -> None:
    conv = {"kernel": _conv2d(sd[f"{conv_key}.weight"])}
    if f"{conv_key}.bias" in sd:
        conv["bias"] = np.asarray(sd[f"{conv_key}.bias"])
    params[f"{name}_conv"] = conv
    params[f"{name}_bn"], stats[f"{name}_bn"] = _bn(sd, bn_key)


def _dense(sd: Dict, prefix: str) -> Dict:
    return {"kernel": _linear(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _layernorm(sd: Dict, prefix: str) -> Dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _resnet18_trunk(sd: Dict) -> Tuple[Dict, Dict]:
    """torchvision ResNet-18 keys (conv1, bn1, layer{1..3}) -> the trunk's
    (params, batch_stats)."""
    params: Dict[str, Any] = {"conv1": {"kernel": _conv2d(sd["conv1.weight"])}}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    for layer in (1, 2, 3):
        for block in (0, 1):
            name, prefix = f"layer{layer}_{block}", f"layer{layer}.{block}"
            p: Dict[str, Any] = {
                "conv1": {"kernel": _conv2d(sd[f"{prefix}.conv1.weight"])},
                "conv2": {"kernel": _conv2d(sd[f"{prefix}.conv2.weight"])},
            }
            s: Dict[str, Any] = {}
            p["bn1"], s["bn1"] = _bn(sd, f"{prefix}.bn1")
            p["bn2"], s["bn2"] = _bn(sd, f"{prefix}.bn2")
            if f"{prefix}.downsample.0.weight" in sd:
                p["downsample_conv"] = {"kernel": _conv2d(sd[f"{prefix}.downsample.0.weight"])}
                p["downsample_bn"], s["downsample_bn"] = _bn(sd, f"{prefix}.downsample.1")
            params[name], stats[name] = p, s
    return params, stats


def _point_mlp(sd: Dict, num_layers: int) -> Tuple[Dict, Dict]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(1, num_layers + 1):
        params[f"mlp{i}"] = {"kernel": _conv1d(sd[f"conv{i}.weight"]),
                             "bias": np.asarray(sd[f"conv{i}.bias"])}
        if f"bn{i}.weight" in sd:
            params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, f"bn{i}")
    return params, stats


def convert_reference_checkpoint(state_dict: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """torch state_dict (reference key layout) -> (params, batch_stats) of
    the detector. Which modules are present is read from the keys, so every
    modality combination converts."""
    sd = {k: _numpy(v) for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    if "camera_encoder.conv1.weight" in sd:
        trunk_p, trunk_s = _resnet18_trunk(_sub(sd, "camera_encoder."))
        cam_p: Dict[str, Any] = {"trunk": trunk_p}
        cam_s: Dict[str, Any] = {"trunk": trunk_s}
        cam_p["channel_proj"] = {"kernel": _conv2d(sd["camera_encoder.channel_proj.0.weight"])}
        cam_p["channel_proj_bn"], cam_s["channel_proj_bn"] = _bn(sd, "camera_encoder.channel_proj.1")
        params["camera_encoder"], stats["camera_encoder"] = cam_p, cam_s

    if "lidar_encoder.conv1.weight" in sd:
        n = len({k.split(".")[1] for k in sd if k.startswith("lidar_encoder.conv")})
        p, s = _point_mlp(_sub(sd, "lidar_encoder."), n)
        params["lidar_encoder"], stats["lidar_encoder"] = {"point_mlp": p}, {"point_mlp": s}

    if "radar_encoder.radar_encoder.conv1.weight" in sd:
        n = len({k.split(".")[2] for k in sd if k.startswith("radar_encoder.radar_encoder.conv")})
        p, s = _point_mlp(_sub(sd, "radar_encoder.radar_encoder."), n)
        rad_p: Dict[str, Any] = {"shared_radar": {"point_mlp": p}}
        if "radar_encoder.fusion_fc.weight" in sd:
            rad_p["fusion"] = _dense(sd, "radar_encoder.fusion_fc")
        params["radar_encoder"], stats["radar_encoder"] = rad_p, {"shared_radar": {"point_mlp": s}}

    fus_p: Dict[str, Any] = {}
    fus_s: Dict[str, Any] = {}
    if "fusion.camera_proj.0.weight" in sd:
        _conv_bn(sd, "fusion.camera_proj.0", "fusion.camera_proj.1", "camera_proj1", fus_p, fus_s)
        _conv_bn(sd, "fusion.camera_proj.3", "fusion.camera_proj.4", "camera_proj2", fus_p, fus_s)
    if "fusion.lidar_init.0.weight" in sd:
        fus_p["lidar_init1"] = _dense(sd, "fusion.lidar_init.0")
        fus_p["lidar_init2"] = _dense(sd, "fusion.lidar_init.2")
        _conv_bn(sd, "fusion.lidar_upsample.0", "fusion.lidar_upsample.1", "lidar_up1", fus_p, fus_s)
        _conv_bn(sd, "fusion.lidar_upsample.4", "fusion.lidar_upsample.5", "lidar_up2", fus_p, fus_s)
    if "fusion.radar_proj.0.weight" in sd:
        fus_p["radar_proj"] = _dense(sd, "fusion.radar_proj.0")
        _conv_bn(sd, "fusion.radar_refine.0", "fusion.radar_refine.1", "radar_refine1", fus_p, fus_s)
        _conv_bn(sd, "fusion.radar_refine.3", "fusion.radar_refine.4", "radar_refine2", fus_p, fus_s)
    if "fusion.bev_fusion.0.weight" in sd:
        _conv_bn(sd, "fusion.bev_fusion.0", "fusion.bev_fusion.1", "bev_fusion1", fus_p, fus_s)
        _conv_bn(sd, "fusion.bev_fusion.3", "fusion.bev_fusion.4", "bev_fusion2", fus_p, fus_s)
    # attention fusion: its projections carry no Sequential index
    # (`fusion.camera_proj.weight` against BEV's `fusion.camera_proj.0.weight`)
    if "fusion.output_proj.0.weight" in sd:
        for ref_name, embed in (("camera_proj", "cam_pos_embed"), ("lidar_proj", "lidar_pos_embed"),
                                ("radar_proj", "radar_pos_embed")):
            if f"fusion.{ref_name}.weight" in sd:
                fus_p[ref_name] = _dense(sd, f"fusion.{ref_name}")
                fus_p[embed] = np.asarray(sd[f"fusion.{embed}"])
        i = 0
        while f"fusion.self_attention_layers.{i}.norm1.weight" in sd:
            base = f"fusion.self_attention_layers.{i}"
            fus_p[f"self_attn_{i}"] = {part: _dense(sd, f"{base}.self_attn.{part}")
                                       for part in ("query", "key", "value", "out")}
            fus_p[f"ffn1_{i}"] = _dense(sd, f"{base}.ffn.0")
            fus_p[f"ffn2_{i}"] = _dense(sd, f"{base}.ffn.3")
            fus_p[f"norm1_{i}"] = _layernorm(sd, f"{base}.norm1")
            fus_p[f"norm2_{i}"] = _layernorm(sd, f"{base}.norm2")
            i += 1
        fus_p["out_proj1"] = _dense(sd, "fusion.output_proj.0")
        fus_p["out_proj2"] = _dense(sd, "fusion.output_proj.3")
    if "fusion.fusion_mlp.0.weight" in sd:  # late fusion
        fus_p["fusion1"] = _dense(sd, "fusion.fusion_mlp.0")
        fus_p["fusion2"] = _dense(sd, "fusion.fusion_mlp.3")
    # the global fusions have no statistics: an empty subtree is never merged
    if fus_p:
        params["fusion"], stats["fusion"] = fus_p, fus_s

    head_p: Dict[str, Any] = {}
    for branch in ("heatmap", "offset", "size", "rot", "vel"):
        key = f"det_head.{branch}_head"
        if f"{key}.0.weight" in sd:
            head_p[f"{branch}_head"] = {
                "conv1": {"kernel": _conv2d(sd[f"{key}.0.weight"]), "bias": np.asarray(sd[f"{key}.0.bias"])},
                "conv2": {"kernel": _conv2d(sd[f"{key}.2.weight"]), "bias": np.asarray(sd[f"{key}.2.bias"])},
            }
    if "det_head.head.0.weight" in sd:  # the MLP head
        head_p["fc1"] = _dense(sd, "det_head.head.0")
        head_p["fc2"] = _dense(sd, "det_head.head.3")
    if head_p:
        params["det_head"] = head_p
    return params, stats


def _merge(dst: Dict, src: Dict) -> None:
    """Copy `src`'s leaves into `dst`; an empty subtree adds nothing."""
    for k, v in src.items():
        if isinstance(v, dict):
            if v:
                _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = np.asarray(v)


def load_reference_checkpoint_into(variables: Dict, checkpoint_path: str) -> Dict:
    """Restore a reference torch checkpoint file ({'model_state_dict': ...}
    or a bare state_dict) into a copy of `variables`; entries the file does
    not map keep their values (the reference loads with strict=False). The
    file is read with ``weights_only=True``: tensors and plain containers,
    never arbitrary pickled objects."""
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model_state_dict", ckpt)
    new_p, new_s = convert_reference_checkpoint(state_dict)
    out = copy.deepcopy({"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    _merge(out["params"], new_p)
    _merge(out["batch_stats"], new_s)
    return out
