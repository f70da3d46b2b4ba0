"""BatchNorm folding for the serving graph, on JAX-layout numpy trees.

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/utils/fold_bn.py:37-101``:
eval-mode BatchNorm after a conv/dense is an affine map with constant
coefficients, so

    y = gamma * (W*x - mu) / sqrt(var + eps) + beta
      = (W * gamma/sqrt(var+eps)) * x + (beta - mu * gamma/sqrt(var+eps))

and the BN disappears. Pairing follows the flax naming conventions
(conv1/bn1, downsample_conv/downsample_bn, channel_proj/channel_proj_bn,
<x>_conv/<x>_bn, mlp<i>/bn<i>). Kernels are HWIO / (in, out): the scale
broadcasts over the last axis. The folded tree loads into a model built
with ``fold_bn=True`` through `utils.convert.load_jax_variables`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

_EPS = 1e-5


def _bn_partner(name: str) -> Optional[str]:
    if name.endswith("_conv"):
        return name[:-5] + "_bn"
    if name.startswith("conv") and name[4:].isdigit():
        return "bn" + name[4:]
    if name.startswith("mlp") and name[3:].isdigit():
        return "bn" + name[3:]
    return name + "_bn"


def _fold_pair(conv: Dict, bn: Dict, stats: Dict) -> Dict:
    scale = np.asarray(bn["scale"], np.float32) / np.sqrt(
        np.asarray(stats["var"], np.float32) + _EPS
    )
    kernel = np.asarray(conv["kernel"], np.float32) * scale
    bias = np.asarray(bn["bias"], np.float32) - np.asarray(stats["mean"], np.float32) * scale
    if "bias" in conv:
        bias = bias + np.asarray(conv["bias"], np.float32) * scale
    return {"kernel": kernel, "bias": bias}


def fold_bn_params(params: Any, batch_stats: Any) -> Any:
    """Fold every (conv|dense, bn) pair found by naming convention; the BN
    params are consumed. Subtrees without pairs pass through unchanged."""
    if not isinstance(params, dict):
        return params
    stats = batch_stats if isinstance(batch_stats, dict) else {}
    # pair first: a BN may come before its conv in the tree's key order
    # (tree utilities sort keys), and must be dropped all the same
    pairs = {}
    for name, sub in params.items():
        partner = _bn_partner(name) if isinstance(sub, dict) else None
        if (
            partner
            and "kernel" in sub
            and isinstance(params.get(partner), dict)
            and "scale" in params[partner]
            and partner in stats
        ):
            pairs[name] = partner
    consumed = set(pairs.values())
    out = {}
    for name, sub in params.items():
        if name in consumed:
            continue
        if name in pairs:
            out[name] = _fold_pair(sub, params[pairs[name]], stats[pairs[name]])
        elif isinstance(sub, dict):
            out[name] = fold_bn_params(sub, stats.get(name, {}))
        else:
            out[name] = sub
    return out


def fold_camera_variables(variables: Dict) -> Dict:
    """Fold only the camera encoder subtree (what a detector built with
    ``fold_bn=True`` expects); every other module keeps its BatchNorms."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats", {}))
    if "camera_encoder" in params:
        params["camera_encoder"] = fold_bn_params(
            params["camera_encoder"], stats.get("camera_encoder", {})
        )
        stats.pop("camera_encoder", None)
    out = {"params": params}
    if stats or "batch_stats" in variables:
        out["batch_stats"] = stats
    return out
