"""Serving artifacts made ahead of time with `torch.export`.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/utils/aot.py``. An
`InferenceServer`'s serving body (forward + decode, `serving.py:_serve_body`)
is exported once per wire signature into a serialized `ExportedProgram`; a
replica loads the programs and runs them without the model's Python code
(the model is still built, to hold the weights).

Artifact format: one .npz holding a `torch.export.save` blob per wire
signature, ``f32`` (float cameras, staged in the model's dtype) and ``u8``
(uint8 cameras, normalized in the graph), both even for camera-off configs,
since the server warms both; plus a ``meta`` JSON entry (format
``bmod-aot-torch-v1``, batch size, shapes, modalities, model dtype,
``fold_bn``, the device type it was traced on, git commit).

Weights are not in the artifact. The programs keep them as lifted
parameters and buffers, saved as shape-only (meta) tensors, and
`attach_aot_serving` binds the server's own tensors to them: an artifact
pairs with any checkpoint of the same config, as the JAX one does. The
programs call B1 as the custom op ``bmod_torch::pointnet_fused``, so loading
one needs the port's ``ops`` imported (this module imports it).

An artifact runs on the device type it was traced on (``cuda`` programs hold
that device in their graph). The JAX package's ``bmod-aot-v1`` StableHLO
artifacts are refused with a message that names them.
"""

from __future__ import annotations

import io
import json
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import pointnet_fused  # noqa: F401  registers bmod_torch::pointnet_fused

FORMAT = "bmod-aot-torch-v1"
JAX_FORMAT = "bmod-aot-v1"


def _git_commit():
    try:
        return subprocess.run(
            ["git", "-C", str(Path(__file__).parents[2]), "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


class ServingGraph(nn.Module):
    """A server's undecorated serving body as a module that holds its model,
    so that `torch.export` lifts the model's parameters and buffers."""

    def __init__(self, server):
        super().__init__()
        self.model = server.model
        self._body = server._serve_body

    def forward(self, cams, lidar, radars):
        return self._body(cams, lidar, radars)


def _zero_batch(server, uint8: bool):
    sample = server._zero_sample()
    if uint8:
        sample["camera_imgs"] = sample["camera_imgs"].astype(np.uint8)
    return server._stage([sample] * server.batch_size)[1][0]


def export_serving_artifact(server, path) -> Dict:
    """Export `server`'s serving body (both wire signatures) to `path` as an
    .npz artifact; returns the metadata also stored in it. The server must
    run its live model (not an artifact)."""
    if server.aot_meta is not None:
        raise ValueError("export needs the server's live model, not one served from an AOT artifact")
    graph = ServingGraph(server).eval()
    blobs = {}
    for name, uint8 in (("f32", False), ("u8", True)):
        with torch.no_grad():
            exported = torch.export.export(graph, _zero_batch(server, uint8), strict=False)
        # the weights stay lifted parameters; store their shapes only, and
        # drop the example inputs (a full-width batch: ~100 MB of cameras)
        exported.example_inputs = None
        for key, t in exported.state_dict.items():
            shape_only = torch.empty_like(t, device="meta")
            if isinstance(t, nn.Parameter):
                shape_only = nn.Parameter(shape_only, requires_grad=t.requires_grad)
            exported.state_dict[key] = shape_only
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        blobs[name] = np.frombuffer(buf.getvalue(), dtype=np.uint8)

    spec = server.spec
    h, w = spec.camera.image_size
    meta = {
        "format": FORMAT,
        "batch_size": int(server.batch_size),
        "image_size": [int(h), int(w)],
        "max_points": int(spec.lidar.max_points),
        "modalities": {
            "camera": bool(spec.use_camera),
            "lidar": bool(spec.use_lidar),
            "radar": bool(spec.use_radar),
        },
        "model_dtype": _dtype_name(server.dtype),
        "fold_bn": bool(server.fold_bn),
        "platforms": [server.device.type],
        "signatures": sorted(blobs),
        "torch_version": torch.__version__,
        "git_commit": _git_commit(),
        "exported_at": time.strftime("%Y-%m-%d %H:%M"),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # through a file object, so np.savez cannot append '.npz' to the path
    with open(path, "wb") as f:
        np.savez(f, meta=np.array(json.dumps(meta)), **blobs)
    return meta


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _read_meta(z, path) -> Dict:
    meta = json.loads(str(z["meta"]))
    fmt = meta.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(
            f"{path}: a JAX package artifact ({JAX_FORMAT}, StableHLO); the PyTorch port serves "
            f"{FORMAT} artifacts only: export one with the port's serve --export-aot"
        )
    if fmt != FORMAT:
        raise ValueError(f"{path}: not a bmod AOT serving artifact of the PyTorch port")
    return meta


def _programs(z, meta) -> Dict[str, "torch.export.ExportedProgram"]:
    return {name: torch.export.load(io.BytesIO(z[name].tobytes())) for name in meta["signatures"]}


def load_serving_artifact(path) -> Tuple[Dict[str, "torch.export.ExportedProgram"], Dict]:
    """Load an artifact written by `export_serving_artifact`: returns
    (programs, meta), `programs` mapping each signature ('f32' / 'u8') to
    its `ExportedProgram` (weights as shape-only tensors)."""
    with np.load(path) as z:
        meta = _read_meta(z, path)
        return _programs(z, meta), meta


def _bind(module: nn.Module, name: str, tensor: torch.Tensor) -> None:
    *owner, leaf = name.split(".")
    for part in owner:
        module = getattr(module, part)
    if leaf in module._parameters:
        module._parameters[leaf] = tensor
    else:
        module._buffers[leaf] = tensor


def _check_against(meta: Dict, server) -> None:
    if meta["batch_size"] != server.batch_size:
        raise ValueError(
            f"AOT artifact was exported for batch_size={meta['batch_size']}, "
            f"server uses {server.batch_size}"
        )
    h, w = server.spec.camera.image_size
    if meta["image_size"] != [h, w] or meta["max_points"] != server.spec.lidar.max_points:
        raise ValueError(
            f"AOT artifact shapes {meta['image_size']}/{meta['max_points']}pts do not match "
            f"the server config {[h, w]}/{server.spec.lidar.max_points}pts"
        )
    want_mods = {
        "camera": bool(server.spec.use_camera),
        "lidar": bool(server.spec.use_lidar),
        "radar": bool(server.spec.use_radar),
    }
    if meta["modalities"] != want_mods:
        raise ValueError(
            f"AOT artifact modalities {meta['modalities']} do not match the server config {want_mods}"
        )
    dtype = _dtype_name(server.dtype)
    if meta["model_dtype"] != dtype:
        raise ValueError(
            f"AOT artifact model dtype {meta['model_dtype']} does not match the server's {dtype} "
            "- export and serve with the same --f32 setting"
        )
    if meta["fold_bn"] != bool(server.fold_bn):
        raise ValueError(
            f"AOT artifact was exported with fold_bn={meta['fold_bn']} but the server uses "
            f"fold_bn={bool(server.fold_bn)} - the weights the programs take differ; export and "
            "serve with the same --no-fold-bn setting"
        )
    if server.device.type not in meta["platforms"]:
        raise ValueError(
            f"AOT artifact was traced on {meta['platforms']}, the server runs on "
            f"{server.device.type}: export on the device type that serves"
        )


def attach_aot_serving(server, path) -> Dict:
    """Swap `server._serve` for the artifact's programs, after checking the
    artifact against the server's configuration (a mismatch fails at
    startup, not mid-request), with the server's own weights bound to them.
    Returns the artifact's metadata."""
    with np.load(path) as z:
        meta = _read_meta(z, path)
        _check_against(meta, server)
        programs = _programs(z, meta)

    weights = ServingGraph(server).state_dict(keep_vars=True)
    modules = {}
    for name, program in programs.items():
        saved = program.state_dict
        if set(saved) != set(weights):
            raise ValueError(
                f"AOT artifact '{name}' takes other weights than the server's model: "
                f"the artifact's only {sorted(set(saved) - set(weights))[:5]}, "
                f"the server's only {sorted(set(weights) - set(saved))[:5]}"
            )
        for key, t in saved.items():
            have = weights[key]
            if t.shape != have.shape or t.dtype != have.dtype:
                raise ValueError(
                    f"AOT artifact '{name}': {key} is {tuple(t.shape)} {t.dtype}, the server's "
                    f"{tuple(have.shape)} {have.dtype}"
                )
        module = program.module()
        for key in saved:
            _bind(module, key, weights[key])
        modules[name] = module

    def _serve_aot(cams, lidar, radars):
        name = "u8" if cams.dtype == torch.uint8 else "f32"
        if name not in modules:
            raise ValueError(f"AOT artifact has no '{name}' wire signature (has {meta['signatures']})")
        with torch.inference_mode():
            return modules[name](cams, lidar, radars)

    server._serve = _serve_aot
    return meta
