"""Restore a checkpoint into a variables tree ready to serve.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/utils/restore.py:18-82``:
build the UNFOLDED model, restore a msgpack checkpoint (either package's)
into its tree, or without one seed it and load the pretrained camera trunk
where configured, and fold the camera BatchNorms when asked. A ``.pth`` or
``.pt`` file is a reference-framework torch checkpoint, migrated by
`utils.reference_convert` over the seeded tree. A failed restore raises; it
never falls back to random weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.detector import MultiModal3DDetector
from .convert import export_jax_variables
from .fold_bn import fold_camera_variables

_INIT_SEED = 0  # the seeded weights served when no checkpoint is given


def load_serving_variables(spec, model_path: Optional[str] = None, fold_bn: bool = False) -> Dict:
    """``{"params", "batch_stats"}`` in JAX layout (numpy), restored from
    `model_path` into the unfolded tree, then folded with `fold_bn`."""
    model = MultiModal3DDetector(spec)
    if model_path is None:
        from .torch_convert import maybe_load_pretrained_camera

        model.init_weights(torch.Generator().manual_seed(_INIT_SEED))
        maybe_load_pretrained_camera(model, spec)
        variables = export_jax_variables(model)
    elif str(model_path).endswith((".pth", ".pt")):
        from .reference_convert import load_reference_checkpoint_into

        model.init_weights(torch.Generator().manual_seed(_INIT_SEED))
        variables = load_reference_checkpoint_into(export_jax_variables(model), model_path)
    else:
        from ..train.checkpoint import fill_kept, load_checkpoint

        template = export_jax_variables(model, empty=True)
        restored = fill_kept(load_checkpoint(model_path, template), template,
                             lambda: export_jax_variables(model))
        variables = {"params": restored["params"], "batch_stats": restored["batch_stats"]}
    if fold_bn:
        variables = fold_camera_variables(variables)
    return variables
