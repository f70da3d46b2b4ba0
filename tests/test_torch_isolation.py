"""The PyTorch port stands alone: every module of it, and chip_smoke.py,
imports with jax, flax, optax and the JAX package blocked; and its config
parsing matches the JAX package's on the repo's configs."""

import dataclasses
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = "bevfusion_multimodal_3d_object_detection_tpu_torch"

_BLOCKED_IMPORT = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "bevfusion_multimodal_3d_object_detection_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
sys.path.insert(0, {str(ROOT)!r})
import {PORT} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(" ".join(names))
"""
# the modules of the training entry point, which must be among them
TRAINING_MODULES = (
    "data.converter", "data.dataset", "data.native", "train.checkpoint", "train.loop",
    "train_detect", "utils.box_geometry", "utils.convert", "utils.metrics", "utils.restore",
    "utils.torch_convert",
)
# the modules of the inference, evaluation and serving entry points
ENTRY_POINT_MODULES = (
    "client", "eval", "inference", "inference_engine", "serve", "serving", "utils.reference_convert",
    "utils.submission",
)
# the modules that hold the fusion and head variants, and the ablation runner
VARIANT_MODULES = (
    "ablation", "models.detector", "models.encoders", "models.fusion", "models.heads", "ops.losses",
)
# the AOT serving, profiling and build-cache modules, the offline data tools
# and their CLI mirrors
TOOL_MODULES = (
    "utils.aot", "utils.profiling", "utils.cache", "data.validate", "data_converter", "data_validate",
    "validate_data_with_samples", "ops.preprocess", "ops.targets",
)
# data parallelism and the camera-view axis
PARALLEL_MODULES = ("parallel", "parallel.distributed", "parallel.mesh", "parallel.view", "parallel.zero")


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True, text=True,
        timeout=120, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.splitlines()[-1].split())
    assert len(imported) >= 52  # every module was imported
    assert {
        f"{PORT}.{m}"
        for m in TRAINING_MODULES + ENTRY_POINT_MODULES + VARIANT_MODULES + TOOL_MODULES + PARALLEL_MODULES
    } <= imported


# DetectorSpec keys the JAX package does not have: the Swin camera stream's
PORT_ONLY_KEYS = {"camera": ("swin",), "bev": ("camera_bev_channels",
                                               "camera_downsample", "camera_zbound")}


@pytest.mark.parametrize("config", ["base.yaml", "bev100.yaml", "base.yaml:geometric", "base.yaml:train"])
def test_config_parsing_matches_jax(config):
    """`:geometric` overrides base.yaml in memory with the geometric eval
    path's camera_to_bev: geometric and splat_mode: pallas; `:train` honors
    the YAML loss weights and mixed precision (Q7 off) and turns on
    gradient accumulation."""
    from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
    from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config

    name, _, override = config.partition(":")
    cfg = port_config.load_config(str(ROOT / "configs" / name))
    if override == "geometric":
        cfg["model"]["bev_fusion"].update(camera_to_bev="geometric", splat_mode="pallas")
        assert port_config.DetectorSpec.from_config(cfg).bev.splat_mode == "pallas"
    elif override == "train":
        cfg.setdefault("compat", {}).update(ignore_config_loss_weights=False, ignore_mixed_precision=False)
        cfg["train"]["gradient_accumulation"] = {"enable": True, "steps": 3}
        train = port_config.TrainSpec.from_config(cfg)
        assert train.mixed_precision and train.grad_accum_steps == 3 and train.loss_weights[2] != 1.0
    for name in ("DetectorSpec", "CompatFlags", "TrainSpec", "DataSpec", "ParallelSpec"):
        port = dataclasses.asdict(getattr(port_config, name).from_config(cfg))
        ref = getattr(jax_config, name).from_config(cfg)
        if name == "DetectorSpec":  # the port's own keys, at their defaults in these configs
            default = dataclasses.asdict(port_config.DetectorSpec())
            for section, keys in PORT_ONLY_KEYS.items():
                for key in keys:
                    assert port[section].pop(key) == default[section][key], (section, key)
        assert port == dataclasses.asdict(ref), name
    for section in ("val", ("inference", "test")):
        assert dataclasses.asdict(
            port_config.PostProcessSpec.from_config(cfg, section)
        ) == dataclasses.asdict(jax_config.PostProcessSpec.from_config(cfg, section))
    with pytest.raises(ValueError, match="unknown compat"):
        port_config.CompatFlags.from_config({"compat": {"no_such_flag": True}})
