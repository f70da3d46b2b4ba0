#!/usr/bin/env python3
"""Numerics of the PyTorch port against the JAX package, on the CPU.

    python3 port_numerics.py

from the repository root (JAX, flax and optax installed; a few minutes).
Prints one JSON line per question, at the narrow test sizes of
tests/torch_port_helpers.py and the batches of tests/torch_train_helpers.py:

- ``kink_ties``: after one train step (pseudo camera-to-BEV), at the
  variables' seed 3 and at the tests' seed 13, the worst first moment of
  the port's f32 step against its float64 step, as a share of the tensor's
  largest; the calls whose ReLU inputs or max-pool windows took another
  side of their kink in f32 than in float64 (kind, call index, elements);
  the f32 step again with the float64 sides replayed into it
  (chip_smoke.TieSides), the ties it crossed and the largest distance
  among them over its tensor's largest |input|;
  and JAX's jitted f32 step against the port's float64 one (which the tests
  hold within 1e-4 of JAX's exact step). Tensors whose float64 first moment
  is below 1e-9 of the largest (biases right before a BatchNorm: zero
  gradient) are left out;
- ``jax_f64_jit``: the radar encoder's float64 gradient in JAX jitted
  against un-jitted, torch's float64 gradient against the un-jitted one,
  and at the element where jitted and un-jitted differ most, a central
  finite difference of the loss beside both;
- ``bf16_server``: sorted detection scores of the port's bf16 server
  against JAX's bf16 servers (``use_pallas`` True and False) and JAX's f32
  server, largest absolute difference over 2 samples;
- ``bf16_train_step``: the mixed-precision train step's losses against
  JAX's model in bf16, relative.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

import conftest  # noqa: E402,F401  (CPU platform, highest matmul precision)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_train_helpers as H  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu.config import DetectorSpec, load_config  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu.models import encoders as jax_enc  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu.serving import InferenceServer as JaxServer  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import encoders as port_enc  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer  # noqa: E402
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables  # noqa: E402
from chip_smoke import TieSides  # noqa: E402
from torch_port_helpers import detector_inputs, narrow_spec, random_variables, to_port_spec  # noqa: E402


def worst_share(got: dict, want: dict, skip) -> tuple:
    rows = [(float((v - want[k]).abs().max() / want[k].abs().max()), k) for k, v in got.items() if k not in skip]
    return max(rows)


def crossed(a: TieSides, b: TieSides) -> list:
    return [("relu" if x.dtype == torch.bool else "max_pool2d", i, int((x != y).sum()))
            for i, (x, y) in enumerate(zip(a.sides, b.sides)) if not torch.equal(x, y)]


def kink_ties() -> dict:
    spec = H.train_spec_of("pseudo")
    batch = H.make_batches(spec)[0]
    out = {}
    for seed in (3, 13):
        variables = H.make_variables(spec, batch, seed)

        def moments(dtype, relu=contextlib.nullcontext()):
            model, opt, step = H.port_step_from(spec, variables, dtype=dtype)
            with relu:
                step(batch)
            return {k: v.clone() for k, v in H.first_moments(model, opt).items()}

        ties = TieSides()
        exact = moments(torch.float64, ties.record())
        largest = max(float(v.abs().max()) for v in exact.values())
        zero = {k for k, v in exact.items() if float(v.abs().max()) < 1e-9 * largest}
        own = TieSides()
        f32 = moments(torch.float32, own.record())
        replayed = moments(torch.float32, ties.replay())
        jax32 = H.state_dict_of(spec, H.jax_steps(spec, variables, [batch])[0]["mu"], variables["batch_stats"])
        row = {"f32_sides_differ": crossed(ties, own), "replay_crossed": ties.flips,
               "their_largest_share": ties.flip_share}
        for name, got in (("port_f32", f32), ("port_f32_replayed", replayed), ("jax_f32", jax32)):
            share, tensor = worst_share({k: v for k, v in got.items() if k in exact}, exact, zero)
            row[name] = {"worst_share": share, "tensor": tensor}
        out[f"seed_{seed}"] = row
    return out


def jax_f64_jit() -> dict:
    spec = narrow_spec().radar
    with jax.enable_x64(True):
        x = jnp.asarray(np.random.RandomState(0).randn(10, 16, 7))
        module = jax_enc.RadarEncoder(spec=spec, dtype=jnp.float64)
        v = random_variables(module.init({"params": jax.random.PRNGKey(0)}, x.astype(jnp.float32)), 3)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        ct = jnp.asarray(np.random.RandomState(1).randn(10, spec.mlp_layers[-1]))

        def f(params):
            out, _ = module.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                                  mutable=["batch_stats"])
            return (out * ct).sum()

        eager, jitted = jax.grad(f)(v["params"]), jax.jit(jax.grad(f))(v["params"])
    enc = load_jax_variables(port_enc.RadarEncoder(to_port_spec(spec)).double(),
                             jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)).train()
    (enc(torch.from_numpy(np.asarray(x))) * torch.from_numpy(np.asarray(ct))).sum().backward()
    grads = dict(enc.named_parameters())
    out = {}
    for i in (1, 2, 3):
        e = np.asarray(eager["point_mlp"][f"mlp{i}"]["kernel"])
        j = np.asarray(jitted["point_mlp"][f"mlp{i}"]["kernel"])
        t = grads[f"point_mlp.mlp{i}.weight"].grad.numpy().T
        top = np.abs(e).max()
        out[f"mlp{i}_kernel"] = {"jit_vs_eager": float(np.abs(j - e).max() / top),
                                 "torch_vs_eager": float(np.abs(t - e).max() / top)}
    e = np.asarray(eager["point_mlp"]["mlp1"]["kernel"])
    j = np.asarray(jitted["point_mlp"]["mlp1"]["kernel"])
    idx = np.unravel_index(int(np.argmax(np.abs(j - e))), e.shape)

    def loss_at(delta):
        kernel = np.array(v["params"]["point_mlp"]["mlp1"]["kernel"])
        kernel[idx] += delta
        params = jax.tree_util.tree_map(lambda a: a, v["params"])
        params["point_mlp"]["mlp1"]["kernel"] = kernel
        with jax.enable_x64(True):
            return float(f(jax.tree_util.tree_map(jnp.asarray, params)))

    h = 1e-6
    out["mlp1_kernel_worst_element"] = {"finite_difference": (loss_at(h) - loss_at(-h)) / (2 * h),
                                        "eager": float(e[idx]), "jit": float(j[idx])}
    return out


def bf16_server() -> dict:
    cfg = load_config(str(ROOT / "configs" / "base.yaml"))
    model = cfg["model"]
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    spec = DetectorSpec.from_config(cfg)
    args = tuple(jnp.asarray(a[:1]) for a in detector_inputs(spec))
    variables = random_variables(
        MultiModal3DDetector(spec=spec).init({"params": jax.random.PRNGKey(0)}, *args), seed=11)
    cams, lidar, radar = detector_inputs(spec, batch=2, seed=5)
    samples = [{"camera_imgs": cams[i], "lidar_points": lidar[i], "radar_points": radar[i]} for i in range(2)]
    kw = dict(config=cfg, batch_size=2, score_threshold=0.0, fold_bn=True, variables=variables)
    scores = {
        "port_bf16": InferenceServer(device="cpu", use_bf16=True, **kw)._run_batch(samples),
        "jax_bf16_pallas": JaxServer(use_bf16=True, use_pallas=True, **kw)._run_batch(samples),
        "jax_bf16_xla": JaxServer(use_bf16=True, **kw)._run_batch(samples),
        "jax_f32": JaxServer(use_bf16=False, **kw)._run_batch(samples),
    }

    def gap(a, b):
        return max(float(np.abs(np.sort(x["scores"]) - np.sort(y["scores"])).max())
                   for x, y in zip(scores[a], scores[b]))

    return {
        "port_vs_jax_pallas": gap("port_bf16", "jax_bf16_pallas"),
        "port_vs_jax_xla": gap("port_bf16", "jax_bf16_xla"),
        "jax_pallas_vs_jax_xla": gap("jax_bf16_pallas", "jax_bf16_xla"),
        "jax_bf16_vs_jax_f32": max(gap("jax_bf16_pallas", "jax_f32"), gap("jax_bf16_xla", "jax_f32")),
        "max_score": float(max(r["scores"].max() for r in scores["jax_f32"])),
    }


def bf16_train_step() -> dict:
    spec = H.train_spec_of("pseudo")
    batch = H.make_batches(spec)[0]
    variables = H.make_variables(spec, batch)
    want = H.jax_steps(spec, variables, [batch], dtype=jnp.bfloat16)[0]["losses"]
    _, _, step = H.port_step_from(spec, variables,
                                  train_spec=dataclasses.replace(H.TRAIN, mixed_precision=True))
    got = {k: float(v) for k, v in step(batch).items()}
    return {k: abs(got[k] / want[k] - 1) for k in H.LOSS_KEYS}


def main() -> None:
    for fn in (kink_ties, jax_f64_jit, bf16_server, bf16_train_step):
        print(json.dumps({fn.__name__: fn()}), flush=True)


if __name__ == "__main__":
    main()
