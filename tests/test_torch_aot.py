"""AOT serving artifacts of the port (utils/aot.py, `torch.export`) on the
CPU, against the live port server and the JAX server.

- Round trip: the narrow config's artifact, served through `aot_path`,
  equals the live port server bit for bit (the same kernels on the same
  inputs), for a uint8 request, float requests and a partial batch; and it
  equals the JAX server at `test_torch_serving.py`'s tolerances (scores
  1e-4, boxes 1e-3 absolute: f32 in two frameworks).
- Weights are not in the artifact: a server restored with other weights
  serves them through the same artifact, bit for bit like a live server
  with those weights.
- Every validation error of JAX `tests/test_aot.py:89` that the port has
  (batch size, dtype, not an artifact, fold_bn, an extensionless path),
  plus modalities and shapes, a JAX package artifact and a device type
  other than the one traced on.
- A camera-off config exports both wire signatures, so the uint8 warm-up
  runs from the artifact (JAX `test_aot.py:162`).
- The serve CLI's flag exclusions, and its --export-aot.
"""

import copy
import json

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.config import DetectorSpec
from bevfusion_multimodal_3d_object_detection_tpu.serving import InferenceServer as JaxServer
from bevfusion_multimodal_3d_object_detection_tpu.utils.aot import (
    export_serving_artifact as jax_export_serving_artifact,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch import serve as serve_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.aot import (
    attach_aot_serving,
    export_serving_artifact,
    load_serving_artifact,
)
from test_torch_serving import _samples, _sorted, narrow_config, variables  # noqa: F401  (fixtures)
from torch_port_helpers import random_variables

KW = dict(batch_size=2, max_delay_ms=200.0, score_threshold=0.5, use_bf16=False, fold_bn=True, device="cpu")


@pytest.fixture(scope="module")
def artifact(narrow_config, variables, tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "serving.aot.npz"
    live = InferenceServer(config=narrow_config, variables=variables, **KW)
    meta = export_serving_artifact(live, path)
    return path, meta, live


def _requests(config):
    samples = _samples(DetectorSpec.from_config(config), 3, seed=5)
    samples[0]["camera_imgs"] = np.random.RandomState(6).randint(0, 256, (6, 32, 64, 3), np.uint8)
    return samples


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_artifact_serves_like_the_live_and_jax_servers(narrow_config, variables, artifact):
    path, meta, live = artifact
    assert meta["format"] == "bmod-aot-torch-v1" and meta["signatures"] == ["f32", "u8"]
    assert meta["platforms"] == ["cpu"] and meta["model_dtype"] == "float32" and meta["fold_bn"]
    assert meta["modalities"] == {"camera": True, "lidar": True, "radar": True}
    programs, _ = load_serving_artifact(path)
    assert all(t.is_meta for p in programs.values() for t in p.state_dict.values())  # no weights inside

    samples = _requests(narrow_config)
    aot = InferenceServer(config=narrow_config, variables=variables, aot_path=str(path), **KW)
    assert aot.aot_meta == meta
    with aot:
        # three requests on batch 2: a coalesced batch (mixed wires) and a partial one
        futures = [aot.submit(s) for s in samples]
        got = [f.result(timeout=300) for f in futures]
    assert aot.stats["requests"] == 3 and aot.stats["padded_rows"] >= 1
    want_live = live._run_batch(samples[:2]) + live._run_batch(samples[2:])
    if aot.stats["batches"] == 2:  # the same batches as the live run: the same bits
        _assert_bit_equal(got, want_live)
    _assert_bit_equal(aot._run_batch(samples[:2]) + aot._run_batch(samples[2:]), want_live)

    jax_server = JaxServer(**{k: v for k, v in KW.items() if k != "device"}, config=narrow_config,
                           variables=variables)
    want = [jax_server._run_batch([s])[0] for s in samples]
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]) > 0
        g, w = _sorted(g), _sorted(w)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_artifact_serves_the_servers_own_weights(narrow_config, variables, artifact):
    path, _, live_a = artifact
    other = random_variables(variables, seed=12)
    live_b = InferenceServer(config=narrow_config, variables=other, **KW)
    aot_b = InferenceServer(config=narrow_config, variables=other, aot_path=str(path), **KW)
    samples = _requests(narrow_config)[:2]
    got = aot_b._run_batch(samples)
    _assert_bit_equal(got, live_b._run_batch(samples))
    assert not all(np.array_equal(g["scores"], w["scores"]) for g, w in zip(got, live_a._run_batch(samples)))


def _rewrite_meta(src, dst, **changes):
    with np.load(src) as z:
        arrays = {k: z[k] for k in z}
    meta = json.loads(str(arrays["meta"]))
    meta.update(changes)
    arrays["meta"] = np.array(json.dumps(meta))
    with open(dst, "wb") as f:
        np.savez(f, **arrays)
    return str(dst)


def test_artifact_validation(narrow_config, variables, artifact, tmp_path):
    """A mismatched artifact fails at startup with a clear error, never
    mid-request. Past the first case, the checks run on copies of the live
    server with one setting changed (they read the artifact's meta before
    anything else)."""
    path, _, live = artifact
    with pytest.raises(ValueError, match="batch_size"):
        InferenceServer(**dict(KW, batch_size=4), config=narrow_config, variables=variables, aot_path=str(path))

    def attach(p, **changes):
        server = copy.copy(live)
        for k, v in changes.items():
            setattr(server, k, v)
        return attach_aot_serving(server, p)

    with pytest.raises(ValueError, match="dtype"):
        attach(path, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fold_bn"):
        attach(path, fold_bn=False)
    bogus = tmp_path / "bogus.npz"
    np.savez(bogus, meta=np.array("{}"))
    with pytest.raises(ValueError, match="not a bmod AOT"):
        attach(bogus)
    for changes, match in (({"image_size": [64, 64]}, "shapes"), ({"max_points": 128}, "shapes"),
                           ({"modalities": {"camera": True, "lidar": True, "radar": False}}, "modalities"),
                           ({"platforms": ["cuda"]}, r"traced on \['cuda'\]"),
                           ({"format": "bmod-aot-v1"}, "JAX package artifact")):
        with pytest.raises(ValueError, match=match):
            attach(_rewrite_meta(path, tmp_path / "changed.npz", **changes))
    # a server that serves an artifact cannot export one
    aot = copy.copy(live)
    aot.aot_meta = attach_aot_serving(aot, path)
    with pytest.raises(ValueError, match="live model"):
        export_serving_artifact(aot, tmp_path / "again.npz")
    # an extensionless path is written exactly as given
    bare = tmp_path / "serving.aot"
    export_serving_artifact(live, bare)
    assert bare.exists() and not (tmp_path / "serving.aot.npz").exists()


def test_jax_artifact_is_refused(narrow_config, variables, tmp_path):
    """A real JAX package artifact (StableHLO) names itself in the error."""
    spec_kw = {k: v for k, v in KW.items() if k != "device"}
    jax_path = tmp_path / "jax.aot.npz"
    jax_export_serving_artifact(JaxServer(config=narrow_config, variables=variables, **spec_kw), jax_path,
                                platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX package artifact"):
        InferenceServer(config=narrow_config, variables=variables, aot_path=str(jax_path), **KW)


def test_camera_off_config_serves_uint8_warmup(tmp_path):
    cfg = {
        "model": {"modality_config": "lidar_only", "lidar_encoder": {"max_points": 128}},
        "dataset": {"cameras": {"image_size": [32, 64]},
                    "max_points": {"lidar": 128, "radar_per_sensor": 8}},
    }
    kw = dict(config=cfg, batch_size=2, use_bf16=False, fold_bn=False, device="cpu")
    src = InferenceServer(**kw)
    path = tmp_path / "lidar.aot.npz"
    meta = export_serving_artifact(src, path)
    assert meta["signatures"] == ["f32", "u8"]
    assert meta["modalities"] == {"camera": False, "lidar": True, "radar": False}
    with InferenceServer(**kw, aot_path=str(path)) as aot:  # start() warms the uint8 wire too
        assert aot.aot_meta["model_dtype"] == "float32"


def test_serve_cli_aot_flags(narrow_config, tmp_path, capsys):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve_cli.main(["--aot", "a.npz", "--export-aot", "b.npz"])
    with pytest.raises(SystemExit, match="unpartitioned"):
        serve_cli.main(["--export-aot", "b.npz", "--data-parallel", "2"])
    with pytest.raises(SystemExit, match="needs that many devices"):  # no card here
        serve_cli.main(["--aot", "a.npz", "--data-parallel", "2"])
    import yaml

    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(narrow_config))
    path = tmp_path / "cli.aot"
    serve_cli.main(["--config", str(cfg), "--device", "cpu", "--f32", "--batch-size", "2", "--export-aot",
                    str(path)])
    assert f"AOT artifact written to {path} (batch=2, signatures=['f32', 'u8'], platforms=['cpu'])" \
        in capsys.readouterr().out
    with np.load(path) as z:
        assert sorted(z) == ["f32", "meta", "u8"]
        assert json.loads(str(z["meta"]))["model_dtype"] == "float32"
