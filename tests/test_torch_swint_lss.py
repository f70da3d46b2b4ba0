"""The port's Swin camera stream against the benchmark's plain reference
(`port_bench/reference/swint_lss.py`), on seeded weights in f32 on the CPU:
a Swin stage with padding and a shifted block, patch merging, the LSS-FPN
neck, the lift with its downsample on a two-grid case, the whole detector at
a small size, and the frustum at stride 8. Leaving out the shift's mask or
the relative-position bias fails the limit. The configurations the
benchmark had before keep their forward bit for bit."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import DetectorSpec, SwinSpec
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import chunk_plans
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as fusion_mod
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.swin import SwinTransformer
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.bev_splat import precompute_frustum_cells
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import normalize_images
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference import model as ref  # noqa: E402
from reference import swint_lss  # noqa: E402

LIMIT = 1e-4  # largest |program - reference| over the reference's largest |value|: f32 summation order only


def _tiny_config():
    """`bevfusion_swint_lss` at 64x128 cameras, Swin widths 32-256 at two
    blocks a stage, a 24x24 camera grid of 8 channels onto 12x12, 8 depth
    bins, 64 LiDAR and 8 radar points on short chains."""
    cfg = yaml.safe_load((BENCH / "configs" / "bevfusion_swint_lss.yaml").read_text())
    m, d = cfg["model"], cfg["dataset"]
    d["cameras"]["image_size"] = m["camera_encoder"]["input_size"] = [64, 128]
    m["camera_encoder"]["swin"].update(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[2, 4, 4, 8])
    m["camera_encoder"]["output_channels"] = 32
    m["bev_fusion"].update(depth_bins=8, camera_bev_channels=8, bev_h=12, bev_w=12, bev_channels=16)
    d["bev_h"] = d["bev_w"] = 12
    m["centernet_head"].update(in_channels=16, head_conv=8)
    d["max_points"] = {"lidar": 64, "radar_per_sensor": 8}
    m["lidar_encoder"].update(max_points=64, mlp_layers=[16, 32], feature_dim=32)
    m["radar_encoder"].update(max_points_per_sensor=8, mlp_layers=[8, 16], feature_dim=16)
    return cfg


def _tree(variables):
    """Flat ``"<collection>/<path>"`` tensors -> the nested numpy tree."""
    tree = {}
    for name, t in variables.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().numpy()
    return tree


def _ring(spec):
    """Six cameras on a ring at the origin, BEVFusion's crop of the nuScenes
    intrinsics at this size (as the benchmark's driver)."""
    h, w = spec.image_hw
    r = 0.48 * w / 704
    top, left = int(900 * r) - h, int(max(0, int(1600 * r) - w) / 2)
    intr = np.array([[1200 * r, 0, 800 * r - left], [0, 1200 * r, 450 * r - top], [0, 0, 1.0]])
    base = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])
    out = []
    for k in range(spec.num_cameras):
        yaw = k * np.pi / 3
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        out.append((intr, rz @ base, np.zeros(3)))
    return out


def _err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(float(want.abs().max()), 1e-6)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = _tiny_config()
    spec = swint_lss.Spec(cfg)
    variables = swint_lss.make_variables(spec, torch.Generator().manual_seed(3), "cpu")
    return cfg, spec, variables


def _sub(variables, prefix):
    """The variables under `prefix`, re-rooted there."""
    out = {}
    for name, t in variables.items():
        coll, rest = name.split("/", 1)
        if rest.startswith(prefix + "/"):
            out[f"{coll}/{rest[len(prefix) + 1:]}"] = t
    return out


def _break(module, fault):
    if fault == "no_mask":
        for m in module.modules():
            if hasattr(m, "attention_mask"):
                m.attention_mask = lambda h, w, device: None
    elif fault == "no_bias":
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    p.zero_()


@pytest.mark.parametrize("fault", ["sound", "no_mask", "no_bias"])
def test_swin_stage_with_padding_and_shift(tiny, fault):
    """Stage 2 at 16x44 tokens (padded to 21x49): a plain and a shifted block."""
    cfg, spec, variables = tiny
    trunk = SwinTransformer(SwinSpec.from_config(cfg["model"]["camera_encoder"]["swin"]))
    load_jax_variables(trunk, _tree(_sub(variables, "camera_encoder/trunk")))
    _break(trunk, fault)
    x = torch.randn(2, 16, 44, 128)
    with torch.no_grad():
        got = trunk.stage2_block1(trunk.stage2_block0(x))
        f = swint_lss.Forward(spec, variables)
        want = f.block(f.block(x, "camera_encoder/trunk/stage2_block0", 4, 0),
                       "camera_encoder/trunk/stage2_block1", 4, 3)
    err = _err(got, want)
    assert (err < LIMIT) is (fault == "sound"), err


def test_patch_merging(tiny):
    cfg, spec, variables = tiny
    trunk = SwinTransformer(SwinSpec.from_config(cfg["model"]["camera_encoder"]["swin"]))
    load_jax_variables(trunk, _tree(_sub(variables, "camera_encoder/trunk")))
    x = torch.randn(2, 15, 22, 32)  # an odd side, padded
    with torch.no_grad():
        got = trunk.stage0_merge(x)
        want = swint_lss.Forward(spec, variables).merge(x, "camera_encoder/trunk/stage0_merge")
    assert got.shape == (2, 8, 11, 64) and _err(got, want) < LIMIT


def test_fpn(tiny):
    cfg, spec, variables = tiny
    model = MultiModal3DDetector(DetectorSpec.from_config(cfg))
    load_jax_variables(model, _tree(variables))
    feats = [torch.randn(3, 64, 8, 22), torch.randn(3, 128, 4, 11), torch.randn(3, 256, 2, 6)]
    with torch.no_grad():
        got = model.eval().camera_encoder.neck(feats)
        want = swint_lss.Forward(spec, variables).fpn(feats)
    assert got.shape == (3, 32, 8, 22) and _err(got, want) < LIMIT


def test_lift_and_downsample(tiny):
    """24x24 camera grid onto 12x12, through B2's plain version with the
    program's chunk plans, against the reference's `index_add_` lift."""
    cfg, spec, variables = tiny
    pspec = DetectorSpec.from_config(cfg)
    model = MultiModal3DDetector(pspec)
    load_jax_variables(model, _tree(variables))
    cal = _ring(spec)
    cells = swint_lss.frustum_cells(spec, cal)
    plans = chunk_plans(cells.astype(np.int32), 24 * 24)
    feats = torch.randn(2, 6, 32, 8, 16)
    chunks = tuple(torch.from_numpy(plans[k])[None].expand(2, *plans[k].shape).contiguous()
                   for k in ("point_idx", "local_ids", "block_idx"))
    with torch.no_grad():
        got = model.eval().fusion.geometric_camera_bev(feats, camera_chunks=chunks)
        want = swint_lss.Forward(spec, variables).geometric(feats, torch.from_numpy(cells))
    assert got.shape == (2, 8, 12, 12) and _err(got, want) < LIMIT


def test_frustum_at_stride_8_drops_out_of_z(tiny):
    cfg, spec, _ = tiny
    pspec = DetectorSpec.from_config(cfg)
    b = pspec.bev
    depths = np.linspace(b.depth_min, b.depth_max, b.depth_bins)
    cal = _ring(spec)
    got = np.stack([precompute_frustum_cells(i, r, t, (8, 16), (64, 128), depths, b.camera_grid, b.pc_range,
                                             b.camera_zbound) for i, r, t in cal])
    want = swint_lss.frustum_cells(spec, cal)
    assert got.shape == (6, 8, 8, 16) and np.array_equal(got, want)
    kept = np.stack([precompute_frustum_cells(i, r, t, (8, 16), (64, 128), depths, b.camera_grid, b.pc_range)
                     for i, r, t in cal])
    assert (got >= 0).sum() < (kept >= 0).sum()  # the far rows under the cameras fall below -10 m


def test_whole_detector(tiny):
    cfg, spec, variables = tiny
    variables = {k: v.clone() for k, v in variables.items()}
    g = torch.Generator().manual_seed(5)
    imgs = torch.randint(0, 256, (2, 6, 64, 128, 3), generator=g, dtype=torch.uint8)
    lidar = torch.rand(2, 64, 4, generator=g) * 20 - 10
    radar = torch.randn(2, 5, 8, 7, generator=g)
    cells = swint_lss.frustum_cells(spec, _ring(spec))
    swint_lss.calibrate_statistics(spec, variables, ref.normalize_uint8(imgs), lidar, radar, torch.from_numpy(cells))
    model = MultiModal3DDetector(DetectorSpec.from_config(cfg))
    load_jax_variables(model, _tree(variables))
    plans = chunk_plans(cells.astype(np.int32), 24 * 24)
    chunks = tuple(torch.from_numpy(plans[k])[None].expand(2, *plans[k].shape).contiguous()
                   for k in ("point_idx", "local_ids", "block_idx"))
    with torch.no_grad():
        got = model.eval()(normalize_images(imgs, size=(64, 128)), lidar, radar, camera_chunks=chunks)
        want = swint_lss.Forward(spec, variables)(ref.normalize_uint8(imgs), lidar, radar, torch.from_numpy(cells))
    assert got["heatmap"].shape == (2, 12, 12, 10)
    for k in want:
        assert _err(got[k], want[k]) < LIMIT, k


def _parent_lift(self, camera_features, camera_cells=None, camera_chunks=None, camera_pairs=None):
    """`GeometricCameraBEV.forward` as it was before the camera grid, its
    width and the downsample: the fused grid, bev_channels, the refine."""
    s = self.spec
    b, n = camera_features.shape[:2]
    flat = camera_features.reshape((b * n,) + camera_features.shape[2:])
    depth_logits = self.depth_head(flat)
    feat = self.feat_proj(flat)
    num_cells = s.bev_h * s.bev_w
    cells = camera_cells.reshape(b * n, -1)
    bev = fusion_mod.lift_splat_matmul_rows(feat, depth_logits, cells, num_cells)
    bev = bev.reshape(b, n, s.bev_h, s.bev_w, s.bev_channels).sum(dim=1)
    bev = self.splat_refine_conv(bev.permute(0, 3, 1, 2))
    return F.relu(self.splat_refine_bn(bev))


@pytest.mark.parametrize("name", ["bevfusion_base", "bevfusion_geometric"])
def test_existing_configurations_keep_their_forward(name, monkeypatch):
    """The base and geometric models give the same bits as the code before
    the camera stream (the lift's forward as it was), with the spans
    recording under a profiler and without."""
    cfg = yaml.safe_load((BENCH / "configs" / f"{name}.yaml").read_text())
    cfg = copy.deepcopy(cfg)
    m, d = cfg["model"], cfg["dataset"]
    d["cameras"]["image_size"] = m["camera_encoder"]["input_size"] = [64, 128]
    d["max_points"] = {"lidar": 64, "radar_per_sensor": 8}
    m["bev_fusion"].update(depth_bins=8, splat_mode="matmul")
    pspec = DetectorSpec.from_config(cfg)
    assert not pspec.camera.is_swin and pspec.bev.camera_grid == (50, 50) and pspec.bev.camera_zbound is None
    model = MultiModal3DDetector(pspec).eval()
    g = torch.Generator().manual_seed(1)
    for p in model.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g) * 0.1)
    imgs = torch.randn(2, 6, 64, 128, 3, generator=g)
    lidar, radar = torch.randn(2, 64, 4, generator=g), torch.randn(2, 5, 8, 7, generator=g)
    kwargs = {}
    if pspec.bev.camera_to_bev == "geometric":
        spec = ref.Spec(cfg)
        intr = np.array([[120.0, 0, 64], [0, 120.0, 32], [0, 0, 1]])
        base = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])
        cells = np.stack([precompute_frustum_cells(intr, base, np.zeros(3), (4, 8), (64, 128),
                                                   np.linspace(1, 59.5, 8), (50, 50), spec.pc_range)] * 6)
        kwargs["camera_cells"] = torch.from_numpy(cells)[None].expand(2, -1, -1, -1, -1)
    with torch.no_grad():
        now = model(imgs, lidar, radar, **kwargs)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            traced = model(imgs, lidar, radar, **kwargs)
        monkeypatch.setattr(fusion_mod.GeometricCameraBEV, "forward", _parent_lift)
        before = model(imgs, lidar, radar, **kwargs)
    for k in now:
        assert torch.equal(now[k], before[k]) and torch.equal(now[k], traced[k]), k


def test_dataset_takes_the_encoders_stride_and_the_camera_grid(tmp_path):
    """The eval CLI's dataset makes the frustum at the Swin encoder's stride
    8 on the 24x24 camera grid, dropping points out of the z range."""
    import pickle

    from scipy.spatial.transform import Rotation

    from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import NuScenesDataset, frustum_cells

    base = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])
    cams = {name: {"calibrated_sensor": {
        "camera_intrinsic": [[1260.0, 0, 815.0], [0, 1260.0, 452.0], [0, 0, 1]],
        "rotation": Rotation.from_matrix(Rotation.from_euler("z", k * np.pi / 3).as_matrix() @ base)
        .as_quat(scalar_first=True).tolist(),
        "translation": [0.0, 0.0, 1.5]}} for k, name in enumerate(
            ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"))}
    info = {"lidar_calibrated_sensor": {"rotation": [1.0, 0, 0, 0], "translation": [0.9, 0.0, 1.8]}, "cams": cams}
    (tmp_path / "nuscenes_infos_val.pkl").write_bytes(pickle.dumps({"infos": [info]}))
    cfg = _tiny_config()
    cfg["dataset"]["data_root"] = str(tmp_path)
    ds = NuScenesDataset(split="val", config=cfg)
    assert (ds.feature_stride, ds.bev_h, ds.bev_w, ds.camera_zbound) == (8, 24, 24, (-10.0, 10.0))
    cells = ds._frustum_cells(info)
    kept = frustum_cells(info, (64, 128), (24, 24), 8, 1.0, 59.5, ds.pc_range, stride=8)
    assert cells.shape == (6, 8, 8, 16) and cells.max() < 24 * 24
    assert np.array_equal(cells[cells >= 0], kept[cells >= 0]) and (cells >= 0).sum() < (kept >= 0).sum()
