"""Config system: YAML loading + typed, hashable model specs.

The port's own copy of the JAX package's config parsing
(``bevfusion_multimodal_3d_object_detection_tpu/config.py:74-510`` and
``:582-698``): the same YAML schema, the same ``compat:`` defaults and the same
frozen dataclasses, so one ``configs/*.yaml`` drives both packages. The model
specs, `TrainSpec` and `DataSpec` are kept; `AugmentSpec` and `ParallelSpec`
come with the slices that read them (augmentation, parallelism).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import yaml

# The 10 nuScenes classes in dataset/label-encoding order
# (ref: configs/base.yaml:33-43, train_detect.py:191-195).
DEFAULT_CLASSES: Tuple[str, ...] = (
    "car",
    "truck",
    "trailer",
    "bus",
    "construction_vehicle",
    "bicycle",
    "motorcycle",
    "pedestrian",
    "traffic_cone",
    "barrier",
)

# The (different) order utils_v2.py reports per-class AP in
# (ref: utils_v2.py:98-101) — quirk Q9.
METRIC_REPORT_CLASSES: Tuple[str, ...] = (
    "car",
    "truck",
    "bus",
    "trailer",
    "construction_vehicle",
    "pedestrian",
    "motorcycle",
    "bicycle",
    "traffic_cone",
    "barrier",
)

DEFAULT_PC_RANGE: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)

# nuScenes camera order of every (N_cam, ...) stack
CAMERA_ORDER: Tuple[str, ...] = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)

RADAR_ORDER: Tuple[str, ...] = (
    "RADAR_FRONT",
    "RADAR_FRONT_LEFT",
    "RADAR_FRONT_RIGHT",
    "RADAR_BACK_LEFT",
    "RADAR_BACK_RIGHT",
)


def load_config(config_path: str) -> Dict[str, Any]:
    """Load a YAML config file into a raw dict (same contract as the reference
    ``load_config``, ref: fusion.py:22-39 / encoders.py:16-33)."""
    with open(config_path, "r") as f:
        return yaml.safe_load(f)


def _get(cfg: Optional[Dict], *path, default=None):
    cur: Any = cfg or {}
    for key in path:
        if not isinstance(cur, dict):
            return default
        cur = cur.get(key, None)
        if cur is None:
            return default
    return cur


# ---------------------------------------------------------------------------
# Compat flags (quirk ledger)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompatFlags:
    """Explicit switches for every reference quirk; defaults = reference behavior.

    See SURVEY.md appendix (quirk ledger Q1-Q20) for file:line citations.
    """

    # Q1: decode labels everything class 0 ("car"):
    # topk class index computed after the modulo (centernet_target.py:434).
    decode_class_always_zero: bool = True
    # Q2: focal loss re-applies sigmoid to the already-sigmoided heatmap
    # (fusion.py:871 + centernet_target.py:563).
    double_sigmoid_focal: bool = True
    # Q3: standalone eval/inference decode uses voxel_size=0.512 on a 50x50
    # grid (fusion_detection.py:757) while training-eval uses 2.048
    # (centernet_target.py:389).
    eval_decode_voxel_0512: bool = True
    # Q4: radar loader returns np.random.randn dummy points
    # (train_detect.py:173-177).
    random_radar_points: bool = True
    # Q5: LiDAR .bin parsed as 4 floats/point; nuScenes is 5
    # (train_detect.py:151).
    lidar_four_float_parse: bool = True
    # Q6: LR scheduler constructed but never stepped (train_detect.py:796-809).
    constant_lr: bool = True
    # Q9: per-class metric report rows use a different class order than label
    # encoding (utils_v2.py:98-101 vs configs/base.yaml:33-43).
    metric_report_class_order: bool = True
    # Q13: PointNet max-pool does not mask zero-padded points
    # (encoders.py:298 with train_detect.py:187-189).
    unmasked_point_padding: bool = True
    # Q7: the reference never reads train.loss_weights (train_detect.py:739);
    # True keeps the CenterNetLoss constructor defaults (1,1,1,1,0.1);
    # False honors the YAML values.
    ignore_config_loss_weights: bool = True
    # Q7-family: train.mixed_precision.enable is declared (and true!) in the
    # reference config but never read (no autocast exists). True = ignore it
    # like the reference (f32 training); False = honor it (bf16 compute).
    ignore_mixed_precision: bool = True
    # Q14: the reference declares dataset.augmentation but never applies it
    # (configs/base.yaml:86-114 vs train_detect.py:123-145). True = no
    # augmentation (reference behavior); False = apply the declared
    # augmentations on device (ops/augment.py).
    skip_augmentation: bool = True
    # Q19: the reference's gaussian_radius divides every quadratic root by 2
    # (the upstream CornerNet bug; centernet_target.py:131-149). False =
    # reference behavior; True = proper (b+sqrt(b^2-4ac))/(2a) roots. Differs
    # only for large boxes on fine grids.
    corrected_gaussian_radius: bool = False
    # Q20: the converter maps nuScenes categories to classes by SUBSTRING
    # (data_converter.py:265-269), which can never match 'traffic_cone'
    # (category 'movable_object.trafficcone') or 'construction_vehicle'
    # (category 'vehicle.construction') — those GT boxes are silently
    # dropped from every converted pickle. True = reference behavior;
    # False adds the corrected alias mapping (data/converter.py).
    substring_class_matching: bool = True
    # Q16-family: the reference declares post_processing blocks under
    # val/test/inference
    # (score_threshold, nms_threshold, max_detections; configs/base.yaml:
    # 393-396, 416-419) but never reads it — eval hardcodes thresh 0.0
    # (eval.py:60) and inference 0.3 (inference.py:80). True = reference
    # behavior (keys ignored); False = honor the YAML block: score
    # threshold, host-side greedy BEV NMS (ops/decode.py:nms_bev), and the
    # max_detections cap on the eval/inference paths.
    ignore_post_processing_config: bool = True

    @staticmethod
    def from_config(cfg: Optional[Dict]) -> "CompatFlags":
        c = _get(cfg, "compat", default={}) or {}
        fields = {f.name for f in dataclasses.fields(CompatFlags)}
        unknown = sorted(set(c) - fields)
        if unknown:
            # the whole quirk-ledger contract rests on these switches: a
            # typo'd flag silently keeping reference behavior would be a
            # silent wrong experiment
            raise ValueError(
                f"unknown compat flag(s) {unknown}; known flags: "
                f"{sorted(fields)}"
            )
        return CompatFlags(**{k: v for k, v in c.items() if k in fields})


@dataclass(frozen=True)
class PostProcessSpec:
    """post_processing blocks (val/test/inference) — declared-but-dead in
    the reference
    (configs/base.yaml:393-396, 416-419); honored here when
    compat.ignore_post_processing_config is False. Defaults mirror the
    reference YAML values."""

    score_threshold: float = 0.3
    nms_threshold: float = 0.5
    max_detections: int = 100

    @staticmethod
    def from_config(
        cfg: Optional[Dict], section="val"
    ) -> "PostProcessSpec":
        """`section` may be one name or a preference-ordered tuple — the
        first section with a post_processing block wins (the engine/serving
        use ("inference", "test") since the reference declares both)."""
        sections = (section,) if isinstance(section, str) else tuple(section)
        p = {}
        for s in sections:
            p = _get(cfg, s, "post_processing", default={}) or {}
            if p:
                break
        return PostProcessSpec(
            score_threshold=float(p.get("score_threshold", 0.3)),
            nms_threshold=float(p.get("nms_threshold", 0.5)),
            max_detections=int(p.get("max_detections", 100)),
        )


# ---------------------------------------------------------------------------
# Model specs
# ---------------------------------------------------------------------------


def parse_modalities(modality_config: Optional[str]) -> Tuple[bool, bool, bool]:
    """Parse 'camera+lidar+radar' / 'all' style strings by substring match,
    matching the reference factory semantics (ref: fusion.py:1197-1202)."""
    if modality_config is None:
        return True, True, True
    m = modality_config.lower().replace(" ", "")
    use_camera = "camera" in m or m == "all"
    use_lidar = "lidar" in m or m == "all"
    use_radar = "radar" in m or m == "all"
    return use_camera, use_lidar, use_radar


@dataclass(frozen=True)
class CameraEncoderSpec:
    backbone: str = "resnet18"
    pretrained: bool = True
    # Local torchvision-format resnet18 state_dict (.pth). With
    # `pretrained: true` and this file present, model init loads the trunk
    # from it (ref: encoders.py:98 models.resnet18(pretrained=True)); with
    # the file absent a loud warning is printed (no network egress here).
    pretrained_path: Optional[str] = None
    freeze_bn: bool = False
    out_channels: int = 512
    total_stride: int = 16
    image_size: Tuple[int, int] = (448, 800)
    # jax.checkpoint each residual block (HBM <-> FLOPs trade for training)
    remat: bool = False


@dataclass(frozen=True)
class LidarEncoderSpec:
    encoder_type: str = "PointNet"  # 'PointNet' or 'VoxelNet'
    input_channels: int = 4
    feat_dim: int = 1024
    max_points: int = 35000
    mlp_layers: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    use_batch_norm: bool = True
    # VoxelNet alternative (ref: encoders.py:308-455, config stub
    # configs/base.yaml:188-192)
    voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.2)


@dataclass(frozen=True)
class RadarEncoderSpec:
    input_channels: int = 7
    feat_dim: int = 256
    num_radars: int = 5
    max_points_per_sensor: int = 125
    mlp_layers: Tuple[int, ...] = (32, 64, 128, 256)
    fusion_method: str = "concat"  # 'concat' | 'max' | 'mean'
    use_batch_norm: bool = True


@dataclass(frozen=True)
class BEVFusionSpec:
    bev_h: int = 50
    bev_w: int = 50
    bev_channels: int = 256
    pc_range: Tuple[float, ...] = DEFAULT_PC_RANGE
    lidar_hidden_dim: int = 128
    lidar_start_size: int = 25
    # camera-to-BEV mode: 'pseudo' = reference parity (mean over cameras +
    # bilinear resize, fusion.py:233-247); 'geometric' = lift-splat over
    # depth bins with a BEVPool-style scatter-add (upgrade path).
    camera_to_bev: str = "pseudo"
    depth_bins: int = 40
    depth_min: float = 1.0
    depth_max: float = 60.0
    # geometric-splat formulation: 'matmul' scatters scalar depth probs and
    # contracts features on the MXU (1.55x end-to-end measured,
    # ops/bev_splat.py:lift_splat_matmul); 'scatter' is the naive
    # lifted-tensor scatter-add (same math, different float summation order);
    # 'pallas' fuses the whole lift-splat into one weighted Pallas pool pass
    # on INFERENCE paths when the batch carries chunk plans (dataset
    # return_camera_chunks), falling back to 'matmul' otherwise/in training;
    # 'culled' uses the calibration-time culled + (cell, pixel)-deduped plan
    # (ops/bev_splat.precompute_culled_pairs) when the batch carries pair
    # plans (dataset return_camera_pairs) — identical math on a compacted
    # point stream, differentiable (works in training), falling back to
    # 'matmul' when plans are absent.
    splat_mode: str = "matmul"
    # static capacities of the culled pair plans (points surviving the range
    # cull / unique (cell, pixel) pairs). 0 = size automatically from the
    # first sample's calibration (+headroom); set explicitly when sample
    # calibrations vary enough to overflow the auto capacity.
    splat_cull_points: int = 0
    splat_cull_pairs: int = 0


@dataclass(frozen=True)
class AttentionFusionSpec:
    hidden_dim: int = 512
    num_heads: int = 8
    num_layers: int = 2
    dropout: float = 0.1
    ffn_expansion: int = 4


@dataclass(frozen=True)
class LateFusionSpec:
    output_dim: int = 512
    hidden_dim: int = 1024
    dropout: float = 0.3


@dataclass(frozen=True)
class CenterNetHeadSpec:
    in_channels: int = 256
    head_conv: int = 64
    num_classes: int = 10
    heatmap_threshold: float = 0.1
    max_detections: int = 100


@dataclass(frozen=True)
class MLPHeadSpec:
    in_channels: int = 512
    hidden_dim: int = 256
    num_classes: int = 10
    dropout: float = 0.1


@dataclass(frozen=True)
class DetectorSpec:
    """Full, hashable model hyperparameter bundle."""

    use_camera: bool = True
    use_lidar: bool = True
    use_radar: bool = True
    fusion_type: str = "bev"  # 'bev' | 'attention' | 'late'
    detection_head: str = "centernet"  # 'centernet' | 'mlp'
    num_classes: int = 10
    camera: CameraEncoderSpec = field(default_factory=CameraEncoderSpec)
    lidar: LidarEncoderSpec = field(default_factory=LidarEncoderSpec)
    radar: RadarEncoderSpec = field(default_factory=RadarEncoderSpec)
    bev: BEVFusionSpec = field(default_factory=BEVFusionSpec)
    attention: AttentionFusionSpec = field(default_factory=AttentionFusionSpec)
    late: LateFusionSpec = field(default_factory=LateFusionSpec)
    centernet: CenterNetHeadSpec = field(default_factory=CenterNetHeadSpec)
    mlp: MLPHeadSpec = field(default_factory=MLPHeadSpec)

    @property
    def num_modalities(self) -> int:
        return int(self.use_camera) + int(self.use_lidar) + int(self.use_radar)

    @property
    def is_spatial(self) -> bool:
        return self.fusion_type == "bev"

    @property
    def head_is_centernet(self) -> bool:
        # MLP head is forced for non-spatial fusions (ref: fusion.py:1074-1088)
        return self.is_spatial and self.detection_head == "centernet"

    def modality_string(self) -> str:
        mods = []
        if self.use_camera:
            mods.append("camera")
        if self.use_lidar:
            mods.append("lidar")
        if self.use_radar:
            mods.append("radar")
        return "+".join(mods)

    @staticmethod
    def from_config(
        cfg: Optional[Dict] = None,
        modality_config: Optional[str] = None,
        fusion_type: Optional[str] = None,
        detection_head: Optional[str] = None,
        num_classes: Optional[int] = None,
    ) -> "DetectorSpec":
        model = _get(cfg, "model", default={}) or {}
        dataset = _get(cfg, "dataset", default={}) or {}

        if modality_config is None:
            modality_config = model.get("modality_config")
        if modality_config is not None:
            use_camera, use_lidar, use_radar = parse_modalities(modality_config)
        else:
            use_camera = model.get("use_camera", True)
            use_lidar = model.get("use_lidar", True)
            use_radar = model.get("use_radar", True)

        cam_cfg = model.get("camera_encoder", {}) or {}
        lid_cfg = model.get("lidar_encoder", {}) or {}
        rad_cfg = model.get("radar_encoder", {}) or {}
        bev_cfg = model.get("bev_fusion", {}) or {}
        attn_cfg = model.get("attention_fusion", {}) or {}
        late_cfg = model.get("late_fusion", {}) or {}
        cn_cfg = model.get("centernet_head", {}) or {}
        mlp_cfg = model.get("mlp_head", {}) or {}

        n_classes = (
            num_classes
            if num_classes is not None
            else dataset.get("num_classes", 10)
        )

        image_size = tuple(cam_cfg.get("input_size", (448, 800)))
        max_points_cfg = dataset.get("max_points") or {}  # null-safe like DataSpec
        max_lidar = max_points_cfg.get(
            "lidar", lid_cfg.get("max_points", 35000)
        )
        max_radar = max_points_cfg.get(
            "radar_per_sensor", rad_cfg.get("max_points_per_sensor", 125)
        )

        return DetectorSpec(
            use_camera=use_camera,
            use_lidar=use_lidar,
            use_radar=use_radar,
            fusion_type=(
                fusion_type
                if fusion_type is not None
                else model.get("fusion_type", "bev")
            ),
            detection_head=(
                detection_head
                if detection_head is not None
                else model.get("detection_head", "centernet")
            ),
            num_classes=n_classes,
            camera=CameraEncoderSpec(
                backbone=cam_cfg.get("backbone", "resnet18"),
                pretrained=cam_cfg.get("pretrained", True),
                pretrained_path=cam_cfg.get("pretrained_path", None),
                freeze_bn=cam_cfg.get("freeze_bn", False),
                out_channels=cam_cfg.get("output_channels", 512),
                total_stride=cam_cfg.get("total_stride", 16),
                image_size=image_size,
                remat=cam_cfg.get("remat", False),
            ),
            lidar=LidarEncoderSpec(
                encoder_type=lid_cfg.get("type", "PointNet"),
                input_channels=lid_cfg.get("input_channels", 4),
                feat_dim=lid_cfg.get("feature_dim", 1024),
                max_points=max_lidar,
                mlp_layers=tuple(
                    lid_cfg.get("mlp_layers", (64, 128, 256, 512, 1024))
                ),
                use_batch_norm=lid_cfg.get("use_batch_norm", True),
            ),
            radar=RadarEncoderSpec(
                input_channels=rad_cfg.get("input_channels", 7),
                feat_dim=rad_cfg.get("feature_dim", 256),
                num_radars=rad_cfg.get("num_radars", 5),
                max_points_per_sensor=max_radar,
                mlp_layers=tuple(rad_cfg.get("mlp_layers", (32, 64, 128, 256))),
                fusion_method=rad_cfg.get("fusion_method", "concat"),
                use_batch_norm=rad_cfg.get("use_batch_norm", True),
            ),
            bev=BEVFusionSpec(
                bev_h=bev_cfg.get("bev_h", dataset.get("bev_h", 50)),
                bev_w=bev_cfg.get("bev_w", dataset.get("bev_w", 50)),
                bev_channels=bev_cfg.get("bev_channels", 256),
                pc_range=tuple(
                    dataset.get("point_cloud_range", DEFAULT_PC_RANGE)
                ),
                camera_to_bev=bev_cfg.get("camera_to_bev", "pseudo"),
                splat_mode=bev_cfg.get("splat_mode", "matmul"),
                splat_cull_points=bev_cfg.get("splat_cull_points", 0),
                splat_cull_pairs=bev_cfg.get("splat_cull_pairs", 0),
                depth_bins=bev_cfg.get("depth_bins", 40),
                depth_min=bev_cfg.get("depth_min", 1.0),
                depth_max=bev_cfg.get("depth_max", 60.0),
            ),
            attention=AttentionFusionSpec(
                hidden_dim=attn_cfg.get("hidden_dim", 512),
                num_heads=attn_cfg.get("num_heads", 8),
                num_layers=attn_cfg.get("num_layers", 2),
                dropout=attn_cfg.get("dropout", 0.1),
                ffn_expansion=attn_cfg.get("ffn_expansion", 4),
            ),
            late=LateFusionSpec(
                output_dim=late_cfg.get("output_dim", 512),
                hidden_dim=(late_cfg.get("hidden_dims") or [1024])[0],
                dropout=late_cfg.get("dropout", 0.3),
            ),
            centernet=CenterNetHeadSpec(
                in_channels=cn_cfg.get(
                    "in_channels", bev_cfg.get("bev_channels", 256)
                ),
                head_conv=cn_cfg.get("head_conv", 64),
                num_classes=n_classes,
                heatmap_threshold=cn_cfg.get("heatmap_threshold", 0.1),
                max_detections=cn_cfg.get("max_detections", 100),
            ),
            mlp=MLPHeadSpec(
                in_channels=mlp_cfg.get("in_channels", 512),
                hidden_dim=(mlp_cfg.get("hidden_dims") or [256])[0],
                num_classes=n_classes,
                dropout=mlp_cfg.get("dropout", 0.1),
            ),
        )


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataSpec:
    data_root: str = "data/nuscenes"
    version: str = "v1.0-mini"
    classes: Tuple[str, ...] = DEFAULT_CLASSES
    pc_range: Tuple[float, ...] = DEFAULT_PC_RANGE
    bev_h: int = 50
    bev_w: int = 50
    max_lidar_points: int = 35000
    max_radar_points: int = 125
    image_size: Tuple[int, int] = (448, 800)
    num_cameras: int = 6
    num_radars: int = 5
    split_ratios: Tuple[float, float, float] = (0.7, 0.2, 0.1)
    num_sweeps: int = 1
    # radar sweep aggregation (the reference never reads radar files, Q4)
    radar_num_sweeps: int = 1
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # opt-in: JPEG decode at a reduced DCT scale (PIL draft mode), then the
    # bilinear resize; pixels differ slightly from the reference's full
    # decode (ref: train_detect.py:129-137)
    jpeg_draft_decode: bool = False

    @staticmethod
    def from_config(cfg: Optional[Dict]) -> "DataSpec":
        d = _get(cfg, "dataset", default={}) or {}
        ratios = d.get("split_ratios", {}) or {}
        aug_norm = _get(d, "augmentation", "camera", "normalize", default={}) or {}
        return DataSpec(
            data_root=d.get("data_root", "data/nuscenes"),
            version=d.get("version", "v1.0-mini"),
            classes=tuple(d.get("classes", DEFAULT_CLASSES)),
            pc_range=tuple(d.get("point_cloud_range", DEFAULT_PC_RANGE)),
            bev_h=d.get("bev_h", 50),
            bev_w=d.get("bev_w", 50),
            max_lidar_points=_get(d, "max_points", "lidar", default=35000),
            max_radar_points=_get(d, "max_points", "radar_per_sensor", default=125),
            image_size=tuple(_get(d, "cameras", "image_size", default=(448, 800))),
            num_cameras=_get(d, "cameras", "num_cameras", default=6),
            num_radars=_get(d, "radars", "num_radars", default=5),
            split_ratios=(ratios.get("train", 0.7), ratios.get("val", 0.2), ratios.get("test", 0.1)),
            num_sweeps=d.get("num_sweeps", 1),
            radar_num_sweeps=d.get("radar_num_sweeps", 1),
            image_mean=tuple(aug_norm.get("mean", (0.485, 0.456, 0.406))),
            image_std=tuple(aug_norm.get("std", (0.229, 0.224, 0.225))),
            jpeg_draft_decode=bool(d.get("jpeg_draft_decode", False)),
        )


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainSpec:
    num_epochs: int = 2
    batch_size: int = 4
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip_norm: float = 10.0
    grad_clip_enable: bool = True
    # (heatmap, offset, size, rot, vel). Q7: the reference declares
    # train.loss_weights but never reads it (train_detect.py:739), so these
    # CenterNetLoss constructor defaults hold unless
    # compat.ignore_config_loss_weights is off.
    loss_weights: Tuple[float, float, float, float, float] = (1.0, 1.0, 1.0, 1.0, 0.1)
    # LR schedule, applied only when compat.constant_lr is off (Q6)
    lr_schedule: str = "cosine"
    lr_t_max: int = 50
    lr_eta_min: float = 1e-6
    warmup_epochs: int = 0
    warmup_initial_lr: float = 1e-5
    save_dir: str = "./checkpoints"
    save_interval: int = 5
    save_best: bool = True
    seed: int = 42
    # train.mixed_precision.enable, declared but never read by the reference:
    # bf16 compute over f32 parameters and optimizer state when honored
    mixed_precision: bool = False
    # train.gradient_accumulation (also dead in the reference): the mean of
    # this many micro-batch gradients per optimizer update
    grad_accum_steps: int = 1
    max_objects: int = 500
    resume_enable: bool = False
    resume_path: Optional[str] = None
    ckpt_backend: str = "msgpack"
    resume_auto: bool = True

    @staticmethod
    def from_config(cfg: Optional[Dict]) -> "TrainSpec":
        t = _get(cfg, "train", default={}) or {}
        compat = CompatFlags.from_config(cfg)
        if compat.ignore_config_loss_weights:
            loss_weights = (1.0, 1.0, 1.0, 1.0, 0.1)  # Q7: ctor defaults
        else:
            lw = t.get("loss_weights", {}) or {}
            loss_weights = (
                lw.get("heatmap", 1.0),
                lw.get("offset", 1.0),
                lw.get("size", 1.0),
                lw.get("rotation", 1.0),
                lw.get("velocity", 0.1),
            )
        opt = t.get("optimizer", {}) or {}
        sched = t.get("lr_scheduler", {}) or {}
        warm = t.get("warmup", {}) or {}
        clip = t.get("grad_clip", {}) or {}
        ckpt = t.get("checkpoint", {}) or {}
        resume = t.get("resume", {}) or {}
        return TrainSpec(
            num_epochs=t.get("num_epochs", 2),
            batch_size=t.get("batch_size", 4),
            loss_weights=loss_weights,
            learning_rate=opt.get("lr", t.get("learning_rate", 1e-4)),
            weight_decay=opt.get("weight_decay", t.get("weight_decay", 0.01)),
            betas=tuple(opt.get("betas", (0.9, 0.999))),
            eps=opt.get("eps", 1e-8),
            grad_clip_norm=clip.get("max_norm", 10.0),
            grad_clip_enable=clip.get("enable", True),
            lr_schedule=(
                "cosine"
                if sched.get("type", "CosineAnnealingLR") == "CosineAnnealingLR"
                else "constant"
            ),
            lr_t_max=sched.get("T_max", 50),
            lr_eta_min=sched.get("eta_min", 1e-6),
            warmup_epochs=warm.get("epochs", 5) if warm.get("enable", False) else 0,
            warmup_initial_lr=warm.get("initial_lr", 1e-5),
            save_dir=ckpt.get("save_dir", "./checkpoints"),
            save_interval=ckpt.get("save_interval", 5),
            save_best=ckpt.get("save_best", True),
            seed=_get(cfg, "seed", default=42),
            mixed_precision=(
                not compat.ignore_mixed_precision
                and _get(cfg, "train", "mixed_precision", "enable", default=False)
            ),
            grad_accum_steps=(
                _get(cfg, "train", "gradient_accumulation", "steps", default=1)
                if _get(cfg, "train", "gradient_accumulation", "enable", default=False)
                else 1
            ),
            resume_enable=resume.get("enable", False),
            resume_path=resume.get("checkpoint_path"),
            ckpt_backend=ckpt.get("backend", "msgpack"),
            resume_auto=resume.get("auto", True),
        )
