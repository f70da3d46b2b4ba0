"""The train step and the eval step of one collated batch.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/train/loop.py``
``:46-291``:

- `make_optimizer` (``:46-88``): optax's global-norm clip, then AdamW with a
  learning rate per update (constant under Q6, else cosine with an optional
  linear warmup), wrapped in ``MultiSteps`` when gradients accumulate;
- `make_train_step` (``:131-239``): forward in train mode (BatchNorm batch
  statistics), CenterNet targets on the device, loss, backward and one
  optimizer update, with bf16 autocast under ``train.mixed_precision``;
- `make_eval_step` (``:242-291``): forward + decode.

The batch is the JAX package's dict of numpy arrays
(`data.dataset.collate_fn`, plus ``gt_boxes`` and ``gt_labels`` to train):
uint8 cameras are normalized on the device, and the geometric path's
``camera_cells`` and chunk plans (``camera_point_idx``, ``camera_local_ids``,
``camera_block_idx``) go to the model as in the JAX package; in training the
geometric branch ignores the plans and takes the matmul splat. The train
step launches no hand-written kernel: the point encoders run their plain
chain, as in the JAX package, whose Pallas kernels have no backward.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CompatFlags, DetectorSpec, TrainSpec
from ..models.detector import MultiModal3DDetector
from ..ops.decode import decode_centernet_predictions
from ..ops.losses import centernet_loss
from ..ops.preprocess import normalize_images
from ..ops.targets import prepare_centernet_targets
from ..utils.device import resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _model_inputs(spec: DetectorSpec, batch: Dict, device: torch.device,
                  dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], ...]:
    cams = lidar = radar = None
    if spec.use_camera:
        cams = _tensor(batch["camera_imgs"], device)
        if cams.dtype == torch.uint8:  # the uint8 wire: normalize on the device
            cams = normalize_images(cams, size=spec.camera.image_size)
        cams = cams.to(dtype)
    if spec.use_lidar:
        lidar = _tensor(batch["lidar_points"], device).to(dtype)
    if spec.use_radar:
        radar = _tensor(batch["radar_points"], device).to(dtype)
    return cams, lidar, radar


def _model_kwargs(spec: DetectorSpec, batch: Dict, device: torch.device) -> Dict:
    kwargs = {}
    if spec.use_camera and "camera_cells" in batch:
        kwargs["camera_cells"] = _tensor(batch["camera_cells"], device)
    if spec.use_camera and "camera_point_idx" in batch:
        # chunk plans of the fused splat (splat_mode: pallas, inference only)
        kwargs["camera_chunks"] = tuple(
            _tensor(batch[k], device)
            for k in ("camera_point_idx", "camera_local_ids", "camera_block_idx")
        )
    return kwargs


def make_eval_step(
    model: MultiModal3DDetector,
    compat: CompatFlags,
    max_detections: int = 100,
    eval_path_decode: bool = False,
    device=None,
) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns eval_step(batch) -> decoded {'boxes' (B, K, 7), 'scores',
    'labels', 'velocities'} on the device. The model moves to `device` (the
    GPU unless the caller names one) and into eval mode; it computes in the
    dtype of its parameters, and decode runs in f32.

    `eval_path_decode=True` decodes at voxel 0.512 when
    `compat.eval_decode_voxel_0512` (quirk Q3, the standalone eval and
    inference path); otherwise the voxel is the grid's own, per axis."""
    device = resolve_device(device)
    spec = model.spec
    if eval_path_decode and compat.eval_decode_voxel_0512:
        voxel_size = 0.512
    else:
        x_min, y_min, _, x_max, y_max, _ = spec.bev.pc_range
        voxel_size = ((x_max - x_min) / spec.bev.bev_w, (y_max - y_min) / spec.bev.bev_h)
    model.to(device).eval()
    # the head's: the point MLPs keep f32 parameters under a cast model
    dtype = next(model.det_head.parameters()).dtype

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()  # a train step on the same model may have run since
        preds = model(*_model_inputs(spec, batch, device, dtype), **_model_kwargs(spec, batch, device))
        return decode_centernet_predictions(
            preds,
            max_detections=max_detections,
            voxel_size=voxel_size,
            pc_range=spec.bev.pc_range,
            class_always_zero=compat.decode_class_always_zero,
        )

    return eval_step


def lr_schedule(train_spec: TrainSpec, compat: CompatFlags,
                steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The learning rate of each optimizer update, by the number of updates
    done before it (optax evaluates its schedule on that count, so the first
    update takes the initial value): constant under Q6 or
    ``lr_schedule: constant``; else a cosine from the rate to ``eta_min`` over
    ``T_max`` epochs of updates, after a linear warmup from
    ``warmup_initial_lr`` when the warmup is on. In float64."""
    lr = train_spec.learning_rate
    if compat.constant_lr or train_spec.lr_schedule == "constant":
        return lambda count: lr
    decay_steps = max(1, train_spec.lr_t_max * steps_per_epoch)
    alpha = train_spec.lr_eta_min / lr

    def cosine(count: int) -> float:
        count = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)

    if train_spec.warmup_epochs <= 0:
        return cosine
    warmup_steps = max(1, train_spec.warmup_epochs * steps_per_epoch)
    start = train_spec.warmup_initial_lr

    def warmup_cosine(count: int) -> float:
        if count < warmup_steps:
            return (start - lr) * (1 - count / warmup_steps) + lr
        return cosine(count - warmup_steps)

    return warmup_cosine


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of all elements of `tensors`, as a 0-d tensor of their
    widest dtype (at least f32)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors), torch.float32)
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.to(dtype)) for t in tensors]))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: `grads` scaled by max_norm / norm when
    their global norm is at least max_norm, else as they are (no epsilon,
    unlike ``torch.nn.utils.clip_grad_norm_``). No host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule))``,
    in ``MultiSteps(k)`` when ``grad_accum_steps`` k > 1, over torch
    parameters. `update(grads)` takes one micro-batch's gradients:

    - with k > 1 it keeps their running mean, and only every k-th call clips
      and steps AdamW; the other calls leave the parameters as they are;
    - `clip_by_global_norm` (optax's, not ``clip_grad_norm_``);
    - AdamW (``torch.optim.AdamW``, decoupled weight decay on every
      parameter as ``optax.adamw`` with no mask) takes ``lr_at(updates)``.
    """

    def __init__(self, train_spec: TrainSpec, compat: CompatFlags, steps_per_epoch: int = 1):
        self.lr_at = lr_schedule(train_spec, compat, steps_per_epoch)
        self.max_norm = train_spec.grad_clip_norm if train_spec.grad_clip_enable else None
        self.every_k = train_spec.grad_accum_steps
        self._adamw_args = dict(betas=tuple(train_spec.betas), eps=train_spec.eps,
                                weight_decay=train_spec.weight_decay)
        self.updates = 0  # optimizer updates done: the schedule's count
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None
        self.params: List[torch.Tensor] = []
        self.adamw: Optional[torch.optim.AdamW] = None

    def init(self, params) -> "Optimizer":
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=self.lr_at(0), **self._adamw_args)
        return self

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Apply one micro-batch's gradients (in the order of the parameters
        given to `init`); True when the parameters moved."""
        grads = list(grads)
        if self.every_k > 1:
            n = self.mini_step
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # optax's running mean: acc + (g - acc) / (n + 1)
            self._acc = [a + (g - a) / (n + 1) for g, a in zip(grads, self._acc)]
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            grads, self._acc = self._acc, None
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_at(self.updates)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        return True


def make_optimizer(train_spec: TrainSpec, compat: CompatFlags, steps_per_epoch: int = 1) -> Optimizer:
    """The optimizer of ``train/loop.py:46-88``; `make_train_step` binds it
    to the model's parameters."""
    return Optimizer(train_spec, compat, steps_per_epoch)


class TrainStep:
    """`train_step(batch) -> losses` (see `make_train_step`); `step` counts
    the calls, as the JAX package's ``TrainState.step``. A call runs
    `forward`, `loss`, `gradients` and `update` in turn."""

    def __init__(self, model: MultiModal3DDetector, optimizer: Optimizer, train_spec: TrainSpec,
                 compat: CompatFlags, check_gradients: bool, device: torch.device):
        self.model, self.optimizer, self.device = model, optimizer, device
        self.train_spec, self.compat = train_spec, compat
        self.check_gradients = check_gradients
        # the head's: the point MLPs keep f32 parameters under a cast model
        self.dtype = next(model.det_head.parameters()).dtype
        self.params = [p for p in model.parameters() if p.requires_grad]
        optimizer.init(self.params)
        self.step = 0

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The model's predictions in train mode (bf16 autocast under
        ``mixed_precision``)."""
        spec, device = self.model.spec, self.device
        self.model.train()
        autocast = (torch.autocast(device.type, dtype=torch.bfloat16)
                    if self.train_spec.mixed_precision else contextlib.nullcontext())
        with autocast:
            return self.model(*_model_inputs(spec, batch, device, self.dtype),
                              **_model_kwargs(spec, batch, device))

    def loss(self, preds: Dict[str, torch.Tensor], batch: Dict) -> Dict[str, torch.Tensor]:
        """The CenterNet loss dict, with targets built on the device."""
        spec = self.model.spec
        targets = prepare_centernet_targets(
            _tensor(batch["gt_boxes"], self.device),
            _tensor(batch["gt_labels"], self.device),
            pc_range=spec.bev.pc_range,
            bev_size=(spec.bev.bev_h, spec.bev.bev_w),
            num_classes=spec.num_classes,
            corrected_gaussian_radius=self.compat.corrected_gaussian_radius,
        )
        return centernet_loss(preds, targets, weights=self.train_spec.loss_weights,
                              double_sigmoid=self.compat.double_sigmoid_focal)

    def gradients(self, total_loss: torch.Tensor) -> List[torch.Tensor]:
        """The gradient of each trained parameter; one the loss does not
        reach is zero, as in JAX."""
        grads = torch.autograd.grad(total_loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]

    def update(self, losses: Dict[str, torch.Tensor], grads: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer update; returns the detached loss dict (with
        ``grad_norm`` and ``grads_finite`` under `check_gradients`)."""
        losses = {k: v.detach() for k, v in losses.items()}
        if self.check_gradients:
            norm = global_norm(grads)
            losses["grad_norm"] = norm
            losses["grads_finite"] = torch.isfinite(norm).float()
        self.optimizer.update(grads)
        self.step += 1
        return losses

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        losses = self.loss(self.forward(batch), batch)
        return self.update(losses, self.gradients(losses["total_loss"]))


def make_train_step(
    model: MultiModal3DDetector,
    optimizer: Optimizer,
    train_spec: TrainSpec,
    compat: CompatFlags,
    augment=None,
    check_gradients: bool = False,
    device=None,
) -> TrainStep:
    """Returns train_step(batch) -> the loss dict (``total_loss`` and the
    five terms, 0-d f32 tensors on the device), after one forward, backward
    and optimizer update. The model moves to `device` (the GPU unless the
    caller names one) and trains in the dtype of its parameters (f32 as
    built); under ``train_spec.mixed_precision`` the forward runs in bf16
    autocast over them, and the loss is f32 either way. The batch is `make_eval_step`'s plus ``gt_boxes`` (B, M, 7
    or 9) and ``gt_labels`` (B, M), -1 for padding rows.

    `check_gradients` adds ``grad_norm`` (the global norm before the clip)
    and ``grads_finite`` to the loss dict. `augment` is read only with
    augmentation on (``compat.skip_augmentation: false``), which is not
    ported yet."""
    del augment
    if not compat.skip_augmentation:
        raise NotImplementedError(
            "training augmentation (compat.skip_augmentation: false) is not ported yet (ROADMAP A8)"
        )
    spec = model.spec
    if spec.use_camera and spec.camera.freeze_bn:
        raise NotImplementedError("camera_encoder.freeze_bn is not ported yet (ROADMAP queue A)")
    device = resolve_device(device)
    model.to(device).train()
    return TrainStep(model, optimizer, train_spec, compat, check_gradients, device)
