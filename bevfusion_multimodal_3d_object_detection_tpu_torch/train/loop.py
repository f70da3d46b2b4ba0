"""The train step, the eval step and the Trainer.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/train/loop.py``
``:46-615``:

- `make_optimizer` (``:46-88``): optax's global-norm clip, then AdamW with a
  learning rate per update (constant under Q6, else cosine with an optional
  linear warmup), wrapped in ``MultiSteps`` when gradients accumulate;
- `make_train_step` (``:131-239``): with ``compat.skip_augmentation`` off
  (Q14) the batch's augmentation (`ops.augment`), then forward in train mode
  (BatchNorm batch statistics, dropout; the camera BNs on their running
  statistics under ``camera_encoder.freeze_bn``), targets on the device
  (CenterNet, or the MLP head's first valid object), loss, backward and one
  optimizer update, with bf16 autocast under ``train.mixed_precision``;
- `make_eval_step` (``:242-291``): forward + decode (the MLP head's raw
  ``cls``/``box``);
- `Trainer` (``:294-615``): epochs with a per-step JSONL log, validation
  with mAP/NDS, and checkpoints in the JAX package's layout.

The batch is the JAX package's dict of numpy arrays
(`data.dataset.collate_fn`, plus ``gt_boxes`` and ``gt_labels`` to train).
Of it the model reads what `MultiModal3DDetector.reads` names in its mode:
the inputs of its modalities and, on the geometric path, the plans its lift
reads of the ``camera_cells``, chunk plans (``camera_point_idx``,
``camera_local_ids``, ``camera_block_idx``) and culled pair plans
(``camera_seg_idx``, ``camera_seg_id``, ``camera_pair_cell``,
``camera_pair_pix``), as in the JAX package: in training the pallas
splat's branch ignores the chunk plans and takes the matmul splat, while the
culled splat trains on its pair plans. The train step launches no
hand-written kernel: the point encoders run their plain chain, as in the JAX
package, whose Pallas kernels have no backward.

Each step first moves those arrays to the device (`_on_device`; the eval
step moves a plan its rows share read-only once, `DevicePlans`), then
computes on `MultiModal3DDetector.forward_inputs` (uint8 cameras normalized
on the device);
the spans of `utils.profiling.span` (recorded only while a profiler runs)
mark the layers: ``eval.inputs`` (the copies, with ``h2d_bytes``, the host
bytes copied, and ``plan_hits``, the share of the plans read that were
already on the device) and ``eval.forward`` (model and decode);
``train.inputs`` (with ``h2d_bytes``, the host arrays' bytes), then
``train.forward`` (augmentation, model, targets, loss), ``train.backward``
and ``train.optimizer``, each of these three with its CUDA stream time;
``train.next_batch``, the Trainer's wait on its loader.

Data parallelism (``train/loop.py:139-152, 303-356, 430-470, 555-615`` of
the JAX package, whose jit gives each step the global batch's semantics):
given a `parallel.DataGroup`, a step takes its node's batch, keeps this
rank's rows (`DataGroup.local_rows`), draws the augmentation for the global
batch and takes its rows, normalizes with the global batch's BatchNorm
statistics (`models.batch_norm.global_statistics`), takes its share of the
global loss (`ops.losses`, normalizers summed over the group), sums the
gradients over the group in one flat bucket and logs the global losses; the
clip and ``grad_norm`` see the summed gradient. With ``shard_optimizer``
and more than one rank the AdamW moments are sharded (`parallel.zero`).
Validation decodes each rank's rows and gathers them to the node's first
rank, which computes the metrics of the node's share of the split.

With a view axis (``parallel.view_parallel`` > 1, `parallel.view`) the
ranks of a view group hold the same rows: the camera trunk runs on each
rank's block of cameras and, under ``bev_spatial``, the head on its block of
BEV rows. Each gradient is counted once: those of the camera trunk and the
row-block head, computed from the rank's own part, are summed over the
world, and every other gradient, the data row's whole on each rank of the
view group, over the data axis alone; so are the loss normalizers and the
logged losses. The trunk's BatchNorm statistics are the world's, the
others' the data axis's. ZeRO-1 shards the moments over the data axis and
replicates them over the view axis, as JAX shards them over ``'data'``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import math
import weakref
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AugmentSpec, CompatFlags, DetectorSpec, PostProcessSpec, TrainSpec
from ..data.dataset import ALL_PLAN_KEYS
from ..models.batch_norm import global_statistics
from ..models.detector import MultiModal3DDetector
from ..ops.augment import augment_modalities, draw_augmentation, step_generator
from ..ops.decode import centernet_decoder
from ..ops.losses import centernet_loss, detection_loss, prepare_mlp_targets
from ..ops.targets import prepare_centernet_targets
from ..parallel.distributed import barrier, sum_flat
from ..parallel.view import partial_modules
from ..utils.device import resolve_device
from ..utils.profiling import span

if TYPE_CHECKING:
    from ..parallel.mesh import DataGroup


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class DevicePlans:
    """Device copies of immutable host plans, each copied once.

    A batch's plan qualifies when it is a view with stride 0 on the batch
    axis (`data.dataset.collate_fn` of samples sharing one calibration's
    plans) over the array that owns its memory, and that owner is read-only
    and exactly each row: the same first byte, shape, strides and dtype.
    The owner is then looked up by identity, through a weak reference, so an
    entry goes when its owner is freed and a freed array's id never finds
    a live entry; the `capacity` most recently used owners are kept. Any
    other array is copied as it is, every time. Nothing compares contents:
    a read-only owner cannot change under its entry."""

    def __init__(self, device: torch.device, capacity: int = 8):
        self.device, self.capacity = device, capacity
        self._entries: "collections.OrderedDict[int, Tuple[weakref.ref, torch.Tensor]]" = collections.OrderedDict()
        self.hits = self.misses = 0

    @property
    def entries(self) -> int:
        return len(self._entries)

    @staticmethod
    def owner(a) -> Optional[np.ndarray]:
        """The read-only array that every row of `a` is, else None."""
        if not isinstance(a, np.ndarray) or a.ndim == 0 or a.shape[0] == 0 or a.strides[0] != 0:
            return None
        owner = a
        while isinstance(owner.base, np.ndarray):
            owner = owner.base
        if (owner.flags.owndata and not owner.flags.writeable and owner.shape == a.shape[1:]
                and owner.strides == a.strides[1:] and owner.dtype == a.dtype
                and owner.ctypes.data == a.ctypes.data):
            return owner
        return None

    def _evict(self, key: int, ref: weakref.ref) -> None:
        entry = self._entries.get(key)
        if entry is not None and entry[0] is ref:
            del self._entries[key]

    def tensor(self, a) -> Tuple[torch.Tensor, int, bool]:
        """`a` on the device, the host bytes copied for it, and whether its
        owner's copy was already there."""
        owner = self.owner(a)
        if owner is None:
            return _tensor(a, self.device), a.nbytes if isinstance(a, np.ndarray) else 0, False
        key = id(owner)
        entry = self._entries.get(key)
        hit = entry is not None and entry[0]() is owner
        if hit:
            self._entries.move_to_end(key)
            self.hits += 1
        else:
            entry = (weakref.ref(owner, functools.partial(self._evict, key)),
                     torch.tensor(owner, device=self.device))
            self._entries[key] = entry
            if len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            self.misses += 1
        return entry[1].expand(a.shape), 0 if hit else owner.nbytes, hit


def _on_device(model: MultiModal3DDetector, batch: Dict, device: torch.device, plans: Optional[DevicePlans] = None,
               targets: bool = False) -> Tuple[Dict, int, Optional[float]]:
    """The batch with the arrays that the model reads in its current mode
    (`MultiModal3DDetector.reads`), and with `targets` the ground truth, on
    `device`, unchanged in dtype; the plans it does not read are left out.
    With `plans` (the eval step's) each plan goes through it. Returns the
    batch, the host bytes copied and the share of the plans read that were
    already on the device (None without `plans` or when it reads none)."""
    keys = model.reads(batch) + (("gt_boxes", "gt_labels") if targets else ())
    out = {k: v for k, v in batch.items() if k not in ALL_PLAN_KEYS}
    nbytes = hits = n_plans = 0
    for k in keys:
        if plans is not None and k in ALL_PLAN_KEYS:
            out[k], copied, hit = plans.tensor(batch[k])
            hits += hit
            n_plans += 1
        else:
            out[k] = _tensor(batch[k], device)
            copied = batch[k].nbytes if isinstance(batch[k], np.ndarray) else 0
        nbytes += copied
    return out, nbytes, hits / n_plans if n_plans else None


def with_data_widths(spec: DetectorSpec, batch: Dict) -> DetectorSpec:
    """`spec` with the LiDAR encoder's input width taken from the batch's
    points, as the JAX package's init traces it from a sample batch: with
    ``num_sweeps`` > 1 the points carry a fifth (time-lag) channel whatever
    ``lidar_encoder.input_channels`` says."""
    if not spec.use_lidar or "lidar_points" not in batch:
        return spec
    width = int(np.shape(batch["lidar_points"])[-1])
    return dataclasses.replace(spec, lidar=dataclasses.replace(spec.lidar, input_channels=width))


def make_eval_step(
    model: MultiModal3DDetector,
    compat: CompatFlags,
    max_detections: int = 100,
    eval_path_decode: bool = False,
    device=None,
) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns eval_step(batch) -> decoded {'boxes' (B, K, 7), 'scores',
    'labels', 'velocities'} on the device (the MLP head: its raw {'cls',
    'box'}, as the JAX package returns them). The model moves to `device` (the
    GPU unless the caller names one) and into eval mode; it computes in the
    dtype of its parameters, and decode runs in f32.

    The decode is `ops.decode.centernet_decoder`'s: with
    `eval_path_decode=True` at voxel 0.512 when
    `compat.eval_decode_voxel_0512` (quirk Q3, the standalone eval and
    inference path); otherwise at the grid's own voxel, per axis.

    Of the geometric path's plans the step moves only those the lift reads
    (`MultiModal3DDetector.reads`: B2's chunk plans without the frustum
    cells, say), and a plan shared by the batch's rows, read-only, through
    its own `DevicePlans` (``eval_step.plans``, with its ``hits``,
    ``misses`` and ``entries``): once for as long as the host array lives."""
    device = resolve_device(device)
    decode = centernet_decoder(model.spec, compat, eval_path_decode, max_detections)
    model.to(device).eval()
    plans = DevicePlans(device)

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()  # a train step on the same model may have run since
        with span("eval.inputs") as inputs:
            batch, nbytes, hits = _on_device(model, batch, device, plans)
            inputs.set(h2d_bytes=nbytes)
            if hits is not None:
                inputs.set(plan_hits=hits)
        with span("eval.forward"):
            preds = model(**model.forward_inputs(batch))
            return decode(preds) if model.spec.head_is_centernet else preds

    eval_step.plans = plans
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
        self.spec = (train_spec, compat, steps_per_epoch)
        self.lr_at = lr_schedule(train_spec, compat, steps_per_epoch)
        # optax keeps a schedule's own count beside AdamW's (utils.convert)
        self.scheduled = not (compat.constant_lr or train_spec.lr_schedule == "constant")
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
        self._step(grads)
        self.updates += 1
        return True

    def _step(self, grads: List[torch.Tensor]) -> None:
        """One AdamW step of every parameter at this update's rate."""
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_at(self.updates)
        self.adamw.step()
        for p in self.params:
            p.grad = None


def make_optimizer(train_spec: TrainSpec, compat: CompatFlags, steps_per_epoch: int = 1) -> Optimizer:
    """The optimizer of ``train/loop.py:46-88``; `make_train_step` binds it
    to the model's parameters."""
    return Optimizer(train_spec, compat, steps_per_epoch)


class TrainStep:
    """`train_step(batch) -> losses` (see `make_train_step`); `step` counts
    the calls, as the JAX package's ``TrainState.step``. A call runs
    `augmented`, `forward`, `loss`, `gradients` and `update` in turn, on
    this rank's rows of the batch under a `data` group, once the arrays it
    reads are on the device."""

    def __init__(self, model: MultiModal3DDetector, optimizer: Optimizer, train_spec: TrainSpec,
                 compat: CompatFlags, check_gradients: bool, device: torch.device,
                 augment: Optional[AugmentSpec] = None, data: Optional["DataGroup"] = None):
        self.model, self.optimizer, self.device = model, optimizer, device
        self.data = data
        # the data axis: the loss normalizers and the replicated gradients
        self.group = None if data is None else data.data_axis
        self.world = None if data is None else data.group
        if data is not None:
            model.shard_views(data.view_shard())
        global_statistics(model, self.group)
        # the modules whose gradients are this rank's part (`view_parts`)
        self.partial: List[torch.nn.Module] = []
        self.train_spec, self.compat = train_spec, compat
        self.check_gradients = check_gradients
        self.augment = None if compat.skip_augmentation else (augment or AugmentSpec())  # Q14
        spec = model.spec
        # the geometric branch's frustum plans are host-side calibration
        # constants: a flip or scale of the scene cannot move with them
        self.geometry_frozen = spec.use_camera and spec.bev.camera_to_bev == "geometric"
        self.params = [p for p in model.parameters() if p.requires_grad]
        optimizer.init(self.params)
        self.step = 0

    def augmented(self, batch: Dict) -> Dict:
        """The batch (its arrays on the device, as `__call__` moves them)
        with its cameras (normalized, in the working dtype), points and GT
        boxes augmented on the device from the draws of
        `ops.augment.step_generator(train_spec.seed, step)`; the batch as
        it is when augmentation is off."""
        if self.augment is None:
            return batch
        inputs = self.model.forward_inputs(batch)
        cams, lidar, radar = (inputs.get(k) for k in ("camera_imgs", "lidar_points", "radar_points"))
        boxes = batch["gt_boxes"]
        rows = boxes.shape[0]
        # the draws of the global batch (every rank's rows), this rank's taken
        total = rows if self.data is None else rows * self.data.n_data
        draws = draw_augmentation(step_generator(self.train_spec.seed, self.step), self.augment, total,
                                  None if radar is None else (total,) + tuple(radar.shape[1:]))
        if self.data is not None:
            draws = draws.rows(self.data.global_rows(rows))
        cams, lidar, radar, boxes = augment_modalities(draws, cams, lidar, radar, boxes, self.augment,
                                                       geometry_frozen=self.geometry_frozen)
        out = dict(batch, gt_boxes=boxes)
        for key, value in (("camera_imgs", cams), ("lidar_points", lidar), ("radar_points", radar)):
            if value is not None:
                out[key] = value
        return out

    def view_parts(self, batch: Dict) -> None:
        """Under a view axis: which modules this rank computes a part of
        (`parallel.view.partial_modules`) for the batch's cameras, and the
        BatchNorm groups that follow (the trunk's over the world when it
        runs on a block of cameras)."""
        if self.data is None or self.data.n_view == 1:
            return
        cams = batch.get("camera_imgs")
        self.partial = partial_modules(self.model, 0 if cams is None else int(np.shape(cams)[1]))
        trunk = getattr(self.model, "camera_encoder", None)
        in_part = any(m is trunk for m in self.partial)
        global_statistics(self.model, self.group, camera_group=self.world if in_part else None)

    def forward(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The model's predictions in train mode (bf16 autocast under
        ``mixed_precision``) on the batch as `__call__` moves it."""
        self.model.train()
        self.view_parts(batch)
        autocast = (torch.autocast(self.device.type, dtype=torch.bfloat16)
                    if self.train_spec.mixed_precision else contextlib.nullcontext())
        with autocast:
            return self.model(**self.model.forward_inputs(batch))

    def loss(self, preds: Dict[str, torch.Tensor], batch: Dict) -> Dict[str, torch.Tensor]:
        """The loss dict, with targets built on the device from the batch's
        ground truth (on the device, as `__call__` moves it): the CenterNet
        loss, or for the MLP head `detection_loss` on the first valid object."""
        spec = self.model.spec
        if not spec.head_is_centernet:
            targets = prepare_mlp_targets(batch["gt_boxes"], batch["gt_labels"], num_classes=spec.num_classes)
            return detection_loss(preds, targets, group=self.group)
        targets = prepare_centernet_targets(
            batch["gt_boxes"],
            batch["gt_labels"],
            pc_range=spec.bev.pc_range,
            bev_size=(spec.bev.bev_h, spec.bev.bev_w),
            num_classes=spec.num_classes,
            corrected_gaussian_radius=self.compat.corrected_gaussian_radius,
        )
        return centernet_loss(preds, targets, weights=self.train_spec.loss_weights,
                              double_sigmoid=self.compat.double_sigmoid_focal, group=self.group)

    def gradients(self, total_loss: torch.Tensor) -> List[torch.Tensor]:
        """The gradient of each trained parameter; one the loss does not
        reach is zero, as in JAX. Under a data group, summed over it: over
        the world for the modules of `partial`, over the data axis for the
        others."""
        grads = torch.autograd.grad(total_loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        if self.group is None:
            return grads
        part = {id(p) for m in self.partial for p in m.parameters()}
        out = list(grads)
        for group, idx in ((self.world, [i for i, p in enumerate(self.params) if id(p) in part]),
                           (self.group, [i for i, p in enumerate(self.params) if id(p) not in part])):
            if idx:
                for i, g in zip(idx, sum_flat([grads[i] for i in idx], group)):
                    out[i] = g
        return out

    def update(self, losses: Dict[str, torch.Tensor], grads: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer update; returns the detached loss dict (with
        ``grad_norm`` and ``grads_finite`` under `check_gradients`); under a
        data group the losses are the global batch's, the sums of the
        ranks' shares."""
        losses = {k: v.detach() for k, v in losses.items()}
        if self.group is not None:
            (total,) = sum_flat([torch.stack(list(losses.values()))], self.group)
            losses = dict(zip(losses, total.unbind()))
        if self.check_gradients:
            norm = global_norm(grads)
            losses["grad_norm"] = norm
            losses["grads_finite"] = torch.isfinite(norm).float()
        self.optimizer.update(grads)
        self.step += 1
        return losses

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        if self.data is not None:
            batch = self.data.local_rows(batch)
        self.model.train()  # the plans it reads in training
        with span("train.inputs") as inputs:
            batch, nbytes, _ = _on_device(self.model, batch, self.device, targets=True)
            inputs.set(h2d_bytes=nbytes)
        timed = self.device.type == "cuda"
        with span("train.forward", device=timed):
            batch = self.augmented(batch)
            losses = self.loss(self.forward(batch), batch)
        with span("train.backward", device=timed):
            grads = self.gradients(losses["total_loss"])
        with span("train.optimizer", device=timed):
            return self.update(losses, grads)


def make_train_step(
    model: MultiModal3DDetector,
    optimizer: Optimizer,
    train_spec: TrainSpec,
    compat: CompatFlags,
    augment=None,
    check_gradients: bool = False,
    device=None,
    process_group: Optional["DataGroup"] = None,
) -> TrainStep:
    """Returns train_step(batch) -> the loss dict (``total_loss`` and the
    five CenterNet terms, or the MLP head's ``cls_loss`` and ``box_loss``;
    0-d f32 tensors on the device), after one forward, backward
    and optimizer update. The model moves to `device` (the GPU unless the
    caller names one) and trains in the dtype of its parameters (f32 as
    built); under ``train_spec.mixed_precision`` the forward runs in bf16
    autocast over them, and the loss is f32 either way. The batch is `make_eval_step`'s plus ``gt_boxes`` (B, M, 7
    or 9) and ``gt_labels`` (B, M), -1 for padding rows.

    `check_gradients` adds ``grad_norm`` (the global norm before the clip)
    and ``grads_finite`` to the loss dict. With ``compat.skip_augmentation``
    off, each step first augments the batch by `augment` (an `AugmentSpec`,
    its defaults when None), the flip and scale frozen on the geometric
    camera-to-BEV. Under ``camera_encoder.freeze_bn`` the camera encoder's
    BatchNorms keep their running statistics (`ResNetCameraEncoder.train`).

    With a `process_group` (`parallel.make_data_group`) the step takes the
    node's batch and trains on this rank's rows with the global batch's
    semantics (see the module docstring); every rank calls it alike."""
    device = resolve_device(device)
    model.to(device).train()
    return TrainStep(model, optimizer, train_spec, compat, check_gradients, device, augment, process_group)


def mlp_detections(preds: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
    """One detection per sample from the MLP head's {'cls', 'box'}: the box,
    the softmax probability of the most probable class and its int64 label,
    with the JAX Trainer's numpy arithmetic (``train/loop.py:473-494``)."""
    cls = preds["cls"].float().cpu().numpy()
    box = preds["box"].float().cpu().numpy()
    probs = np.exp(cls - cls.max(axis=-1, keepdims=True))
    probs /= probs.sum(axis=-1, keepdims=True)
    dets = []
    for i in range(cls.shape[0]):
        label = int(np.argmax(probs[i]))
        dets.append({"boxes": box[i:i + 1], "scores": np.array([probs[i, label]]),
                     "labels": np.array([label], np.int64)})
    return dets


class HostBuffers:
    """Host copies of tensors in buffers allocated once (pinned for CUDA
    tensors) and reused while the shapes and dtypes stay."""

    def __init__(self):
        self._buffers: Dict[str, torch.Tensor] = {}

    def copy(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The buffers holding `tensors`' values, the copies complete."""
        out, devices = {}, set()
        for name, t in tensors.items():
            buf = self._buffers.get(name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._buffers[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            out[name] = buf
            if t.is_cuda:
                devices.add(t.device)
        for device in devices:
            torch.cuda.current_stream(device).synchronize()
        return out


class Trainer:
    """Epochs, validation with mAP/NDS, and checkpoints over `make_train_step`
    and `make_eval_step` (``train/loop.py:294-615`` of the JAX package,
    mirroring the reference ``main()``, ref: train_detect.py:590-813).

    `init_state` seeds the model from ``train_spec.seed`` and loads the
    camera trunk from a local torchvision file under
    ``camera_encoder.pretrained``. Checkpoints hold the JAX package's payload
    (``params``, ``batch_stats``, ``opt_state``, ``step``, ``epoch``,
    ``best_map``) in its layout, so each package restores the other's.

    `process_group` (a `parallel.DataGroup`) trains data-parallel (see the
    module docstring); `shard_optimizer` then shards the AdamW moments
    (ZeRO-1, `parallel.zero`) when the group has more than one rank. Under a
    group every rank must call `save_checkpoint` and `load_checkpoint`. A
    msgpack checkpoint is written by the global rank 0, its moments the
    gathered full ones (the JAX layout, restored by either package and
    sharded again on load). A directory checkpoint (``orbax``,
    ``orbax_async``; `train.checkpoint`) is written by every rank that holds
    a part: rank 0 the variables, the counts and, without ZeRO, the
    moments; under ZeRO each data index's first view rank its shard, which
    no rank gathers, and a restore reads this rank's slice for the current
    world. The state is first copied to host buffers, allocated once
    (pinned on CUDA) and reused; ``orbax_async`` returns once that copy is
    complete and writes on a background thread
    (`train.checkpoint.wait_for_checkpoints` is the fence)."""

    def __init__(
        self,
        model: MultiModal3DDetector,
        train_spec: TrainSpec,
        compat: CompatFlags = CompatFlags(),
        steps_per_epoch: int = 1,
        check_gradients: bool = False,
        device=None,
        augment: Optional[AugmentSpec] = None,
        process_group: Optional["DataGroup"] = None,
        shard_optimizer: bool = False,
    ):
        self.model = model
        self.spec = model.spec
        self.train_spec = train_spec
        self.compat = compat
        self.check_gradients = check_gradients
        self.augment = augment
        self.device = resolve_device(device)
        self.data = process_group
        self.shard_optimizer = bool(shard_optimizer and process_group is not None and process_group.n_data > 1)
        if self.shard_optimizer:
            from ..parallel.zero import ZeroOptimizer

            # sharded over the data axis, replicated over the view axis
            self.optimizer = ZeroOptimizer(train_spec, compat, steps_per_epoch, process_group.data_axis)
        else:
            self.optimizer = make_optimizer(train_spec, compat, steps_per_epoch)
        self.train_step: Optional[TrainStep] = None
        self.eval_step: Optional[Callable] = None
        self.best_map = -1.0
        self._host = HostBuffers()  # a directory checkpoint's snapshot

    # -- state ---------------------------------------------------------------
    def init_state(self, sample_batch: Optional[Dict] = None) -> "Trainer":
        """Seeded weights, the pretrained camera trunk where configured, and
        a fresh optimizer. The JAX package traces its init from a sample
        batch, so its LiDAR width follows the data; the port's model is
        built before, from a spec that `with_data_widths` fits to a batch.
        Given one, `sample_batch` is checked against the model: a width
        that differs raises."""
        from ..utils.torch_convert import maybe_load_pretrained_camera

        if sample_batch is not None and with_data_widths(self.spec, sample_batch) != self.spec:
            raise ValueError(
                f"the batch's LiDAR points have {np.shape(sample_batch['lidar_points'])[-1]} channels but the "
                f"model's LiDAR encoder takes {self.spec.lidar.input_channels}: build the model from "
                "train.loop.with_data_widths(spec, batch)"
            )
        self.model.init_weights(torch.Generator().manual_seed(self.train_spec.seed))
        maybe_load_pretrained_camera(self.model, self.spec)
        self.train_step = make_train_step(
            self.model, self.optimizer, self.train_spec, self.compat, augment=self.augment,
            check_gradients=self.check_gradients, device=self.device, process_group=self.data,
        )
        self.eval_step = make_eval_step(self.model, self.compat, device=self.device)
        return self

    @property
    def step(self) -> int:
        """Train-step calls so far, restored with a checkpoint."""
        return self.train_step.step

    # -- loops ---------------------------------------------------------------
    def train_one_epoch(self, loader, log_every: int = 10, log_file: Optional[str] = None) -> float:
        """One pass over `loader`; returns the mean total loss and appends one
        JSON line per step to `log_file` (``step``, ``step_seconds`` and the
        loss terms), closed even when a step fails."""
        if self.train_step is None:
            raise RuntimeError("call init_state first")
        log_fh = open(log_file, "a") if log_file else None
        try:
            return self._epoch_inner(loader, log_every, log_fh)
        finally:
            if log_fh:
                log_fh.close()

    def _epoch_inner(self, loader, log_every, log_fh) -> float:
        import json
        import time

        total, count = 0.0, 0
        batches = iter(loader)
        for i in itertools.count():
            with span("train.next_batch"):
                batch = next(batches, None)
            if batch is None:
                break
            t0 = time.perf_counter()
            losses = self.train_step(batch)
            loss = float(losses["total_loss"])
            step_s = time.perf_counter() - t0
            total += loss
            count += 1
            if log_every and (i % log_every == 0):
                print(f"  step {self.step}: loss={loss:.4f} "
                      f"hm={float(losses.get('heatmap_loss', 0.0)):.4f} ({step_s * 1000:.0f} ms)")
            if log_fh:
                log_fh.write(json.dumps({
                    "step": self.step,
                    "step_seconds": round(step_s, 4),
                    **{k: round(float(v), 6) for k, v in losses.items()},
                }) + "\n")
        return total / max(count, 1)

    def evaluate(self, loader, score_thresh: float = 0.0, post_process=None) -> Dict:
        """Validation pass: decode and metrics (the training-eval decode with
        score_thresh 0.0, ref: train_detect.py:500-536). `post_process`, a
        `PostProcessSpec` (`PostProcessSpec.resolve`'s), applies its score
        threshold and, where it has them, BEV NMS and cap instead. The MLP head
        gives one detection per sample: the softmax's most probable class,
        its probability and the predicted box (`post_process` unused, as in
        the JAX package)."""
        from ..ops.decode import decode_to_host
        from ..utils.metrics import compute_metrics

        if self.eval_step is None:
            raise RuntimeError("call init_state first")
        pp = post_process or PostProcessSpec(score_thresh, None, None)
        predictions, ground_truths = [], []
        data = self.data
        for batch in loader:
            n = len(batch["gt_boxes"])
            if data is None:
                decoded = self.eval_step(batch)
            else:
                # each data index decodes its rows of the batch (its view
                # group together), padded to split evenly by repeating the
                # last row (as the JAX Trainer pads for its mesh), and the
                # node's first rank gets them all
                pad = (-n) % data.node_blocks
                if pad:
                    batch = {k: np.concatenate([v] + [v[-1:]] * pad) if isinstance(v, np.ndarray) else v
                             for k, v in batch.items()}
                decoded = data.gather_node_rows(dict(self.eval_step(data.local_rows(batch))))
                if not data.is_node_leader:
                    continue
                decoded = {k: v[:n] for k, v in decoded.items()}
            if not self.spec.head_is_centernet:
                dets = mlp_detections(decoded)
            else:
                dets = decode_to_host(decoded, score_thresh=pp.score_threshold, nms_thresh=pp.nms_threshold,
                                      max_detections=pp.max_detections)
            predictions.extend(dets)
            for bi in range(n):
                ground_truths.append({"boxes": np.asarray(batch["gt_boxes"][bi]),
                                      "labels": np.asarray(batch["gt_labels"][bi])})
        metrics = None
        if data is None or data.is_node_leader:
            metrics = compute_metrics(
                predictions, ground_truths, num_classes=self.spec.num_classes,
                report_class_order="reference" if self.compat.metric_report_class_order else "dataset",
            )
        return metrics if data is None else data.node_broadcast(metrics)

    # -- checkpointing ---------------------------------------------------------
    def _full_optimizer(self, empty: bool = False) -> Optimizer:
        """The optimizer with every parameter's moments: under ZeRO a plain
        `Optimizer` holding the gathered moments (a collective: every rank
        calls it), or with `empty` none, a restore's template."""
        if not self.shard_optimizer:
            return self.optimizer
        if empty:
            full = Optimizer(*self.optimizer.spec).init(self.optimizer.params)
            full.updates = self.optimizer.updates
            return full
        return self.optimizer.gathered()

    def _payload(self, epoch: int, best_map: float, empty: bool = False,
                 optimizer: Optional[Optimizer] = None, opt_state: bool = True) -> Dict:
        from ..utils.convert import export_jax_variables, opt_state_to_jax

        variables = export_jax_variables(self.model, empty=empty)
        payload = {
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "step": np.asarray(self.step, np.int32),
            "epoch": np.asarray(epoch, np.int32),
            "best_map": np.asarray(best_map, np.float32),
        }
        if opt_state:
            optimizer = optimizer or self._full_optimizer(empty)
            payload["opt_state"] = opt_state_to_jax(optimizer, self.model, empty=empty)
        return payload

    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints: the global rank 0."""
        return self.data is None or self.data.rank == 0

    def save_checkpoint(self, path: str, epoch: int, backend: str = "msgpack") -> None:
        """Write the payload in the JAX package's msgpack layout (global
        rank 0 only, the others waiting until it is written), or under
        ``orbax`` / ``orbax_async`` a directory checkpoint (see the class
        docstring)."""
        from .checkpoint import DIRECTORY_BACKENDS, save_checkpoint

        if backend in DIRECTORY_BACKENDS:
            self._save_directory(path, epoch, backend)
            return
        optimizer = self._full_optimizer()
        if self.writes:
            save_checkpoint(path, self._payload(epoch, self.best_map, optimizer=optimizer))
        if self.data is not None:
            barrier(self.data.group)

    def _save_directory(self, path: str, epoch: int, backend: str) -> None:
        from .checkpoint import process_group_peers, wait_for_checkpoints, write_checkpoint

        # one write in flight: the host buffers are the last one's until it is done
        wait_for_checkpoints()
        snap = self._snapshot()
        files = functools.partial(self._directory_files, snap, epoch, self.best_map, backend)
        peers = process_group_peers() if self.data is not None else None
        write_checkpoint(path, files, snap["step"], background=backend == "orbax_async", peers=peers)

    def _writes_shard(self) -> bool:
        """Whether this rank writes a ZeRO-1 shard: each data index's first
        view rank (the moments are replicated over the view axis)."""
        return self.shard_optimizer and self.data.view_index == 0

    def _snapshot(self) -> Dict:
        """What this rank writes of a directory checkpoint, copied to the
        host buffers; the copies are complete when it returns, so the next
        step may change the state in place."""
        opt = self.optimizer
        tensors: Dict[str, torch.Tensor] = {}
        if self.writes:
            tensors.update({f"state/{k}": v for k, v in self.model.state_dict().items()
                            if not k.endswith("num_batches_tracked")})
            for i, a in enumerate(opt._acc or ()):
                tensors[f"acc/{i}"] = a
            if not self.shard_optimizer:
                for i, p in enumerate(opt.params):
                    state = opt.adamw.state.get(p)
                    if state:
                        tensors[f"exp_avg/{i}"], tensors[f"exp_avg_sq/{i}"] = state["exp_avg"], state["exp_avg_sq"]
        if self._writes_shard():
            tensors["shard/exp_avg"], tensors["shard/exp_avg_sq"] = opt.shard_moments()
        return {"tensors": self._host.copy(tensors), "step": self.step, "updates": opt.updates,
                "mini_step": opt.mini_step, "acc": opt._acc is not None}

    def _directory_files(self, snap: Dict, epoch: int, best_map: float, backend: str) -> Dict:
        """This rank's files of a directory checkpoint, from its snapshot
        (built on the writer's thread: the live state is not read)."""
        from types import SimpleNamespace

        from ..utils.convert import export_jax_variables, flat_layout, opt_state_to_jax
        from .checkpoint import opt_state_file, payload_files, shard_file

        opt, t = self.optimizer, snap["tensors"]
        files: Dict = {}
        if self.writes:
            step = torch.tensor(float(snap["updates"]))
            frozen = SimpleNamespace(
                params=opt.params, updates=snap["updates"], mini_step=snap["mini_step"],
                scheduled=opt.scheduled, max_norm=opt.max_norm, every_k=opt.every_k,
                _acc=[t[f"acc/{i}"] for i in range(len(opt.params))] if snap["acc"] else None,
                adamw=SimpleNamespace(state={
                    p: {"step": step, "exp_avg": t[f"exp_avg/{i}"], "exp_avg_sq": t[f"exp_avg_sq/{i}"]}
                    for i, p in enumerate(opt.params) if f"exp_avg/{i}" in t}),
            )
            variables = export_jax_variables(
                self.model, state={k[len("state/"):]: v for k, v in t.items() if k.startswith("state/")})
            payload = {**variables, "step": np.asarray(snap["step"], np.int32),
                       "epoch": np.asarray(epoch, np.int32), "best_map": np.asarray(best_map, np.float32)}
            if self.shard_optimizer:
                payload["opt_state"] = opt_state_to_jax(frozen, self.model, moments=("exp_avg", "exp_avg_sq"))
                moments = dict(flat_layout(opt, self.model), numel=sum(p.numel() for p in opt.params),
                               shard_numel=opt.shard_numel, dtype=str(opt.shard.dtype).removeprefix("torch."))
                files.update(payload_files(payload, backend, moments, self.data.n_data))
            else:
                payload["opt_state"] = opt_state_to_jax(frozen, self.model)
                files.update(payload_files(payload, backend))
        if self._writes_shard():
            files[opt_state_file(self.data.data_index, self.data.n_data)] = shard_file(
                opt.lo, opt.hi, t["shard/exp_avg"].cpu().numpy(), t["shard/exp_avg_sq"].cpu().numpy())
        return files

    def load_checkpoint(self, path: str, restore_optimizer: bool = True,
                        keep_on_shape_mismatch: bool = False, backend: str = "msgpack") -> int:
        """Restore parameters, BatchNorm statistics, the step count, the best
        mAP and (with `restore_optimizer`) the optimizer state from `path`,
        with the JAX package's strict=False merge (a directory: strict, see
        `train.checkpoint`); returns the saved epoch. The path decides the
        format; `backend` is taken for the JAX signature. Under ZeRO-1 a
        directory's sharded moments are read for this rank's slice alone."""
        from ..utils.convert import flat_layout, load_jax_variables, opt_state_from_jax
        from .checkpoint import (check_moment_layout, fill_kept, load_checkpoint, read_meta, read_moments,
                                 wait_for_checkpoints)

        if self.train_step is None:
            raise RuntimeError("init_state before restoring")
        wait_for_checkpoints()
        if self.data is not None:
            barrier(self.data.group)  # a checkpoint being written is read by no rank
        meta = read_meta(path) if Path(path).is_dir() else None
        sharded = restore_optimizer and self.shard_optimizer and meta is not None and "moments" in meta
        # the template gives keys, shapes and dtypes without exporting the
        # state; only a leaf the file lacks reads the current value
        template = self._payload(0, 0.0, empty=True, opt_state=not sharded)
        restored = load_checkpoint(path, template, keep_on_shape_mismatch=keep_on_shape_mismatch)
        restored = fill_kept(restored, template, lambda: self._payload(0, 0.0, opt_state=not sharded))
        load_jax_variables(self.model, {"params": restored["params"],
                                        "batch_stats": restored["batch_stats"]})
        if sharded:
            check_moment_layout(meta, flat_layout(self.optimizer, self.model), path)
            counts = self._full_optimizer(empty=True)
            opt_state_from_jax(counts, self.model, meta["opt_state"], moments=False)
            self.optimizer.load_shard(counts, *read_moments(path, meta, self.optimizer.lo, self.optimizer.hi))
        elif restore_optimizer:
            full = self._full_optimizer(empty=True)
            opt_state_from_jax(full, self.model, restored["opt_state"])
            if self.shard_optimizer:
                self.optimizer.load_gathered(full)  # each rank keeps its shard
        self.train_step.step = int(restored["step"])
        self.best_map = float(restored["best_map"])
        return int(restored["epoch"])
