"""Multi-process data parallelism over ``torch.distributed``.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/parallel/distributed.py``.
One process drives one GPU, launched by torchrun
(``python -m torch.distributed.run``). A torchrun node plays the part of a
JAX process: the loader strides the epoch by node (`RankLayout.node`,
`RankLayout.num_nodes`), and a node's ranks split its batch into contiguous
equal row blocks (`parallel.mesh.DataGroup.local_rows`), as ``P('data')``
splits a JAX process's batch over its devices. Ranks are numbered node by
node, as torchrun numbers them, so rank r holds rows
``[r * m, (r + 1) * m)`` of the global batch (with a view axis, the ranks
of a view group hold the same rows: `parallel.mesh`).

- `maybe_initialize` joins the process group behind the config switch, from
  torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``) or the config's coordinator; NCCL on CUDA, gloo on the
  CPU unless `backend` says otherwise;
- `sum_flat`: the gradient sum over the group in one flat bucket;
- `barrier`, `is_multi_process` and `all_processes_mean` as in the JAX
  package.

Numerics contract (the JAX package's): N processes at per-process batch m
reproduce one process at global batch N * m. The BatchNorm statistics
(`models.batch_norm`, an autograd function whose backward sums over the
group too) and the loss normalizers (`ops.losses`) are summed over the
group, each rank's loss is its share of the global loss, and the gradients
are summed.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class RankLayout:
    """Where this process sits: its global rank of `world_size`, and its
    local rank of the `local_world_size` processes of its node."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1

    @property
    def node(self) -> int:
        """The node's index: the JAX package's ``process_index``."""
        return self.rank // self.local_world_size

    @property
    def num_nodes(self) -> int:
        """The number of nodes: the JAX package's ``process_count``."""
        return self.world_size // self.local_world_size


def rank_layout() -> RankLayout:
    """This process's layout: rank and world size from the initialized
    process group (else torchrun's ``RANK`` / ``WORLD_SIZE``, else one
    process), the node's size from ``LOCAL_WORLD_SIZE`` (1 without it:
    a process per node). Raises where the ranks are not numbered node by
    node with equal nodes, as torchrun numbers them."""
    env = os.environ
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    layout = RankLayout(rank, world, local_rank, local_world)
    node = env.get("GROUP_RANK")
    if (world % local_world or local_rank != rank % local_world
            or (node is not None and int(node) != layout.node)):
        raise ValueError(
            f"rank {rank} of {world} is local rank {local_rank} of {local_world} on node {node}: the ranks must be "
            "numbered node by node, with the same number of processes on every node (torchrun "
            "--nproc_per_node N on every node)"
        )
    return layout


def maybe_initialize(
    enable: bool,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """``init_process_group`` behind the config switch; True when the
    process group is up. Safe to call twice.

    The rendezvous is ``coordinator_address`` (``host:port``) where given,
    else torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``; rank and world size
    come from ``RANK`` / ``WORLD_SIZE``, or without torchrun from
    `process_id` / `num_processes` (one process per node). With torchrun
    the config's `num_processes` / `process_id`, the JAX package's process
    count and index, must be its node count and node index. `backend`
    defaults to NCCL for a CUDA `device` and gloo for the CPU; under NCCL the
    process's CUDA device becomes `device` (``cuda:LOCAL_RANK`` unless
    named)."""
    if not enable:
        return False
    if dist.is_initialized():
        return True
    env = os.environ
    torchrun = "WORLD_SIZE" in env
    if torchrun:
        layout = rank_layout()
        for name, value, want in (("num_processes", num_processes, layout.num_nodes),
                                  ("process_id", process_id, layout.node)):
            if value is not None and int(value) != want:
                raise ValueError(f"parallel.multi_host.{name} is {value}, but torchrun gives {want}")
        rank, world = layout.rank, layout.world_size
    else:
        rank, world = int(process_id or 0), int(num_processes or 1)
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    else:
        raise ValueError(
            "no coordinator: launch with torchrun (python -m torch.distributed.run), which sets MASTER_ADDR "
            "and MASTER_PORT, or set parallel.multi_host.coordinator_address"
        )
    backend = backend or ("nccl" if resolve_device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(resolve_device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def barrier(group=None) -> None:
    """Wait for every process of `group`; nothing without a process group."""
    if not dist.is_initialized():
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def is_multi_process(group=None) -> bool:
    return dist.is_initialized() and dist.get_world_size(group) > 1


def all_processes_mean(values: Dict[str, float]) -> Dict[str, float]:
    """The mean over nodes of scalar metrics that each node's ranks hold
    alike (e.g. each node's validation metrics); identity with one node.
    As the JAX package takes it: each value rounded to float32, one row a
    node gathered, and ``np.mean`` of the float32 rows."""
    if not dist.is_initialized() or rank_layout().num_nodes == 1:
        return dict(values)
    layout = rank_layout()
    keys = sorted(values)
    # NCCL takes the tensors on this process's CUDA device
    device = torch.cuda.current_device() if dist.get_backend() == "nccl" else "cpu"
    local = torch.from_numpy(np.asarray([float(values[k]) for k in keys], np.float32)).to(device)
    rows = local.new_empty(layout.world_size * len(keys))
    dist.all_gather_into_tensor(rows, local)
    # each node's row once: its first rank's
    stacked = rows.view(layout.world_size, len(keys))[::layout.local_world_size].cpu().numpy()
    mean = np.mean(stacked, axis=0)
    return {k: float(mean[i]) for i, k in enumerate(keys)}


def sum_flat(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each of `tensors` summed over `group`: one all-reduce per dtype, of
    one flat bucket (not one call a tensor). Returns views of the buckets."""
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out
