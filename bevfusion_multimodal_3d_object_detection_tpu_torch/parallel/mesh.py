"""The data-parallel group: the port's counterpart of the JAX package's
``('data', 'view')`` mesh with a view axis of 1
(``bevfusion_multimodal_3d_object_detection_tpu/parallel/mesh.py``).

`make_data_group` (``make_mesh``) takes every process of the initialized
process group onto the data axis; `DataGroup.local_rows` (``shard_batch``)
gives this rank its contiguous block of its node's batch. The camera-view
axis and the BEV-spatial partitioning are not ported (ROADMAP A13b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import RankLayout, rank_layout

A13B = (
    "parallel.view_parallel > 1 and parallel.bev_spatial (the camera-view axis and the BEV-spatial "
    "partitioning) are not ported yet (ROADMAP A13b)"
)


@dataclass(frozen=True)
class DataGroup:
    """Every process on the data axis (`group`, the world), and this
    process's node (`node_group`), with the rank layout."""

    group: dist.ProcessGroup
    node_group: dist.ProcessGroup
    layout: RankLayout

    @property
    def size(self) -> int:
        return self.layout.world_size

    @property
    def rank(self) -> int:
        return self.layout.rank

    @property
    def node_size(self) -> int:
        return self.layout.local_world_size

    @property
    def node_rank(self) -> int:
        return self.layout.local_rank

    @property
    def is_node_leader(self) -> bool:
        return self.layout.local_rank == 0

    def local_rows(self, batch: Dict) -> Dict:
        """This rank's contiguous block of its node's batch: every array
        (numpy or tensor) cut along axis 0; other values (``tokens``) pass
        through. A batch that does not split evenly over the node's ranks
        raises, as the JAX package's sharding does."""
        n = self.node_size
        rows = next(len(v) for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)))
        if rows % n:
            raise ValueError(
                f"a batch of {rows} rows does not split over the {n} processes of a node: "
                "train.batch_size must divide by the processes per node"
            )
        m = rows // n
        block = slice(self.node_rank * m, (self.node_rank + 1) * m)
        return {k: v[block] if isinstance(v, (np.ndarray, torch.Tensor)) else v for k, v in batch.items()}

    def gather_node_rows(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each tensor's blocks from the node's ranks, concatenated in rank
        order along axis 0 (every rank gets them; one all-gather a key)."""
        out = {}
        for k in sorted(tensors):
            t = tensors[k].contiguous()
            parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(self.node_size)]
            dist.all_gather(parts, t, group=self.node_group)
            out[k] = torch.cat(parts)
        return out

    def node_broadcast(self, obj):
        """The node leader's `obj` on every rank of the node."""
        box = [obj]
        leader = self.rank - self.node_rank
        dist.broadcast_object_list(box, src=leader, group=self.node_group)
        return box[0]


def make_data_group(n_data: Optional[int] = None, n_view: int = 1, multi_host: bool = False) -> DataGroup:
    """The data axis over every process of the initialized process group.
    Without `multi_host` the processes are one node's and their number must
    be `n_data` (``parallel.data_parallel``), whose global batch is one
    node's batch; with it they span the nodes, whose batches stack into the
    global batch. ``n_view`` > 1 raises (ROADMAP A13b)."""
    if n_view > 1:
        raise NotImplementedError(A13B)
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call parallel.maybe_initialize first")
    layout = rank_layout()
    if not multi_host:
        if layout.num_nodes != 1:
            raise ValueError(
                f"{layout.num_nodes} nodes without parallel.multi_host: data_parallel spans one node's processes"
            )
        if n_data is not None and n_data != layout.world_size:
            raise ValueError(
                f"parallel.data_parallel is {n_data} but {layout.world_size} processes run: launch "
                f"torchrun --nproc_per_node {n_data}"
            )
    world = dist.group.WORLD
    node_group = world
    if layout.num_nodes > 1:
        # every rank creates every node's group, in the same order
        node_group, _ = dist.new_subgroups(group_size=layout.local_world_size)
    return DataGroup(world, node_group, layout)
