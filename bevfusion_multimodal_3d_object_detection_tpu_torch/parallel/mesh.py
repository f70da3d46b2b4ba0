"""The ('data', 'view') rank layout: the port's counterpart of the JAX
package's ``('data', 'view')`` mesh
(``bevfusion_multimodal_3d_object_detection_tpu/parallel/mesh.py``).

`make_data_group` (``make_mesh``) lays every process of the initialized
process group out as JAX's ``devices.reshape(n_data, n_view)``: rank r is at
data index ``r // n_view`` and view index ``r % n_view``. The ranks of one
data index form a view group and hold the same rows of the batch; the ranks
of one view index form a data-axis group. `DataGroup.local_rows`
(``shard_batch``) gives a rank its data index's contiguous block of its
node's batch; `DataGroup.view_shard` its place on the view axis
(`parallel.view`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import RankLayout, rank_layout
from .view import ViewShard


@dataclass(frozen=True)
class DataGroup:
    """Every process (`group`, the world), this process's node
    (`node_group`), the rank layout, and the view axis: `n_view` ranks a
    view group (`view_group`, None when `n_view` is 1) and the ranks of this
    rank's view index over the data axis (`data_axis`, the world when
    `n_view` is 1)."""

    group: dist.ProcessGroup
    node_group: dist.ProcessGroup
    layout: RankLayout
    data_axis: dist.ProcessGroup
    n_view: int = 1
    view_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.layout.world_size

    @property
    def rank(self) -> int:
        return self.layout.rank

    @property
    def n_data(self) -> int:
        return self.layout.world_size // self.n_view

    @property
    def data_index(self) -> int:
        return self.layout.rank // self.n_view

    @property
    def view_index(self) -> int:
        return self.layout.rank % self.n_view

    @property
    def node_size(self) -> int:
        return self.layout.local_world_size

    @property
    def node_rank(self) -> int:
        return self.layout.local_rank

    @property
    def node_blocks(self) -> int:
        """The data indices of a node: the blocks its batch is cut into."""
        return self.layout.local_world_size // self.n_view

    @property
    def is_node_leader(self) -> bool:
        return self.layout.local_rank == 0

    def view_shard(self) -> Optional[ViewShard]:
        """This rank's place on the view axis; None without one."""
        if self.n_view == 1:
            return None
        return ViewShard(self.view_group, self.view_index, self.n_view)

    def global_rows(self, rows: int) -> slice:
        """The rows of the global batch that this rank holds when each data
        index holds `rows`."""
        return slice(self.data_index * rows, (self.data_index + 1) * rows)

    def local_rows(self, batch: Dict) -> Dict:
        """This rank's contiguous block of its node's batch, the block of its
        data index within the node (the ranks of a view group hold the same
        rows): every array (numpy or tensor) cut along axis 0; other values
        (``tokens``) pass through. A batch that does not split evenly over
        the node's data indices raises, as the JAX package's sharding does."""
        n = self.node_blocks
        rows = next(len(v) for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)))
        if rows % n:
            raise ValueError(
                f"a batch of {rows} rows does not split over the {n} data indices of a node: "
                "train.batch_size must divide by the processes per node over view_parallel"
            )
        m = rows // n
        i = self.node_rank // self.n_view
        block = slice(i * m, (i + 1) * m)
        return {k: v[block] if isinstance(v, (np.ndarray, torch.Tensor)) else v for k, v in batch.items()}

    def gather_node_rows(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each tensor's blocks from the node's data indices, concatenated in
        order along axis 0 (every rank gets them; one all-gather a key over
        the node, of which the first rank of each view group is kept)."""
        out = {}
        for k in sorted(tensors):
            t = tensors[k].contiguous()
            parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(self.node_size)]
            dist.all_gather(parts, t, group=self.node_group)
            out[k] = torch.cat(parts[::self.n_view])
        return out

    def node_broadcast(self, obj):
        """The node leader's `obj` on every rank of the node."""
        box = [obj]
        leader = self.rank - self.node_rank
        dist.broadcast_object_list(box, src=leader, group=self.node_group)
        return box[0]


def make_data_group(n_data: Optional[int] = None, n_view: int = 1, multi_host: bool = False) -> DataGroup:
    """The ('data', 'view') layout over every process of the initialized
    process group. Without `multi_host` the processes are one node's and
    their number must be `n_data` x `n_view` (``parallel.data_parallel`` x
    ``view_parallel``), whose global batch is one node's batch; with it they
    span the nodes, ``n_data = world // n_view``, and the nodes' batches
    stack into the global batch. A view group must lie within one node."""
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call parallel.maybe_initialize first")
    layout = rank_layout()
    world = layout.world_size
    if n_view < 1 or world % n_view:
        raise ValueError(f"view_parallel={n_view} does not divide the {world} processes")
    if not multi_host:
        if layout.num_nodes != 1:
            raise ValueError(
                f"{layout.num_nodes} nodes without parallel.multi_host: data_parallel spans one node's processes"
            )
        if n_data is not None and n_data * n_view != world:
            raise ValueError(
                f"parallel.data_parallel x view_parallel is {n_data} x {n_view} but {world} processes run: "
                f"launch torchrun --nproc_per_node {n_data * n_view}"
            )
    if layout.local_world_size % n_view:
        # JAX's form_global_batch: a data row owned by two hosts would take
        # two different loader slices for one shard
        raise ValueError(
            f"each 'data' shard must be owned by exactly one node, but a view group of {n_view} ranks spans "
            f"nodes of {layout.local_world_size} processes (view axis crossing host boundaries) - use a "
            "view_parallel that divides the per-host device count"
        )
    whole = dist.group.WORLD
    node_group = whole
    # every rank creates every group, in the same order
    if layout.num_nodes > 1:
        node_group, _ = dist.new_subgroups(group_size=layout.local_world_size)
    if n_view == 1:
        return DataGroup(whole, node_group, layout, whole)
    rows = world // n_view
    view_group, _ = dist.new_subgroups_by_enumeration([[d * n_view + v for v in range(n_view)] for d in range(rows)])
    data_axis, _ = dist.new_subgroups_by_enumeration([[d * n_view + v for d in range(rows)] for v in range(n_view)])
    return DataGroup(whole, node_group, layout, data_axis, n_view, view_group)
