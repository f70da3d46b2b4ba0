"""Data parallelism over ``torch.distributed``, with the camera-view axis
and BEV-spatial partitioning (`parallel.view`). ZeRO-1 is `parallel.zero`,
imported on its own: it builds on `train.loop`."""

from .distributed import (  # noqa: F401
    RankLayout,
    all_processes_mean,
    barrier,
    is_multi_process,
    maybe_initialize,
    rank_layout,
    sum_flat,
)
from .mesh import DataGroup, make_data_group  # noqa: F401
from .view import LocalViews, ViewShard  # noqa: F401
