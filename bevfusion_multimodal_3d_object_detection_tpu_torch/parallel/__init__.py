"""Data parallelism over ``torch.distributed`` (ROADMAP A13; the camera-view
axis and BEV-spatial partitioning, A13b, are not ported). ZeRO-1 is
`parallel.zero`, imported on its own: it builds on `train.loop`."""

from .distributed import (  # noqa: F401
    RankLayout,
    all_processes_mean,
    barrier,
    global_rows,
    is_multi_process,
    maybe_initialize,
    rank_layout,
    sum_flat,
)
from .mesh import A13B, DataGroup, make_data_group  # noqa: F401
