"""The port's view-parallel train step (``parallel.view_parallel``, with and
without ``bev_spatial``) against one process at the global batch: gloo
processes laid out as (data 1, view 2) and (data 2, view 2), from the same
state, on `torch_parallel_worker.parallel_batches` (halves that differ in
positives and BatchNorm statistics), at narrow widths in float64, held at
test_torch_parallel.py's limits (losses 1e-6 relative; parameters,
BatchNorm running statistics and AdamW first moments 1e-6 of each tensor's
largest). Each rank of (data 1, view 2) runs the camera trunk on 3 of the 6
cameras and, under ``bev_spatial``, the head on 8 of the 16 BEV rows. The
check rejects the three ways of counting wrong (`chip_smoke.view_mutant`):
the trunk's statistics of each view rank's cameras alone, the replicated
gradients summed over the world, and the row-block head without its halo
rows. Also the ('data', 'view') rank layout itself, and the server's
devices grid (rows: replicas; columns: the view axis)."""

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import DetectorSpec
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from chip_smoke import VIEW_MUTANTS, detections_agree, make_samples, randomize_stats
from torch_parallel_worker import launch, parallel_batches
from torch_port_helpers import narrow_spec, to_port_spec
from torch_trainer_helpers import tree_config

LIMIT = 1e-6  # test_torch_parallel.py's
STEPS = 2
LAYOUTS = {"data1_view2": 2, "data2_view2": 4}  # the world; view_parallel is 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's `relative_errors` of each step against one process's
    steps (trained in each rank process), and its layout."""
    spec = to_port_spec(narrow_spec("camera+lidar+radar"))
    g = torch.Generator().manual_seed(3)
    state = randomize_stats(MultiModal3DDetector(spec).init_weights(g), g).double().state_dict()
    batches = parallel_batches(spec, STEPS)
    steps = [dict(n_view=2, batches=batches[:1]), dict(n_view=2, bev_spatial=True),
             dict(n_view=2, bev_spatial=True, batches=batches[:1], shard_optimizer=True)]
    mutants = [dict(steps[1], batches=batches[:1], mutant=m) for m in VIEW_MUTANTS]
    kw = dict(spec=spec, state=state, batches=batches)

    def jobs(runs):
        return [("step_errors_here", dict(kw, runs=runs)), ("layout_of", {})]

    ckpt = str(tmp_path_factory.mktemp("view_zero") / "ckpt")
    # the two layouts at once
    wide, narrow = launch(jobs(steps) + [("view_checkpoint", dict(spec=spec, state=state, batch=batches[0], root=ckpt))],
                          world=LAYOUTS["data2_view2"],
                          during=lambda: launch(jobs(steps + mutants), world=LAYOUTS["data1_view2"]))
    return {"data1_view2": narrow, "data2_view2": wide}


@pytest.mark.parametrize("bev_spatial", [False, True], ids=["cameras", "cameras+bev_rows"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_view_ranks_equal_one_rank_at_the_global_batch(runs, layout, bev_spatial):
    for rank in runs[layout]:
        errors = rank[0][int(bev_spatial)]
        assert len(errors) == (STEPS if bev_spatial else 1)
        for step, errs in enumerate(errors):
            assert all(v <= LIMIT for v in errs.values()), (step, errs)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero_shards_over_the_data_axis(runs, layout):
    """``shard_optimizer``: ZeRO-1 over the data axis, replicated over the
    view axis ((data 1, view 2) has one data index: nothing to shard); the
    step equals one process's."""
    for rank in runs[layout]:
        (errs,) = rank[0][2]
        assert all(v <= LIMIT for v in errs.values()), errs


def test_zero_directory_checkpoint_written_once_a_data_index(runs):
    """A directory checkpoint under (data 2, view 2) with ZeRO-1: the moments
    are replicated over the view axis, so view index 0 of each data index
    writes its shard and view index 1 writes nothing (as orbax writes each
    shard once); each rank restores its slice bit for bit."""
    written = [rank[2]["written"] for rank in runs["data2_view2"]]
    assert written == [["meta.msgpack", "opt_state.0-of-2.msgpack", "variables.msgpack"], [],
                       ["opt_state.1-of-2.msgpack"], []]
    assert all(rank[2]["moments_equal"] for rank in runs["data2_view2"])


@pytest.mark.parametrize("mutant", VIEW_MUTANTS)
def test_view_mutants_fail(runs, mutant):
    for rank in runs["data1_view2"]:
        (errs,) = rank[0][3 + VIEW_MUTANTS.index(mutant)]
        assert max(errs.values()) > 100 * LIMIT, errs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rank_layout_is_jax_reshape(runs, layout):
    """Rank r is at data index r // 2 and view index r % 2 (JAX's
    ``devices.reshape(n_data, n_view)``); a view group holds its data
    index's rows, and the node's gather keeps one block a data index."""
    ranks = runs[layout]
    n_data = len(ranks) // 2
    for r, rank in enumerate(ranks):
        got = rank[1]
        assert (got["data_index"], got["view_index"], got["shard_index"]) == (r // 2, r % 2, r % 2)
        assert got["view_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert got["data_ranks"] == [d * 2 + r % 2 for d in range(n_data)]
        m = 8 // n_data
        assert got["rows"] == list(range(r // 2 * m, (r // 2 + 1) * m))
        assert got["gathered"] == list(range(n_data))


def test_server_grid_splits_the_cameras(tmp_path):
    """`InferenceServer(devices=[["cpu", "cpu"]])`: one replica whose
    cameras are split over a row of two devices, a trunk replica on each
    taking 3 cameras a call; and a 2x2 grid. Both give one device's
    detections at the serving tolerances."""
    cfg = tree_config(tmp_path, tmp_path / "data", modality="camera+radar")
    samples = make_samples(DetectorSpec.from_config(cfg), np.random.RandomState(4), 4)
    kw = dict(config=cfg, batch_size=4, score_threshold=0.0, use_bf16=False)
    want = InferenceServer(device="cpu", **kw)._run_batch(samples)
    for devices in ([["cpu", "cpu"]], [["cpu", "cpu"], ["cpu", "cpu"]]):
        server = InferenceServer(devices=devices, **kw)
        cameras = []
        for replica, _, _ in server.replicas:
            for trunk in replica.view.replicas:
                trunk.register_forward_hook(lambda module, args, out: cameras.append(args[0].shape[1]))
        detections_agree(server._run_batch(samples), want, f"grid {devices} vs one device")
        assert cameras == [3] * 2 * len(devices)
    with pytest.raises(ValueError, match="as many devices"):
        InferenceServer(devices=[["cpu", "cpu"], ["cpu"]], **kw)
