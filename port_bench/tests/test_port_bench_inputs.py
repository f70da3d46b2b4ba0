"""The seeded inputs: the same seed gives the same inputs, another seed
other contents of the same shapes."""

import numpy as np

from core import inputs, registry
from reference.geometry import frustum_cells
from reference.model import Spec

SPEC = Spec(registry.config(registry.benchmark(), "bevfusion_geometric"))


def test_samples_are_seeded_and_shaped():
    a = inputs.samples(SPEC, 2, 2**33 + 1, "cpu", [28000, 35000], [20, 125])
    b = inputs.samples(SPEC, 2, 2**33 + 1, "cpu", [28000, 35000], [20, 125])
    c = inputs.samples(SPEC, 2, 2**33 + 2, "cpu", [28000, 35000], [20, 125])
    for x, y, z in zip(a, b, c):
        assert x["camera_imgs"].shape == (6, 448, 800, 3) and x["camera_imgs"].dtype == np.uint8
        assert x["lidar_points"].shape == (35000, 4) and x["radar_points"].shape == (5, 125, 7)
        for k in x:
            assert np.array_equal(x[k], y[k]) and not np.array_equal(x[k], z[k])
        real = (x["lidar_points"] != 0).any(-1)
        assert 28000 <= real.sum() <= 35000 and real[: real.sum()].all()
        radar_real = (x["radar_points"] != 0).any(-1).sum(-1)
        assert ((20 <= radar_real) & (radar_real <= 125)).all()
        lo, hi = np.array(SPEC.pc_range[:3]), np.array(SPEC.pc_range[3:])
        pts = x["lidar_points"][real][:, :3]
        assert ((pts >= lo) & (pts <= hi)).all()


def test_boxes_are_seeded_and_inside_the_grid():
    b1, l1 = inputs.gt_boxes(SPEC, 4, 500, [5, 60], 7)
    b2, l2 = inputs.gt_boxes(SPEC, 4, 500, [5, 60], 7)
    assert np.array_equal(b1, b2) and np.array_equal(l1, l2)
    n = (l1 >= 0).sum(1)
    assert ((5 <= n) & (n <= 60)).all() and b1.shape == (4, 500, 7)
    assert (np.abs(b1[..., :2]) <= 0.95 * 51.2 + 1e-4).all()


def test_ring_cells_cover_the_grid():
    cells = frustum_cells(SPEC, inputs.ring_calibration(SPEC))
    assert cells.shape == (6, 118, 28, 50)
    inside = cells[cells >= 0]
    assert inside.max() < 2500 and 0.5 < (cells >= 0).mean() <= 1.0
