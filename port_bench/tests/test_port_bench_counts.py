"""The yardstick's operation and byte counts against the repository's
recorded figures (PERF.md's table of kernels)."""

import pytest

from core import counts, registry
from reference.model import Spec

BASE = Spec(registry.config(registry.benchmark(), "bevfusion_base"))
GEOMETRIC = Spec(registry.config(registry.benchmark(), "bevfusion_geometric"))


def test_b1_lidar_chain_is_390_gflop_at_8_by_35000():
    assert counts.b1_flops(BASE, 8)["lidar"] == pytest.approx(390.08256e9, rel=1e-9)
    assert counts.chain_flops(40, 125, [7, 32, 64, 128, 256]) == counts.b1_flops(BASE, 8)["radar"]


def test_b2_bytes_match_the_48_row_bf16_case():
    # 48 camera rows of 28x50 pixels, 40 depth bins, 256 channels, a 50x50 grid, bf16 features
    assert counts.b2_bytes(48, 1400, 40, 256, 2500, 2) == pytest.approx(185.2e6, rel=1e-3)


def test_model_flops_parts():
    cams = 6 * (counts.trunk_flops(448, 800) + counts.conv_flops(28, 50, 1, 256, 512))
    assert 115e9 < cams < 125e9  # ResNet-18 to layer3 on six 448x800 views
    assert counts.model_flops(BASE) > cams + counts.b1_flops(BASE, 1)["lidar"]
    assert counts.model_flops(GEOMETRIC) != counts.model_flops(BASE)


def test_conv_flops_counts_strided_outputs():
    assert counts.conv_flops(4, 4, 3, 2, 5, 2) == 2 * 2 * 2 * 9 * 2 * 5
