"""The trace arithmetic on a synthetic trace."""

import pytest

from core import readers, trace


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


EVENTS = [
    _ev("host step", 0, 1000, "cpu_op"),
    _ev("cudaMemcpyAsync", 300, 250, "cuda_runtime"),
    _ev("void (anonymous namespace)::pointnet_tile_kernel<__nv_bfloat16>(Params)", 100, 200),
    _ev("void reduce_tiles_kernel(float const*)", 300, 10),
    _ev("gemm", 250, 100),  # overlaps the tile kernel
    _ev("void (anonymous namespace)::pointnet_tile_kernel<__nv_bfloat16>(Params)", 600, 5),
    _ev("slice_kernel<float>", 700, 100),
]


def test_union_and_idle():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((350 - 100 + 5 + 100) * 1e-6)
    assert readers.device_idle({"trace": s}) == pytest.approx(100 * (1 - 355 / 1000))


def test_kernel_groups_and_gaps():
    s = trace.summarize(EVENTS)
    assert s["kernels"]["b1"]["seconds"] == pytest.approx(215e-6)
    assert s["kernels"]["b1"]["main"] == pytest.approx([200e-6, 5e-6])
    assert s["kernels"]["b2"]["seconds"] == pytest.approx(100e-6)
    assert s["idle_gaps"][0] == ["cudaMemcpyAsync", pytest.approx(250e-6)]  # 350..600, the innermost host event
    assert s["idle_gaps"][1][0] == "host step"
    assert s["device_ops"][0][0].startswith("void (anonymous")


def test_b1_roofline_tells_the_launches_apart():
    s = trace.summarize(EVENTS)
    data = {"trace": s, "b1_launch_flops": {"lidar": 989e12 * 100e-6, "radar": 989e12 * 1e-6}, "b1_dtype": "bf16"}
    assert readers.b1_roofline(data) == pytest.approx(100 * 101e-6 / 215e-6)
    assert readers.b2_roofline({"trace": s, "b2_bytes": 3.35e12 * 50e-6}) == pytest.approx(50.0)


def test_readers_find_nothing_to_read():
    assert readers.b1_roofline({"trace": None}) is None
    assert readers.mfu({"model_flops": 0, "sub_window_s": 1.0}, "bf16") is None
    assert readers.device_idle({"trace": None}) is None
