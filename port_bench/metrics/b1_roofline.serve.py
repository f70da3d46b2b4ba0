"""Kernel B1 (fused PointNet) in the serve cell: its bound at the peak of its working type over its device time (%)."""

from core.readers import b1_roofline


def read(ctx, data):
    return b1_roofline(data)
