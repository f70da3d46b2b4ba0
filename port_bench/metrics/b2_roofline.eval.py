"""Kernel B2 (weighted BEV pool) in the eval cell: its bytes at the memory bandwidth over its device time (%)."""

from core.readers import b2_roofline


def read(ctx, data):
    return b2_roofline(data)
