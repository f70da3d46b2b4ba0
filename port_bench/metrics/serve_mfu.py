"""Served model operations in the profiled sub-window against the bf16 peak (%)."""

from core.readers import mfu


def read(ctx, data):
    return mfu(data, "bf16")
