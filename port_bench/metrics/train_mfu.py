"""Trained model operations (3 x forward, f32, TF32 convolutions) in the profiled sub-window against the TF32 peak (%)."""

from core.readers import mfu


def read(ctx, data):
    return mfu(data, "tf32")
