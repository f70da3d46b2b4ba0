"""The train step's gradients: CUDA stream ms a step, from its `train.backward`
spans."""

from core import spans


def read(ctx, data):
    return spans.mean_device_ms("train.backward")
