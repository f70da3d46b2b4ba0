"""The train step's augmentation, forward, targets and loss: CUDA stream ms a
step, from its `train.forward` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_device_ms("train.forward")
