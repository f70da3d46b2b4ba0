"""The train step's clip and AdamW update: CUDA stream ms a step, from its
`train.optimizer` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_device_ms("train.optimizer")
