"""The train step moving the arrays it reads to the device: ms a step, from its
`train.inputs` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_ms("train.inputs")
