"""The camera's view transform (depth net, B2's pool onto the 360x360 grid,
the downsample) in the Swin eval cell: CUDA stream ms a step, from the
program's `camera.lift` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_device_ms("camera.lift")
