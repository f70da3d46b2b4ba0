"""The camera encoder (Swin-T and its LSS-FPN neck) in the Swin eval cell:
CUDA stream ms a step, from the program's `camera.encode` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_device_ms("camera.encode")
