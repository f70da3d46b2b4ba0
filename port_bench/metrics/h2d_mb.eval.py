"""The host arrays the eval step moves to the device: MB (1e6 bytes) a step,
from its `eval.inputs` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_attr("eval.inputs", "h2d_bytes", 1e-6)
