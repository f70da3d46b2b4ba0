"""The eval step moving the arrays it reads to the device: ms a step, from its
`eval.inputs` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_ms("eval.inputs")
