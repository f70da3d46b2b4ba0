"""The server's staging of a batch (stack, pad, host-to-device copies): ms a
batch, from its `serve.stage` spans."""

from core import spans


def read(ctx, data):
    return spans.mean_ms("serve.stage")
