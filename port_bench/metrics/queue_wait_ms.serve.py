"""A served request's wait from submit to the start of its batch's staging: ms
a request, from the `serve.stage` spans."""

from core import spans


def read(ctx, data):
    return spans.attr_ratio("serve.stage", "queue_wait_s", "requests", 1e3)
