"""The share of served batches staged in page-locked host memory, whose
copies to the card are asynchronous: % of the `serve.stage` spans, from
their `pinned` attribute (none where the spans carry no such attribute)."""

from core import spans


def read(ctx, data):
    return spans.mean_attr("serve.stage", "pinned", 100.0)
