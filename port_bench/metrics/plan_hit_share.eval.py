"""The share of the plan arrays the eval step's lift read that were already
on the card (the step's device plan cache): % of them, the mean of the
`eval.inputs` spans' `plan_hits` attribute (none where the spans carry no
such attribute: a program without the cache, or a path that reads no
plans)."""

from core import spans


def read(ctx, data):
    return spans.mean_attr("eval.inputs", "plan_hits", 100.0)
