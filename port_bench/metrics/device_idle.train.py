"""Device idle share of the train cell's profiled sub-window (%)."""

from core.readers import device_idle


def read(ctx, data):
    return device_idle(data)
