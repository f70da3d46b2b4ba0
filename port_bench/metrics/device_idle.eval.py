"""Device idle share of the eval cell's profiled sub-window (%)."""

from core.readers import device_idle


def read(ctx, data):
    return device_idle(data)
