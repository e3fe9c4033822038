"""The share of the profiled train steps in which the device ran nothing."""
from benchmark import layers


def read(ctx):
    return layers.device_idle(ctx, "train")
