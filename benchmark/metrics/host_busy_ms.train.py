"""Host ms of a train step outside its waits on the device."""
from benchmark import layers


def read(ctx):
    return layers.host_busy(ctx, "train")
