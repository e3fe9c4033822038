"""The train step's useful flops as a share of the H100's peak."""
from benchmark import layers


def read(ctx):
    return layers.mfu(ctx, "train")
