"""The sparse convs' share of their roofline in a eval step: their
bound over the device time of what `ops/sparse_conv*.py` launched."""
from benchmark import layers

LAYER_FILES = {"sparse_conv": layers.LAYERS["sparse_conv"]}


def read(ctx):
    return layers.roofline(ctx, "eval", "sparse_conv")


read.LAYER_FILES = LAYER_FILES
