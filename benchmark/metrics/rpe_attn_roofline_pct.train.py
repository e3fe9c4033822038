"""The RPE cross-attention's share of its roofline in a train step: its
bound over the device time of what `ops/rpe_attention.py` launched
(kernels C and F and F's table sum)."""
from benchmark import layers

LAYER_FILES = {"rpe_attn": layers.LAYERS["rpe_attn"]}


def read(ctx):
    return layers.roofline(ctx, "train", "rpe_attn")


read.LAYER_FILES = LAYER_FILES
