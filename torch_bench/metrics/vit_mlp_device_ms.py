"""The device time of ViT's ``vit_mlp`` spans, forward plus backward, a
round, in ms: every block's LN2, fc1, GELU, fc2 and residual add. Layer:
local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "vit_mlp")
