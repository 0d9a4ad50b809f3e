"""The device time of ViT's ``vit_head`` spans, forward plus backward, a
round, in ms: the final LayerNorm of the class token, dropout and the dense
layer. Layer: local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "vit_head")
