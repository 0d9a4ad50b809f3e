"""The device time of ViT's ``vit_attention`` spans, forward plus backward,
a round, in ms: every block's LN1, qkv, softmax attention, proj and
residual add. Layer: local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "vit_attention")
