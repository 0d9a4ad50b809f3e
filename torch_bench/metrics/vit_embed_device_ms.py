"""The device time of ViT's ``vit_embed`` spans, forward plus backward, a
round, in ms: the patch embedding, the class token and the position
embeddings. Layer: local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "vit_embed")
