"""The device time of ResNet's ``stem`` spans, forward plus backward, a
round, in ms: the stem (conv 7x7/2, GroupNorm, relu, max-pool). Layer: local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "stem")
