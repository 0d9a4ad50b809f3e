"""The device time of ResNet's ``head`` spans, forward plus backward, a
round, in ms: the head (spatial mean, dropout, fc). Layer: local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "head")
