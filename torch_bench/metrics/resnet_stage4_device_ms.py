"""The device time of ResNet's ``stage4`` spans, forward plus backward, a
round, in ms: stage 4's bottleneck blocks. Layer: local training."""

from torch_bench.metrics._resnet_stages import read_stage


def read(ctx):
    return read_stage(ctx, "stage4")
