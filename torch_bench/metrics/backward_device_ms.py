"""The device time of the program's ``backward`` spans, a round, in ms: the
backward pass of every local step. Layer: local training."""

from torch_bench.metrics._program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "backward")
