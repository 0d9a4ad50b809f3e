"""The device time of the program's ``optimizer`` spans, a round, in ms:
every local step's SGD step (clip, weight decay, momentum, update). Layer:
local training."""

from torch_bench.metrics._program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "optimizer")
