"""The device time of the program's ``forward`` spans, a round, in ms: the
model and the loss of every local step, dropout draws included. Layer:
local training."""

from torch_bench.metrics._program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "forward")
