"""The device's idle time inside local training, a round, in ms: the gaps
between the device-only capture's operations that start inside the host
interval of a program's ``local_train`` span. Layer: local training."""

from torch_bench.metrics._program_spans import read_idle_ms


def read(ctx):
    return read_idle_ms(ctx, "local_train")
