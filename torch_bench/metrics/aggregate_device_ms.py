"""The device time of the program's ``aggregate`` span, a round, in ms:
``defense.aggregate_with_aux`` in ``run_round``; the in-program twin of
``aggregate_ms``. Layer: aggregation."""

from torch_bench.metrics._program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "aggregate")
