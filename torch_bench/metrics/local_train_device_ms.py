"""The device time of the program's ``local_train`` span, a round, in ms:
the trainer's call in ``run_round``; the in-program twin of
``local_train_ms``. Layer: local training."""

from torch_bench.metrics._program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "local_train")
