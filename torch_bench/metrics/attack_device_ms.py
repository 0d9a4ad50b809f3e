"""The device time of the program's ``attack`` span, a round, in ms:
``attack.poison_updates`` in ``run_round``; the in-program twin of
``attack_ms``. Layer: the attack."""

from torch_bench.metrics._program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "attack")
