"""A round's start to its attack span's start, mean over the window's
rounds, in ms: local training, whatever trainer the engine runs. Layer:
local training."""

from torch_bench.metrics._spans import mean_ms


def read(ctx):
    if ctx.spans is None:
        return None
    rounds, attacks = ctx.spans.of("round"), ctx.spans.of("attack")
    return mean_ms([(r[0], a[0]) for r, a in zip(rounds, attacks)])
