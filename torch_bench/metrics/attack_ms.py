"""The span around ``attack.poison_updates``, mean a round, in ms, in cells
whose traffic has an attack. Layer: the attack."""

from torch_bench.metrics._spans import mean_ms


def read(ctx):
    if ctx.spans is None or ctx.cell.traffic["attack"]["name"] == "none":
        return None
    return mean_ms(ctx.spans.of("attack"))
