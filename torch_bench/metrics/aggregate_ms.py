"""The span around ``defense.aggregate_with_aux``, mean a round, in ms.
Layer: aggregation."""

from torch_bench.metrics._spans import mean_ms


def read(ctx):
    if ctx.spans is None:
        return None
    return mean_ms(ctx.spans.of("aggregate"))
