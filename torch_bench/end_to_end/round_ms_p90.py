"""The 90th percentile of the wall time of every round in the window, in ms
(host clock, linear interpolation between order statistics)."""

import statistics


def read(ctx):
    ms = [t * 1e3 for t in ctx.round_s]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
