"""Device kernels launched a round: the profiled rounds' kernels (copies
and fills left out) over the rounds profiled. Layer: the round."""


def read(ctx):
    if ctx.trace is None:
        return None
    return len(ctx.trace.kernels()) / ctx.trace.rounds
