"""Process start to the first timed round: imports, the kernel libraries,
the federation and weights made from the seed, the first rounds."""


def read(ctx):
    return ctx.setup_s
