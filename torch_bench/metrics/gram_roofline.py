"""The Gram kernel's share of its roofline (bytes-bound), in %. Layer: the
kernels."""

from torch_bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "gram")
