"""A kernel's share of its roofline from the profiled rounds, in %: the
bound at the call's shape (``rooflines/<kernel>.py``, ``peaks.py``) over
the device time of one call's kernels. Nothing to read where the cell's
traffic makes no such call or the trace holds none of its kernels."""

import importlib

from torch_bench.peaks import bound_s


def share(ctx, kernel):
    call = ctx.cell.traffic["kernels"].get(kernel)
    if ctx.trace is None or not call or not call["launches_per_round"]:
        return None
    mod = importlib.import_module(f"torch_bench.rooflines.{kernel}")
    times = ctx.trace.by_kernel()
    launches = times.get(mod.KERNELS[0], (0.0, 0))[1]
    seconds = sum(times.get(k, (0.0, 0))[0] for k in mod.KERNELS)
    if not launches or not seconds > 0:
        return None
    least, _ = bound_s(*mod.cost(call, ctx.cell.config["param_count"]))
    return 100.0 * least / (seconds / launches)
