"""The round's logical FLOPs a second over the configuration's peak, in %.

A round's logical FLOPs: 3 x the model's forward FLOPs a sample x the real
samples trained (clients x samples x local epochs; padding not counted),
plus each aggregation kernel's useful operations a round
(``rooflines/<kernel>.py::logical_flops``: the Gram's 2 C^2 D). Over the
window's rounds and seconds (host clock), against ``peak_flops`` of the
configuration. Layer: the round."""

import importlib


def round_flops(cell):
    cfg, mix = cell.config, cell.traffic
    model = importlib.import_module(
        f"torch_bench.reference.models.{cfg['model']}")
    samples = mix["clients"] * mix["samples_per_client"] * mix["local_epochs"]
    flops = 3 * model.forward_flops_per_sample(cfg) * samples
    for kernel, call in mix["kernels"].items():
        if call["launches_per_round"]:
            mod = importlib.import_module(f"torch_bench.rooflines.{kernel}")
            flops += call["launches_per_round"] * mod.logical_flops(
                call, cfg["param_count"])
    return flops


def read(ctx):
    rate = len(ctx.round_s) / ctx.window_s
    return 100.0 * round_flops(ctx.cell) * rate / ctx.cell.config["peak_flops"]
