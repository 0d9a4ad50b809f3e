"""A ResNet stage's device time a round: its forward spans (``<stage>``)
plus its backward spans (``<stage>.bwd``), which
``multimodal_fl_security_tpu_torch/models/resnet.py`` records while the
traced run's profiler records. A program without them gives nothing."""

from torch_bench.metrics._program_spans import read_device_ms


def read_stage(ctx, stage):
    parts = [read_device_ms(ctx, name) for name in (stage, stage + ".bwd")]
    if all(part is None for part in parts):
        return None
    return sum(part for part in parts if part is not None)
