"""Per-round numbers from the program's own spans
(``multimodal_fl_security_tpu_torch/utils/tracing.py``), recorded while the
traced run's profiler sessions record.

Only the spans of the device-only capture (``ctx.trace``) count: those whose
host interval overlaps its window. Span and trace share one clock, the one
``time.time_ns()`` reads. A program without the tracer gives nothing."""

import importlib

from torch_bench.trace import gaps


def records():
    """The program's span records, or None where it has no tracer."""
    try:
        tracing = importlib.import_module(
            "multimodal_fl_security_tpu_torch.utils.tracing")
    except ModuleNotFoundError:
        return None
    return tracing.spans()


def in_window(trace, spans, name):
    """The spans called ``name`` whose host interval overlaps the window."""
    lo, hi = trace.window
    return [s for s in spans or ()
            if s.name == name and s.start_ns <= hi and s.end_ns >= lo]


def device_ms(trace, spans, name):
    """The device time of the ``name`` spans, summed a round, in ms."""
    mine = in_window(trace, spans, name)
    if not mine:
        return None
    return sum(s.device_ms for s in mine) / trace.rounds


def idle_ms(trace, spans, name):
    """The device's idle gaps over the window that start inside the host
    interval of a ``name`` span, summed a round, in ms."""
    mine = in_window(trace, spans, name)
    if not mine:
        return None
    held = [(s.start_ns, s.end_ns) for s in mine]
    idle = gaps([(s, e) for _, s, e in trace.device], *trace.window)
    return 1e-6 * sum(e - s for s, e in idle
                      if any(a <= s <= b for a, b in held)) / trace.rounds


def read_device_ms(ctx, name):
    return None if ctx.trace is None else device_ms(ctx.trace, records(),
                                                    name)


def read_idle_ms(ctx, name):
    return None if ctx.trace is None else idle_ms(ctx.trace, records(), name)
