"""CPU tests of the readers of the program's spans (``metrics/_program_spans.py``
and the seven metrics on it), on a synthetic device trace and span records.

Run from the repository root: ``python -m pytest torch_bench/tests``.
"""

from __future__ import annotations

import importlib
import sys
import types

import pytest

from multimodal_fl_security_tpu_torch import utils as port_utils
from multimodal_fl_security_tpu_torch.utils.tracing import Span
from torch_bench.metrics import _program_spans
from torch_bench.trace import Trace

US = 1_000  # ns

#: two profiled rounds in a window of [100, 1000] us
TRACE = Trace(rounds=2, window=(100 * US, 1000 * US), labels=[], device=[
    ("k", 100 * US, 200 * US), ("k", 250 * US, 380 * US),
    ("k", 450 * US, 480 * US), ("k", 520 * US, 600 * US),
    ("k", 700 * US, 1000 * US)])
# The window's idle gaps: [200, 250], [380, 450], [480, 520], [600, 700] us.


def span(name, start_us, end_us, device_ms, parent=None, round=1):
    return Span(name, id=start_us, parent=parent, round=round,
                start_ns=start_us * US, end_ns=end_us * US,
                device_ms=device_ms)


SPANS = [
    span("local_train", 0, 90, 100.0, round=0),      # an earlier capture
    span("local_train", 50, 400, 3.0),               # starts before the window
    span("forward", 60, 150, 1.0, parent=50),
    span("backward", 150, 300, 1.5, parent=50),
    span("optimizer", 300, 390, 0.25, parent=50),
    span("attack", 400, 420, 0.125),
    span("aggregate", 420, 490, 0.5),
    span("local_train", 500, 850, 5.0, round=2),
    span("forward", 510, 600, 2.0, parent=500, round=2),
    span("backward", 600, 800, 2.5, parent=500, round=2),
    span("optimizer", 800, 845, 0.5, parent=500, round=2),
    span("attack", 850, 870, 0.375, round=2),
    span("aggregate", 870, 990, 1.5, round=2),
    span("local_train", 1100, 1200, 100.0, round=3),  # a later capture
]

#: each reader's value on TRACE and SPANS: the two rounds' sum over 2
WANT = {
    "forward_device_ms": (1.0 + 2.0) / 2,
    "backward_device_ms": (1.5 + 2.5) / 2,
    "optimizer_device_ms": (0.25 + 0.5) / 2,
    "local_train_device_ms": (3.0 + 5.0) / 2,
    "attack_device_ms": (0.125 + 0.375) / 2,
    "aggregate_device_ms": (0.5 + 1.5) / 2,
    # gaps starting at 200 and 380 (round 1's local_train) and at 600
    # (round 2's); the one at 480 starts between the two
    "train_idle_ms": (50 + 70 + 100) * 1e-3 / 2,
}


def reader(metric):
    return importlib.import_module(f"torch_bench.metrics.{metric}")


@pytest.mark.parametrize("metric", sorted(WANT))
def test_readers_sum_the_window_s_spans_over_its_rounds(metric, monkeypatch):
    monkeypatch.setattr(_program_spans, "records", lambda: SPANS)
    got = reader(metric).read(types.SimpleNamespace(trace=TRACE))
    assert got == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_readers_give_nothing_without_a_trace_or_a_span_in_it(metric,
                                                             monkeypatch):
    read = reader(metric).read
    monkeypatch.setattr(_program_spans, "records", lambda: SPANS)
    assert read(types.SimpleNamespace(trace=None)) is None
    outside = [s for s in SPANS if s.start_ns >= TRACE.window[1]
               or s.end_ns <= TRACE.window[0]]
    monkeypatch.setattr(_program_spans, "records", lambda: outside)
    assert read(types.SimpleNamespace(trace=TRACE)) is None
    monkeypatch.setattr(_program_spans, "records", lambda: [])
    assert read(types.SimpleNamespace(trace=TRACE)) is None


def test_a_program_without_the_tracer_gives_nothing(monkeypatch, tmp_path):
    # the port's ``utils`` package as it was before the tracer
    monkeypatch.setattr(port_utils, "__path__", [str(tmp_path)])
    monkeypatch.delattr(port_utils, "tracing")
    monkeypatch.delitem(sys.modules,
                        "multimodal_fl_security_tpu_torch.utils.tracing")
    assert _program_spans.records() is None
    ctx = types.SimpleNamespace(trace=TRACE)
    for metric in WANT:
        assert reader(metric).read(ctx) is None


def test_the_window_takes_every_span_that_overlaps_it():
    names = [(s.name, s.start_ns // US)
             for s in _program_spans.in_window(TRACE, SPANS, "local_train")]
    assert names == [("local_train", 50), ("local_train", 500)]
    one = Trace(rounds=1, window=(100 * US, 460 * US), labels=[],
                device=TRACE.device)
    assert _program_spans.device_ms(one, SPANS, "aggregate") == 0.5
    # the window's end falls in round 2's first gap: only 200 and 380
    assert _program_spans.idle_ms(one, SPANS, "local_train") == \
        pytest.approx((50 + 70) * 1e-3)
