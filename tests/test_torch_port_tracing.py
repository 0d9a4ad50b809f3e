"""The round's spans (``utils/tracing.py``) on the CPU.

A small federation: C=5 clients with N=16 rows, batch 8, one epoch (two
local steps a round), ALIE from client 0, Krum f=1 (the Gram's plain
version), SimpleCNN with dropout. Tracing is off outside a profiler session
and then records nothing; inside one each round gives one ``local_train``,
``attack`` and ``aggregate`` span and one ``forward``, ``backward`` and
``optimizer`` span a step, on the profiler's own clock; the round's numbers
are the same either way.
"""

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from multimodal_fl_security_tpu_torch.attacks import get_attack
from multimodal_fl_security_tpu_torch.data.stacking import ClientData
from multimodal_fl_security_tpu_torch.defenses.krum import KrumDefense
from multimodal_fl_security_tpu_torch.models import create_model, init_model
from multimodal_fl_security_tpu_torch.rounds.engine import RoundEngine, TrainSpec
from multimodal_fl_security_tpu_torch.utils import tracing

C, N, B, EPOCHS = 5, 16, 8, 1
STEPS = N // B * EPOCHS
CPU = torch.device("cpu")
MARKER = "inside_aggregate"


class MarkedKrum(KrumDefense):
    """Krum with a profiler label around its work, inside the round's
    ``aggregate`` span."""

    def aggregate_with_aux(self, updates, weights, ctx=None):
        with record_function(MARKER):
            return super().aggregate_with_aux(updates, weights, ctx)


@pytest.fixture(scope="module")
def engine():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 10, size=(C, N)).astype(np.int32)
    protos = rng.uniform(size=(10, 1, 28, 28)).astype(np.float32)
    images = (protos[labels]
              + 0.35 * rng.normal(size=(C, N, 1, 28, 28))).astype(np.float32)
    mask = np.ones((C, N), np.float32)
    mask[2, 12:] = 0.0
    model = create_model("simple_cnn", num_classes=10)
    return RoundEngine(
        model,
        ClientData.from_numpy({"image": images, "label": labels}, mask,
                              mask.sum(1).astype(np.int32), 10, "cpu"),
        TrainSpec(learning_rate=0.05, local_epochs=EPOCHS, batch_size=B),
        attack=get_attack("alie", {"num_malicious": 1}),
        defense=MarkedKrum({"num_malicious": 1, "multi_k": 1}),
        malicious_clients=[0],
    )


@pytest.fixture(scope="module")
def params(engine):
    return init_model(engine.model, in_channels=1, seed=0, device="cpu")


@pytest.fixture(autouse=True)
def empty_tracer():
    tracing.clear()
    yield
    tracing.clear()


def run_rounds(engine, params, rounds, profiled):
    """``rounds`` rounds from ``params`` and seed 0; with ``profiled``
    inside a CPU profiler session, whose events are returned too."""
    gen = torch.Generator().manual_seed(0)
    outs = []

    def go():
        p = params
        for _ in range(rounds):
            p, m = engine.run_round(p, gen)
            outs.append((p, m))

    if not profiled:
        go()
        return outs, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go()
    return outs, list(prof.profiler.kineto_results.events())


def test_off_records_nothing_and_creates_no_event(engine, params,
                                                  monkeypatch):
    def no_cuda(*args, **kwargs):
        raise AssertionError("the off path made a CUDA call")

    for name in ("Event", "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    assert not torch.autograd._profiler_enabled()
    run_rounds(engine, params, 1, profiled=False)
    assert tracing.spans() == []
    assert tracing.TRACER.dropped == 0

    cuda = torch.device("cuda")
    first = tracing.span("forward", cuda)
    assert tracing.span("local_train", CPU) is first
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(200):
            with tracing.span("forward", cuda):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, tracing.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno")
    assert sum(d.size_diff for d in grown) <= 0
    assert sum(d.count_diff for d in grown) <= 0


def test_profiled_rounds_nest_their_spans(engine, params):
    rounds = 2
    run_rounds(engine, params, rounds, profiled=True)
    spans = tracing.spans()
    assert len(spans) == rounds * (3 + 3 * STEPS)
    by_id = {s.id: s for s in spans}
    round_ids = sorted({s.round for s in spans})
    assert len(round_ids) == rounds
    for r in round_ids:
        mine = [s for s in spans if s.round == r]
        top = {s.name: s for s in mine if s.parent is None}
        assert sorted(top) == ["aggregate", "attack", "local_train"]
        assert [s.name for s in mine if s.parent is None] == [
            "local_train", "attack", "aggregate"]
        train = top["local_train"]
        steps = [s for s in mine if s.parent is not None]
        assert [s.name for s in steps] == ["forward", "backward",
                                          "optimizer"] * STEPS
        for s in mine:
            assert s.start_ns <= s.end_ns
            assert s.device_ms is None  # CPU work: no device time
            if s.parent is not None:
                parent = by_id[s.parent]
                assert parent is train
                assert parent.start_ns <= s.start_ns <= s.end_ns \
                    <= parent.end_ns
        ends = [s.end_ns for s in steps]
        assert ends == sorted(ends)
        assert train.end_ns <= top["attack"].start_ns
        assert top["attack"].end_ns <= top["aggregate"].start_ns


def test_profiler_labels_share_the_spans_clock(engine, params):
    _, events = run_rounds(engine, params, 2, profiled=True)
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.name() == MARKER)
    aggs = [s for s in tracing.spans() if s.name == "aggregate"]
    assert len(marks) == len(aggs) == 2
    slack = 50_000  # ns
    for (start, end), span in zip(marks, aggs):
        assert span.start_ns - slack <= start <= end <= span.end_ns + slack


def test_tracing_leaves_the_round_bitwise_unchanged(engine, params):
    off, _ = run_rounds(engine, params, 2, profiled=False)
    on, _ = run_rounds(engine, params, 2, profiled=True)
    assert len(tracing.spans()) == 2 * (3 + 3 * STEPS)
    for (p_off, m_off), (p_on, m_on) in zip(off, on):
        assert torch.equal(p_off, p_on)
        assert sorted(m_off) == sorted(m_on)
        for key in m_off:
            assert torch.equal(m_off[key], m_on[key]), key


class FakeEvent:
    """Stands in for ``torch.cuda.Event`` where there is no card."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        self.at = stream.clock()

    def elapsed_time(self, end):
        return float(end.at - self.at)


class FakeStream:
    device = torch.device("cuda", 0)

    def __init__(self):
        self.t = 0

    def clock(self):
        self.t += 1
        return self.t


def test_cuda_spans_take_events_from_a_pool_and_drop_past_the_limit(
        monkeypatch):
    stream, synced = FakeStream(), []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    FakeEvent.made = 0
    cuda = torch.device("cuda")
    tracer = tracing.Tracer(max_spans=4)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("local_train", cuda):
            with tracer.span("forward", cuda):
                pass
        assert FakeEvent.made == 4
        first = tracer.spans()
        assert synced == [stream.device]
        assert [s.device_ms for s in first] == [3.0, 1.0]
        assert first[1].parent == first[0].id
        for _ in range(3):
            with tracer.span("optimizer", cuda):
                pass
    assert FakeEvent.made == 4  # the first spans' events, reused
    assert len(tracer.spans()) == 4
    assert tracer.dropped == 1
    tracer.clear()
    assert tracer.spans() == [] and tracer.dropped == 0
