"""Spans of the round's layers, kept in memory while a profiler records.

The port's counterpart of the role of
``multimodal_fl_security_tpu/utils/profiling.py``: there, named regions go
into a JAX device profile; here each span is a record in memory, stamped on
the host with ``time.time_ns()``, which is the clock of ``torch.profiler``'s
timeline, and, for work on a CUDA device, timed on the device by a pair of
CUDA events recorded on the current stream at its edges.

Tracing is on exactly while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``), and off everywhere else: then
:func:`span` returns one shared no-op object, and makes no CUDA call, no
allocation and no profiler label. The spans put no label into the
profiler's trace, so the device operations that trace records are the
program's own.

Read them by wrapping a few rounds in a profiler session::

    from torch.profiler import ProfilerActivity, profile
    from multimodal_fl_security_tpu_torch.utils import tracing

    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(3):
            params, _ = engine.run_round(params, generator)
    for s in tracing.spans():  # synchronises once
        print(s.round, s.name, s.parent, s.end_ns - s.start_ns, s.device_ms)

The spans, each timing the work where it happens: ``local_train``,
``attack`` and ``aggregate`` around the three layers of
``RoundEngine.run_round``, and, inside ``local_train``, ``forward`` (the
model and the loss; in the kernel trainer also the step's draws and
gathers), ``backward`` and ``optimizer`` for every local step. A model may
split its own step further: ResNet's stages (``models/resnet.py``) and
ViT's sub-blocks (``models/vit.py``) are spans inside ``forward`` and,
opened and closed from gradient hooks (:func:`backward_spans`), inside
``backward``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

#: records kept until :func:`clear`; spans beyond it are dropped and counted
MAX_SPANS = 16_384

_enabled = torch.autograd._profiler_enabled


@dataclass(slots=True)
class Span:
    """One span: host ``start_ns``/``end_ns`` on the profiler's clock, and
    ``device_ms``, the device time between its edges (None on the CPU, and
    until :func:`spans` resolves it)."""

    name: str
    id: int
    parent: Optional[int]
    round: int
    start_ns: int
    end_ns: Optional[int] = None
    device_ms: Optional[float] = None
    #: (start event, end event, stream) until resolved
    _events: Optional[tuple] = field(default=None, repr=False, compare=False)


class _Off:
    """The context manager of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("tracer", "record")

    def __init__(self, tracer: "Tracer", record: Span):
        self.tracer, self.record = tracer, record

    def __enter__(self):
        return self.record

    def __exit__(self, *exc):
        self.tracer.close(self.record)
        return False


class Tracer:
    """The records of one process's spans.

    A profiler session is process-wide, so the module keeps one tracer
    (:data:`TRACER`) that every layer of the port writes to and that a
    reader of a profiled window reads from."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self.round = 0       # run_round calls so far
        self.dropped = 0     # spans beyond max_spans
        self._records: List[Span] = []
        self._open: List[int] = []   # ids of the open spans, innermost last
        self._ids = 0
        #: events of resolved spans, reused by later ones
        self._pool: List[torch.cuda.Event] = []

    def next_round(self) -> None:
        """Counts a ``run_round`` call: the spans that follow share its id."""
        self.round += 1

    def span(self, name: str, device: torch.device):
        """A context manager around work on ``device``: a record while a
        profiler session records, else the shared no-op."""
        rec = self.open(name, device)
        return _OFF if rec is None else _Open(self, rec)

    def open(self, name: str, device: torch.device) -> Optional[Span]:
        """Opens a span whose end :meth:`close` marks, for edges that no
        ``with`` block encloses, such as two gradient hooks; its parent is
        the innermost span open. None while tracing is off or past
        ``max_spans``."""
        if not _enabled():
            return None
        if len(self._records) >= self.max_spans:
            self.dropped += 1
            return None
        rec = Span(name, self._ids, self._open[-1] if self._open else None,
                   self.round, time.time_ns())
        self._ids += 1
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            rec._events = (self._event(), self._event(), stream)
            rec._events[0].record(stream)
        self._records.append(rec)
        self._open.append(rec.id)
        return rec

    def close(self, rec: Optional[Span]) -> None:
        """Ends a span that :meth:`open` returned; None is a no-op."""
        if rec is None:
            return
        if rec._events is not None:
            _, end, stream = rec._events
            end.record(stream)
        rec.end_ns = time.time_ns()
        self._open.remove(rec.id)

    def _event(self) -> torch.cuda.Event:
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def spans(self) -> List[Span]:
        """Every record since :meth:`clear`, in start order, with the device
        times of the closed ones resolved (one synchronisation a device).
        Their events go back to the pool."""
        pending = [r for r in self._records
                   if r._events is not None and r.end_ns is not None]
        for device in {r._events[2].device for r in pending}:
            torch.cuda.synchronize(device)
        for rec in pending:
            start, end, _ = rec._events
            rec.device_ms = start.elapsed_time(end)
            rec._events = None
            self._pool += (start, end)
        return list(self._records)

    def clear(self) -> None:
        """Drops every record and the count of dropped spans; the events of
        closed spans go back to the pool."""
        for rec in self._records:
            if rec._events is not None and rec.end_ns is not None:
                self._pool += rec._events[:2]
        self._records, self.dropped = [], 0


TRACER = Tracer()


def backward_spans(marks: Sequence[Tuple[torch.Tensor, Optional[str]]],
                   device: torch.device) -> None:
    """Gradient hooks that split a backward into spans: when the gradient
    of a tensor of ``marks`` arrives, the span open ends and the span named
    beside it (None: none) begins. ``marks`` is in backward order."""
    state: List[Optional[Span]] = [None]

    def at(name: Optional[str]):
        def hook(grad):
            TRACER.close(state[0])
            state[0] = None if name is None else TRACER.open(name, device)
        return hook

    for tensor, name in marks:
        tensor.register_hook(at(name))


enabled = _enabled
span = TRACER.span
spans = TRACER.spans
clear = TRACER.clear
next_round = TRACER.next_round
