"""The profiler's sub-windows: device time by kernel, busy and idle time.

``torch.profiler`` (CUPTI) records every device operation of a few steady
rounds. Two captures are made:

- the device alone (:func:`capture`): the busy time, the union of the
  device operations' intervals over the window from the first operation's
  start to the last one's end, and each kernel's device time and launch
  count by short name. Recording the host's operations too would slow the
  host by several microseconds a launch and open gaps on the device that
  the unprofiled round does not have;
- with the host (``host=True``, one round): the same, plus the host's
  operations and the benchmark's labels (``record_function``: the window,
  each round, the attack and the aggregation), which name the longest idle
  gaps by the innermost label and host operation running when each began.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "bench_window"
ROUND = "round"
LABELS = (ROUND, "attack", "aggregate")
Interval = Tuple[int, int]


@dataclass
class Trace:
    """Events of the profiled rounds, in the profiler's nanoseconds."""

    rounds: int
    window: Interval
    device: List[Tuple[str, int, int]]   # (short name, start, end)
    labels: List[Tuple[str, int, int]]   # benchmark labels
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        """Device operations other than copies and fills."""
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return busy_ns([(s, e) for _, s, e in self.device],
                       *self.window) * 1e-9

    def by_kernel(self) -> Dict[str, Tuple[float, int]]:
        """Short name -> (device seconds, launches)."""
        out: Dict[str, Tuple[float, int]] = {}
        for name, s, e in self.device:
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + (e - s) * 1e-9, n + 1)
        return out


def short_name(raw: str) -> str:
    """``void at::native::(anonymous namespace)::k<...>(float*, ...)`` ->
    ``at::native::k``."""
    name = raw.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0].strip()


def union(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, in order."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(intervals: List[Interval], lo: int, hi: int) -> int:
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle stretches of ``[lo, hi]`` between the intervals."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _innermost(events: List[Tuple[str, int, int]], starts: List[int],
               t: int) -> str:
    """The latest-starting event of ``events`` (sorted by start) that holds
    ``t``, or ``""``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        name, s, e = events[i]
        if e >= t:
            return name
        i -= 1
    return ""


def breakdown(trace: Trace, labelled: Trace, top: int = 10
              ) -> Dict[str, list]:
    """The device operations of ``trace`` that took most time, and the
    longest idle gaps of ``labelled`` by what the host was doing, in
    seconds."""
    ops = sorted(((n, t) for n, (t, _) in trace.by_kernel().items()),
                 key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(s, e) for _, s, e in labelled.device],
                       *labelled.window), key=lambda g: g[0] - g[1])[:top]
    labels = sorted(labelled.labels, key=lambda e: e[1])
    host = sorted(labelled.host, key=lambda e: e[1])
    lstarts, hstarts = [e[1] for e in labels], [e[1] for e in host]
    named = []
    for s, e in idle:
        where = _innermost(labels, lstarts, s) or "between_rounds"
        what = _innermost(host, hstarts, s)
        named.append([f"{where}:{what}" if what else where, (e - s) * 1e-9])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def capture(run: Callable[[], None], rounds: int, host: bool = False
            ) -> Trace:
    """Profile ``rounds`` calls of ``run`` (one round each, labelled by the
    caller's recorders) inside one ``bench_window`` label; with ``host``
    the host's operations and the labels are recorded too."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for _ in range(rounds):
                with record_function(ROUND):
                    run()
            torch.cuda.synchronize()
    window, device, labels, ops = None, [], [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in LABELS and name != WINDOW:  # labels' mirrors
                device.append((short_name(name), start, end))
        elif name == WINDOW:
            window = (start, end)
        elif name in LABELS:
            labels.append((name, start, end))
        elif name.startswith("aten::"):
            ops.append((name, start, end))
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    if window is None:
        if host:
            raise RuntimeError("the profiler recorded no window label")
        window = (min(s for _, s, _ in device), max(e for _, _, e in device))
    return Trace(rounds=rounds, window=window, device=device, labels=labels,
                 host=ops)
