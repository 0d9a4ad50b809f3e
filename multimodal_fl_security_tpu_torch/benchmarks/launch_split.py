"""Device time and host time of one probe-kernel launch, apart.

    python -m multimodal_fl_security_tpu_torch.benchmarks.launch_split

For ``max2`` at ``sublane_pool_reshape``'s two strided halves of a
[32, 56, 256] f32 tensor and ``carry_sum`` at ``grid_scratch_persist``'s
[4, 5, 1024] (the K5 probes' shapes), and for the PyTorch call each is
timed against (``amax`` over the pair axis, ``sum`` over the steps), prints
one line each and a JSON summary:

- the device time of one call, from ``torch.profiler``'s kernel records
  (the kernels' own CUDA time over a window of calls, per call);
- the host time of one call: ``time.perf_counter`` over many calls with one
  ``torch.cuda.synchronize`` at the end.

Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch

#: calls in a profiler window; calls timed on the host
DEVICE_CALLS = 200
HOST_CALLS = 2000


def cases() -> Dict[str, Tuple[Callable, Optional[Callable[[str], bool]]]]:
    """name -> (the call, a test on a kernel record's name that picks the
    call's own kernel; None for the library calls: all their kernels)."""
    from multimodal_fl_security_tpu_torch.ops.probe_reduce import (
        carry_sum,
        max2,
    )

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((32, 56, 256), generator=gen, device="cuda")
    pairs = x.view(32, 7, 2, 4, 256)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    d = torch.arange(4 * 5 * 8 * 128, dtype=torch.float32,
                     device="cuda").view(4, 5, 1024)
    return {
        "max2": (lambda: max2(a, b),
                 lambda k: "max2" in k and "bwd" not in k),
        "amax": (lambda: pairs.amax(dim=2), None),
        "carry_sum": (lambda: carry_sum(d), lambda k: "carry_sum" in k),
        "sum": (lambda: d.sum(dim=1), None),
    }


def profiler_us(call: Callable, match: Optional[Callable[[str], bool]]
                ) -> Optional[float]:
    """Device time of one call, in us: the kernel records ``match`` picks
    (all of them for None) over DEVICE_CALLS calls, per call; None if the
    profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DEVICE_CALLS):
            call()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and (match is None
                                                   or match(evt.key)):
            t = getattr(evt, "self_device_time_total", None)
            total += t if t is not None else evt.self_cuda_time_total
    return total / DEVICE_CALLS if total > 0 else None


def host_us(call: Callable) -> float:
    """Host time of one call, in us: HOST_CALLS calls and one synchronize."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def measure() -> Dict[str, Dict[str, Optional[float]]]:
    """Each case's device time (profiler) and host time, in us."""
    return {name: {"device_us_profiler": profiler_us(call, match),
                   "host_us": host_us(call)}
            for name, (call, match) in cases().items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_split.py needs a CUDA card", file=sys.stderr)
        return 1
    res = measure()
    for name, r in res.items():
        prof = r["device_us_profiler"]
        prof_text = f"{prof:.2f} us" if prof is not None else "not measured"
        print(f"[split] {name}: device {prof_text} (profiler); host "
              f"{r['host_us']:.2f} us a call")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "launch_split": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
