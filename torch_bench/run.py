"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started on.

    python3 -m torch_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

1. Set-up: the federation and the initial weights from ``--seed`` on the
   card (``federation.py``), the port's ``RoundEngine`` (``program.py``),
   then the first rounds (``FIRST_ROUNDS``) through ``run_round``. The first
   of them builds the kernel libraries and meets every shape; all of them
   are the rounds the correctness check compares.
2. The window: the same engine runs round after round in a closed loop for
   ``--seconds``. A round is over when its ``client_loss_mean`` is on the
   host. With ``--trace 1`` each round's layers are timed by spans (the
   device synchronised at each boundary), and a profiler sub-window over a
   few more rounds follows (``trace.py``).
3. The peak device memory is read, the program's state freed, and the plain
   f32 reference (``reference/``) runs the first rounds again from the
   seed; ``correctness.py`` compares the two.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (rounds), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each compared number beside
its limit, which also end standard error. Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from torch_bench import correctness, federation, program  # noqa: E402
from torch_bench.cell import CHECKOUT, Cell, load_cell  # noqa: E402
from torch_bench.reference.round import (  # noqa: E402
    Readings,
    layer_gaps,
    run_rounds,
)
from torch_bench.trace import Trace, breakdown, capture  # noqa: E402

#: rounds run before the window; the correctness check compares them
FIRST_ROUNDS = 3
#: the profiled sub-window holds at least one round and about this long
PROFILE_S = 1.0
PROFILE_MAX_ROUNDS = 3
#: every build and kernel cache, at fixed paths inside the checkout
CACHE = CHECKOUT / "build" / "torch_bench_cache"
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "cuda"}


@dataclass
class Context:
    """What the readers in ``end_to_end/`` and ``metrics/`` read."""

    cell: Cell
    setup_s: float
    window_s: float
    round_s: List[float]
    spans: Optional[program.Spans]
    trace: Optional[Trace]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class _Capture:
    """Stands in for ``engine.attack``: keeps each round's rows before and
    after the attack on the host."""

    def __init__(self, attack, readings: Readings):
        self.attack, self.readings = attack, readings

    def __getattr__(self, attr):
        return getattr(self.attack, attr)

    def poison_updates(self, generator, updates, *args, **kwargs):
        out = self.attack.poison_updates(generator, updates, *args, **kwargs)
        self.readings.trained.append(updates.detach().to("cpu", copy=True))
        self.readings.attacked.append(out.detach().to("cpu", copy=True))
        return out


def first_rounds(engine, params, gen, rounds: int,
                 selection: Optional[str] = None) -> Readings:
    """The first rounds through ``run_round``, as the comparison reads
    them; ``selection`` names the round metric that holds the defense's
    choice of clients."""
    out = Readings([], [], [params.clone()])
    attack = engine.attack
    engine.attack = _Capture(attack, out)
    try:
        for _ in range(rounds):
            params, m = engine.run_round(params, gen)
            out.losses.append(float(m["client_loss_mean"]))
            out.update_norms.append(float(m["update_norm_mean"]))
            out.thetas.append(params.clone())
            out.selections.append(m[selection].detach().cpu()
                                  if selection else None)
    finally:
        engine.attack = attack
    return out


def window(engine, params, gen, seconds: float,
           spans: Optional[program.Spans]):
    """Rounds in a closed loop until ``seconds`` have passed; returns the
    parameters, each round's seconds, the window's seconds and the rounds
    whose loss was not finite."""
    round_s, failed = [], 0
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        t0 = time.perf_counter()
        params, m = engine.run_round(params, gen)
        loss = float(m["client_loss_mean"])
        end = time.perf_counter()
        round_s.append(end - t0)
        failed += not math.isfinite(loss)
        if spans is not None:
            spans.add("round", t0, end)
    return params, round_s, end - start, failed


def reference(cell: Cell, fed, readings: Readings, device) -> Readings:
    """The plain reference's first rounds from the seed, following the
    program's selections."""
    return run_rounds(fed, cell.config, cell.traffic,
                      federation.round_generator(fed, device),
                      len(readings.losses), follow=readings.selections)


def compare(cell: Cell, fed, readings: Readings, device,
            ref: Optional[Readings] = None) -> Dict[str, float]:
    """Every number of ``correctness.py`` between the program's first
    rounds and the reference's (``ref``, run here if not given)."""
    cfg, mix = cell.config, cell.traffic
    if ref is None:
        ref = reference(cell, fed, readings, device)
    out = correctness.numbers(readings, ref, cfg["leaves"])
    out.update(layer_gaps(readings, fed, mix, lambda got, want:
                          correctness.worst_leaf_difference(
                              got, want, cfg["leaves"])))
    return out


def launch_checks(cell: Cell, before: Dict[str, int], rounds: int
                  ) -> Dict[str, float]:
    """Each of the traffic mix's kernels launched as often as its defense
    makes it launch, a round: ``|launches / rounds - expected|``."""
    out = {}
    for kernel, call in cell.traffic["kernels"].items():
        counter = importlib.import_module(f"torch_bench.counters.{kernel}")
        got = (counter.read() - before[kernel]) / rounds
        out[f"{kernel}_launch_gap"] = abs(got - call["launches_per_round"])
    return out


def counters(cell: Cell) -> Dict[str, int]:
    return {k: importlib.import_module(f"torch_bench.counters.{k}").read()
            for k in cell.traffic["kernels"]}


def read_metrics(entries, kind: str, ctx: Context) -> Dict[str, Any]:
    out = {}
    for entry in entries:
        reader = importlib.import_module(f"torch_bench.{kind}.{entry['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             plant: Optional[Callable] = None) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's object.

    ``plant(engine, fed)``, for the checks' own tests, breaks the program
    underneath before the first round."""
    device = torch.device(device)
    t_start = T_START if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    program.apply_precision_flags(cfg)
    fed = federation.make_federation(cfg, mix, seed, device)
    engine = program.build_engine(cfg, mix, fed)
    if plant is not None:
        plant(engine, fed)
    gen = federation.round_generator(fed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    selection = mix["defense"].get("selection")
    readings = first_rounds(engine, fed.theta0.clone(), gen, FIRST_ROUNDS,
                            selection)
    params = readings.thetas[-1].clone()
    sync(device)
    setup_s = time.perf_counter() - t_start

    spans = program.Spans(sync=True, device=device) if trace else None
    originals = program.record_layers(engine, spans) if trace else None
    before = counters(cell)
    params, round_s, window_s, failed = window(engine, params, gen, seconds,
                                               spans)
    checks = (launch_checks(cell, before, len(round_s))
              if device.type == "cuda" else {})
    profiled = None
    if trace and device.type == "cuda":
        program.restore_layers(engine, originals)
        program.record_layers(engine, None)  # labels, no synchronisation
        rounds = max(1, min(PROFILE_MAX_ROUNDS,
                            math.ceil(PROFILE_S / min(round_s))))
        state = {"params": params}

        def one_round():
            state["params"], m = engine.run_round(state["params"], gen)
            float(m["client_loss_mean"])

        profiled = capture(one_round, rounds)
        labelled = capture(one_round, 1, host=True)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    del engine, params
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks.update(compare(cell, fed, readings, device))
    limits = dict(cell.limits)
    limits.update({k: 0.0 for k in checks if k.endswith("_launch_gap")})
    correct, judged = correctness.judge(checks, limits)

    ctx = Context(cell, setup_s, window_s, round_s, spans, profiled)
    metrics = (read_metrics(cell.per_layer, "metrics", ctx) if trace
               else read_metrics(cell.end_to_end, "end_to_end", ctx))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(round_s),
              "failed": failed, "metrics": metrics, "device": dev}
    if profiled is not None:
        dev["busy_s"] = profiled.busy_s()
        dev["window_s"] = profiled.window_s
        result["breakdown"] = breakdown(profiled, labelled)
    result["rounds"] = {"window": len(round_s), "first": FIRST_ROUNDS,
                        "profiled": profiled.rounds if profiled else 0}
    result["checks"] = {name: {"value": finite(c["value"]),
                               "limit": finite(c["limit"])}
                        for name, c in judged.items()}
    return result


def finite(x: float):
    return x if math.isfinite(x) else None


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def use_checkout_caches() -> None:
    for var, sub in CACHE_DIRS.items():
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is visible: no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible: no result",
              file=sys.stderr)
        return 3
    use_checkout_caches()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    result["card"] = card_line()
    print(f"card: {result['card']}; rounds in the window: "
          f"{result['rounds']['window']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks  # the last key
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
