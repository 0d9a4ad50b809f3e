#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives the port (``multimodal_fl_security_tpu_torch``, no JAX) through its
paths and fails loudly on anything wrong. Phases, in order:

1. Device: a CUDA card of compute capability 9.0; prints its name and
   power limit as ``nvidia-smi`` reports them. TF32 is switched off for
   matmuls and convolutions, so f32 comparisons are f32.
2. Build: compiles ``csrc/gram.cu`` and ``csrc/sorted_reduce.cu`` with nvcc
   for sm_90a, both at once (timed; registers, shared memory and spills).
3. Gram kernel against its plain version at the main path's
   [100, 421,642] and at ragged shapes. Requires max|G_kernel - G_plain|
   <= 1e-5 * max|G_plain|, the same Krum pick from both, and two kernel
   calls bitwise equal; times both with CUDA events.
4. Sorted-reduce kernel against its plain version (``torch.sort``, then a
   row pick or a mean) at [100, 421,642], at ragged shapes from [1, 1000]
   to [1024, 2049], and at [100, 8,000,000], in both modes (trim 10 at
   C=100). Requires the median equal, the trimmed mean within
   1e-6 * max|U|, two calls bitwise equal, and NaN / +-inf ordered as
   ``torch.sort`` orders them; times both with CUDA events.
5. Krum north star: ``bench.build_engine("cuda")`` at the full constants
   (100 clients x 600 samples, batch 32, 2 local epochs, Krum f=20, bf16
   compute); one warm-up round and 3 timed rounds. Requires finite losses,
   one Gram launch per round, and test accuracy > 0.5 (chance is 0.1).
6. Robust rounds at the same width, clients 0..19 malicious: R1 ALIE +
   trimmed mean (1 warm-up and 3 timed rounds), R2 IPM + median, R3
   scaling + geometric median, R4 min_max + Bulyan (2 rounds each).
   Requires finite losses and parameters, one sorted-reduce launch per
   round (and one Gram launch per round in R4), the first round's
   aggregate through the kernels equal to the plain versions' on the same
   update matrix, and test accuracy > 0.5 after R1 and R2.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then non-zero and the last line is never printed.
"""

from __future__ import annotations

import json
import math
import time
from concurrent.futures import ThreadPoolExecutor

import torch

GRAM_SOURCE = "multimodal_fl_security_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "multimodal_fl_security_tpu/ops/pallas_kernels.py:72"
SORT_SOURCE = "multimodal_fl_security_tpu_torch/csrc/sorted_reduce.cu"
SORT_REPLACES = "multimodal_fl_security_tpu/ops/pallas_kernels.py:182"
MAIN_SHAPE = (100, 421_642)
RAGGED_SHAPES = [(7, 1000), (65, 4099), (130, 3001)]
SORT_RAGGED_SHAPES = [(1, 1000), (2, 1000), (7, 1000), (65, 4099),
                      (128, 3001), (130, 3001), (1024, 2049)]
SORT_BIG_SHAPE = (100, 8_000_000)  # the JAX record's (docs/performance.md)
REL_TOL = 1e-5
SORT_REL_TOL = 1e-6  # trimmed mean: f32 sums in another order
GEOMED_REL_TOL = 1e-5
NUM_MALICIOUS = 20
#: (run, defense, its config, attack, its config, warm-up rounds, rounds)
ROBUST_RUNS = [
    ("R1", "trimmed_mean", {"trim_ratio": 0.1},
     "alie", {"num_malicious": NUM_MALICIOUS}, 1, 3),
    ("R2", "median", {}, "ipm", {"epsilon": 0.1, "use_benign_mean": True},
     0, 2),
    ("R3", "geometric_median", {"max_iters": 100, "tol": 1e-5},
     "scaling", {"scale": 10.0}, 0, 2),
    ("R4", "bulyan", {"num_malicious": NUM_MALICIOUS},
     "min_max", {"perturbation": "std"}, 0, 2),
]
MIN_ACCURACY = {"R1": 0.5, "R2": 0.5}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    from multimodal_fl_security_tpu_torch.bench import nvidia_smi_line

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}, capability {cap[0]}.{cap[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(nvidia_smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from multimodal_fl_security_tpu_torch.ops import _build, gram, sorted_reduce

    def build(name):
        t0 = time.perf_counter()
        path, log = _build.build(name)
        return path, log, time.perf_counter() - t0

    # One nvcc per source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = list(pool.map(build, ["gram", "sorted_reduce"]))
    gram._library()
    sorted_reduce._library()
    for path, log, seconds in builds:
        print(f"[build] {path.name} in {seconds:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function prop" in line:
                print(f"[build] {line.strip()}")
    print(f"[build] both kernels in {time.perf_counter() - t0:.2f} s")


def krum_pick(g: torch.Tensor) -> int:
    from multimodal_fl_security_tpu_torch.defenses.krum import KrumDefense
    from multimodal_fl_security_tpu_torch.ops.gram import sq_dists_from_gram

    c = g.shape[0]
    krum = KrumDefense({"num_malicious": min(20, (c - 3) // 2)})
    scores = krum.scores_from_dists(torch.sqrt(sq_dists_from_gram(g)))
    return int(torch.argsort(scores, stable=True)[0])


def time_ms(fn, u: torch.Tensor, iters: int = 20) -> float:
    """Mean milliseconds per call, CUDA-event timed after a warm-up."""
    for _ in range(3):
        fn(u)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(u)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel() -> dict:
    from multimodal_fl_security_tpu_torch.models import create_model, init_model
    from multimodal_fl_security_tpu_torch.ops.gram import gram, gram_plain

    gen = torch.Generator("cuda").manual_seed(0)
    # Main path's shape and kind of input: near-identical parameter vectors.
    base = init_model(create_model("simple_cnn"), in_channels=1, seed=0,
                      device="cuda")
    inputs = [base + 0.01 * torch.randn(MAIN_SHAPE, generator=gen,
                                        device="cuda")]
    inputs += [torch.randn(s, generator=gen, device="cuda")
               for s in RAGGED_SHAPES]
    main_err = None
    for u in inputs:
        g = gram(u)
        g_again = gram(u)
        g_plain = gram_plain(u)
        g_f64 = gram_plain(u.double())
        torch.cuda.synchronize()
        err = float((g - g_plain).abs().max())
        scale = float(g_plain.abs().max())
        err_f64 = float((g.double() - g_f64).abs().max())
        plain_f64 = float((g_plain.double() - g_f64).abs().max())
        print(f"[kernel] gram {tuple(u.shape)}: max|kernel-plain| {err:.6g} "
              f"(tolerance {REL_TOL} * max|G| = {REL_TOL * scale:.6g}); "
              f"vs f64: kernel {err_f64:.6g}, plain {plain_f64:.6g}")
        if not err <= REL_TOL * scale:
            raise AssertionError(
                f"gram kernel disagrees at {tuple(u.shape)}: {err} > "
                f"{REL_TOL} * {scale}")
        if not torch.equal(g, g_again):
            raise AssertionError(f"gram kernel not bitwise reproducible at "
                                 f"{tuple(u.shape)}")
        if u.shape[0] >= 5 and krum_pick(g) != krum_pick(g_plain):
            raise AssertionError(f"Krum picks differ at {tuple(u.shape)}")
        if main_err is None:
            main_err = err

    u = inputs[0]
    # In turns: plain, kernel, kernel, plain.
    plain_a = time_ms(gram_plain, u)
    kern_a = time_ms(gram, u)
    kern_b = time_ms(gram, u)
    plain_b = time_ms(gram_plain, u)
    ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    print(f"[kernel] gram {MAIN_SHAPE}: kernel {kern_a:.4f} / {kern_b:.4f} ms,"
          f" plain {plain_a:.4f} / {plain_b:.4f} ms")
    return {"name": "gram", "route": "cuda", "source": GRAM_SOURCE,
            "replaces": GRAM_REPLACES, "max_abs_err": main_err,
            "ms": ms, "plain_ms": plain_ms}


def sort_trim(c: int) -> int:
    """Rows trimmed per end at C: 10 at C=100, as trimmed_mean's 0.1 gives."""
    return min(max(1, c // 10), (c - 1) // 2)


def check_sorted_reduce(u: torch.Tensor, mode: str, trim: int) -> float:
    """Kernel against plain on ``u``; returns max|kernel - plain|."""
    from multimodal_fl_security_tpu_torch.ops.sorted_reduce import (
        sorted_reduce,
        sorted_reduce_plain,
    )

    got = sorted_reduce(u, mode, trim)
    again = sorted_reduce(u, mode, trim)
    want = sorted_reduce_plain(u, mode, trim)
    torch.cuda.synchronize()
    shape = tuple(u.shape)
    err = float((got - want).abs().max())
    scale = float(u.abs().max())
    if not torch.equal(got, again):
        raise AssertionError(f"sorted_reduce {mode} not bitwise reproducible "
                             f"at {shape}")
    if mode == "median" and not torch.equal(got, want):
        raise AssertionError(f"sorted_reduce median differs from torch.sort's "
                             f"at {shape}: max err {err}")
    if mode == "trimmed" and not err <= SORT_REL_TOL * scale:
        raise AssertionError(f"sorted_reduce trimmed mean disagrees at {shape}:"
                             f" {err} > {SORT_REL_TOL} * {scale}")
    print(f"[kernel] sorted_reduce {mode} {shape} trim {trim}: "
          f"max|kernel-plain| {err:.6g} (max|U| {scale:.6g})")
    return err


def phase_sorted_reduce_kernel() -> dict:
    from multimodal_fl_security_tpu_torch.models import create_model, init_model
    from multimodal_fl_security_tpu_torch.ops.sorted_reduce import (
        sorted_reduce,
        sorted_reduce_plain,
    )

    gen = torch.Generator("cuda").manual_seed(1)
    base = init_model(create_model("simple_cnn"), in_channels=1, seed=0,
                      device="cuda")
    main = base + 0.01 * torch.randn(MAIN_SHAPE, generator=gen, device="cuda")
    errs = {mode: check_sorted_reduce(main, mode, 10)
            for mode in ("median", "trimmed")}
    # Against f64 sums: how far each side's f32 trimmed mean is from exact.
    exact = sorted_reduce_plain(main.double(), "trimmed", 10)
    for name, fn in (("kernel", sorted_reduce), ("plain", sorted_reduce_plain)):
        e = float((fn(main, "trimmed", 10).double() - exact).abs().max())
        print(f"[kernel] sorted_reduce trimmed {MAIN_SHAPE}: {name} vs f64 "
              f"{e:.6g}")
    del exact
    for shape in SORT_RAGGED_SHAPES:
        u = torch.randn(shape, generator=gen, device="cuda")
        u[: shape[0] // 4] = u[0]  # ties, as colluders make them
        for mode in ("median", "trimmed"):
            check_sorted_reduce(u, mode, sort_trim(shape[0]))

    # NaN and +-inf: the kernel must order them as torch.sort does.
    u = torch.randn((9, 33), generator=gen, device="cuda")
    u[torch.rand(u.shape, generator=gen, device="cuda") < 0.2] = math.nan
    u[torch.rand(u.shape, generator=gen, device="cuda") < 0.1] = math.inf
    u[torch.rand(u.shape, generator=gen, device="cuda") < 0.1] = -math.inf
    u[:, 0] = math.nan  # a column of NaN only
    u[:5, 1] = math.nan  # 5 of 9 NaN: the median row is a NaN
    u[:5, 2] = math.inf  # 5 of 9 +inf: the median row is +inf
    got = sorted_reduce(u, "median")
    want = torch.sort(u, dim=0).values[4]
    if not (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num())):
        raise AssertionError("sorted_reduce orders NaN / inf unlike torch.sort")
    print(f"[kernel] sorted_reduce NaN/inf [9, 33]: median as torch.sort's "
          f"({int(got.isnan().sum())} NaN, {int(got.isinf().sum())} inf)")

    times = {}
    for shape, iters in ((MAIN_SHAPE, 20), (SORT_BIG_SHAPE, 5)):
        u = main if shape == MAIN_SHAPE else torch.randn(
            shape, generator=gen, device="cuda")
        if shape == SORT_BIG_SHAPE:
            for mode in ("median", "trimmed"):
                check_sorted_reduce(u, mode, 10)
        for mode in ("median", "trimmed"):
            def kern(x, mode=mode):
                return sorted_reduce(x, mode, 10)

            def plain(x, mode=mode):
                return sorted_reduce_plain(x, mode, 10)

            # In turns: plain, kernel, kernel, plain.
            plain_a = time_ms(plain, u, iters)
            kern_a = time_ms(kern, u, iters)
            kern_b = time_ms(kern, u, iters)
            plain_b = time_ms(plain, u, iters)
            times[shape, mode] = ((kern_a + kern_b) / 2, (plain_a + plain_b) / 2)
            print(f"[kernel] sorted_reduce {mode} {shape}: kernel "
                  f"{kern_a:.4f} / {kern_b:.4f} ms, plain {plain_a:.4f} / "
                  f"{plain_b:.4f} ms")
        del u
    torch.cuda.empty_cache()
    ms, plain_ms = times[MAIN_SHAPE, "trimmed"]
    return {"name": "sorted_reduce", "route": "cuda", "source": SORT_SOURCE,
            "replaces": SORT_REPLACES, "max_abs_err": errs["trimmed"],
            "ms": ms, "plain_ms": plain_ms}


def phase_main_path() -> int:
    from multimodal_fl_security_tpu_torch.bench import (
        build_engine,
        result_line,
        time_rounds,
    )
    from multimodal_fl_security_tpu_torch.ops.gram import gram
    from multimodal_fl_security_tpu_torch.utils.metrics import evaluate_model

    t0 = time.perf_counter()
    engine, params, test_set = build_engine("cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    print(f"[main] built the 100-client engine in "
          f"{time.perf_counter() - t0:.2f} s (D={params.numel()})")

    gram.launches = 0
    t0 = time.perf_counter()
    params, warm = engine.run_round(params, gen)
    torch.cuda.synchronize()
    print(f"[main] warm-up round {time.perf_counter() - t0:.3f} s")
    n_rounds = 3
    params, seconds, metrics = time_rounds(engine, params, gen, n_rounds)
    launches = gram.launches

    losses = [float(m["client_loss_mean"]) for m in [warm] + metrics]
    picks = [int(m["selected_first"]) for m in [warm] + metrics]
    print(f"[main] {n_rounds} rounds in {seconds:.3f} s; client_loss_mean "
          f"{losses}; Krum picks {picks}; gram launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite client loss: {losses}")
    if launches != 1 + n_rounds:
        raise AssertionError(
            f"expected one gram launch per round ({1 + n_rounds}), "
            f"counted {launches}")
    if params.shape != (MAIN_SHAPE[1],) or not bool(torch.isfinite(params).all()):
        raise AssertionError("the new global parameters are not finite "
                             f"[{MAIN_SHAPE[1]}] values")
    ev = evaluate_model(engine.model, params, test_set)
    print(f"[main] test accuracy {ev['accuracy']:.4f}, loss {ev['loss']:.4f} "
          f"after {1 + n_rounds} rounds")
    if not ev["accuracy"] > 0.5:
        raise AssertionError(f"test accuracy {ev['accuracy']} <= 0.5")
    print(json.dumps(result_line(n_rounds, seconds)))
    return launches


class FirstUpdates:
    """A defense that keeps a copy of the first update matrix it is given."""

    def __init__(self, defense):
        self.defense = defense
        self.updates = None

    def aggregate_with_aux(self, updates, weights, ctx=None):
        if self.updates is None:
            self.updates = updates.clone()
        return self.defense.aggregate_with_aux(updates, weights, ctx)


def check_aggregate(run: str, defense, u: torch.Tensor,
                    weights: torch.Tensor) -> None:
    """The defense's aggregate of ``u`` through the kernels against the
    plain versions' on the same matrix (launches here are not counted)."""
    from multimodal_fl_security_tpu_torch.ops.gram import (
        gram_plain,
        sq_dists_from_gram,
    )
    from multimodal_fl_security_tpu_torch.ops.reductions import (
        coordinate_median,
        weiszfeld,
    )
    from multimodal_fl_security_tpu_torch.ops.sorted_reduce import (
        sorted_reduce_plain,
    )

    scale = float(u.abs().max())
    if defense.name == "geometric_median":
        y, iters = weiszfeld(u, coordinate_median(u), defense.max_iters,
                             defense.tol)
        y_plain, iters_plain = weiszfeld(u, sorted_reduce_plain(u, "median"),
                                         defense.max_iters, defense.tol)
        err = float((y - y_plain).abs().max())
        print(f"[robust] {run} Weiszfeld iterations on the first round's U: "
              f"{iters} (plain start: {iters_plain})")
        tol = GEOMED_REL_TOL * scale
    else:
        agg, aux = defense.aggregate_with_aux(u, weights)
        if defense.name == "median":
            plain = sorted_reduce_plain(u, "median")
            tol = 0.0
        elif defense.name == "trimmed_mean":
            trim = max(1, int(u.shape[0] * defense.trim_ratio))
            plain = sorted_reduce_plain(u, "trimmed", trim)
            tol = SORT_REL_TOL * scale
        else:  # bulyan
            f = defense.num_malicious
            selected = defense.select_from_dists(
                torch.sqrt(sq_dists_from_gram(gram_plain(u))))
            mask = torch.zeros_like(aux["selected_mask"])
            mask[selected] = 1.0
            if not torch.equal(mask, aux["selected_mask"]):
                raise AssertionError(f"{run}: Bulyan selects other clients "
                                     "through the Gram kernel than through "
                                     "the plain Gram")
            plain = sorted_reduce_plain(u.index_select(0, selected),
                                        "trimmed", f)
            tol = SORT_REL_TOL * scale
        err = float((agg - plain).abs().max())
        if defense.name == "median" and not torch.equal(agg, plain):
            raise AssertionError(f"{run}: the median differs from the plain "
                                 f"version's (max err {err})")
    print(f"[robust] {run} {defense.name} on the first round's U: "
          f"max|kernels-plain| {err:.6g} (tolerance {tol:.6g})")
    if not err <= tol:
        raise AssertionError(f"{run}: {defense.name} disagrees with its plain "
                             f"version: {err} > {tol}")


def phase_robust_rounds() -> dict:
    """R1-R4 at full width; returns each kernel's launches over the runs."""
    from multimodal_fl_security_tpu_torch.bench import (
        build_engine,
        result_line,
        time_rounds,
    )
    from multimodal_fl_security_tpu_torch.ops.gram import gram
    from multimodal_fl_security_tpu_torch.ops.sorted_reduce import sorted_reduce
    from multimodal_fl_security_tpu_torch.utils.metrics import evaluate_model

    totals = {"gram": 0, "sorted_reduce": 0}
    low_accuracy = []
    for run, defense, dconf, attack, aconf, warm, n_rounds in ROBUST_RUNS:
        engine, params, test_set = build_engine(
            "cuda", defense=defense, defense_config=dconf, attack=attack,
            attack_config=aconf, num_malicious_clients=NUM_MALICIOUS)
        recorder = FirstUpdates(engine.defense)
        engine.defense = recorder
        gen = torch.Generator("cuda").manual_seed(0)
        torch.cuda.synchronize()

        gram.launches = 0
        sorted_reduce.launches = 0
        metrics = []
        for _ in range(warm):
            params, m = engine.run_round(params, gen)
            metrics.append(m)
        params, seconds, timed = time_rounds(engine, params, gen, n_rounds)
        launches = {"gram": gram.launches,
                    "sorted_reduce": sorted_reduce.launches}
        metrics += timed

        rounds = warm + n_rounds
        losses = [float(m["client_loss_mean"]) for m in metrics]
        print(f"[robust] {run} {attack} + {defense}: {rounds} rounds, "
              f"{n_rounds} timed in {seconds:.3f} s; client_loss_mean "
              f"{losses}; launches {launches}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{run}: non-finite client loss: {losses}")
        if params.shape != (MAIN_SHAPE[1],) or not bool(
                torch.isfinite(params).all()):
            raise AssertionError(f"{run}: the new global parameters are not "
                                 f"finite [{MAIN_SHAPE[1]}] values")
        want = {"gram": rounds if defense == "bulyan" else 0,
                "sorted_reduce": rounds}
        if launches != want:
            raise AssertionError(f"{run}: expected launches {want}, counted "
                                 f"{launches}")
        for name in totals:
            totals[name] += launches[name]

        check_aggregate(run, recorder.defense, recorder.updates, engine.counts)
        ev = evaluate_model(engine.model, params, test_set)
        print(f"[robust] {run} test accuracy {ev['accuracy']:.4f}, loss "
              f"{ev['loss']:.4f} after {rounds} rounds")
        if run in MIN_ACCURACY and not ev["accuracy"] > MIN_ACCURACY[run]:
            low_accuracy.append(f"{run}: test accuracy {ev['accuracy']} <= "
                                f"{MIN_ACCURACY[run]}")
        if run == "R1":
            print(json.dumps(result_line(
                n_rounds, seconds,
                metric="fl_rounds_per_min_100c_trimmed_mean_alie",
                with_gram=False)))
        del engine, recorder, params, test_set, metrics, timed
        torch.cuda.empty_cache()
    if low_accuracy:  # raised after every run has been driven and read
        raise AssertionError("; ".join(low_accuracy))
    return totals


def main() -> None:
    name = phase_device()
    phase_build()
    gram_row = phase_kernel()
    sort_row = phase_sorted_reduce_kernel()
    north_star = phase_main_path()
    robust = phase_robust_rounds()
    # Each path ran with the counts set to 0 just before it.
    gram_row["launches"] = north_star + robust["gram"]
    sort_row["launches"] = robust["sorted_reduce"]
    print(f"[paths] gram launches: {north_star} (Krum north star) + "
          f"{robust['gram']} (R4); sorted_reduce launches: "
          f"{robust['sorted_reduce']} (R1-R4)")
    print(json.dumps({"kernels": [gram_row, sort_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
