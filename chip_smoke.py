#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives the port (``multimodal_fl_security_tpu_torch``, no JAX) through its
main path and fails loudly on anything wrong. Phases, in order:

1. Device: a CUDA card of compute capability 9.0; prints its name and
   power limit as ``nvidia-smi`` reports them. TF32 is switched off for
   matmuls and convolutions, so f32 comparisons are f32.
2. Build: compiles ``csrc/gram.cu`` with nvcc for sm_90a (timed).
3. Kernel against its plain version: the centered Gram kernel against
   ``gram_plain`` at the main path's [100, 421,642] and at ragged shapes.
   Requires max|G_kernel - G_plain| <= 1e-5 * max|G_plain|, the same Krum
   pick from both, and two kernel calls bitwise equal; times both with
   CUDA events.
4. Main path: ``bench.build_engine("cuda")`` at the full north-star
   constants (100 clients x 600 samples, batch 32, 2 local epochs, Krum
   f=20, bf16 compute); one warm-up round and 3 timed rounds. Requires
   finite losses, one Gram launch per round, and test accuracy > 0.5
   (chance is 0.1).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then non-zero and the last line is never printed.
"""

from __future__ import annotations

import json
import math
import time

import torch

GRAM_SOURCE = "multimodal_fl_security_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "multimodal_fl_security_tpu/ops/pallas_kernels.py:72"
MAIN_SHAPE = (100, 421_642)
RAGGED_SHAPES = [(7, 1000), (65, 4099), (130, 3001)]
REL_TOL = 1e-5


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
    from multimodal_fl_security_tpu_torch.ops import _build, gram

    t0 = time.perf_counter()
    path, log = _build.build("gram")
    gram._library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


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


def main() -> None:
    name = phase_device()
    phase_build()
    gram_row = phase_kernel()
    gram_row["launches"] = phase_main_path()
    print(json.dumps({"kernels": [gram_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
