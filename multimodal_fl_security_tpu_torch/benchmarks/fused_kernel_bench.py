"""Check and time the port's fused local training on a CUDA card.

Counterpart of ``benchmarks/fused_kernel_bench.py`` of the JAX package:

- :func:`run_check`: C=4 clients x 64 rows (the last 8 masked), 8 input
  channels, f32 with TF32 off, 2 epochs, lr 0.05; the kernel path
  (``ops/fused_kernel.py::fused_local_train``) against the plain whole-loop
  oracle (``ops/fused_train.py::mirror_local_train``) within max abs 1e-4.
- :func:`run_bench`: the north-star width (100 clients x 600 real rows
  padded to 608, batch 32, 2 epochs = 38 SGD steps per client, bf16
  compute, lr 0.01, momentum 0.9, clip 1.0) on the port bench's 1-channel
  synthetic clients (``bench.build_engine``). It times four trainers on the
  same data, ms per call after ``torch.cuda.synchronize()``: the kernel
  path, the mirror, the engine's ``make_local_train_fn`` (shuffled, with
  dropout; on the card the one loop with the kernel step ``KernelStep`` and
  the round's draws) and the same loop with the autograd step
  (``rounds/engine.py::AutogradStep``, what the JAX bench compares
  against: the same round in plain PyTorch). It also counts the kernel path's launches per
  call by wrapper and by kernel (the conv and dense kernels,
  ``ops/_launch.py::KERNEL_LAUNCHES``), checks that two calls are bitwise
  equal, measures the drift from the mirror, and evaluates the FedAvg of
  the trained clients and of the engine's two trainers' on the bench's test
  set.
  With ``use_dropout`` the kernel path drops at rates 0.25 / 0.5 (Philox
  masks drawn in the kernel) and the mirror takes the plain generator's
  masks for the same seed; the bench adds the change that another seed
  makes and times the call without dropout beside it.
  ``run_check(use_dropout=True)`` holds the dropout path to the mirror in
  the same way.
- :func:`time_call`: one kernel-path call at the north-star width in a
  given compute dtype, timed alone with its launches by kernel. In f32,
  the experiments' default ("for strict parity", ``ExperimentConfig.
  compute_dtype`` of the JAX package), this is the call ``run_bench`` does
  not time.

Run on the card::

    python -m multimodal_fl_security_tpu_torch.benchmarks.fused_kernel_bench

prints the card's name and power limit and one JSON line per mode (the
f32 call after the bf16 bench); ``--profile`` adds :func:`profile_call`'s
lines: bf16 without and with dropout, then f32.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict

import torch

from multimodal_fl_security_tpu_torch.ops._launch import (
    kernel_launches,
    reset_kernel_launches,
)

CHECK_ATOL = 1e-4
LEARNING_RATE = 0.01
LOCAL_EPOCHS = 2


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_check(device="cuda", clients: int = 4, n: int = 64,
              in_channels: int = 8, use_dropout: bool = False,
              seed: int = 0) -> Dict:
    """The kernel path against the mirror at a small f32 shape; with
    ``use_dropout`` both drop with the masks of ``seed`` (the mirror's from
    the plain generator)."""
    from multimodal_fl_security_tpu_torch.models import create_model, init_model
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        fused_local_train,
    )
    from multimodal_fl_security_tpu_torch.ops.fused_train import (
        B,
        dropout_masks_plain,
        mirror_local_train,
    )

    gen = torch.Generator().manual_seed(0)
    images = torch.randn((clients, n, in_channels, 28, 28), generator=gen)
    labels = torch.randint(0, 10, (clients, n), generator=gen)
    mask = torch.ones((clients, n))
    mask[:, -8:] = 0.0
    images, labels, mask = (t.to(device) for t in (images, labels, mask))
    params = init_model(create_model("simple_cnn"), in_channels, seed=1,
                        device=device)
    kw = dict(learning_rate=0.05, momentum=0.9, clip_norm=1.0,
              local_epochs=2, compute_dtype=torch.float32)
    masks = dropout_masks_plain(seed, clients, B, 2 * n // B,
                                dtype=torch.float32, device=device) \
        if use_dropout else None
    reset_kernel_launches()
    with full_f32():
        got = fused_local_train(params, images, labels, mask,
                                use_dropout=use_dropout, seed=seed, **kw)
        _sync(device)
        launches = kernel_launches()
        want = mirror_local_train(params, images, labels, mask,
                                  dropout_masks=masks, **kw)
    _sync(device)
    err = float((got - want).abs().max())
    moved = float((want - params).abs().max())
    return {"mode": "check", "ok": bool(err <= CHECK_ATOL), "clients": clients,
            "use_dropout": use_dropout, "atol": CHECK_ATOL,
            "max_abs_err_vs_mirror": err, "max_param_move": moved,
            "kernel_launches": launches}


def _time_call(fn: Callable, device, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, host clock after
    ``torch.cuda.synchronize()``."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def logical_flops_per_call(clients: int, samples: int, epochs: int) -> float:
    """SimpleCNN's forward at 28x28x1 per real sample, backward ~2x forward,
    as ``bench.py`` counts it; padding rows are not counted."""
    conv1 = 2 * 3 * 3 * 1 * 32 * 28 * 28
    conv2 = 2 * 3 * 3 * 32 * 64 * 14 * 14
    fc1 = 2 * 3136 * 128
    fc2 = 2 * 128 * 10
    return 3.0 * (conv1 + conv2 + fc1 + fc2) * clients * epochs * samples


def run_bench(device="cuda", num_clients: int = 100, samples: int = 600,
              iters: int = 3, use_dropout: bool = False,
              seed: int = 0) -> Dict:
    """The four trainers at the north-star width, with dropout if asked;
    see the module doc."""
    from multimodal_fl_security_tpu_torch.bench import build_engine
    from multimodal_fl_security_tpu_torch.ops.client_dropout import RoundDraws
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        DROPOUT_STEP_KERNELS,
        LAUNCHES_PER_DROPOUT_STEP,
        LAUNCHES_PER_STEP,
        STEP_KERNELS,
        fused_local_train,
    )
    from multimodal_fl_security_tpu_torch.ops.fused_train import (
        B,
        dropout_masks_plain,
        mirror_local_train,
    )
    from multimodal_fl_security_tpu_torch.ops.reductions import weighted_mean
    from multimodal_fl_security_tpu_torch.rounds.engine import (
        AutogradStep,
        make_local_train_fn,
    )
    from multimodal_fl_security_tpu_torch.rounds.local_train import (
        train_clients,
    )
    from multimodal_fl_security_tpu_torch.utils.metrics import evaluate_model

    engine, params, test_set = build_engine(device, num_clients, samples)
    images, labels = engine.arrays["image"], engine.arrays["label"]
    mask = engine.mask
    steps = LOCAL_EPOCHS * (mask.shape[1] // B)
    kw = dict(learning_rate=LEARNING_RATE, momentum=0.9, clip_norm=1.0,
              local_epochs=LOCAL_EPOCHS, compute_dtype=torch.bfloat16)
    masks = dropout_masks_plain(seed, num_clients, B, steps,
                                device=device) if use_dropout else None
    counted = DROPOUT_STEP_KERNELS if use_dropout else STEP_KERNELS
    gen = torch.Generator(device).manual_seed(0)
    local_train = make_local_train_fn(engine.model, engine.spec,
                                      mask.shape[1])

    def kernel(drop=use_dropout, at_seed=seed):
        return fused_local_train(params, images, labels, mask,
                                 use_dropout=drop, seed=at_seed, **kw)

    def mirror():
        return mirror_local_train(params, images, labels, mask,
                                  dropout_masks=masks, **kw)

    def engine_trainer():
        return local_train(params, engine.arrays, mask, gen)[0]

    def autograd_trainer():
        step = AutogradStep(engine.model, engine.spec, params, num_clients)
        return train_clients(step, RoundDraws(gen, engine.model.dropout_rates),
                             images, labels, mask,
                             local_epochs=engine.spec.local_epochs,
                             batch_size=engine.spec.batch_size)[0]

    def fedavg(clients):
        return evaluate_model(engine.model,
                              weighted_mean(clients, engine.counts), test_set)

    # One counted call, then a second for the bitwise check.
    for fn in counted:
        fn.launches = 0
    reset_kernel_launches()
    out = kernel()
    _sync(device)
    launches = {fn.__name__: fn.launches for fn in counted}
    per_kernel = kernel_launches()
    again = kernel()
    ref = mirror()
    _sync(device)
    bitwise = bool(torch.equal(out, again))
    drift = float((out - ref).abs().max())
    finite = bool(torch.isfinite(out).all())
    ev = fedavg(out)
    extra = {}
    if use_dropout:
        extra["max_change_other_seed"] = float(
            (out - kernel(at_seed=seed + 1)).abs().max())
    del again, ref
    # The engine's two trainers, not yet run: their warm-up, and their
    # FedAvg accuracy (each drops at the model's rates from its own
    # generator).
    extra["engine_fedavg_accuracy"] = float(fedavg(engine_trainer())["accuracy"])
    extra["autograd_fedavg_accuracy"] = float(
        fedavg(autograd_trainer())["accuracy"])
    # In turns: kernel, mirror, engine, autograd, (without dropout twice),
    # kernel.
    kern_a = _time_call(kernel, device, iters)
    mirror_ms = _time_call(mirror, device, iters)
    engine_ms = _time_call(engine_trainer, device, iters)
    autograd_ms = _time_call(autograd_trainer, device, iters)
    if use_dropout:
        runs = [_time_call(lambda: kernel(drop=False), device, iters)
                for _ in range(2)]
        extra.update(no_dropout_ms=sum(runs) / 2, no_dropout_ms_runs=runs)
    kern_b = _time_call(kernel, device, iters)
    kernel_ms = (kern_a + kern_b) / 2
    flops = logical_flops_per_call(num_clients, samples, LOCAL_EPOCHS)
    per_step = LAUNCHES_PER_DROPOUT_STEP if use_dropout else LAUNCHES_PER_STEP
    return {
        "mode": "bench", "use_dropout": use_dropout, "clients": num_clients,
        "steps": steps, "kernel_ms": kernel_ms,
        "kernel_ms_runs": [kern_a, kern_b],
        "mirror_ms": mirror_ms, "engine_ms": engine_ms,
        "autograd_ms": autograd_ms,
        "ms_per_step": kernel_ms / steps,
        "launches": launches, "launches_total": sum(launches.values()),
        "kernel_launches": per_kernel,
        "launches_expected": per_step * steps,
        "bitwise_repeat": bitwise, "finite": finite,
        "max_drift_vs_mirror": drift,
        "fedavg_accuracy": float(ev["accuracy"]),
        "fedavg_loss": float(ev["loss"]),
        "logical_tflop": flops / 1e12,
        "logical_tflops_per_s": flops / (kernel_ms * 1e-3) / 1e12,
        **extra,
    }


def time_call(compute_dtype=torch.float32, device="cuda",
              num_clients: int = 100, samples: int = 600,
              iters: int = 3) -> Dict:
    """ms per kernel-path call in ``compute_dtype`` at the north-star width
    (the mean over ``iters`` calls, and each call's), after a warm-up call;
    the launches by kernel of one call, and whether its parameters are
    finite."""
    from multimodal_fl_security_tpu_torch.bench import build_engine
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        fused_local_train,
    )

    engine, params, _ = build_engine(device, num_clients, samples)
    kw = dict(learning_rate=LEARNING_RATE, momentum=0.9, clip_norm=1.0,
              local_epochs=LOCAL_EPOCHS, compute_dtype=compute_dtype)

    def call():
        return fused_local_train(params, engine.arrays["image"],
                                 engine.arrays["label"], engine.mask, **kw)

    call()  # warm-up: builds and loads the kernels
    _sync(device)
    reset_kernel_launches()
    out = call()
    _sync(device)
    launches = {k: v for k, v in kernel_launches().items() if v}
    runs = [_time_call(call, device, 1) for _ in range(iters)]
    return {"mode": "call", "compute_dtype": str(compute_dtype),
            "clients": num_clients, "ms_per_call": sum(runs) / iters,
            "ms_runs": runs, "kernel_launches": launches,
            "finite": bool(torch.isfinite(out).all())}


def profile_call(device="cuda", num_clients: int = 100, samples: int = 600,
                 top: int = 12, use_dropout: bool = False,
                 compute_dtype=torch.bfloat16) -> Dict:
    """``torch.profiler`` over one kernel-path call in ``compute_dtype`` at
    the north-star width (with dropout if asked), after a warm-up call: the
    device's busy time and idle share over the span of its events, the
    kernels launched, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multimodal_fl_security_tpu_torch.bench import build_engine
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        fused_local_train,
    )

    engine, params, _ = build_engine(device, num_clients, samples)
    kw = dict(learning_rate=LEARNING_RATE, momentum=0.9, clip_norm=1.0,
              local_epochs=LOCAL_EPOCHS, compute_dtype=compute_dtype,
              use_dropout=use_dropout)

    def call():
        return fused_local_train(params, engine.arrays["image"],
                                 engine.arrays["label"], engine.mask, **kw)

    call()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:  # the union of the events' intervals
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    span = spans[-1][1] - spans[0][0]
    by_name: Dict[str, float] = {}
    for e in events:  # "void (anonymous namespace)::k<...>(...)" -> "k"
        name = e.name.removeprefix("void ").removeprefix(
            "(anonymous namespace)::").split("(")[0].split("<")[0]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    copies = sum(1 for e in events if e.name.startswith(("Memcpy", "Memset")))
    return {"mode": "profile", "compute_dtype": str(compute_dtype),
            "use_dropout": use_dropout, "wall_ms": wall_ms,
            "device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span, "device_events": len(events),
            "kernel_launches": len(events) - copies,
            "by_kernel_ms": {name: us / 1e3 for name, us in ranked}}


def main() -> None:
    import argparse

    from multimodal_fl_security_tpu_torch.bench import nvidia_smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one kernel-path call, without and "
                         "with dropout, and one f32 call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the fused-training bench needs a CUDA device")
    print(nvidia_smi_line())
    print(json.dumps(run_check()), flush=True)
    print(json.dumps(run_bench()), flush=True)
    print(json.dumps(time_call(torch.float32)), flush=True)
    print(json.dumps(run_check(use_dropout=True)), flush=True)
    print(json.dumps(run_bench(use_dropout=True)), flush=True)
    if args.profile:
        for use_dropout in (False, True):
            print(json.dumps(profile_call(use_dropout=use_dropout)),
                  flush=True)
        print(json.dumps(profile_call(compute_dtype=torch.float32)),
              flush=True)


if __name__ == "__main__":
    main()
