#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives the port (``multimodal_fl_security_tpu_torch``, no JAX) through its
paths and fails loudly on anything wrong. Phases, in order:

1. Device: a CUDA card of compute capability 9.0; prints its name and
   power limit as ``nvidia-smi`` reports them. TF32 is switched off for
   matmuls and convolutions, so f32 comparisons are f32.
2. Build: compiles every ``csrc/*.cu`` with nvcc for sm_90a, one process
   each, all at once (timed; registers, shared memory and spills); requires
   HMMA/HGMMA instructions in the SASS of every tensor-core kernel
   (``TC_KERNELS``, each instantiation: the Gram's and K3's wgmma kernels,
   the bf16 forward, the conv gradients and fc1's forward and backward, and
   the f32 path's 3xTF32 kernels: HGMMA in ``stem_raw_tf32`` and
   ``conv2_dgrad_tf32``, HMMA in ``conv2_fwd_tf32``, ``conv2_wgrad_tf32``
   and ``stem_wgrad_tf32`` (both sparse mma), ``dense_fwd_tf32`` and
   ``dense_bwd_tf32``).
3. Gram kernel (3xTF32 on the tensor cores) against its plain version at
   the main path's [100, 421,642], with its first 20 rows scaled x10 (the
   scaling attack), at ragged shapes and at [100, 8,000,000]. Requires
   max|G_kernel - G_plain| <= 1e-5 * max|G_plain|, the same Krum pick from
   both, two kernel calls bitwise equal and G symmetric; prints both
   errors against an f64 Gram; times kernel and plain with CUDA events at
   [100, 421,642] and [100, 8M] beside ``torch.mm`` of the centered U, and
   ``torch.mean``'s share of ``gram()``.
4. Sorted-reduce kernel against its plain version (``torch.sort``, then a
   row pick or a mean) at [100, 421,642], at ragged shapes from [1, 1000]
   to [1024, 2049], at [100, 8,000,000] (trim 10 at C=100) and at the
   ResNet-50 cell's [20, 23,917,832] (trim 2), in both modes. Requires
   the median equal, the trimmed mean within 1e-6 * max|U|, two calls
   bitwise equal, and NaN / +-inf ordered as ``torch.sort`` orders them;
   times both with CUDA events.
5. Krum north star: ``bench.build_engine("cuda")`` at the full constants
   (100 clients x 600 samples, batch 32, 2 local epochs, Krum f=20, bf16
   compute); one warm-up round and 3 timed rounds. Requires finite losses,
   one Gram launch per round, and test accuracy > 0.5 (chance is 0.1).
6. Robust rounds at the same width, clients 0..19 malicious: R1 ALIE +
   trimmed mean (1 warm-up and 3 timed rounds), R2 IPM + median, R3
   scaling + geometric median, R4 min_max + Bulyan (2 rounds each), in
   bf16, and R5, R1's round in f32 (the benchmark's trimmed cell; 2
   rounds). Requires finite losses and parameters, one sorted-reduce
   launch per round (and one Gram launch per round in R4), the first
   round's aggregate through the kernels equal to the plain versions' on
   the same update matrix, and test accuracy > 0.5 after R1 and R2. Local
   training runs the engine's kernel step
   (``ops/fused_kernel.py::KernelStep``), counted in every run: 16
   launches a step by wrapper (``DRAWN_DROPOUT_STEP_KERNELS``: 4 of them
   ``drawn_dropout``) and by kernel those of the run's dtype (as in 7b and
   7c). These counts are the launches of the kernels line's
   local-training rows.

7. Fused local training (the K3/K4 slice), at the north star's width:
   (a) each kernel of ``csrc/client_conv.cu``, ``client_dense.cu`` and
   ``client_sgd.cu`` against its plain version on one step's real
   activations ([100, 32, 1, 28, 28] images; conv2, fc1 and fc2 forward
   and backward; CE; SGD at [100, 421,642]), in f32 with TF32 off (max
   |kernel - plain| <= 1e-5 * max|plain|; the stem's and conv2's forward,
   the weight gradients, conv2's input gradient and fc1's forward and
   backward, on ``stem_fwd_f32``, ``conv2_fwd_tf32``, ``stem_wgrad_tf32``,
   ``conv2_wgrad_tf32``, ``conv2_dgrad_tf32``, ``dense_fwd_tf32`` and
   ``dense_bwd_tf32``, are
   held at that tolerance to the exact (f64) results instead, their errors
   there to at most 4x the f32 plain versions', and their distances from
   the plain versions printed) and in
   bf16 (<= 1e-2 * max|plain|, one rounding apart; the forward convs, fc1's
   forward and backward and the conv gradients on the tensor-core kernels;
   each pooled conv's argmax equal to the plain version's wherever its window gap exceeds that tolerance,
   and agreeing on > 0.99 of all outputs),
   timed in turns with CUDA events beside the one PyTorch call that
   computes the same product (cuDNN, ``baddbmm``, TF32 off; three timings
   of it in the same turns, the median kept, the spread printed): conv2's
   forward and
   gradient kernels in both dtypes, the stem's weight gradient in f32
   (``stem_wgrad_tf32``, held to f64 like conv2's), the stem's forward
   also in f32 (``stem_fwd_f32``), fc1's f32 forward and backward
   (``dense_fwd_tf32``, ``dense_bwd_tf32``), fc2's forward and backward in
   the bf16 path's kernels, the rest in bf16, the stem's bf16 weight gradient
   with its library call and bound; f32 bounds count operations at the
   3xTF32 rate and print the f32 CUDA-core figure beside them;
   fc1's and fc2's backward beside the two ``torch.bmm`` and the sum that
   compute the same outputs (a reference, not a single library call);
   (b) ``fused_kernel_bench.run_check()`` (kernel path against
   ``mirror_local_train`` within 1e-4 at f32; per step 1 each of
   ``stem_fwd_f32``, ``conv2_fwd_tf32``, ``stem_wgrad_tf32``,
   ``conv2_wgrad_tf32``, ``conv2_dgrad_tf32``, ``dense_fwd_tf32`` and
   ``dense_bwd_tf32``, fc2 on the CUDA-core kernels, no ``conv_fwd``);
   (c)
   ``run_bench()`` at full width in
   bf16:
   finite parameters, 12 launches per step x 38 steps, by kernel 38 each
   on ``conv2_fwd_tc``, ``stem_fwd_tc``, ``dense_fwd_tc``,
   ``dense_bwd_tc`` and fc2's ``dense_fwd`` and ``dense_bwd``, 76 + 38 on
   the conv gradients' tensor-core kernels, two calls
   bitwise equal, FedAvg test accuracy > 0.5; prints the kernel path's,
   the mirror's, the engine trainer's and the autograd trainer's ms per
   call; then one f32
   ``fused_local_train`` call on the same clients
   (``fused_kernel_bench.time_call``), timed with its launches by kernel
   (38 each of ``stem_fwd_f32``, ``conv2_fwd_tf32``, ``dense_fwd_tf32``,
   ``dense_bwd_tf32``, and of ``dense_fwd`` and ``dense_bwd`` for fc2);
   (d) K3, the raw stem conv, at [100, 32, 28*28*8] x [100, 4, 4, 8, 128],
   in each dtype: its path (one ``client_stem_conv`` call, counted: one
   ``stem_raw_tc`` launch in bf16, one ``stem_raw_tf32`` in f32), held to
   ``client_stem_conv_plain`` at the tolerances of (a) (in f32 also its
   error against f64 to at most 4x the plain's), bitwise on repeat and, on
   small integers, bitwise the plain version; times beside grouped
   ``F.conv2d`` (three timings, the median kept); then one f32 K3 call off
   K3's geometry (one input channel, [100, 32, 28*28] x [100, 4, 4, 1,
   128]), its path one ``conv_fwd`` launch (the CUDA-core raw kernel), held
   to the plain version, timed the same way.
8. The Mosaic probe set (K5): ``benchmarks/mosaic_probe.run_probes()``,
   every probe's kernel path against its plain version (layout, generator
   and carried sums bitwise, the rest within the JAX probe's tolerance);
   each contraction shape's split over k (phases 8 and 9); then each
   probe's kernel and plain times in turns (CUDA events), each contraction
   probe's ``torch.matmul`` / ``torch.einsum`` of its own function (median
   of three), and per kernel the one PyTorch call that computes the same
   function, where there is one; then each such kernel against that call
   in 5 rounds of turns: the factor's median and range; for ``max2`` and
   ``carry_sum`` (and their library calls) the device time of one launch
   and the host time of one call, apart
   (``benchmarks/launch_split.py``).
9. The autodiff probe set (K6): ``benchmarks/ad_in_kernel_probe.
   run_probes()``, every probe's gradient through the hand-written backward
   kernels against ``torch.autograd`` of the plain body, at the JAX probe's
   tolerance; times of both, and of the backward-only kernels (also in 5
   rounds of turns against their plain versions).
10. K4's dropout: the dropout kernel against its plain version (bitwise,
   [100, 32, 3136] and [100, 32, 128], f32 and bf16); the kernel step's
   ``drawn_dropout`` against ``drawn_dropout_plain`` on the same x and
   drawn uniforms u at the round's shapes and keeps ([100, 32, 3136] at
   0.75, [100, 32, 128] at 0.5, f32 and bf16; bitwise), timed in turns
   beside the plain version with its bound (x and u read, y written);
   ``run_check(use_dropout=True)`` (C=4, f32, against the mirror fed the
   plain generator's masks, within 1e-4); ``run_bench(use_dropout=True)``
   at full width in bf16: 16 launches per step x 38 steps (by kernel as in
   7c), a bitwise repeat with the same seed,
   another result with another seed, finite parameters, FedAvg test
   accuracy > 0.3, the drift from the mirror fed the same masks, and ms per
   call beside the call without dropout.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then non-zero and the last line is never printed.
"""

from __future__ import annotations

import json
import math
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

GRAM_SOURCE = "multimodal_fl_security_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "multimodal_fl_security_tpu/ops/pallas_kernels.py:72"
SORT_SOURCE = "multimodal_fl_security_tpu_torch/csrc/sorted_reduce.cu"
SORT_REPLACES = "multimodal_fl_security_tpu/ops/pallas_kernels.py:182"
MAIN_SHAPE = (100, 421_642)
RAGGED_SHAPES = [(7, 1000), (65, 4099), (130, 3001)]
GRAM_BIG_SHAPE = (100, 8_000_000)  # the aggregation cells' scale
SCALED_ROWS = 20  # rows scaled x10 in one Gram input (R3's attack)
SORT_RAGGED_SHAPES = [(1, 1000), (2, 1000), (7, 1000), (65, 4099),
                      (128, 3001), (130, 3001), (1024, 2049)]
SORT_BIG_SHAPE = (100, 8_000_000)  # the JAX record's (docs/performance.md)
#: the ResNet-50 cell's trimmed mean: 20 clients, D = 23,917,832, trim 2
SORT_RESNET_SHAPE = (20, 23_917_832)
SORT_RESNET_TRIM = 2
REL_TOL = 1e-5
SORT_REL_TOL = 1e-6  # trimmed mean: f32 sums in another order
GEOMED_REL_TOL = 1e-5
NUM_MALICIOUS = 20
#: (run, defense, its config, attack, its config, warm-up rounds, rounds,
#: compute dtype)
ROBUST_RUNS = [
    ("R1", "trimmed_mean", {"trim_ratio": 0.1},
     "alie", {"num_malicious": NUM_MALICIOUS}, 1, 3, torch.bfloat16),
    ("R2", "median", {}, "ipm", {"epsilon": 0.1, "use_benign_mean": True},
     0, 2, torch.bfloat16),
    ("R3", "geometric_median", {"max_iters": 100, "tol": 1e-5},
     "scaling", {"scale": 10.0}, 0, 2, torch.bfloat16),
    ("R4", "bulyan", {"num_malicious": NUM_MALICIOUS},
     "min_max", {"perturbation": "std"}, 0, 2, torch.bfloat16),
    ("R5", "trimmed_mean", {"trim_ratio": 0.1},
     "alie", {"num_malicious": NUM_MALICIOUS}, 0, 2, torch.float32),
]
MIN_ACCURACY = {"R1": 0.5, "R2": 0.5}
#: H100 SXM data sheet, dense, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12  # the tensor cores' TF32 rate
F32_CORE_FLOPS = 67e12  # f32 outside the tensor cores
#: an f32 function's operations count at the 3xTF32 rate (its kernels run
#: each f32 product as three TF32 ones on the tensor cores, or could)
PEAK_FLOPS = {torch.float32: TF32_FLOPS / 3, torch.bfloat16: 989e12}
#: each local-training kernel's source, by its wrapper's name prefix
FUSED_SOURCES = {prefix: f"multimodal_fl_security_tpu_torch/csrc/{src}.cu"
                 for prefix, src in (("conv", "client_conv"),
                                     ("conv2", "client_conv"),
                                     ("stem", "client_conv"),
                                     ("dense", "client_dense"),
                                     ("client", "client_sgd"))}
K3_REPLACES = "multimodal_fl_security_tpu/ops/client_conv.py:97"
K3_SOURCE = "multimodal_fl_security_tpu_torch/csrc/client_stem_raw.cu"
K4_REPLACES = "multimodal_fl_security_tpu/ops/fused_kernel.py:307"
#: max|kernel - plain| allowed over max|plain|: f32 with TF32 off (the same
#: products summed in another order) and bf16 (outputs one rounding apart)
FUSED_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: a 3xTF32 kernel's error against f64 sums, at most this many times the f32
#: plain version's
F64_FACTOR = 4
FUSED_CHECK_ATOL = 1e-4
#: a pooled conv kernel's argmax must agree with its plain version's on more
#: than this share of outputs (near ties may route either way)
MIN_ARGMAX_AGREEMENT = 0.99
FUSED_MIN_ACCURACY = 0.5
DROPOUT_MIN_ACCURACY = 0.3
CSRC = "multimodal_fl_security_tpu_torch/csrc"
MOSAIC = "benchmarks/mosaic_probe.py"
AD_PROBE = "benchmarks/ad_in_kernel_probe.py"
#: each probe kernel's wrapper name: (source, the TPU kernel it replaces,
#: the probe whose shapes time it)
PROBE_KERNELS = {
    "gather": ("probe_layout.cu", f"{MOSAIC}:53", "major_transpose"),
    "contract": ("probe_contract.cu", f"{MOSAIC}:53", "dgrad_rhs_T_big"),
    "masked_ce": ("probe_reduce.cu", f"{MOSAIC}:53", "softmax_masked"),
    "max2": ("probe_reduce.cu", f"{MOSAIC}:53", "sublane_pool_reshape"),
    "block_fold": ("probe_reduce.cu", f"{MOSAIC}:53", "selector_matmul_fold"),
    "carry_sum": ("probe_reduce.cu", f"{MOSAIC}:310", "grid_scratch_persist"),
    "scalar_accum": ("probe_reduce.cu", f"{MOSAIC}:528", "scalar_accum_smem"),
    "philox_draw_twice": ("probe_prng.cu", f"{MOSAIC}:283", "prng_replay"),
    "max2_bwd": ("probe_reduce.cu", f"{AD_PROBE}:60", "ad_mask_relu_max"),
    "relu_mask": ("probe_reduce.cu", f"{AD_PROBE}:60", "ad_mask_relu_max"),
    "relu_mask_bwd": ("probe_reduce.cu", f"{AD_PROBE}:60",
                      "ad_mask_relu_max"),
}
#: each contraction probe's function as one PyTorch call (bf16 operands
#: cast to f32 first: the probe's function has an f32 result), and its k
CONTRACT_LIBRARY = {
    "dot_3d_2d": (torch.matmul, 128),
    "einsum_brl_rlf": (lambda a, w: torch.matmul(a.reshape(32, -1),
                                                 w.reshape(-1, 128)), 14336),
    "batched_dot": (torch.matmul, 256),
    "outer_wgrad": (lambda a, g: torch.einsum("brl,bf->rlf", a, g), 32),
    "wgrad_2d": (lambda a, g: torch.matmul(a.T, g), 1792),
    "bf16_mixed": (lambda a, b: torch.matmul(a.float(), b.float()), 128),
    "bf16_default_prec": (lambda a, b: torch.matmul(a.float(), b.float()),
                          128),
    "outer_wgrad_chunked": (lambda a, g: torch.einsum("brl,bf->rlf", a, g),
                            32),
    "dgrad_rhs_T_2d": (lambda g, w: torch.matmul(g, w.T), 128),
    "dgrad_rhs_T_big": (lambda g, w: torch.matmul(g, w.T), 256),
    "dgrad_rhs_T_batched": (lambda g, w: torch.matmul(g, w.transpose(1, 2)),
                            128),
}
#: every tensor-core kernel that phase 2 requires HMMA instructions in
TC_KERNELS = ("gram_tc_kernel", "stem_raw_tc_kernel", "conv2_fwd_tc_kernel",
              "stem_fwd_tc_kernel", "conv2_wgrad_tc_kernel",
              "stem_wgrad_tc_kernel",
              "conv2_dgrad_tc_kernel", "dense_fwd_tc_kernel",
              "dense_bwd_tc_kernel", "stem_raw_tf32_kernel",
              "conv2_wgrad_tf32_kernel", "stem_wgrad_tf32_kernel",
              "conv2_dgrad_tf32_kernel",
              "dense_fwd_tf32_kernel", "dense_bwd_tf32_kernel",
              "conv2_fwd_tf32_kernel")
#: the instruction phase 2 requires in a 3xTF32 kernel's SASS: HGMMA for
#: wgmma, HMMA for mma.sync
TF32_OPS = {"stem_raw_tf32_kernel": "HGMMA",
            "conv2_fwd_tf32_kernel": "HMMA",
            "conv2_wgrad_tf32_kernel": "HMMA",
            "stem_wgrad_tf32_kernel": "HMMA",
            "conv2_dgrad_tf32_kernel": "HGMMA",
            "dense_fwd_tf32_kernel": "HMMA",
            "dense_bwd_tf32_kernel": "HMMA"}
DROPOUT_SOURCE = f"{CSRC}/client_dropout.cu"
DROPOUT_REPLACES = "multimodal_fl_security_tpu/ops/fused_kernel.py:403"
#: the engine's dropout, which the kernel step applies from drawn uniforms
DRAWN_DROPOUT_REPLACES = "multimodal_fl_security_tpu/models/simple_cnn.py:104"
#: fc1's two dropout layers in the round: (shape, keep)
DRAWN_DROPOUT_CASES = (((100, 32, 3136), 0.75), ((100, 32, 128), 0.5))


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
    from multimodal_fl_security_tpu_torch.ops import (
        _build,
        client_conv,
        client_dense,
        client_dropout,
        client_sgd,
        gram,
        philox,
        probe_contract,
        probe_layout,
        probe_reduce,
        sorted_reduce,
    )

    def build(name):
        t0 = time.perf_counter()
        path, log = _build.build(name)
        return path, log, time.perf_counter() - t0

    # One nvcc per source, all started together; each library's loader.
    loaders = {"gram": gram._library,
               "sorted_reduce": sorted_reduce._library,
               "client_conv": client_conv._library,
               "client_stem_raw": client_conv._stem_raw_library,
               "client_dense": client_dense._library,
               "client_sgd": client_sgd._library,
               "client_dropout": client_dropout._library,
               "probe_layout": probe_layout._library,
               "probe_contract": probe_contract._library,
               "probe_reduce": probe_reduce._library,
               "probe_prng": philox._library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        builds = list(pool.map(build, loaders))
    for load in loaders.values():
        load()
    for path, log, seconds in builds:
        print(f"[build] {path.name} in {seconds:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function prop" in line:
                print(f"[build] {line.strip()}")
    print(f"[build] {len(loaders)} sources in "
          f"{time.perf_counter() - t0:.2f} s")
    check_tensor_cores([p for p, _, _ in builds
                        if p.name.startswith(("libgram-", "libclient_conv-",
                                              "libclient_stem_raw-",
                                              "libclient_dense-"))])


def check_tensor_cores(libs) -> None:
    """``cuobjdump -sass`` of the Gram, conv and dense libraries: every
    tensor-core kernel (``*_tc_kernel`` and ``*_tf32_kernel``, each
    instantiation) holds HMMA (mma.sync) or HGMMA (wgmma) instructions,
    each of TC_KERNELS has one, and each 3xTF32 kernel the one of
    TF32_OPS."""
    from multimodal_fl_security_tpu_torch.ops._build import find_nvcc

    counts, name = {}, None
    for lib in libs:
        sass = subprocess.run(
            [str(Path(find_nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
            capture_output=True, text=True, check=True).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = {"HMMA": 0, "HGMMA": 0}
            elif name:
                for op in ("HMMA", "HGMMA"):
                    counts[name][op] += op in line
    tc = {n: k for n, k in counts.items()
          if "_tc_kernel" in n or "_tf32_kernel" in n}
    for n, k in tc.items():
        short = n.split("_cu_")[-1]
        print(f"[build] SASS {short}: {k['HMMA'] + k['HGMMA']} HMMA/HGMMA "
              f"({k['HMMA']} HMMA, {k['HGMMA']} HGMMA)")
    missing = [k for k in TC_KERNELS if not any(k in n for n in tc)]
    wrong = [n for n, k in tc.items() for kernel, op in TF32_OPS.items()
             if kernel in n and not k[op]]
    if missing or wrong or not all(k["HMMA"] + k["HGMMA"]
                                   for k in tc.values()):
        raise AssertionError(f"tensor-core kernels without HMMA: {tc}; "
                             f"not found: {missing}; without their "
                             f"instruction: {wrong}")


def bound(nbytes_moved: float, flops: float,
          dtype: torch.dtype = torch.float32) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate of ``dtype`` (H100 SXM data sheet;
    for f32 the 3xTF32 rate, :data:`PEAK_FLOPS`; :func:`f32_core_ms` gives
    the f32 CUDA-core figure beside it)."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_core_ms(flops: float) -> float:
    """``flops`` at the f32 CUDA-core rate, in ms."""
    return flops / F32_CORE_FLOPS * 1e3


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def check_gram(u: torch.Tensor) -> float:
    """Kernel against plain on ``u``; returns max|kernel - plain|."""
    from multimodal_fl_security_tpu_torch.ops.gram import gram, gram_plain

    g = gram(u)
    g_again = gram(u)
    g_plain = gram_plain(u)
    torch.cuda.synchronize()
    shape = tuple(u.shape)
    err = float((g - g_plain).abs().max())
    scale = float(g_plain.abs().max())
    g_f64 = gram_plain(u.double())
    err_f64 = float((g.double() - g_f64).abs().max())
    plain_f64 = float((g_plain.double() - g_f64).abs().max())
    del g_f64
    print(f"[kernel] gram {shape}: max|kernel-plain| {err:.6g} (tolerance "
          f"{REL_TOL} * max|G| = {REL_TOL * scale:.6g}); vs f64: kernel "
          f"{err_f64:.6g}, plain {plain_f64:.6g}")
    if not err <= REL_TOL * scale:
        raise AssertionError(f"gram kernel disagrees at {shape}: {err} > "
                             f"{REL_TOL} * {scale}")
    if not torch.equal(g, g_again):
        raise AssertionError(f"gram kernel not bitwise reproducible at "
                             f"{shape}")
    if not torch.equal(g, g.T):
        raise AssertionError(f"gram kernel not symmetric at {shape}")
    if u.shape[0] >= 5 and krum_pick(g) != krum_pick(g_plain):
        raise AssertionError(f"Krum picks differ at {shape}")
    return err


def gram_times(u: torch.Tensor, iters: int) -> tuple:
    """(kernel ms, plain ms, torch.mm of the centered U ms, torch.mean ms):
    kernel and plain in turns (plain, kernel, kernel, plain)."""
    from multimodal_fl_security_tpu_torch.ops.gram import gram, gram_plain

    plain_a = time_ms(gram_plain, u, iters)
    kern_a = time_ms(gram, u, iters)
    kern_b = time_ms(gram, u, iters)
    plain_b = time_ms(gram_plain, u, iters)
    # The one library call for the same product: a GEMM of the centered U.
    uc = u - u.mean(dim=0)
    library_ms = time_ms(lambda x: torch.mm(x, x.T), uc, iters)
    del uc
    mean_ms = time_ms(lambda x: x.mean(dim=0), u, iters)
    print(f"[kernel] gram {tuple(u.shape)}: kernel {kern_a:.4f} / "
          f"{kern_b:.4f} ms, plain {plain_a:.4f} / {plain_b:.4f} ms, "
          f"torch.mm of the centered U {library_ms:.4f} ms; torch.mean "
          f"{mean_ms:.4f} ms ({mean_ms / ((kern_a + kern_b) / 2):.1%} of "
          f"gram())")
    return (kern_a + kern_b) / 2, (plain_a + plain_b) / 2, library_ms, mean_ms


def gram_bound(c: int, d: int) -> tuple:
    """(bound_ms, bound_by) of the 3xTF32 Gram: U read once and G written
    once, against the 3 C (C + 1) D products at the TF32 rate; prints the
    f32 CUDA-core figure (C (C + 1) D at 67 TFLOP/s) beside it."""
    moved = 4 * (c * d + c * c)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * c * (c + 1) * d / TF32_FLOPS * 1e3
    f32_ms = max(t_bytes, f32_core_ms(c * (c + 1) * d))
    print(f"[kernel] gram [{c}, {d}] bound: {max(t_bytes, t_ops):.4f} ms "
          f"(bytes {t_bytes:.4f}, 3xTF32 operations {t_ops:.4f}); at the "
          f"f32 CUDA-core rate {f32_ms:.4f} ms")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel() -> dict:
    from multimodal_fl_security_tpu_torch.models import create_model, init_model

    gen = torch.Generator("cuda").manual_seed(0)
    # Main path's shape and kind of input: near-identical parameter vectors;
    # then the same with the first rows scaled x10, as R3's attack sends.
    base = init_model(create_model("simple_cnn"), in_channels=1, seed=0,
                      device="cuda")
    main = base + 0.01 * torch.randn(MAIN_SHAPE, generator=gen,
                                     device="cuda")
    scaled = main.clone()
    scaled[:SCALED_ROWS] *= 10.0
    main_err = check_gram(main)
    check_gram(scaled)
    del scaled
    for s in RAGGED_SHAPES:
        check_gram(torch.randn(s, generator=gen, device="cuda"))

    ms, plain_ms, library_ms, mean_ms = gram_times(main, 20)
    bound_ms, bound_by = gram_bound(*MAIN_SHAPE)
    big = 0.01 * torch.randn(GRAM_BIG_SHAPE, generator=gen, device="cuda")
    big += 1.0
    big_err = check_gram(big)
    big_ms, big_plain_ms, big_library_ms, _ = gram_times(big, 5)
    big_bound_ms, _ = gram_bound(*GRAM_BIG_SHAPE)
    del big
    torch.cuda.empty_cache()
    return {"name": "gram", "route": "cuda", "source": GRAM_SOURCE,
            "replaces": GRAM_REPLACES, "max_abs_err": main_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "mean_ms": mean_ms, "ms_100x8M": big_ms,
            "plain_ms_100x8M": big_plain_ms,
            "library_ms_100x8M": big_library_ms,
            "bound_ms_100x8M": big_bound_ms, "max_abs_err_100x8M": big_err}


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
    for shape, trim, iters in ((MAIN_SHAPE, 10, 20), (SORT_BIG_SHAPE, 10, 5),
                               (SORT_RESNET_SHAPE, SORT_RESNET_TRIM, 5)):
        u = main if shape == MAIN_SHAPE else torch.randn(
            shape, generator=gen, device="cuda")
        if shape != MAIN_SHAPE:
            for mode in ("median", "trimmed"):
                check_sorted_reduce(u, mode, trim)
        for mode in ("median", "trimmed"):
            def kern(x, mode=mode, trim=trim):
                return sorted_reduce(x, mode, trim)

            def plain(x, mode=mode, trim=trim):
                return sorted_reduce_plain(x, mode, trim)

            # In turns: plain, kernel, kernel, plain.
            plain_a = time_ms(plain, u, iters)
            kern_a = time_ms(kern, u, iters)
            kern_b = time_ms(kern, u, iters)
            plain_b = time_ms(plain, u, iters)
            times[shape, mode] = ((kern_a + kern_b) / 2, (plain_a + plain_b) / 2)
            print(f"[kernel] sorted_reduce {mode} {shape} trim {trim}: kernel "
                  f"{kern_a:.4f} / {kern_b:.4f} ms, plain {plain_a:.4f} / "
                  f"{plain_b:.4f} ms")
        del u
    torch.cuda.empty_cache()
    ms, plain_ms = times[MAIN_SHAPE, "trimmed"]
    # Library calls: torch.sort over the client axis (the trimmed mean has
    # no single call) and torch.median; the bound is one read of U.
    library_ms = time_ms(lambda x: torch.sort(x, dim=0), main)
    median_ms = time_ms(lambda x: torch.median(x, dim=0), main)
    bound_ms, bound_by = bound(nbytes(main) + 4 * main.shape[1], 0)
    print(f"[kernel] sorted_reduce {MAIN_SHAPE}: torch.sort {library_ms:.4f}"
          f" ms, torch.median {median_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"name": "sorted_reduce", "route": "cuda", "source": SORT_SOURCE,
            "replaces": SORT_REPLACES, "max_abs_err": errs["trimmed"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
    """R1-R5 at full width; returns each kernel's launches over the runs,
    by wrapper (the Gram, the sorted reduce and the kernel step's) and
    by kernel (``ops/_launch.py::KERNEL_LAUNCHES``)."""
    from multimodal_fl_security_tpu_torch.bench import (
        build_engine,
        result_line,
        time_rounds,
    )
    from multimodal_fl_security_tpu_torch.ops._launch import (
        kernel_launches,
        reset_kernel_launches,
    )
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        DRAWN_DROPOUT_STEP_KERNELS,
    )
    from multimodal_fl_security_tpu_torch.ops.gram import gram
    from multimodal_fl_security_tpu_torch.ops.sorted_reduce import sorted_reduce
    from multimodal_fl_security_tpu_torch.utils.metrics import evaluate_model

    aggregation = (gram, sorted_reduce)
    totals = {"gram": 0, "sorted_reduce": 0,
              "trainer": {w.__name__: 0 for w in DRAWN_DROPOUT_STEP_KERNELS},
              "kernels": dict.fromkeys(kernel_launches(), 0)}
    low_accuracy = []
    for run, defense, dconf, attack, aconf, warm, n_rounds, dtype in \
            ROBUST_RUNS:
        engine, params, test_set = build_engine(
            "cuda", defense=defense, defense_config=dconf, attack=attack,
            attack_config=aconf, num_malicious_clients=NUM_MALICIOUS,
            dtype=dtype)
        recorder = FirstUpdates(engine.defense)
        engine.defense = recorder
        gen = torch.Generator("cuda").manual_seed(0)
        torch.cuda.synchronize()

        for w in (*aggregation, *DRAWN_DROPOUT_STEP_KERNELS):
            w.launches = 0
        reset_kernel_launches()
        metrics = []
        for _ in range(warm):
            params, m = engine.run_round(params, gen)
            metrics.append(m)
        params, seconds, timed = time_rounds(engine, params, gen, n_rounds)
        launches = {w.__name__: w.launches for w in aggregation}
        trainer = {w.__name__: w.launches for w in DRAWN_DROPOUT_STEP_KERNELS}
        by_kernel = kernel_launches()
        metrics += timed

        rounds = warm + n_rounds
        steps = rounds * engine.spec.local_epochs * (
            engine.mask.shape[1] // engine.spec.batch_size)
        losses = [float(m["client_loss_mean"]) for m in metrics]
        print(f"[robust] {run} {attack} + {defense} ({dtype}): {rounds} "
              f"rounds, {n_rounds} timed in {seconds:.3f} s; "
              f"client_loss_mean {losses}; launches {launches}; the kernel "
              f"step: {steps} steps, launches by wrapper {trainer}, by kernel "
              f"{ {k: v for k, v in by_kernel.items() if v} }")
        want_trainer = {w.__name__: k * steps
                        for w, k in DRAWN_DROPOUT_STEP_KERNELS.items()}
        want_kernels = kernel_counts(
            f32_steps=steps if dtype == torch.float32 else 0,
            tc_steps=steps if dtype == torch.bfloat16 else 0)
        if trainer != want_trainer or by_kernel != want_kernels:
            raise AssertionError(
                f"{run}: the kernel step's launches by wrapper {trainer} "
                f"in {rounds} rounds (expected "
                f"{want_trainer}), by kernel {by_kernel} (expected "
                f"{want_kernels})")
        for kind, counts in (("trainer", trainer), ("kernels", by_kernel)):
            for name, n in counts.items():
                totals[kind][name] += n
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
        for name, n in launches.items():
            totals[name] += n

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


def held(what: str, got: torch.Tensor, want: torch.Tensor,
         dtype: torch.dtype, against: str = "plain") -> float:
    """max|got - want|; raises past FUSED_REL_TOL[dtype] * max|want|.
    ``against`` names the reference: the plain version, or f64 sums."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    tol = FUSED_REL_TOL[dtype] * float(want.abs().max())
    name = "f32" if dtype == torch.float32 else "bf16"
    print(f"[fused] {what} {name}: max|kernel-{against}| {err:.6g} "
          f"(tolerance {tol:.6g})")
    if not err <= tol:
        raise AssertionError(f"{what} {name}: the kernel disagrees with its "
                             f"{against} reference: {err} > {tol}")
    return err


def wgrad_f64(xin: torch.Tensor, dp: torch.Tensor, h: torch.Tensor,
              arg: torch.Tensor, w: torch.Tensor) -> tuple:
    """The exact weight gradient of a 3x3 SAME stride-1 conv, (dW, db) of
    ``conv_wgrad``'s operands summed in f64 (``conv2d_weight`` and dz's
    sum)."""
    from multimodal_fl_security_tpu_torch.ops import client_conv as cc

    c = xin.shape[0]
    dz = cc._dense_dz(dp, h, arg, *xin.shape[-2:]).double()
    gw = torch.nn.grad.conv2d_weight(
        cc._grouped(xin.float()).double(), (c * w.shape[1], *w.shape[2:]),
        cc._grouped(dz), padding=1, groups=c)
    return gw.view(w.shape), dz.sum(dim=(1, 3, 4))


def dgrad_f64(dp: torch.Tensor, h: torch.Tensor, arg: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """The exact input gradient of a pooled 3x3 SAME stride-1 conv from
    ``conv_dgrad``'s operands, summed in f64 (``conv2d_input``)."""
    from multimodal_fl_security_tpu_torch.ops import client_conv as cc

    c, b = dp.shape[:2]
    hw = (2 * dp.shape[-2], 2 * dp.shape[-1])
    dz = cc._dense_dz(dp, h, arg, *hw).double()
    dx = torch.nn.grad.conv2d_input(
        (b, c * w.shape[2], *hw), w.double().reshape(-1, *w.shape[2:]),
        cc._grouped(dz), padding=1, groups=c)
    return cc._ungrouped(dx, c)


def pooled_f64(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The exact pooled forward of a 3x3 SAME stride-1 conv: the
    convolution summed in f64 (grouped ``F.conv2d``), then each 2x2
    window's max, the bias and relu, in f64."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.ops import client_conv as cc

    c, bsz = x.shape[:2]
    z = cc._ungrouped(F.conv2d(cc._grouped(x.double()),
                               w.double().reshape(-1, *w.shape[2:]),
                               padding=1, groups=c), c)
    cout, oh, ow = z.shape[2:]
    win = z.reshape(c, bsz, cout, oh // 2, 2, ow // 2, 2).amax(dim=(4, 6))
    return torch.relu(win + b.double()[:, None, :, None, None])


def held_f64(what: str, got: torch.Tensor, exact: torch.Tensor,
             plain: torch.Tensor) -> tuple:
    """A 3xTF32 kernel's f32 output held to the exact (f64) one at
    FUSED_REL_TOL, and its error there to at most F64_FACTOR times the f32
    plain version's (whose f32 sums need not keep f32's accuracy); prints
    its distance from the plain version. Returns (its error against f64,
    that distance)."""
    err = held(what, got, exact, torch.float32, against="f64")
    e_p = float((plain.double() - exact).abs().max())
    d_p = float((got - plain).abs().max())
    print(f"[fused] {what} f32: max|kernel-plain| {d_p:.6g}; vs f64: plain "
          f"{e_p:.6g}")
    if not err <= F64_FACTOR * e_p:
        raise AssertionError(f"{what} f32: error against f64 {err} > "
                             f"{F64_FACTOR} x the plain version's {e_p}")
    return err, d_p


def held_argmax(what: str, got: torch.Tensor, want: torch.Tensor,
                x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> float:
    """The share of a pooled conv kernel's argmax bytes ``got`` equal to its
    plain version's ``want`` (x and w its operands). Raises at or below
    MIN_ARGMAX_AGREEMENT, and on any difference where the plain version's
    window gap (the largest of the four f32 sums less the next) exceeds
    FUSED_REL_TOL[dtype] * max|sum|: the two sum the same products in
    another order, so only near ties may choose differently."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.ops import client_conv as cc

    c, bsz = x.shape[:2]
    z = cc._ungrouped(F.conv2d(cc._grouped(cc._round(x, dtype)),
                               cc._round(w, dtype).reshape(-1, *w.shape[2:]),
                               padding=1, groups=c), c)
    cout, oh, ow = z.shape[2:]
    win = z.reshape(c, bsz, cout, oh // 2, 2, ow // 2, 2).permute(
        0, 1, 2, 3, 5, 4, 6).reshape(c, bsz, cout, oh // 2, ow // 2, 4)
    top2 = win.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > \
        FUSED_REL_TOL[dtype] * float(win.abs().max())
    same = got == want
    agreement = float(same.float().mean())
    wrong_clear = int((clear & ~same).sum())
    name = "f32" if dtype == torch.float32 else "bf16"
    print(f"[fused] {what} {name} argmax: agreement {agreement:.6f}, "
          f"{wrong_clear} differ of {int(clear.sum())} outputs whose window "
          f"gap exceeds the tolerance")
    if not agreement > MIN_ARGMAX_AGREEMENT or wrong_clear:
        raise AssertionError(
            f"{what} {name}: the kernel's argmax disagrees with its plain "
            f"version: agreement {agreement} (gate > {MIN_ARGMAX_AGREEMENT}), "
            f"{wrong_clear} differences beyond a near tie")
    return agreement


def turns(kern, plain, iters: int = 20) -> tuple:
    """(kernel ms, plain ms): CUDA-event means in turns plain, kernel,
    kernel, plain."""
    plain_a = time_ms(lambda _: plain(), None, iters)
    kern_a = time_ms(lambda _: kern(), None, iters)
    kern_b = time_ms(lambda _: kern(), None, iters)
    plain_b = time_ms(lambda _: plain(), None, iters)
    return (kern_a + kern_b) / 2, (plain_a + plain_b) / 2


def turns_beside(kern, plain, lib, iters: int = 20) -> tuple:
    """(kernel ms, plain ms, the library call's three runs sorted, or
    None without one): CUDA-event means in turns plain, library, kernel,
    library, kernel, library, plain."""
    if lib is None:
        return (*turns(kern, plain, iters), None)
    p0, l0, k0, l1, k1, l2, p1 = (
        time_ms(lambda _, fn=fn: fn(), None, iters)
        for fn in (plain, lib, kern, lib, kern, lib, plain))
    return (k0 + k1) / 2, (p0 + p1) / 2, sorted((l0, l1, l2))


def phase_fused_kernels() -> dict:
    """7a: every local-training kernel against its plain version on one
    step's activations at the north star's shapes; returns the rows of the
    kernels line (without launches) by kernel name."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.bench import build_engine
    from multimodal_fl_security_tpu_torch.models.simple_cnn import SimpleCNN
    from multimodal_fl_security_tpu_torch.ops import client_conv as cc
    from multimodal_fl_security_tpu_torch.ops import client_dense as cd
    from multimodal_fl_security_tpu_torch.ops import client_sgd as cs

    f32, bf16 = torch.float32, torch.bfloat16
    engine, params, _ = build_engine("cuda")
    c = engine.num_clients
    x = engine.arrays["image"][:, :32]  # the first step's batch, in place
    labels = engine.arrays["label"][:, :32]
    mask = engine.mask[:, :32].clone()
    mask[:, -5:] = 0.0  # padded rows, as in the last batch of a pass
    layout = SimpleCNN().layout(1)
    gen = torch.Generator("cuda").manual_seed(3)
    p = params + 0.01 * torch.randn((c, layout.dim), generator=gen,
                                    device="cuda")  # distinct clients
    v = layout.views(p)
    rows, errs, agree, timed = {}, {}, {}, {}

    def bwd(fn, dz, xin, w, b, msk, wdt, gdt, dt):
        gw, gb = torch.empty_like(w), torch.empty_like(b)
        return gw, gb, fn(dz, xin, w, gw, gb, mask=msk, wdtype=wdt,
                          gdtype=gdt, dx_dtype=dt)

    def wgrad(fn, xin, dp, h, arg, w, b, dt):
        gw, gb = torch.empty_like(w), torch.empty_like(b)
        fn(xin, dp, h, arg, gw, gb, dtype=dt)
        return gw, gb

    def forward(what, xin, layer, dt, nhwc=False):
        """One pooled conv (``layer`` conv1, the stem, or conv2) at dt:
        held to its plain version (bf16) or to the exact (f64) pooled map
        (f32: stem_fwd_f32's FMA chain and conv2_fwd_tf32's 3xTF32 sums
        keep f32's accuracy), its argmax to the plain version's."""
        wl, bl = v[f"{layer}.weight"], v[f"{layer}.bias"]
        got, arg = cc.conv_fwd(xin, wl, bl, dtype=dt, channels_last=nhwc)
        want, warg = cc.conv_fwd_plain(xin, wl, bl, dtype=dt,
                                       channels_last=nhwc)
        key = "stem" if layer == "conv1" else "conv2_fwd"
        if dt == f32:
            errs[key, dt], errs[key + "_vs_plain", dt] = held_f64(
                what, got, pooled_f64(xin, wl, bl), want)
        else:
            errs[key, dt] = held(what, got, want, dt)
        agree[key, dt] = held_argmax(what.split(" [")[0], arg, warg, xin, wl,
                                     dt)
        return got, arg

    for dt in (f32, bf16):
        h1, a1 = forward("stem fwd [100, 32, 1, 28, 28]", x, "conv1", dt,
                         nhwc=True)
        h3, a3 = forward("conv2 fwd [100, 32, 32, 14, 14]", h1, "conv2", dt)
        f3 = h3.view(c, 32, -1)
        h4 = cd.dense_fwd(f3, v["fc1.weight"], v["fc1.bias"], relu=True,
                          wdtype=dt, out_dtype=dt)
        plain_h4 = cd.dense_fwd_plain(f3, v["fc1.weight"], v["fc1.bias"],
                                      relu=True, wdtype=dt, out_dtype=dt)
        if dt == f32:
            w1d, f3d = v["fc1.weight"].double(), f3.double()
            # dense_fwd_tf32's and dense_bwd_tf32's 3xTF32 sums keep f32's
            # accuracy: held to the exact (f64) results, as conv2's.
            errs["dense_fwd", dt], errs["dense_fwd_vs_plain", dt] = held_f64(
                "fc1 fwd [100, 32, 3136]", h4, torch.relu(torch.baddbmm(
                    v["fc1.bias"].double().unsqueeze(1), f3d,
                    w1d.transpose(1, 2))), plain_h4)
        else:
            errs["dense_fwd", dt] = held("fc1 fwd [100, 32, 3136]", h4,
                                         plain_h4, dt)
        logits = cd.dense_fwd(h4, v["fc2.weight"], v["fc2.bias"], wdtype=f32,
                              out_dtype=f32)
        errs["fc2", dt] = held("fc2 fwd [100, 32, 128]", logits,
                               cd.dense_fwd_plain(h4, v["fc2.weight"],
                                                  v["fc2.bias"], wdtype=f32,
                                                  out_dtype=f32), dt)
        loss, dl = cs.client_ce(logits, labels, mask)
        loss_p, dl_p = cs.client_ce_plain(logits, labels, mask)
        held("ce loss [100]", loss, loss_p, f32)
        errs["ce", dt] = held("ce dlogits [100, 32, 10]", dl, dl_p, f32)
        k2 = bwd(cd.dense_bwd, dl, h4, v["fc2.weight"], v["fc2.bias"], h4,
                 f32, f32, dt)
        for name, got, ref in zip(("dW", "db", "dx"), k2, bwd(
                cd.dense_bwd_plain, dl, h4, v["fc2.weight"], v["fc2.bias"],
                h4, f32, f32, dt)):
            errs["fc2_bwd", dt, name] = held(f"fc2 bwd {name}", got, ref, dt)
        dz4 = k2[2]
        k1 = bwd(cd.dense_bwd, dz4, f3, v["fc1.weight"], v["fc1.bias"], None,
                 dt, dt, dt)
        p1 = bwd(cd.dense_bwd_plain, dz4, f3, v["fc1.weight"], v["fc1.bias"],
                 None, dt, dt, dt)
        if dt == f32:
            dz4d = dz4.double()
            exact = (torch.bmm(dz4d.transpose(1, 2), f3d), dz4d.sum(dim=1),
                     torch.bmm(dz4d, w1d))
            for name, got, ref, pl in zip(("dW", "db", "dx"), k1, exact, p1):
                errs["dense_bwd", dt, name], \
                    errs["dense_bwd_vs_plain", dt, name] = held_f64(
                        f"fc1 bwd {name}", got, ref, pl)
            del exact, w1d, f3d
        else:
            for name, got, ref in zip(("dW", "db", "dx"), k1, p1):
                errs["dense_bwd", dt, name] = held(f"fc1 bwd {name}", got,
                                                   ref, dt)
        dh3 = k1[2].view(h3.shape)
        got2, plain2 = (wgrad(fn, h1, dh3, h3, a3, v["conv2.weight"],
                              v["conv2.bias"], dt)
                        for fn in (cc.conv_wgrad, cc.conv_wgrad_plain))
        dh1 = cc.conv_dgrad(dh3, h3, a3, v["conv2.weight"], (14, 14),
                            dtype=dt, channels_last=True)
        plain_dh1 = cc.conv_dgrad_plain(dh3, h3, a3, v["conv2.weight"],
                                        (14, 14), dtype=dt)
        if dt == f32:
            # conv2_wgrad_tf32's and conv2_dgrad_tf32's 3xTF32 sums keep
            # f32's accuracy; the plain versions' f32 sums need not, so the
            # kernels are held to the exact (f64) gradients.
            exact = wgrad_f64(h1, dh3, h3, a3, v["conv2.weight"])
            for name, got, ref, pl in zip(("dW", "db"), got2, exact, plain2):
                errs["conv_wgrad", dt, name], \
                    errs["conv_wgrad_vs_plain", dt, name] = held_f64(
                        f"conv2 wgrad {name}", got, ref, pl)
            errs["conv_dgrad", dt], errs["conv_dgrad_vs_plain", dt] = \
                held_f64("conv2 dgrad [100, 32, 32, 14, 14]", dh1,
                         dgrad_f64(dh3, h3, a3, v["conv2.weight"]), plain_dh1)
        else:
            for name, got, ref in zip(("dW", "db"), got2, plain2):
                errs["conv_wgrad", dt, name] = held(f"conv2 wgrad {name}",
                                                    got, ref, dt)
            errs["conv_dgrad", dt] = held(
                "conv2 dgrad [100, 32, 32, 14, 14]", dh1, plain_dh1, dt)
        got1, plain1 = (wgrad(fn, x, dh1, h1, a1, v["conv1.weight"],
                              v["conv1.bias"], dt)
                        for fn in (cc.conv_wgrad, cc.conv_wgrad_plain))
        if dt == f32:
            # stem_wgrad_tf32's 3xTF32 sums: held to the exact gradient.
            exact = wgrad_f64(x, dh1, h1, a1, v["conv1.weight"])
            for name, got, ref, pl in zip(("dW", "db"), got1, exact, plain1):
                errs["stem_wgrad", dt, name], \
                    errs["stem_wgrad_vs_plain", dt, name] = held_f64(
                        f"stem wgrad {name}", got, ref, pl)
        else:
            for name, got, ref in zip(("dW", "db"), got1, plain1):
                errs["stem_wgrad", dt, name] = held(f"stem wgrad {name}",
                                                    got, ref, dt)
        timed[dt] = dict(h1=h1, a1=a1, h3=h3, a3=a3, f3=f3, h4=h4,
                         logits=logits, dl=dl, dz4=dz4, dh3=dh3, dh1=dh1)

    # The optimizer over the flat [C, D] buffers (f32 only).
    g = 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
    partial = cs.client_sq_norm(g)
    errs["sq_norm", f32] = held("sq_norm [100, 421,642]",
                                partial.sum(1, keepdim=True),
                                cs.client_sq_norm_plain(g), f32)
    mom = 0.1 * torch.randn(p.shape, generator=gen, device="cuda")
    pk, mk, pp, mp = p.clone(), mom.clone(), p.clone(), mom.clone()
    opt = dict(lr=0.01, momentum=0.9, clip_norm=1.0)
    cs.client_sgd_update(pk, mk, g, partial, **opt)
    cs.client_sgd_update_plain(pp, mp, g, partial, **opt)
    held("sgd momentum [100, 421,642]", mk, mp, f32)
    errs["sgd_update", f32] = held("sgd params [100, 421,642]", pk, pp, f32)

    # Times, at each kernel's dtype (bf16 for the path's kernels, f32 for
    # the f32 path's), with bounds.
    t, t32 = timed[bf16], timed[f32]
    w2, b2 = v["conv2.weight"], v["conv2.bias"]
    w1, b1 = v["fc1.weight"], v["fc1.bias"]
    xg = cc._grouped(t["h1"]).contiguous()
    wg = w2.to(bf16).reshape(-1, *w2.shape[2:])
    conv2_flops = 2 * c * 32 * 64 * 32 * 9 * 14 * 14
    gw2, gb2 = torch.empty_like(w2), torch.empty_like(b2)
    gw1, gb1 = torch.empty_like(w1), torch.empty_like(b1)
    gwf2, gbf2 = torch.empty_like(v["fc2.weight"]), torch.empty_like(
        v["fc2.bias"])
    gwc1 = torch.empty_like(v["conv1.weight"])
    gbc1 = torch.empty_like(v["conv1.bias"])
    pk2, mk2 = p.clone(), mom.clone()

    def conv_grads(dt, wgrad_name, dgrad_name):
        """conv2's weight and input gradients at dtype dt, by the names of
        the kernels that run them: bf16 the tensor-core ones, f32
        conv2_wgrad_tf32 and conv2_dgrad_tf32 (3xTF32)."""
        a = timed[dt]
        xgd = cc._grouped(a["h1"]).contiguous()
        wgd = w2.to(dt).reshape(-1, *w2.shape[2:])
        dzg = cc._grouped(cc._dense_dz(a["dh3"], a["h3"], a["a3"], 14, 14)
                          ).to(dt).contiguous()
        live3 = int(((a["h3"] > 0) & (a["dh3"] != 0)).sum())
        return {
            wgrad_name: (
                lambda: cc.conv_wgrad(a["h1"], a["dh3"], a["h3"], a["a3"],
                                      gw2, gb2, dtype=dt),
                lambda: cc.conv_wgrad_plain(a["h1"], a["dh3"], a["h3"],
                                            a["a3"], gw2, gb2, dtype=dt),
                lambda: torch.nn.grad.conv2d_weight(xgd, wgd.shape, dzg,
                                                    padding=1, groups=c),
                nbytes(a["h1"], a["dh3"], a["h3"], a["a3"], w2, b2),
                2 * live3 * (32 * 9 + 1), dt),
            dgrad_name: (
                lambda: cc.conv_dgrad(a["dh3"], a["h3"], a["a3"], w2,
                                      (14, 14), dtype=dt,
                                      channels_last=True),
                lambda: cc.conv_dgrad_plain(a["dh3"], a["h3"], a["a3"], w2,
                                            (14, 14), dtype=dt),
                lambda: torch.nn.grad.conv2d_input(xgd.shape, wgd, dzg,
                                                   padding=1, groups=c),
                nbytes(a["dh3"], a["h3"], a["a3"], w2, a["dh1"]),
                2 * live3 * 32 * 9, dt),
        }

    w1c, b1c = v["conv1.weight"], v["conv1.bias"]
    xsg = cc._grouped(x).to(bf16).contiguous()
    xsg32 = cc._grouped(x).contiguous()
    dz1g32 = cc._grouped(cc._dense_dz(t32["dh1"], t32["h1"], t32["a1"], 28,
                                      28)).contiguous()
    live1_32 = int(((t32["h1"] > 0) & (t32["dh1"] != 0)).sum())
    w1g = w1c.to(bf16).reshape(-1, *w1c.shape[2:])
    xg32 = cc._grouped(t32["h1"]).contiguous()
    wf2, bf2 = v["fc2.weight"], v["fc2.bias"]
    cases = {
        "conv2_fwd_tc": (
            lambda: cc.conv_fwd(t["h1"], w2, b2, dtype=bf16),
            lambda: cc.conv_fwd_plain(t["h1"], w2, b2, dtype=bf16),
            lambda: F.conv2d(xg, wg, b2.to(bf16).reshape(-1), padding=1,
                             groups=c),
            nbytes(t["h1"], w2, b2, t["h3"], t["a3"]), conv2_flops, bf16),
        "stem_fwd_tc": (
            lambda: cc.conv_fwd(x, w1c, b1c, dtype=bf16, channels_last=True),
            lambda: cc.conv_fwd_plain(x, w1c, b1c, dtype=bf16,
                                      channels_last=True),
            lambda: F.conv2d(xsg, w1g, b1c.to(bf16).reshape(-1), padding=1,
                             groups=c),
            nbytes(x, w1c, b1c, t["h1"], t["a1"]),
            2 * c * 32 * 32 * 9 * 28 * 28, bf16),
        # The f32 call's kernels at its activations: conv2's forward
        # (3xTF32), the stem's (CUDA cores), fc1's forward and backward
        # (3xTF32).
        "conv2_fwd_tf32": (
            lambda: cc.conv_fwd(t32["h1"], w2, b2),
            lambda: cc.conv_fwd_plain(t32["h1"], w2, b2),
            lambda: F.conv2d(xg32, w2.reshape(-1, *w2.shape[2:]),
                             b2.reshape(-1), padding=1, groups=c),
            nbytes(t32["h1"], w2, b2, t32["h3"], t32["a3"]), conv2_flops,
            f32),
        "stem_fwd_f32": (
            lambda: cc.conv_fwd(x, w1c, b1c, channels_last=True),
            lambda: cc.conv_fwd_plain(x, w1c, b1c, channels_last=True),
            lambda: F.conv2d(xsg32, w1c.reshape(-1, 1, 3, 3),
                             b1c.reshape(-1), padding=1, groups=c),
            nbytes(x, w1c, b1c, t32["h1"], t32["a1"]),
            2 * c * 32 * 32 * 9 * 28 * 28, f32),
        "dense_fwd_tf32": (
            lambda: cd.dense_fwd(t32["f3"], w1, b1, relu=True, wdtype=f32,
                                 out_dtype=f32),
            lambda: cd.dense_fwd_plain(t32["f3"], w1, b1, relu=True,
                                       wdtype=f32, out_dtype=f32),
            lambda: torch.baddbmm(b1.unsqueeze(1), t32["f3"],
                                  w1.transpose(1, 2)),
            nbytes(t32["f3"], w1, b1, t32["h4"]), 2 * c * 32 * 3136 * 128,
            f32),
        "dense_bwd_tf32": (
            lambda: cd.dense_bwd(t32["dz4"], t32["f3"], w1, gw1, gb1,
                                 wdtype=f32, gdtype=f32, dx_dtype=f32),
            lambda: cd.dense_bwd_plain(t32["dz4"], t32["f3"], w1, gw1, gb1,
                                       wdtype=f32, gdtype=f32, dx_dtype=f32),
            None, nbytes(t32["dz4"], t32["f3"], w1, gw1, gb1, t32["f3"]),
            4 * c * 32 * 3136 * 128, f32),
        **conv_grads(f32, "conv2_wgrad_tf32", "conv2_dgrad_tf32"),
        **conv_grads(bf16, "conv_wgrad_tc", "conv_dgrad_tc"),
        # The stem's weight gradient in f32 (3xTF32, sparse on the tensor
        # cores), at [100, 32, 1, 28, 28] beside conv2d_weight.
        "stem_wgrad_tf32": (
            lambda: cc.conv_wgrad(x, t32["dh1"], t32["h1"], t32["a1"], gwc1,
                                  gbc1),
            lambda: cc.conv_wgrad_plain(x, t32["dh1"], t32["h1"], t32["a1"],
                                        gwc1, gbc1),
            lambda: torch.nn.grad.conv2d_weight(
                xsg32, (c * 32, 1, 3, 3), dz1g32, padding=1, groups=c),
            nbytes(x, t32["dh1"], t32["h1"], t32["a1"], w1c, b1c),
            2 * live1_32 * (9 + 1), f32),
        "dense_fwd_tc": (
            lambda: cd.dense_fwd(t["f3"], w1, b1, relu=True, wdtype=bf16,
                                 out_dtype=bf16),
            lambda: cd.dense_fwd_plain(t["f3"], w1, b1, relu=True,
                                       wdtype=bf16, out_dtype=bf16),
            lambda: torch.baddbmm(b1.to(bf16).unsqueeze(1), t["f3"],
                                  w1.to(bf16).transpose(1, 2)),
            nbytes(t["f3"], w1, b1, t["h4"]), 2 * c * 32 * 3136 * 128, bf16),
        # fc2 on the bf16 path: the CUDA-core kernel (f32 weights).
        "dense_fwd": (
            lambda: cd.dense_fwd(t["h4"], wf2, bf2, wdtype=f32,
                                 out_dtype=f32),
            lambda: cd.dense_fwd_plain(t["h4"], wf2, bf2, wdtype=f32,
                                       out_dtype=f32),
            lambda: torch.baddbmm(bf2.unsqueeze(1), t["h4"].float(),
                                  wf2.transpose(1, 2)),
            nbytes(t["h4"], wf2, bf2, t["logits"]), 2 * c * 32 * 128 * 10,
            f32),
        "dense_bwd_tc": (
            lambda: cd.dense_bwd(t["dz4"], t["f3"], w1, gw1, gb1,
                                 wdtype=bf16, gdtype=bf16, dx_dtype=bf16),
            lambda: cd.dense_bwd_plain(t["dz4"], t["f3"], w1, gw1, gb1,
                                       wdtype=bf16, gdtype=bf16,
                                       dx_dtype=bf16),
            None, nbytes(t["dz4"], t["f3"], w1, gw1, gb1, t["f3"]),
            4 * c * 32 * 3136 * 128, bf16),
        # fc2's backward on the bf16 path: the CUDA-core kernel (f32
        # weights), through fc1's relu (the mask) into a bf16 dx.
        "dense_bwd": (
            lambda: cd.dense_bwd(t["dl"], t["h4"], wf2, gwf2, gbf2,
                                 mask=t["h4"], wdtype=f32, gdtype=f32,
                                 dx_dtype=bf16),
            lambda: cd.dense_bwd_plain(t["dl"], t["h4"], wf2, gwf2, gbf2,
                                       mask=t["h4"], wdtype=f32, gdtype=f32,
                                       dx_dtype=bf16),
            None, nbytes(t["dl"], t["h4"], t["h4"], wf2, gwf2, gbf2, t["h4"]),
            4 * c * 32 * 128 * 10, f32),
        "client_ce": (
            lambda: cs.client_ce(t["logits"], labels, mask),
            lambda: cs.client_ce_plain(t["logits"], labels, mask),
            None, nbytes(t["logits"], labels, mask, t["dl"]),
            6 * t["dl"].numel(), f32),
        "client_sq_norm": (
            lambda: cs.client_sq_norm(g), lambda: cs.client_sq_norm_plain(g),
            lambda: torch.linalg.vector_norm(g, dim=1), nbytes(g),
            2 * g.numel(), f32),
        "client_sgd_update": (
            lambda: cs.client_sgd_update(pk2, mk2, g, partial, **opt),
            lambda: cs.client_sgd_update_plain(pk2, mk2, g, partial, **opt),
            None, 5 * nbytes(g), 5 * g.numel(), f32),
    }
    err_key = {"conv2_fwd_tf32": ("conv2_fwd", f32),
               "conv2_fwd_tc": ("conv2_fwd", bf16),
               "stem_fwd_tc": ("stem", bf16),
               "dense_fwd_tc": ("dense_fwd", bf16),
               "conv2_wgrad_tf32": ("conv_wgrad", f32, "dW"),
               "stem_wgrad_tf32": ("stem_wgrad", f32, "dW"),
               "conv2_dgrad_tf32": ("conv_dgrad", f32),
               "stem_fwd_f32": ("stem", f32),
               "dense_fwd_tf32": ("dense_fwd", f32),
               "dense_bwd_tf32": ("dense_bwd", f32, "dW"),
               "conv_wgrad_tc": ("conv_wgrad", bf16, "dW"),
               "conv_dgrad_tc": ("conv_dgrad", bf16),
               "dense_fwd": ("fc2", bf16),
               "dense_bwd_tc": ("dense_bwd", bf16, "dW"),
               "dense_bwd": ("fc2_bwd", bf16, "dW"),
               "client_ce": ("ce", f32), "client_sq_norm": ("sq_norm", f32),
               "client_sgd_update": ("sgd_update", f32)}
    for name, (kern, plain, lib, moved, flops, dt) in cases.items():
        # The library's time moves between runs (cuDNN's conv2 forward
        # took 1.47 and 2.42 ms in two runs of one build on an H100 80GB
        # HBM3 at 700 W): three timings in the turns, the median kept, the
        # spread printed.
        ms, plain_ms, lib_runs = turns_beside(kern, plain, lib)
        library_ms = lib_runs[1] if lib else None
        bound_ms, bound_by = bound(moved, flops, dt)
        lib_text = (f"{library_ms:.4f} ms (runs {lib_runs[0]:.4f}-"
                    f"{lib_runs[2]:.4f})" if lib else "none")
        core_text = ""
        if dt == f32:
            core_ms = max(moved / HBM_BYTES_PER_S * 1e3, f32_core_ms(flops))
            core_text = f"; at the f32 CUDA-core rate {core_ms:.4f} ms"
        print(f"[fused] {name} {'f32' if dt == f32 else 'bf16'}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_text}, "
              f"bound {bound_ms:.4f} ms ({bound_by}){core_text}")
        rows[name] = {
            "name": name, "route": "cuda",
            "source": FUSED_SOURCES[name.split("_")[0]],
            "replaces": K4_REPLACES,
            "max_abs_err": errs[err_key[name]], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        if err_key[name][0] in ("stem", "conv2_fwd"):
            rows[name]["argmax_agreement"] = agree[err_key[name][:2]]
        key = (err_key[name][0] + "_vs_plain",) + err_key[name][1:]
        if key in errs:  # max_abs_err: against f64 sums
            rows[name]["max_abs_err_vs_f32_plain"] = errs[key]
    # A dense backward has no single library call: as a reference, the two
    # torch.bmm (dW = dz^T x, dx = dz W; in bf16 fc1's W cast from the f32
    # buffer, fc2's x cast to f32) and the sum (db) that compute the same
    # outputs.
    for name, dz, xin, w in (("dense_bwd_tc", t["dz4"], t["f3"], w1),
                             ("dense_bwd_tf32", t32["dz4"], t32["f3"], w1),
                             ("dense_bwd", t["dl"], t["h4"], wf2)):
        ref_runs = sorted(time_ms(lambda _, dz=dz, xin=xin, w=w: (
            torch.bmm(dz.transpose(1, 2), xin.to(dz.dtype)),
            torch.bmm(dz, w.to(dz.dtype)), dz.float().sum(dim=1)), None)
            for _ in range(3))
        rows[name]["reference_ms"] = ref_runs[1]
        print(f"[fused] {name}: reference (two torch.bmm, W's cast and the "
              f"sum) {ref_runs[1]:.4f} ms (runs {ref_runs[0]:.4f}-"
              f"{ref_runs[2]:.4f})")
    # The other use of a kernel on the path (the stem's weight gradient),
    # with its library call and bound.
    dz1g = cc._grouped(cc._dense_dz(t["dh1"], t["h1"], t["a1"], 28, 28)
                       ).to(bf16).contiguous()
    live1 = int(((t["h1"] > 0) & (t["dh1"] != 0)).sum())
    extra = {
        "stem wgrad": (lambda: cc.conv_wgrad(x, t["dh1"], t["h1"], t["a1"],
                                             gwc1, gbc1, dtype=bf16),
                       lambda: cc.conv_wgrad_plain(x, t["dh1"], t["h1"],
                                                   t["a1"], gwc1, gbc1,
                                                   dtype=bf16),
                       lambda: torch.nn.grad.conv2d_weight(
                           xsg, w1g.shape, dz1g, padding=1, groups=c),
                       nbytes(x, t["dh1"], t["h1"], t["a1"], w1c, b1c),
                       2 * live1 * (9 + 1)),
    }
    for name, (kern, plain, lib, moved, flops) in extra.items():
        ms, plain_ms = turns(kern, plain)
        library_ms = time_ms(lambda _: lib(), None)
        bound_ms, bound_by = bound(moved, flops, bf16)
        print(f"[fused] {name} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
    print(f"[fused] live outputs of the weight gradients: stem {live1} "
          f"(bf16), {live1_32} (f32)")
    del engine, timed, t, t32, cases, extra
    torch.cuda.empty_cache()
    return rows


def phase_fused_path() -> dict:
    """7b and 7c: the kernel path against the mirror at f32, then at full
    width in bf16 with its gates; returns the launches of one call."""
    from multimodal_fl_security_tpu_torch.benchmarks.fused_kernel_bench import (
        run_bench,
        run_check,
    )
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        LAUNCHES_PER_STEP,
    )

    check = run_check()
    print(f"[fused] run_check: {json.dumps(check)}")
    if not check["max_abs_err_vs_mirror"] <= FUSED_CHECK_ATOL:
        raise AssertionError(f"fused_local_train differs from the mirror by "
                             f"{check['max_abs_err_vs_mirror']} > "
                             f"{FUSED_CHECK_ATOL}")
    check_kernels("run_check (f32)", check, f32_steps=4)
    t0 = time.perf_counter()
    bench = run_bench()
    print(f"[fused] run_bench in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(bench)}")
    print(f"[fused] ms per call: kernel path {bench['kernel_ms']:.3f}, "
          f"mirror {bench['mirror_ms']:.3f}, engine trainer "
          f"{bench['engine_ms']:.3f}, autograd trainer "
          f"{bench['autograd_ms']:.3f}; max drift from the mirror "
          f"{bench['max_drift_vs_mirror']:.6g}")
    failures = []
    if not bench["finite"]:
        failures.append("non-finite parameters")
    if bench["steps"] != 38 or bench["launches_total"] != \
            LAUNCHES_PER_STEP * 38:
        failures.append(f"launches {bench['launches_total']} != "
                        f"{LAUNCHES_PER_STEP} x 38")
    if not bench["bitwise_repeat"]:
        failures.append("two calls differ")
    if not bench["fedavg_accuracy"] > FUSED_MIN_ACCURACY:
        failures.append(f"FedAvg accuracy {bench['fedavg_accuracy']} <= "
                        f"{FUSED_MIN_ACCURACY}")
    if failures:
        raise AssertionError("fused local training: " + "; ".join(failures))
    check_kernels("run_bench (bf16)", bench, tc_steps=38)
    # The kernels' rows: the tensor-core ones and fc2's dense_fwd and
    # dense_bwd from the bf16 path, the f32 path's kernels from run_check
    # (the rows of the stem's f32 kernels: those kernels' counts).
    f32_path = check["kernel_launches"]
    return {**bench["launches"], **bench["kernel_launches"],
            **{k: f32_path[k] for k in ("stem_fwd_f32", "conv2_fwd_tf32",
                                        "conv2_wgrad_tf32", "stem_wgrad_tf32",
                                        "conv2_dgrad_tf32", "dense_fwd_tf32",
                                        "dense_bwd_tf32")}}


def phase_fused_f32_call() -> dict:
    """7c, continued: one f32 ``fused_local_train`` call on the north
    star's clients (``fused_kernel_bench.time_call``): ms per call and
    launches by kernel; finite parameters, every conv and dense launch on
    the f32 path's kernels, none on ``conv_fwd``."""
    from multimodal_fl_security_tpu_torch.benchmarks.fused_kernel_bench import (
        time_call,
    )

    res = time_call(torch.float32)
    runs = ", ".join(f"{r:.3f}" for r in res["ms_runs"])
    print(f"[fused] f32 call ({res['clients']} clients, 38 steps): "
          f"{res['ms_per_call']:.3f} ms per call (runs {runs}); launches by "
          f"kernel {res['kernel_launches']}")
    steps = 38
    want = {"stem_fwd_f32": steps, "conv2_fwd_tf32": steps,
            "stem_wgrad_tf32": steps,
            "conv2_wgrad_tf32": steps, "conv2_dgrad_tf32": steps,
            "dense_fwd": steps, "dense_fwd_tf32": steps, "dense_bwd": steps,
            "dense_bwd_tf32": steps}
    if not res["finite"] or res["kernel_launches"] != want:
        raise AssertionError(f"f32 call: finite {res['finite']}, launches "
                             f"{res['kernel_launches']}, expected {want}")
    return res


def stem_f64(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """K3 in f64 on the card: the accuracy checks' reference."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.ops import client_conv as cc

    c, b = x.shape[:2]
    xx = x.double().view(c, b, 28, 28, 8).permute(0, 1, 4, 2, 3)
    ww = w4.double().permute(0, 4, 3, 1, 2).reshape(-1, 8, 4, 4)
    return cc._ungrouped(F.conv2d(cc._grouped(xx), ww, stride=2, padding=1,
                                  groups=c), c).permute(0, 1, 3, 4, 2)


def phase_k3() -> list:
    """7d: K3, the raw stem conv, at [100, 32, 28*28*8] x [100, 4, 4, 8,
    128], in bf16 (``stem_raw_tc``) and f32 (``stem_raw_tf32``), then in f32
    off its geometry (``conv_fwd``, :func:`raw_conv_fwd`); returns the three
    rows, each one's launches those of its path (one ``client_stem_conv``
    call, every count set to 0 just before)."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.ops import client_conv as cc
    from multimodal_fl_security_tpu_torch.ops._launch import (
        kernel_launches,
        reset_kernel_launches,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    kernels = {bf16: "stem_raw_tc", f32: "stem_raw_tf32"}
    c, b = 100, 32
    gen = torch.Generator("cuda").manual_seed(9)
    x = torch.randn((c, b, 28 * 28 * 8), generator=gen, device="cuda")
    w4 = 0.1 * torch.randn((c, 4, 4, 8, 128), generator=gen, device="cuda")
    xi = torch.randint(-3, 4, x.shape, generator=gen, device="cuda").float()
    wi = torch.randint(-2, 3, w4.shape, generator=gen, device="cuda").float()
    ref = stem_f64(x, w4)
    rows = []
    for dt in (bf16, f32):
        name, kernel = ("bf16", "f32")[dt == f32], kernels[dt]
        xd, wd = x.to(dt), w4.to(dt)
        reset_kernel_launches()
        y = cc.client_stem_conv(xd, wd)
        torch.cuda.synchronize()
        launches = kernel_launches()
        print(f"[K3] path: one client_stem_conv call in {name}, launches by "
              f"kernel {launches}")
        if launches != {**dict.fromkeys(launches, 0), kernel: 1}:
            raise AssertionError(f"K3 in {name} did not run {kernel} once: "
                                 f"{launches}")
        if y.shape != (c, b, 14, 14, 128) or y.dtype != dt or \
                not bool(torch.isfinite(y).all()):
            raise AssertionError(f"K3's output: {tuple(y.shape)} {y.dtype}, "
                                 f"or not finite")
        want = cc.client_stem_conv_plain(xd, wd)
        err = held(f"K3 raw stem [100, 32, 6272] ({kernel})", y, want, dt)
        if dt == f32:
            e_k, e_p = (float((v.double() - ref).abs().max())
                        for v in (y, want))
            print(f"[K3] f32 vs f64: kernel {e_k:.6g}, plain {e_p:.6g}")
            if not e_k <= F64_FACTOR * e_p:
                raise AssertionError(f"K3 in f32: error against f64 {e_k} "
                                     f"over 4x the plain version's {e_p}")
        if not torch.equal(y, cc.client_stem_conv(xd, wd)):
            raise AssertionError(f"K3 in {name}: two calls differ")
        got_i = cc.client_stem_conv(xi.to(dt), wi.to(dt))
        with torch.backends.cudnn.flags(enabled=False):  # exact on integers
            want_i = cc.client_stem_conv_plain(xi.to(dt), wi.to(dt))
        if not torch.equal(got_i, want_i):
            raise AssertionError(f"K3 in {name} on integer operands differs "
                                 f"from its plain version")
        print(f"[K3] {name}: two calls bitwise equal; on integer operands "
              f"(max |sum| {float(want_i.float().abs().max()):.0f}) bitwise "
              f"the plain version")
        xg = cc._grouped(xd.view(c, b, 28, 28, 8).permute(0, 1, 4, 2, 3)
                         ).contiguous()
        wg = wd.permute(0, 4, 3, 1, 2).reshape(-1, 8, 4, 4).contiguous()
        ms, plain_ms = turns(lambda: cc.client_stem_conv(xd, wd),
                             lambda: cc.client_stem_conv_plain(xd, wd))
        lib_runs = sorted(time_ms(lambda _: F.conv2d(
            xg, wg, stride=2, padding=1, groups=c), None) for _ in range(3))
        moved = nbytes(xd, wd) + xd.element_size() * c * b * 196 * 128
        flops = 2 * c * b * 196 * 128 * 128
        bound_ms, bound_by = bound(moved, flops, dt)
        core_text = ""
        if dt == f32:
            core_ms = max(moved / HBM_BYTES_PER_S * 1e3, f32_core_ms(flops))
            core_text = f"; at the f32 CUDA-core rate {core_ms:.4f} ms"
        print(f"[K3] {kernel} {name}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (grouped F.conv2d) "
              f"{lib_runs[1]:.4f} ms (runs {lib_runs[0]:.4f}-"
              f"{lib_runs[2]:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}){core_text}")
        rows.append({"name": kernel, "route": "cuda", "source": K3_SOURCE,
                     "replaces": K3_REPLACES, "launches": launches[kernel],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_runs[1]})
        del xd, wd, y, want, got_i, want_i, xg, wg
    del x, w4, xi, wi, ref
    torch.cuda.empty_cache()
    rows.append(raw_conv_fwd(c, b, gen))
    return rows


def raw_conv_fwd(c: int, b: int, gen: torch.Generator) -> dict:
    """7d, continued: an f32 K3 call off K3's geometry (one input channel,
    as the north star's images: [C, B, 28*28] x [C, 4, 4, 1, 128]), whose
    path is one launch of the CUDA-core raw ``conv_fwd`` (every count set to
    0 just before); held to the plain version, its error against f64
    printed; times beside grouped ``F.conv2d``. Returns its row."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.ops import client_conv as cc
    from multimodal_fl_security_tpu_torch.ops._launch import (
        kernel_launches,
        reset_kernel_launches,
    )

    x = torch.randn((c, b, 28 * 28), generator=gen, device="cuda")
    w4 = 0.1 * torch.randn((c, 4, 4, 1, 128), generator=gen, device="cuda")
    reset_kernel_launches()
    y = cc.client_stem_conv(x, w4)
    torch.cuda.synchronize()
    launches = kernel_launches()
    print(f"[K3] path: one f32 client_stem_conv call at one input channel, "
          f"launches by kernel {launches}")
    if launches != {**dict.fromkeys(launches, 0), "conv_fwd": 1}:
        raise AssertionError(f"K3 off its geometry did not run conv_fwd "
                             f"once: {launches}")
    if y.shape != (c, b, 14, 14, 128) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"K3's output off its geometry: "
                             f"{tuple(y.shape)}, or not finite")
    want = cc.client_stem_conv_plain(x, w4)
    err = held("K3 raw stem [100, 32, 784] (conv_fwd)", y, want,
               torch.float32)
    xg = cc._grouped(x.view(c, b, 1, 28, 28))  # [B, C, 28, 28]
    wg = w4.permute(0, 4, 3, 1, 2).reshape(-1, 1, 4, 4).contiguous()
    ref = cc._ungrouped(F.conv2d(xg.double(), wg.double(), stride=2,
                                 padding=1, groups=c), c).permute(0, 1, 3, 4,
                                                                  2)
    print(f"[K3] conv_fwd f32 vs f64: kernel "
          f"{float((y.double() - ref).abs().max()):.6g}, plain "
          f"{float((want.double() - ref).abs().max()):.6g}")
    ms, plain_ms = turns(lambda: cc.client_stem_conv(x, w4),
                         lambda: cc.client_stem_conv_plain(x, w4))
    lib_runs = sorted(time_ms(lambda _: F.conv2d(
        xg, wg, stride=2, padding=1, groups=c), None) for _ in range(3))
    moved = nbytes(x, w4, y)
    flops = 2 * c * b * 196 * 128 * 16
    bound_ms, bound_by = bound(moved, flops)
    print(f"[K3] conv_fwd f32 at one input channel: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (grouped F.conv2d) "
          f"{lib_runs[1]:.4f} ms (runs {lib_runs[0]:.4f}-{lib_runs[2]:.4f}), "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    row = {"name": "conv_fwd", "route": "cuda",
           "source": FUSED_SOURCES["conv"], "replaces": K3_REPLACES,
           "launches": launches["conv_fwd"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_runs[1]}
    del x, w4, y, want, ref, xg, wg
    torch.cuda.empty_cache()
    return row


def kernel_counts(f32_steps: int = 0, tc_steps: int = 0) -> dict:
    """The launches by kernel of ``f32_steps`` f32 and ``tc_steps`` bf16
    SGD steps of the kernel path: per step two forward convs, two weight
    gradients and one input gradient, and fc1's and fc2's forward and
    backward; in f32 conv2 and fc1 on the 3xTF32 kernels (conv2_fwd_tf32,
    conv2_wgrad_tf32, conv2_dgrad_tf32, dense_fwd_tf32, dense_bwd_tf32),
    the stem's forward on stem_fwd_f32, its weight gradient on
    stem_wgrad_tf32 and fc2 on the CUDA-core kernels, none on conv_fwd;
    in bf16 all on the tensor-core ones but fc2's (f32
    weights)."""
    return {"conv_fwd": 0, "conv2_fwd_tc": tc_steps,
            "conv2_fwd_tf32": f32_steps, "stem_fwd_tc": tc_steps,
            "stem_fwd_f32": f32_steps, "stem_raw_tc": 0, "stem_raw_tf32": 0,
            "conv2_wgrad_tf32": f32_steps,
            "stem_wgrad_tf32": f32_steps,
            "conv_wgrad_tc": 2 * tc_steps,
            "conv_dgrad_tc": tc_steps, "conv2_dgrad_tf32": f32_steps,
            "dense_fwd": f32_steps + tc_steps, "dense_fwd_tc": tc_steps,
            "dense_fwd_tf32": f32_steps, "dense_bwd": f32_steps + tc_steps,
            "dense_bwd_tc": tc_steps, "dense_bwd_tf32": f32_steps}


def check_kernels(what: str, result: dict, f32_steps: int = 0,
                  tc_steps: int = 0) -> None:
    """Every launch of the conv and dense wrappers went through the kernel
    of its dtype (:func:`kernel_counts`)."""
    want = kernel_counts(f32_steps, tc_steps)
    got = result["kernel_launches"]
    print(f"[fused] {what}: launches by kernel {got}")
    if got != want:
        raise AssertionError(f"{what}: launches by kernel {got}, expected "
                             f"{want}")


def probe_wrappers() -> dict:
    """Every probe kernel's wrapper (K5, K6), by name."""
    from multimodal_fl_security_tpu_torch.ops import (
        philox,
        probe_contract,
        probe_layout,
        probe_reduce,
    )

    return {w.__name__: w for w in (probe_layout.gather,
                                    probe_contract.contract,
                                    philox.philox_draw_twice,
                                    *probe_reduce.WRAPPERS)}


def run_counted(run, what: str) -> dict:
    """A probe set's ``run_probes`` on the card with every probe kernel's
    count set to 0 just before; raises if a probe failed, else returns the
    launches by wrapper (and the results, under "results"). Prints each
    contraction shape's split over k."""
    from multimodal_fl_security_tpu_torch.ops.probe_contract import contract

    wrappers = probe_wrappers()
    for w in wrappers.values():
        w.launches = 0
    contract.plans.clear()
    results = run("cuda")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    for shape, (splits, chunk) in contract.plans.items():
        print(f"[{what}] contract (batch, m, n, k) {shape}: {splits} "
              f"split(s) of k, chunk {chunk}")
    failed = [r for r in results if r["status"] != "PASS"]
    for r in failed:
        print(f"[{what}] FAIL {r['probe']}: {r['detail']}")
    if failed:
        raise AssertionError(f"{what}: {len(failed)} of {len(results)} "
                             f"probes failed")
    print(f"[{what}] {len(results)} of {len(results)} probes passed; "
          f"launches {launches}")
    return {"launches": launches, "results": results}


def probe_row(name: str, ms: float, plain_ms: float, library_ms, moved: int,
              ops: float, err: float) -> dict:
    source, replaces, probe = PROBE_KERNELS[name]
    bound_ms, bound_by = bound(moved, ops)
    lib_text = f"{library_ms:.4f} ms" if library_ms is not None else "none"
    print(f"[kernels] {name} at {probe}'s shapes: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_text}, bound {bound_ms:.6f} ms "
          f"({bound_by}), max|kernel-plain| {err:.3g}")
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def stable_factor(what: str, name: str, kern, other, other_name: str,
                  rounds: int = 5) -> dict:
    """``kern`` against ``other`` in ``rounds`` rounds of :func:`turns`:
    prints the factor kern / other of each round's means, its median and
    range, and both medians; returns them as row keys."""
    runs = [turns(kern, other, 10) for _ in range(rounds)]
    f = sorted(k / o for k, o in runs)
    k_med = sorted(k for k, _ in runs)[rounds // 2]
    o_med = sorted(o for _, o in runs)[rounds // 2]
    print(f"[{what}] {name} over {rounds} rounds of turns: kernel "
          f"{k_med:.4f} ms, {other_name} {o_med:.4f} ms (medians); factor "
          f"median {f[rounds // 2]:.3f}, range {f[0]:.3f}-{f[-1]:.3f}")
    return {f"factor_vs_{other_name}_median": f[rounds // 2],
            f"factor_vs_{other_name}_range": [f[0], f[-1]],
            "ms_median_5": k_med, f"{other_name}_ms_median_5": o_med}


def phase_probes() -> tuple:
    """8: the K5 probes; returns (rows of the kernels line without
    launches, launches by wrapper)."""
    import torch.nn.functional as F

    from multimodal_fl_security_tpu_torch.benchmarks import launch_split
    from multimodal_fl_security_tpu_torch.benchmarks import mosaic_probe as mp

    run = run_counted(mp.run_probes, "K5")
    errs = {r["probe"]: r["max_abs_err"] for r in run["results"]}
    gen = torch.Generator("cuda").manual_seed(5)
    inputs, times, contract_lib = {}, {}, {}
    for probe in mp.PROBES:
        args = inputs[probe.name] = probe.make(gen, torch.device("cuda"))
        times[probe.name] = turns(lambda: probe.kernel(*args),
                                  lambda: probe.plain(*args))
        lib_text = ""
        if probe.name in CONTRACT_LIBRARY:
            lib, k = CONTRACT_LIBRARY[probe.name]
            runs = sorted(time_ms(lambda _: lib(*args), None)
                          for _ in range(3))
            contract_lib[probe.name] = runs[1]
            outputs = lib(*args).numel()
            bound_ms, bound_by = bound(nbytes(*args) + 4 * outputs,
                                       2 * outputs * k)
            lib_text = (f", library {runs[1]:.4f} ms (runs {runs[0]:.4f}-"
                        f"{runs[2]:.4f}), bound {bound_ms:.4f} ms "
                        f"({bound_by})")
        print(f"[K5] {probe.name} ({probe.family}): kernel "
              f"{times[probe.name][0]:.4f} ms, plain {times[probe.name][1]:.4f}"
              f" ms{lib_text}, max|kernel-plain| {errs[probe.name]:.3g}")
    for family in ("layout", "contract", "reduce", "prng"):
        names = [p.name for p in mp.PROBES if p.family == family]
        print(f"[K5] family {family}: kernel {sum(times[n][0] for n in names):.4f}"
              f" ms over {len(names)} probes, plain "
              f"{sum(times[n][1] for n in names):.4f} ms")

    (x,) = inputs["major_transpose"]
    g, w = inputs["dgrad_rhs_T_big"]
    xs, lab = inputs["softmax_masked"]
    (xp,) = inputs["sublane_pool_reshape"]
    (d,) = inputs["selector_matmul_fold"]
    (dg,) = inputs["grid_scratch_persist"]
    (ds,) = inputs["scalar_accum_smem"]
    f4 = 4
    lab_long = lab.long().squeeze(1)  # the library call's label type
    # (library call or None, bytes moved, operations) at each kernel's probe
    cases = {
        "gather": (lambda: x.permute(1, 0, 2).contiguous(), 2 * nbytes(x), 0),
        "contract": (lambda: torch.matmul(g, w.T),
                     nbytes(g, w) + f4 * g.shape[0] * w.shape[0],
                     2 * g.shape[0] * w.shape[0] * g.shape[1]),
        # The -1e30 lanes add exactly 0 to the masked sum: the NLL over the
        # 10 valid lanes is the same function.
        "masked_ce": (lambda: F.cross_entropy(xs[:, :10], lab_long,
                                              reduction="none"),
                      nbytes(xs, lab) + f4 * xs.shape[0], 5 * xs.numel()),
        "max2": (lambda: xp.view(32, 7, 2, 4, 256).amax(dim=2),
                 nbytes(xp) * 3 // 2, xp.numel() // 2),
        "block_fold": (lambda: torch.einsum("bibj->ij", d.view(4, 32, 4, 64)),
                       f4 * 5 * 32 * 64, 3 * 32 * 64),
        "carry_sum": (lambda: dg.sum(dim=1), nbytes(dg) * 6 // 5, dg.numel()),
        "scalar_accum": (lambda: ds.sum(), nbytes(ds) + f4, ds.numel()),
        # Integer work, counted at the f32 rate: ~100 operations per Philox
        # call, two draws of 2,048 calls; out: two int64 draws and an f32.
        "philox_draw_twice": (None, 32 * 256 * (8 + 8 + 4),
                              2 * 2048 * 100),
    }
    rows = {}
    for name, (lib, moved, ops) in cases.items():
        probe = PROBE_KERNELS[name][2]
        library_ms = time_ms(lambda _: lib(), None) if lib else None
        rows[name] = probe_row(name, *times[probe], library_ms, moved, ops,
                               errs[probe])
    # Host-bound kernels' factors over their library calls move 2-4x from
    # run to run: each kernel against its library call in 5 rounds of
    # turns, the factor's median and range.
    by_name = {p.name: p for p in mp.PROBES}
    for name, (lib, _, _) in cases.items():
        if lib is not None:
            probe = by_name[PROBE_KERNELS[name][2]]
            args = inputs[probe.name]
            rows[name].update(stable_factor(
                "K5", name, lambda: probe.kernel(*args), lib, "library"))
    # max2's and carry_sum's time a call, apart: the device time of one
    # launch and the host time of one wrapper call, beside their library
    # calls' (benchmarks/launch_split.py).
    split = launch_split.measure()
    for name, lib_name in (("max2", "amax"), ("carry_sum", "sum")):
        k, lib_split = split[name], split[lib_name]
        rows[name]["launch_split_us"] = k
        rows[name]["library_launch_split_us"] = lib_split
        dev = [f"{r['device_us_profiler']:.2f} us"
               if r["device_us_profiler"] is not None else "not measured"
               for r in (k, lib_split)]
        print(f"[K5] {name} a call: device {dev[0]} (profiler), host "
              f"{k['host_us']:.2f} us; {lib_name}: device {dev[1]}, host "
              f"{lib_split['host_us']:.2f} us; factor over {lib_name} "
              f"(5 rounds) {rows[name]['factor_vs_library_median']:.3f}")
    # The contraction at its longest k, beside its library call.
    rows["contract"]["ms_einsum_brl_rlf"] = times["einsum_brl_rlf"][0]
    rows["contract"]["library_ms_einsum_brl_rlf"] = \
        contract_lib["einsum_brl_rlf"]
    return rows, run["launches"]


def phase_ad_probes() -> tuple:
    """9: the K6 probes; returns (rows of the backward-only kernels without
    launches, launches by wrapper)."""
    from multimodal_fl_security_tpu_torch.benchmarks import (
        ad_in_kernel_probe as ad,
    )
    from multimodal_fl_security_tpu_torch.ops import probe_reduce as pr
    from multimodal_fl_security_tpu_torch.ops.probe_autograd import PLAIN_OPS

    run = run_counted(ad.run_probes, "K6")
    errs = {r["probe"]: r["max_abs_err"] for r in run["results"]}
    gen = torch.Generator("cuda").manual_seed(6)
    for probe in ad.PROBES:
        args = probe.make(gen, torch.device("cuda"))
        ms, plain_ms = turns(lambda: probe.grads(*args),
                             lambda: probe.grads(*args, ops=PLAIN_OPS), 10)
        print(f"[K6] {probe.name}: hand-written backward {ms:.4f} ms, "
              f"torch.autograd of the plain body {plain_ms:.4f} ms, "
              f"max|kernel-plain| {errs[probe.name]:.3g}")

    # The kernels only the backward passes launch, at ad_mask_relu_max's
    # shapes: its relu and row mask, and its lane max's backward.
    (x,) = ad.BY_NAME["ad_mask_relu_max"].make(gen, torch.device("cuda"))
    keep = ad.ROW_KEEP
    a = pr.relu_mask(x, *keep)
    b = torch.roll(a, 64, 2)
    gout = torch.randn(x.shape, generator=gen, device="cuda")
    ga, gb, pa, pb = (torch.empty_like(x) for _ in range(4))

    def max2_bwd():
        pr.max2_bwd(a, b, gout, ga, gb)
        return ga, gb

    def max2_bwd_plain():
        pr.max2_bwd_plain(a, b, gout, pa, pb)
        return pa, pb

    cases = {
        "relu_mask": (lambda: pr.relu_mask(x, *keep),
                      lambda: pr.relu_mask_plain(x, *keep),
                      2 * nbytes(x), x.numel()),
        "relu_mask_bwd": (lambda: pr.relu_mask_bwd(x, gout, *keep),
                          lambda: pr.relu_mask_bwd_plain(x, gout, *keep),
                          3 * nbytes(x), x.numel()),
        "max2_bwd": (max2_bwd, max2_bwd_plain, 5 * nbytes(x),
                     2 * x.numel()),
    }
    rows = {}
    for name, (kern, plain, moved, ops) in cases.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((u - v).abs().max()) for u, v in zip(got, want))
        if not all(torch.equal(u, v) for u, v in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max err {err})")
        rows[name] = probe_row(name, *turns(kern, plain), None, moved, ops,
                               err)
        # No library call computes these: the kernel against its plain
        # version, in the same 5 rounds.
        rows[name].update(stable_factor("K6", name, kern, plain, "plain"))
    return rows, run["launches"]


def phase_dropout() -> tuple:
    """10: K4's dropout; returns (its row without launches, its launches on
    one call at full width)."""
    from multimodal_fl_security_tpu_torch.benchmarks.fused_kernel_bench import (
        run_bench,
        run_check,
    )
    from multimodal_fl_security_tpu_torch.ops.client_dropout import (
        dropout_apply,
        dropout_apply_plain,
    )
    from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
        LAUNCHES_PER_DROPOUT_STEP,
    )

    gen = torch.Generator("cuda").manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in ((100, 32, 3136), (100, 32, 128)):
        for dt in (f32, bf16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            kw = dict(seed=7, step=37, stream=1, keep=0.75, dtype=dt)
            got, want = dropout_apply(x, **kw), dropout_apply_plain(x, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"dropout {shape} {dt}: the kernel "
                                     f"differs from its plain version")
            kept = float((got != 0).float().mean())
            print(f"[dropout] {shape} {dt}: bitwise the plain version; kept "
                  f"{kept:.6f} (keep 0.75)")
    x = torch.randn((100, 32, 3136), generator=gen, device="cuda").to(bf16)
    kw = dict(seed=7, step=37, stream=0, keep=0.75, dtype=bf16)
    ms, plain_ms = turns(lambda: dropout_apply(x, **kw),
                         lambda: dropout_apply_plain(x, **kw), 10)
    # 2.5 M Philox calls of ~100 integer operations, at the f32 rate.
    bound_ms, bound_by = bound(2 * nbytes(x), x.numel() // 4 * 100)
    print(f"[dropout] [100, 32, 3136] bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    row = {"name": "dropout_apply", "route": "cuda", "source": DROPOUT_SOURCE,
           "replaces": DROPOUT_REPLACES, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}

    check = run_check(use_dropout=True)
    print(f"[dropout] run_check: {json.dumps(check)}")
    if not check["max_abs_err_vs_mirror"] <= FUSED_CHECK_ATOL:
        raise AssertionError(f"fused_local_train with dropout differs from "
                             f"the mirror by {check['max_abs_err_vs_mirror']}"
                             f" > {FUSED_CHECK_ATOL}")
    check_kernels("run_check(use_dropout=True) (f32)", check, f32_steps=4)
    t0 = time.perf_counter()
    bench = run_bench(use_dropout=True)
    print(f"[dropout] run_bench(use_dropout=True) in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(bench)}")
    print(f"[dropout] ms per call: with dropout {bench['kernel_ms']:.3f}, "
          f"without {bench['no_dropout_ms']:.3f}; mirror (masks given) "
          f"{bench['mirror_ms']:.3f}, engine trainer {bench['engine_ms']:.3f}, "
          f"autograd trainer {bench['autograd_ms']:.3f}; "
          f"max drift from the mirror {bench['max_drift_vs_mirror']:.6g}")
    failures = []
    if not bench["finite"]:
        failures.append("non-finite parameters")
    if bench["steps"] != 38 or bench["launches_total"] != \
            LAUNCHES_PER_DROPOUT_STEP * 38:
        failures.append(f"launches {bench['launches_total']} != "
                        f"{LAUNCHES_PER_DROPOUT_STEP} x 38")
    if not bench["bitwise_repeat"]:
        failures.append("two calls with one seed differ")
    if not bench["max_change_other_seed"] > 0:
        failures.append("another seed gives the same parameters")
    if not bench["fedavg_accuracy"] > DROPOUT_MIN_ACCURACY:
        failures.append(f"FedAvg accuracy {bench['fedavg_accuracy']} <= "
                        f"{DROPOUT_MIN_ACCURACY}")
    if failures:
        raise AssertionError("dropout path: " + "; ".join(failures))
    check_kernels("run_bench(use_dropout=True) (bf16)", bench, tc_steps=38)
    return row, bench["launches"]["dropout_apply"]


def phase_drawn_dropout() -> dict:
    """10, continued: the kernel step's ``drawn_dropout`` against its
    plain version at the round's shapes and keeps, f32 and bf16 (bitwise),
    then timed; returns its row of the kernels line without launches."""
    from multimodal_fl_security_tpu_torch.ops.client_dropout import (
        drawn_dropout,
        drawn_dropout_plain,
    )

    gen = torch.Generator("cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    for shape, keep in DRAWN_DROPOUT_CASES:
        u = torch.rand(shape, generator=gen, device="cuda")
        for dt in (f32, bf16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            kw = dict(keep=keep, dtype=dt)
            got, want = drawn_dropout(x, u, **kw), drawn_dropout_plain(x, u,
                                                                       **kw)
            bits = torch.int32 if dt == f32 else torch.int16
            if not torch.equal(got.view(bits), want.view(bits)):
                raise AssertionError(f"drawn_dropout {shape} {dt}: the kernel "
                                     f"differs from its plain version")
            ms, plain_ms = turns(lambda: drawn_dropout(x, u, **kw),
                                 lambda: drawn_dropout_plain(x, u, **kw), 10)
            bound_ms, bound_by = bound(nbytes(x, u, got), 0)
            times[(shape, dt)] = (ms, plain_ms, bound_ms, bound_by)
            kept = float((u < keep).float().mean())
            print(f"[dropout] drawn_dropout {list(shape)} {dt} keep {keep}: "
                  f"bitwise the plain version; kept {kept:.6f}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    # The row: fc1's input layer in f32, the benchmark's cells' path.
    ms, plain_ms, bound_ms, bound_by = times[(DRAWN_DROPOUT_CASES[0][0], f32)]
    return {"name": "drawn_dropout", "route": "cuda",
            "source": DROPOUT_SOURCE, "replaces": DRAWN_DROPOUT_REPLACES,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main() -> None:
    name = phase_device()
    phase_build()
    gram_row = phase_kernel()
    sort_row = phase_sorted_reduce_kernel()
    north_star = phase_main_path()
    robust = phase_robust_rounds()
    fused_rows = phase_fused_kernels()
    fused = phase_fused_path()
    phase_fused_f32_call()
    k3_rows = phase_k3()
    probe_rows, k5 = phase_probes()
    ad_rows, k6 = phase_ad_probes()
    drop_row, drop_launches = phase_dropout()
    drawn_row = phase_drawn_dropout()
    # Each path ran with the counts set to 0 just before it. Local
    # training's kernels: their launches in R1-R5's rounds (the kernel
    # trainer), by kernel where a wrapper runs several.
    trainer = {**robust["trainer"], **robust["kernels"]}
    gram_row["launches"] = north_star + robust["gram"]
    sort_row["launches"] = robust["sorted_reduce"]
    for kernel, row in fused_rows.items():
        row["launches"] = trainer[kernel]
    for kernel, row in {**probe_rows, **ad_rows}.items():
        row["launches"] = k5[kernel] + k6[kernel]
    drop_row["launches"] = drop_launches
    drawn_row["launches"] = trainer["drawn_dropout"]
    print(f"[paths] gram launches: {north_star} (Krum north star) + "
          f"{robust['gram']} (R4); sorted_reduce launches: "
          f"{robust['sorted_reduce']} (R1-R5); the kernel step in R1-R5 "
          f"(bf16 R1-R4, f32 R5): by wrapper {robust['trainer']}, by kernel "
          f"{robust['kernels']}; fused_local_train (one call, 38 steps, "
          f"bf16): {fused}; K3 (one call each): "
          f"{ {r['name']: r['launches'] for r in k3_rows} }; K5 probes: "
          f"{k5}; K6 probes: {k6}; "
          f"Philox dropout (one call, 38 steps): {drop_launches}")
    rows = [gram_row, sort_row, *fused_rows.values(), *k3_rows,
            *probe_rows.values(), *ad_rows.values(), drop_row, drawn_row]
    missing = [r["name"] for r in rows if not r["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
