"""CPU tests of the benchmark's arithmetic and of its correctness check.

Run from the repository root: ``python -m pytest torch_bench/tests``. The
runs here use the cells' own configurations and limits at a tiny traffic
size (9 clients, 64 samples), with the harness's look for a card skipped.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
import types

import pytest
import torch

from torch_bench import correctness, faults, run
from torch_bench.cell import load_cell
from torch_bench.end_to_end import round_ms_p90
from torch_bench.metrics import device_idle_share, mfu
from torch_bench.peaks import bound_s
from torch_bench.rooflines import gram, sorted_reduce
from torch_bench.trace import Trace, breakdown, busy_ns, gaps, short_name

CELLS = ("trimmed_alie_c100_f32", "bulyan_minmax_c100_f32")
D = 421_642
SEED = 2**31 + 11


def tiny(cell, samples: int = 64):
    """The cell at 9 clients x ``samples``, one colluder, f = 1."""
    mix = dict(cell.traffic, clients=9, samples_per_client=samples)
    if mix["malicious_clients"]:
        mix["malicious_clients"] = 1
    for part in ("attack", "defense"):
        conf = dict(mix[part]["config"])
        if "num_malicious" in conf:
            conf["num_malicious"] = 1
        mix[part] = dict(mix[part], config=conf)
    return dataclasses.replace(cell, traffic=mix)


def run_tiny(cell, plant=None):
    torch.manual_seed(0)
    return run.run_cell(cell, SEED, 0.01, False, device="cpu",
                        t_start=time.perf_counter(), plant=plant)


@dataclasses.dataclass
class _Ctx:
    round_s: list


def test_round_ms_p90_is_taken_over_every_round():
    rounds = [0.001 * k for k in range(1, 11)]  # 1..10 ms
    got = round_ms_p90.read(_Ctx(rounds))
    assert got == pytest.approx(9.1)
    assert got == pytest.approx(
        statistics.quantiles([1e3 * t for t in rounds], n=10,
                             method="inclusive")[8])
    assert round_ms_p90.read(_Ctx([0.25])) == pytest.approx(250.0)


def test_mfu_flops_match_the_hand_count_at_the_north_star():
    # fwd a sample: conv1 2*9*1*32*784 + conv2 2*9*32*64*196
    # + fc1 2*3136*128 + fc2 2*128*10 = 8,482,304; training 3x over
    # 100 clients x 600 samples x 2 epochs; the Gram 2 * 100^2 * D (the
    # sorted reduce counts no FLOPs).
    hand = 3 * 8_482_304 * 120_000 + 2 * 100 * 100 * D
    assert hand == pytest.approx(3.062e12, rel=1e-4)
    assert mfu.round_flops(load_cell("bulyan_minmax_c100_f32")) == hand
    # no Gram in the trimmed-mean cell
    assert mfu.round_flops(load_cell("trimmed_alie_c100_f32")) == \
        3 * 8_482_304 * 120_000


def test_roofline_bounds_at_the_north_star():
    # PERF.md's 0.050 ms counted U and G; the kernel reads the mean too.
    t, by = bound_s(*gram.cost({"rows": 100}, D))
    assert by == "bytes"
    assert t == pytest.approx(4 * (100 * D + D + 100 * 100) / 3.35e12)
    assert 0.050e-3 < t < 0.051e-3
    t, by = bound_s(*sorted_reduce.cost({"rows": 100}, D))
    assert by == "bytes"
    assert t == pytest.approx(4 * (100 * D + D) / 3.35e12)
    assert round(t * 1e3, 3) == 0.051
    # operations: C (C + 1) D at the 3xTF32 rate
    assert gram.cost({"rows": 100}, D)[1] == 100 * 101 * D


def test_short_kernel_names():
    assert short_name("void (anonymous namespace)::k<float>(float*, int)") \
        == "k"
    assert short_name("void at::native::(anonymous namespace)::"
                      "max_pool_backward_nchw<float, float>(int, float*)") \
        == "at::native::max_pool_backward_nchw"
    assert short_name("gram_tc_kernel(float const*, float*, int)") == \
        "gram_tc_kernel"


def test_idle_share_is_the_union_of_device_intervals():
    device = [("k", 0, 10), ("k", 5, 15), ("m", 20, 30), ("k", 38, 50)]
    assert busy_ns([(s, e) for _, s, e in device], 0, 40) == 27
    assert gaps([(s, e) for _, s, e in device], 0, 40) == [(15, 20),
                                                          (30, 38)]
    trace = Trace(rounds=2, window=(0, 40), device=device,
                  labels=[("round", 0, 18), ("round", 19, 40),
                          ("attack", 29, 31)],
                  host=[("aten::sort", 14, 21), ("aten::mm", 30, 33)])
    assert trace.busy_s() == pytest.approx(27e-9)
    share = device_idle_share.read(types.SimpleNamespace(trace=trace))
    assert share == pytest.approx(100 * 13 / 40)
    out = breakdown(trace, trace)
    assert out["device_ops"][0] == ["k", pytest.approx(32e-9)]  # summed
    assert out["idle_gaps"] == [["attack:aten::mm", pytest.approx(8e-9)],
                                ["round:aten::sort", pytest.approx(5e-9)]]
    assert len(trace.kernels()) == 4


def test_worst_leaf_gap_leaves_out_still_leaves():
    leaves = [["a", [4]], ["b", [4]], ["c", [4]]]
    want = torch.tensor([1.0] * 4 + [2.0] * 4 + [1e-9] * 4)
    got = want.clone()
    got[8:] = 5.0  # a still leaf moved: left out by the rule
    assert correctness.worst_leaf_gap(got, want, leaves) == 0.0
    got[:4] *= 1.5
    assert correctness.worst_leaf_gap(got, want, leaves) == \
        pytest.approx(1.0 / 2.0)  # |3 - 2| / max(2, median 2)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_port_in_f32(workload):
    """The port's round against the plain reference at a tiny size: every
    number is rounding-small, but min_max's crafted rows, whose threshold
    the port takes from an uncentered f32 Gram (``attacks/agr_agnostic.py``)
    and the reference from exact distances."""
    res = run_tiny(tiny(load_cell(workload)))
    for name, c in res["checks"].items():
        small = 1e-2 if name == "attack_gap" else 1e-3
        assert c["value"] is not None and c["value"] < small, (name, c)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = run_tiny(tiny(load_cell(workload)))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The reference in the control precision (TF32), in the program's
    place. Its gap from the f32 reference grows over a client's local steps,
    so the clients keep the cell's 600 samples (38 steps a round)."""
    cell = tiny(load_cell(workload), samples=600)
    res = run_tiny(cell, faults.control(cell.config, cell.traffic))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in sorted(faults.PLANTS)
    if f != "altered_attack" or load_cell(w).traffic["attack"]["name"] != "none"])
def test_a_fault_is_not_correct(workload, fault):
    res = run_tiny(tiny(load_cell(workload)), faults.PLANTS[fault])
    assert not res["correct"], res["checks"]


def test_result_line_keys_and_checks_last():
    res = run_tiny(tiny(load_cell("trimmed_alie_c100_f32")))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"rounds_per_min", "round_ms_p90",
                                   "setup_s"}
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())


def test_a_near_tie_takes_the_program_s_pick():
    """Two rows whose Krum scores tie within the f32 Gram's rounding: the
    reference takes the program's pick of either; a row that scores far
    above the lowest is not taken, nor in Bulyan's selections."""
    from torch_bench.reference.defenses import bulyan, krum

    g = torch.Generator().manual_seed(5)
    rows = torch.randn(11, 4096, generator=g)
    rows[1] = rows[0]  # scores tie exactly: the first is the lowest
    conf = {"num_malicious": 2}
    sc = krum.scores(krum.distances(rows), 2)
    low = int(torch.argmin(sc))
    twin = 1 - low if low in (0, 1) else None
    assert twin is not None, "the tied pair scores lowest by construction"
    far = int(torch.argmax(sc))
    for pick, want in ((twin, twin), (far, low), (low, low)):
        prefer = torch.zeros(11, dtype=torch.bool)
        prefer[pick] = True
        assert krum.select(rows, conf, prefer).tolist() == [want]
    assert krum.select(rows, conf).tolist() == [low]
    tie = krum.margin(krum.distances(rows), krum.f32_distances(rows), 2)
    assert 0.0 < tie < 1e-4 * float(sc.min())
    own = bulyan.select(rows, conf)
    swapped = [twin if i == low else i for i in own]
    prefer = torch.zeros(11, dtype=torch.bool)
    prefer[swapped] = True
    assert sorted(bulyan.select(rows, conf, prefer)) == sorted(own)
    prefer[far] = True
    prefer[own[-1]] = False
    assert far not in bulyan.select(rows, conf, prefer)


def test_control_precisions_round_as_stated():
    from torch_bench.reference.precision import round_to

    x = torch.tensor([1.0, -0.3, 2.0**-10, 448.0 / 3.0])
    for mode, grid in (("fp8", 8), ("int8", 127)):
        y = round_to(x, mode)
        scale = float(x.abs().max()) / (448.0 if mode == "fp8" else 127.0)
        assert float(y.abs().max()) == pytest.approx(float(x.abs().max()))
        if mode == "int8":
            assert torch.allclose(y / scale, torch.round(x / scale),
                                  atol=1e-4)
        else:  # e4m3: 3 mantissa bits, a relative step of 2**-3 at most
            assert float(((y - x).abs() / x.abs())[:2].max()) <= 2.0**-4
    # TF32 keeps 10 mantissa bits; a tie goes away from zero
    assert round_to(torch.tensor([1.0 + 2.0**-12]), "tf32").item() == 1.0
    assert round_to(torch.tensor([1.0 + 2.0**-11]), "tf32").item() == \
        1.0 + 2.0**-10
