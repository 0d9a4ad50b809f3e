"""Port sorted reduction and client-axis reductions against the JAX package's.

The JAX side runs its Pallas sorted-reduce kernel in interpret mode, as
``tests/test_pallas_kernels.py`` does, with a small ``block_d`` so the grid's
ragged last block runs. The port side runs the plain torch version (a CPU
tensor). Tolerances: the median must be equal (the same sorted value); a
trimmed mean within atol 1e-6 * max|U| (f32 sums in different orders);
the geometric median within atol 1e-5 * max|U| (Weiszfeld iterations over
sums in different orders). The CUDA cases hold the Hopper kernel to the
plain version on the card and skip without one.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops.reductions import (
    clip_rows,
    coordinate_median,
    geometric_median,
    row_norms,
    trimmed_mean,
    weiszfeld,
)
from multimodal_fl_security_tpu_torch.ops.sorted_reduce import (
    sorted_reduce,
    sorted_reduce_plain,
)

CS = [1, 2, 5, 8, 20, 100]
RAGGED = [(1, 1000), (2, 1000), (7, 1000), (65, 4099), (128, 3001),
          (130, 3001), (1024, 2049)]


def jax_ops():
    """The JAX references, imported where they are used: the CUDA cases must
    also run on a machine that has no JAX (``pytest --noconftest -m cuda``)."""
    import jax.numpy as jnp

    from multimodal_fl_security_tpu.ops import pallas_kernels, reductions

    return jnp, pallas_kernels, reductions


def trim_for(c):
    return min(max(1, c // 10), (c - 1) // 2)


def hard_updates(c, d, seed=0):
    """Near-identical rows (like client parameters), some exact repeats (as
    ALIE's colluders make them) and a few +-inf entries."""
    rng = np.random.RandomState(seed)
    u = (rng.normal(0, 1, size=(1, d))
         + 0.05 * rng.normal(0, 1, size=(c, d))).astype(np.float32)
    if c >= 4:
        u[c // 2:c // 2 + max(1, c // 5)] = u[0]  # ties
    u[rng.randint(0, c, 3), rng.randint(0, d, 3)] = np.inf
    u[rng.randint(0, c, 3), rng.randint(0, d, 3)] = -np.inf
    return u


def atol_of(u, rel):
    return rel * float(np.abs(u[np.isfinite(u)]).max())


@pytest.mark.parametrize("mode", ["median", "trimmed"])
@pytest.mark.parametrize("c", CS)
def test_sorted_reduce_matches_pallas(c, mode):
    jnp, pallas_kernels, _ = jax_ops()
    u = hard_updates(c, 300, seed=c)
    trim = trim_for(c)
    want = np.asarray(pallas_kernels.sorted_reduce_pallas(
        jnp.asarray(u), mode=mode, trim=trim, block_d=128, interpret=True))
    before = sorted_reduce.launches
    got = sorted_reduce(torch.from_numpy(u), mode, trim)
    assert sorted_reduce.launches == before  # no kernel on the CPU
    assert got.shape == (300,) and got.dtype == torch.float32
    if mode == "median":
        assert torch.equal(got, torch.from_numpy(want.copy()))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=atol_of(u, 1e-6))


@pytest.mark.parametrize("c,ratio", [(5, 0.2), (7, 0.1), (20, 0.25), (2, 0.5),
                                     (3, 0.4), (100, 0.1)])
def test_trimmed_mean_and_median_match_jax(c, ratio):
    jnp, _, reductions = jax_ops()
    u = hard_updates(c, 257, seed=7 * c)
    np.testing.assert_allclose(
        trimmed_mean(torch.from_numpy(u), ratio).numpy(),
        np.asarray(reductions.trimmed_mean(jnp.asarray(u), ratio)), rtol=0,
        atol=atol_of(u, 1e-6))
    want = np.array(reductions.coordinate_median(jnp.asarray(u)))
    assert torch.equal(coordinate_median(torch.from_numpy(u)),
                       torch.from_numpy(want))


@pytest.mark.parametrize("u,fn,want", [
    # C=5, ratio .2 -> trim 1 per end -> mean(2, 3, 4) = 3
    ([[1.0], [2.0], [3.0], [4.0], [100.0]], lambda t: trimmed_mean(t, 0.2),
     [3.0]),
    # C=2, ratio .5 -> t=1, 2t >= C -> the median, lower middle
    ([[1.0], [9.0]], lambda t: trimmed_mean(t, 0.5), [1.0]),
    # torch.median's lower middle for even C: 2.0, not 2.5
    ([[1.0], [2.0], [3.0], [10.0]], coordinate_median, [2.0]),
])
def test_reduction_goldens(u, fn, want):
    # The goldens of tests/test_defenses.py.
    got = fn(torch.tensor(u, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want)


@pytest.mark.parametrize("c,d,outlier", [(9, 8, 0.0), (7, 8, 500.0),
                                         (20, 301, 50.0)])
def test_geometric_median_matches_jax(c, d, outlier):
    jnp, _, reductions = jax_ops()
    rng = np.random.RandomState(c)
    u = rng.normal(3.0, 0.2, size=(c, d)).astype(np.float32)
    if outlier:
        u[-1] = outlier
    want = np.asarray(reductions.geometric_median(jnp.asarray(u)))
    got = geometric_median(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_of(u, 1e-5))
    if outlier:
        assert float(np.abs(got - 3.0).max()) < 1.0  # robust to the outlier


def test_weiszfeld_stops_like_the_while_loop():
    jnp, _, reductions = jax_ops()
    rng = np.random.RandomState(1)
    u = torch.from_numpy(rng.normal(0, 1, size=(11, 40)).astype(np.float32))
    y0 = coordinate_median(u)
    one, iters = weiszfeld(u, y0, max_iters=1)
    assert iters == 1
    np.testing.assert_allclose(
        one.numpy(),
        np.asarray(reductions.geometric_median(jnp.asarray(u.numpy()),
                                               max_iters=1)), atol=1e-6)
    y, iters = weiszfeld(u, y0, max_iters=100, tol=1e-5)
    assert 1 < iters < 100  # converged before the cap
    _, again = weiszfeld(u, y, max_iters=100, tol=1e-5)
    assert again == 1  # from the converged point the first move is tiny


@pytest.mark.parametrize("ord", ["l2", "linf"])
def test_row_norms_and_clip_rows_match_jax(ord):
    jnp, _, reductions = jax_ops()
    rng = np.random.RandomState(2)
    u = (rng.normal(0, 1, size=(6, 50)) * np.arange(1, 7)[:, None]
         ).astype(np.float32)
    u[2] = 0.0  # a zero row is left as it is
    np.testing.assert_allclose(
        row_norms(torch.from_numpy(u), ord).numpy(),
        np.asarray(reductions.row_norms(jnp.asarray(u), ord)), rtol=1e-6)
    np.testing.assert_allclose(
        clip_rows(torch.from_numpy(u), 5.0, ord).numpy(),
        np.asarray(reductions.clip_rows(jnp.asarray(u), 5.0, ord)),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad,kwargs,error", [
    (torch.zeros(4, 3, dtype=torch.float64), {}, TypeError),
    (torch.zeros(12), {}, ValueError),
    (torch.zeros(0, 5), {}, ValueError),
    (torch.zeros(3, 0), {}, ValueError),
    (torch.zeros(4, 3), {"mode": "mean"}, ValueError),
    (torch.zeros(4, 3), {"mode": "trimmed", "trim": 2}, ValueError),
    (torch.zeros(4, 3), {"mode": "trimmed", "trim": -1}, ValueError),
])
def test_sorted_reduce_rejects_what_the_kernel_does_not_take(bad, kwargs,
                                                             error):
    with pytest.raises(error):
        sorted_reduce(bad, **kwargs)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("sorted_reduce")
    assert not (tmp_path / "build").exists()


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(100, 421_642)] + RAGGED)
def test_sorted_reduce_kernel_matches_plain_on_cuda(c, d):
    cuda_or_skip()
    u = torch.from_numpy(hard_updates(c, d, seed=c + d)).cuda()
    trim = trim_for(c)
    before = sorted_reduce.launches
    for mode in ("median", "trimmed"):
        got = sorted_reduce(u, mode, trim)
        again = sorted_reduce(u, mode, trim)
        want = sorted_reduce_plain(u, mode, trim)
        assert torch.equal(got, again)  # no atomics: bitwise reproducible
        if mode == "median":
            assert torch.equal(got, want)
        else:
            finite = u[torch.isfinite(u)].abs().max()
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-6 * float(finite))
    assert sorted_reduce.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 8, 100])
def test_sorted_reduce_kernel_orders_nan_and_inf_like_torch_sort(c):
    cuda_or_skip()
    rng = np.random.RandomState(c)
    u = rng.normal(0, 1, size=(c, 97)).astype(np.float32)
    u[rng.rand(c, 97) < 0.2] = np.nan
    u[rng.rand(c, 97) < 0.1] = np.inf
    u[rng.rand(c, 97) < 0.1] = -np.inf
    u[:, 0] = np.nan  # a column of NaN only
    u = torch.from_numpy(u).cuda()
    srt = torch.sort(u, dim=0).values
    got = sorted_reduce(u, "median")
    want = srt[(c - 1) // 2]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    if c >= 3:
        trimmed = sorted_reduce(u, "trimmed", 1)
        plain = sorted_reduce_plain(u, "trimmed", 1)
        assert torch.equal(torch.isnan(trimmed), torch.isnan(plain))
        assert torch.equal(torch.isinf(trimmed), torch.isinf(plain))
        ok = torch.isfinite(plain)
        torch.testing.assert_close(trimmed[ok], plain[ok], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_sorted_reduce_kernel_refuses_more_than_1024_clients():
    cuda_or_skip()
    u = torch.zeros((1025, 16), device="cuda")
    with pytest.raises(ValueError, match="C <= 1024"):
        sorted_reduce(u, "median")
    assert torch.equal(sorted_reduce(u[:1024].contiguous(), "median"),
                       torch.zeros(16, device="cuda"))
