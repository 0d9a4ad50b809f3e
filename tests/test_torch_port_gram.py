"""Port centered Gram and pairwise distances against the JAX package's.

The JAX side runs its Pallas Gram kernel in interpret mode, as
``tests/test_pallas_kernels.py`` does, with a small ``block_d`` so the
kernel's grid and its jnp remainder tail both run. The port side runs the
plain torch version (a CPU tensor). Tolerance: rtol 1e-5, atol 1e-4 (f32
sums in different orders). The CUDA case holds the Hopper kernel to the
plain version on the card and skips without one.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops.gram import gram, gram_plain
from multimodal_fl_security_tpu_torch.ops.pairwise import (
    pairwise_dists,
    pairwise_sq_dists,
)

# Ragged C and D: D is no multiple of block_d=128, C no multiple of 8.
SHAPES = [(7, 1000), (13, 300), (5, 129), (10, 128)]


def jax_ops():
    """The JAX references, imported where they are used: the CUDA case must
    also run on a machine that has no JAX (``pytest --noconftest -m cuda``)."""
    import jax.numpy as jnp

    from multimodal_fl_security_tpu.ops import pairwise, pallas_kernels

    return jnp, pairwise, pallas_kernels


def updates(c, d, seed=0):
    rng = np.random.RandomState(seed)
    # Near-identical vectors with a large common offset, like client params.
    return (rng.normal(0, 1, size=(1, d))
            + 0.1 * rng.normal(0, 1, size=(c, d))).astype(np.float32)


@pytest.mark.parametrize("c,d", SHAPES)
def test_gram_matches_pallas_gram(c, d):
    jnp, _, pallas_kernels = jax_ops()
    u = updates(c, d)
    want = np.asarray(pallas_kernels.gram_pallas(
        jnp.asarray(u), block_d=128, interpret=True))
    before = gram.launches
    got = gram(torch.from_numpy(u))  # CPU tensor: the plain version
    assert gram.launches == before  # no kernel on the CPU
    assert got.shape == (c, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c,d", SHAPES)
def test_pairwise_sq_dists_matches_jax(c, d):
    jnp, pairwise, pallas_kernels = jax_ops()
    u = updates(c, d, seed=1)
    got = pairwise_sq_dists(torch.from_numpy(u)).numpy()
    for want in (pairwise.pairwise_sq_dists(jnp.asarray(u)),
                 pallas_kernels.pairwise_sq_dists_pallas(
                     jnp.asarray(u), block_d=128, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    assert np.all(np.diag(got) == 0.0) and np.all(got >= 0.0)
    np.testing.assert_allclose(
        pairwise_dists(torch.from_numpy(u)).numpy(),
        np.asarray(pairwise.pairwise_dists(jnp.asarray(u))), rtol=1e-5,
        atol=1e-4)


@pytest.mark.parametrize("bad,error", [
    (torch.zeros(4, 3, dtype=torch.float64), TypeError),
    (torch.zeros(12), ValueError),
    (torch.zeros(0, 5), ValueError),
    (torch.zeros(3, 0), ValueError),
])
def test_gram_rejects_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        gram(bad)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("gram")
    assert not (tmp_path / "build").exists()


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build._library_path("k")
    assert _build._library_path("k") == first
    (src / "k.cu").write_text("// v2\n")
    assert _build._library_path("k") != first
    with pytest.raises(FileNotFoundError):
        _build._library_path("missing")


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(100, 421_642), (7, 1000), (65, 4099),
                                 (130, 3001), (1, 33)])
def test_gram_kernel_matches_plain_on_cuda(c, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    u = torch.from_numpy(updates(c, d, seed=2)).cuda()
    before = gram.launches
    g = gram(u)
    g_again = gram(u)
    assert gram.launches == before + 2
    want = gram_plain(u)
    err = float((g - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    assert torch.equal(g, g_again)  # no atomics: bitwise reproducible
    assert torch.equal(g, g.T)
