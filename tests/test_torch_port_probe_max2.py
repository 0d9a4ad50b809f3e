"""The probes' elementwise maximum (``max2``, ``csrc/probe_reduce.cu``) and
its lean launch path.

On the CPU: ``max2_plain`` (the wrapper's CPU route) is bitwise JAX's
``maximum`` and the JAX probe's ``jnp.max`` over the pair axis on planted
ties, signed zeros, infinities and NaNs; the packed launch arguments
(``max2_launch_args``) equal each view's address, shape (with leading 1s
to five axes) and ``stride()`` (with leading 0s), and the route is the rows route exactly where the last
axis has stride 1, an extent that is a multiple of 4 and 16-byte aligned
rows; the wrapper raises on other dtypes, on shapes that differ and on
more than five axes.

The ``cuda`` cases hold the kernel bitwise (bit patterns, NaNs included)
to ``max2_plain`` at ``sublane_pool_reshape``'s two
halves (the rows route), at strided views that take the route of one
element a thread, and on planted ties, signed zeros, infinities and NaNs
in either operand; each call launches once. They skip without a card.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.ops.probe_reduce import (
    max2,
    max2_launch_args,
    max2_plain,
)


def pool_halves(x):
    """``sublane_pool_reshape``'s two halves of x [32, 56, 256]."""
    pairs = x.view(32, 7, 2, 4, 256)
    return pairs[:, :, 0], pairs[:, :, 1]


def views(x):
    """name -> (a, b, the route max2 must take) over x [32, 56, 256]."""
    a, b = pool_halves(x)
    flat = x.view(-1)
    return {
        "the probe's halves": (a, b, 1),
        "contiguous": (x[:16], x[16:], 1),
        "one axis": (flat[:1024], flat[4096:5120], 1),
        "five axes": (x.view(2, 8, 2, 7, 8, 256)[0],
                      x.view(2, 8, 2, 7, 8, 256)[1], 1),
        "last axis strided": (x[..., ::2], x[..., 1::2], 0),
        "transposed": (x[:8].transpose(1, 2), x[8:16].transpose(1, 2), 0),
        "misaligned rows": (flat[1:1 + 4096].view(16, 256),
                            flat[8192:8192 + 4096].view(16, 256), 0),
        "odd last extent": (x[:, :, :255], x[:, :, 1:], 0),
    }


def planted_pairs(seed=0):
    """a, b [32, 7, 4, 256] f32 (numpy): random values with planted ties,
    +-0 against each other in both orders, +-inf, and NaNs in a, in b and
    in both."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((32, 7, 4, 256)).astype(np.float32)
    b = rng.standard_normal(a.shape).astype(np.float32)
    pick = rng.integers(0, 12, a.shape)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5], np.float32)
    for k in range(6):
        a[pick == k] = special[k]  # a special value against a random b
    b[pick == 6] = a[pick == 6]  # ties
    a[pick == 7], b[pick == 7] = 0.0, -0.0
    a[pick == 8], b[pick == 8] = -0.0, 0.0
    b[pick == 9] = np.nan
    a[pick == 10], b[pick == 10] = np.nan, np.nan
    return a, b


@pytest.mark.parametrize("jax_form", ["maximum", "max over the pair axis"])
def test_max2_plain_is_jax_maximum_bitwise(jax_form):
    """The rule max2 and its plain version follow is JAX's, bit for bit:
    ``jnp.maximum``, and the JAX probe's ``jnp.max(v, axis=2)`` over the
    [32, 7, 2, 4, 256] pairs."""
    import jax.numpy as jnp

    a, b = planted_pairs()
    if jax_form == "maximum":
        want = np.asarray(jnp.maximum(a, b))
    else:
        want = np.asarray(jnp.max(jnp.asarray(np.stack([a, b], axis=2)),
                                  axis=2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert np.isnan(want).any() and (np.signbit(want) & (want == 0)).any()
    for got in (max2_plain(ta, tb), max2(ta, tb)):
        np.testing.assert_array_equal(
            got.contiguous().numpy().view(np.int32), want.view(np.int32))


def test_max2_launch_args_follow_the_views():
    x = torch.randn((32, 56, 256), generator=torch.Generator().manual_seed(0))
    for what, (a, b, route) in views(x).items():
        out = torch.empty(a.shape)
        got_route, args = max2_launch_args(a, b, out)
        lead = 5 - a.dim()
        assert got_route == route, what
        assert args[:3] == (a.data_ptr(), b.data_ptr(), out.data_ptr()), what
        assert args[3:8] == (1,) * lead + tuple(a.shape), what
        assert args[8:13] == (0,) * lead + a.stride(), what
        assert args[13:] == (0,) * lead + b.stride(), what


def test_max2_refuses_what_the_kernel_does_not_take():
    a = torch.randn((4, 8))
    with pytest.raises(TypeError):
        max2(a.double(), a.double())
    with pytest.raises(TypeError):
        max2(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError):
        max2(a, a[:, :4])
    six = torch.randn((1, 2, 1, 2, 1, 4))
    with pytest.raises(ValueError):
        max2_launch_args(six, six, torch.empty(six.shape))


# ---------------------------------------------------------------- CUDA

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator("cuda").manual_seed(0)


def bitwise(got, want):
    """Equal bit patterns (NaN payloads included) and layout."""
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))


def launched(a, b):
    """(max2(a, b), the launches it made)."""
    before = max2.launches
    out = max2(a, b)
    return out, max2.launches - before


@pytest.mark.cuda
def test_max2_matches_plain_on_every_route(cuda):
    x = torch.randn((32, 56, 256), generator=cuda, device="cuda")
    for what, (a, b, route) in views(x).items():
        assert max2_launch_args(a, b, torch.empty_like(a))[0] == route, what
        got, n = launched(a, b)
        torch.cuda.synchronize()
        assert n == 1, what
        assert got.is_contiguous() and bitwise(got, max2_plain(a, b)), what


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
def test_max2_planted_ties_zeros_and_nans(cuda, strided):
    """Ties, +-0 against each other, +-inf, and NaNs in a, in b and in
    both, on both routes: bitwise max2_plain (JAX's maximum)."""
    x = torch.randn((32, 56, 256), generator=cuda, device="cuda")
    pairs = x.view(32, 7, 2, 4, 256)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1.5], device="cuda")
    pick = torch.randint(0, 12, a.shape, generator=cuda, device="cuda")
    for k in range(6):
        a[pick == k] = special[k]  # a special value against a random b
    b[pick == 6] = a[pick == 6]  # planted ties
    b[pick == 7] = -0.0
    a[pick == 7] = 0.0
    b[pick == 8] = 0.0
    a[pick == 8] = -0.0
    b[pick == 9] = float("nan")  # NaN in b
    a[pick == 10] = float("nan")  # NaN in both
    b[pick == 10] = float("nan")
    if strided:
        a, b = a[..., ::2], b[..., 1::2]
    assert max2_launch_args(a, b, torch.empty_like(a))[0] == int(not strided)
    got, n = launched(a, b)
    want = max2_plain(a, b)
    torch.cuda.synchronize()
    assert n == 1
    assert bool(torch.isnan(want).any())
    assert bitwise(got, want)
