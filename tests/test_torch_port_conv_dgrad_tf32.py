"""conv2's f32 input gradient on Hopper's tensor cores in 3xTF32
(``conv2_dgrad_tf32``, ``csrc/client_conv.cu``).

On the CPU, the kernel's arithmetic is emulated in numpy as
``tests/test_torch_port_conv_tf32.py`` emulates its sisters: every f32
operand split into hi = tf32(a) and lo = tf32(a - hi) (``tf32_rne``); each
of the kernel's chunks (one (kh, kw) of one stage of 16 output channels
co, 2 k8 steps) sums lo hi + hi lo + hi hi in a fresh f32 sum, added to
the total in the kernel's order: the stages co in [0, 16), [16, 32),
[32, 48), [48, 64), each over the nine taps. The
emulated dX is held to the JAX package by way of the stem: it goes through
the stem's ``conv_wgrad_plain``, and the stem's weight gradient is held to
the JAX side's folded gradient of one step (``jax_step``), as
``test_step_grads_match_folded_jax_grads`` holds the port's. Its error
against f64 is held to at most 4x that of the f32 plain version
(``conv2d_input``), and on small integers it equals the plain version
bitwise.

The ``cuda`` cases run the kernel on the card at small ragged shapes, at
C = 5, B = 33 (an item of 256 stacked rows straddles the samples, and the
persistent grid's last items fall unevenly) and at C = 100, B = 32, with
the maps NCHW or NHWC and dX NHWC or NCHW (the main path's layouts, read
and written with vector accesses, and strided ones, one element at a time),
and once with a pooled map that the relu kills everywhere (dX = 0): within
rtol 1e-5 and atol 1e-5 of max|reference| of the exact (f64) gradient, the
error against it at most 4x the f32 plain version's, two calls bitwise
equal, bitwise the plain version on small integers, one ``conv2_dgrad_tf32``
launch a call. An f32 input gradient off conv2's geometry raises before any
launch. They skip without a card.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.ops.client_conv import (
    _dense_dz,
    _grouped,
    _ungrouped,
    conv_dgrad,
    conv_dgrad_plain,
    conv_fwd,
    conv_fwd_plain,
    conv_wgrad_plain,
)
from test_torch_port_client_ops import (  # noqa: F401 (case: a fixture)
    CIN,
    C,
    case,
    jax_step,
    min_window_gap,
    nchw,
    stack_trees,
)
from test_torch_port_conv_tf32 import (  # noqa: F401 (cuda: a fixture)
    F64_FACTOR,
    assert_f32_close,
    close,
    counted,
    cuda,
    port_step_conv2,
    split,
)


def conv2_dgrad_3xtf32(dp, h, arg, w):
    """``conv2_dgrad_tf32_kernel``'s arithmetic on conv2's pooled gradient,
    map and argmax [C, B, 64, 7, 7] and weights [C, 64, 32, 3, 3] (torch
    tensors): dX[(y, x), ci] = sum over (co, kh, kw) of dZ[(y + 1 - kh,
    x + 1 - kw), co] W[co, ci, kh, kw] in 3xTF32, each (stage of 16
    channels, tap) chunk summed afresh and added to the total in the
    kernel's order. Returns dX [C, B, 32, 14, 14] as numpy f32."""
    c, b = dp.shape[:2]
    dz = np.pad(_dense_dz(dp, h, arg, 14, 14).numpy(),
                ((0, 0), (0, 0), (0, 0), (1, 1), (1, 1)))  # [C, B, 64, 16, 16]
    wn = w.float().numpy()
    dx = np.zeros((c, b, 196, 32), np.float32)
    for stage in range(4):
        co = slice(16 * stage, 16 * stage + 16)
        for kh in range(3):
            for kw in range(3):
                a = dz[:, :, co, 2 - kh:16 - kh, 2 - kw:16 - kw]
                a = a.reshape(c, b, 16, 196).transpose(0, 1, 3, 2)
                (ah, al) = split(a)
                (bh, bl) = split(wn[:, None, co, :, kh, kw])
                dx += ((al @ bh) + (ah @ bl)) + (ah @ bh)
    return np.ascontiguousarray(
        dx.reshape(c, b, 14, 14, 32).transpose(0, 1, 4, 2, 3))


def dgrad_f64(dp, h, arg, w):
    """The exact input gradient of conv2 (``conv2d_input`` in f64)."""
    c, b = dp.shape[:2]
    dz = _dense_dz(dp, h, arg, 14, 14).double()
    dx = torch.nn.grad.conv2d_input(
        (b, c * 32, 14, 14), w.double().reshape(-1, 32, 3, 3), _grouped(dz),
        padding=1, groups=c)
    return _ungrouped(dx, c)


def conv2_operands(gen, c, b, device="cpu", ints=False, maps_nhwc=False,
                   dead=False):
    """conv2's input-gradient operands: the pooled map and argmax of the
    plain forward on a random post-relu input (NCHW maps, or NHWC), a
    pooled gradient of the map's strides, and w [C, 64, 32, 3, 3];
    ``ints``: small integers; ``dead``: a bias that the relu turns into a
    zero map (h = 0 everywhere, so dX = 0)."""
    def draw(shape, lo, hi, scale):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen,
                                 device=device).float()
        return scale * torch.randn(shape, generator=gen, device=device)

    x = draw((c, b, 14, 14, 32), -3, 4, 1.0).permute(0, 1, 4, 2, 3)
    if not ints:
        x = torch.relu(x)
    w = draw((c, 64, 32, 3, 3), -2, 3, 0.3)
    bias = draw((c, 64), -2, 3, 0.1) - (1e4 if dead else 0.0)
    h, arg = conv_fwd_plain(x, w, bias, channels_last=maps_nhwc)
    dp = torch.empty_like(h).copy_(draw(h.shape, -4, 5, 0.1))
    return dp, h, arg, w


def test_conv2_dgrad_3xtf32_matches_folded_jax_grads_through_the_stem(case):
    """The emulated kernel's dX, carried through the stem's weight gradient
    (``conv_wgrad_plain``), against the JAX side's folded stem gradient of
    the same step, at the tolerance of
    ``test_step_grads_match_folded_jax_grads`` (rtol 1e-4, atol 1e-5: the
    two packages' forward and backward sum in other orders)."""
    from multimodal_fl_security_tpu_torch.models.from_jax import (
        params_from_jax,
    )

    assert min_window_gap(case) > 2e-6  # the comparison's premise
    steps = [jax_step(case, c) for c in range(C)]
    want = case["model"].layout(CIN).views(params_from_jax(
        case["model"], stack_trees([s[1] for s in steps]), device="cpu"))
    views = case["model"].layout(CIN).views(case["params"])
    x = nchw(case["images"])
    h1, dh3, h3, a3 = port_step_conv2(case)
    _, a1 = conv_fwd(x, views["conv1.weight"], views["conv1.bias"],
                     channels_last=True)
    dh1 = torch.from_numpy(conv2_dgrad_3xtf32(dh3, h3, a3,
                                              views["conv2.weight"]))
    gw = torch.empty_like(views["conv1.weight"])
    gb = torch.empty_like(views["conv1.bias"])
    conv_wgrad_plain(x, dh1, h1, a1, gw, gb)
    np.testing.assert_allclose(gw.numpy(), want["conv1.weight"].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), want["conv1.bias"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("operands", ["random", "the step's"])
def test_conv2_dgrad_3xtf32_keeps_f32_accuracy(request, operands):
    """Against the f64 input gradient, the emulated kernel is within rtol
    1e-5 / atol 1e-5 of max|f64|, and off by at most 4x the f32 plain
    version's error: on random operands at C = 3, B = 5 and on one step's
    conv2 operands."""
    if operands == "random":
        dp, h, arg, w = conv2_operands(torch.Generator().manual_seed(1), 3, 5)
    else:
        case = request.getfixturevalue("case")
        _, dp, h, arg = port_step_conv2(case)
        w = case["model"].layout(CIN).views(case["params"])["conv2.weight"]
    ref = dgrad_f64(dp, h, arg, w).numpy()
    got = conv2_dgrad_3xtf32(dp, h, arg, w)
    plain = conv_dgrad_plain(dp, h, arg, w, (14, 14)).numpy()
    assert got.shape == plain.shape and got.dtype == np.float32
    assert_f32_close(got, ref, "the emulated kernel against f64")
    err, err_plain = (float(np.abs(v - ref).max()) for v in (got, plain))
    assert err <= F64_FACTOR * err_plain, (err, err_plain)


def test_conv2_dgrad_3xtf32_exact_on_integers():
    """On small integers hi = a and lo = 0, and every product and sum is
    exact: the emulation equals the plain version bitwise."""
    dp, h, arg, w = conv2_operands(torch.Generator().manual_seed(5), 2, 3,
                                   ints=True)
    _, lo = split(w.numpy())
    assert not lo.any()
    want = conv_dgrad_plain(dp, h, arg, w, (14, 14)).numpy()
    assert float(np.abs(want).max()) > 50  # sums large enough to test
    np.testing.assert_array_equal(conv2_dgrad_3xtf32(dp, h, arg, w), want)


# ---------------------------------------------------------------- CUDA

#: (C, B, relu): B = 1, 5 and 7 end each client inside a 64-row tile; C =
#: 5, B = 33 puts an odd sample in a client's last 256-row item and leaves
#: the persistent grid's last items uneven; "dead": a pooled map that the
#: relu kills everywhere, so dX = 0 (the integer operands stay live)
CASES = [(1, 1, "live"), (3, 5, "live"), (2, 7, "live"), (100, 32, "live"),
         (5, 33, "live"), (3, 5, "dead")]


@pytest.mark.cuda
@pytest.mark.parametrize("out_nhwc", [True, False])
@pytest.mark.parametrize("maps_nhwc", [False, True])
@pytest.mark.parametrize("c,b,relu", CASES)
def test_conv2_dgrad_tf32_matches_f64(cuda, c, b, relu, maps_nhwc,
                                      out_nhwc):
    """f32 conv2 input gradients run conv2_dgrad_tf32 once a call: within
    the f32 tolerance of the exact (f64) gradient, its error there at most
    4x the f32 plain version's, two calls bitwise equal, and on small
    integers bitwise the plain version (without cuDNN). The main path's
    layouts are NCHW maps and an NHWC dX. A dead map gives dX = 0."""
    dp, h, arg, w = conv2_operands(cuda, c, b, "cuda", maps_nhwc=maps_nhwc,
                                   dead=relu == "dead")
    got, launches = counted(lambda: conv_dgrad(
        dp, h, arg, w, (14, 14), channels_last=out_nhwc))
    again = conv_dgrad(dp, h, arg, w, (14, 14), channels_last=out_nhwc)
    plain = conv_dgrad_plain(dp, h, arg, w, (14, 14),
                             channels_last=out_nhwc)
    ref = dgrad_f64(dp, h, arg, w)
    dpi, hi, ai, wi = conv2_operands(cuda, c, b, "cuda", ints=True,
                                     maps_nhwc=maps_nhwc)
    got_i = conv_dgrad(dpi, hi, ai, wi, (14, 14), channels_last=out_nhwc)
    with torch.backends.cudnn.flags(enabled=False):
        want_i = conv_dgrad_plain(dpi, hi, ai, wi, (14, 14))
    torch.cuda.synchronize()
    assert launches == {"conv2_dgrad_tf32": 1}
    assert got.shape == (c, b, 32, 14, 14) and got.dtype == torch.float32
    assert got.stride() == plain.stride()
    assert torch.equal(got, again)  # fixed-order sums
    if relu == "dead":
        assert not bool((h > 0).any()) and not bool(got.any())
    close(got, ref)
    err, err_plain = (float((v.double() - ref).abs().max())
                      for v in (got, plain))
    print(f"[conv2_dgrad_tf32 C={c} B={b} {relu} maps NHWC {maps_nhwc} dX "
          f"NHWC {out_nhwc}] max|kernel-plain| "
          f"{float((got - plain).abs().max()):.3g}; vs f64: kernel "
          f"{err:.3g}, plain {err_plain:.3g}")
    assert err <= F64_FACTOR * err_plain, (err, err_plain)
    assert float(want_i.abs().max()) > 50  # sums large enough to test
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
def test_conv_dgrad_off_conv2_raises(cuda):
    """An f32 input gradient off conv2's geometry (16 -> 32 channels at
    10x10) is refused by the route chosen before the launch: it raises
    and launches nothing."""
    x = torch.relu(torch.randn((3, 5, 16, 10, 10), generator=cuda,
                               device="cuda"))
    w = 0.3 * torch.randn((3, 32, 16, 3, 3), generator=cuda, device="cuda")
    bias = 0.1 * torch.randn((3, 32), generator=cuda, device="cuda")
    h, arg = conv_fwd_plain(x, w, bias)
    dp = 0.1 * torch.randn(h.shape, generator=cuda, device="cuda")
    before = conv_dgrad.launches

    def call():
        with pytest.raises(ValueError, match="conv2_dgrad_tf32"):
            conv_dgrad(dp, h, arg, w, (10, 10), channels_last=True)

    _, launches = counted(call)
    assert launches == {} and conv_dgrad.launches == before
