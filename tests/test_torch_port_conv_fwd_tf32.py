"""The pooled f32 forward convolutions of local training: conv2's on
Hopper's tensor cores in 3xTF32 (``conv2_fwd_tf32``) and the stem's in f32
FMA on the CUDA cores (``stem_fwd_f32``), both in ``csrc/client_conv.cu``.

On the CPU, each kernel's arithmetic is emulated in numpy. conv2's as
``tests/test_torch_port_conv_tf32.py`` emulates its sisters: every f32
operand split into hi = tf32(a) and lo = tf32(a - hi) (``tf32_rne``), lo hi
+ hi lo + hi hi summed in f32, each of the kernel's chunks (one tap of one
half of the input channels ci, 2 k8 steps) into a fresh sum added to the
total in the kernel's order: ci in [0, 16) over the nine taps, then ci in
[16, 32). The stem's as its FMA chain over (ci, kh, kw), each FMA the f64
sum of the exact product and the f32 total, rounded to f32. Both then pool
as the kernels do: the first maximum of each window in (di, dj) order, the
f32 bias, relu. Each emulation is held to the JAX package's forward
(``Conv_0`` pooled through relu, and ``ConvPoolFused_0``, as
``test_stem_and_conv2_forward_match_jax`` builds them) at rtol 1e-4 and
atol 1e-5, its error against f64 to at most 4x the f32 plain version's,
and on small integers it equals the plain version bitwise.

The ``cuda`` cases run both kernels on the card at small ragged shapes and
at C = 100, B = 32, in the main path's layouts (conv2's input NHWC and its
maps NCHW, the stem's maps NHWC; read and written with vector accesses)
and in others (one element at a time): within rtol 1e-5 and atol 1e-5 of
max|reference| of the exact (f64) pooled map, the error there at most 4x
the f32 plain version's, two calls bitwise equal, bitwise the plain
version on small integers, the argmax equal to the plain version's
wherever the window gap exceeds the tolerance (planted ties included), one
launch a call. An f32 pooled call off both geometries raises before any
launch. They skip without a card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_fl_security_tpu_torch.ops.client_conv import (
    _grouped,
    _ungrouped,
    conv_fwd,
    conv_fwd_plain,
)
from test_torch_port_client_ops import (  # noqa: F401 (case: a fixture)
    CIN,
    C,
    case,
    client_tree,
    jax_side,
    nchw,
)
from test_torch_port_conv_tf32 import (  # noqa: F401 (cuda: a fixture)
    F64_FACTOR,
    RTOL,
    assert_f32_close,
    close,
    counted,
    cuda,
    products_3xtf32,
    split,
)


def pool_epilogue(z, b):
    """The kernels' pooled epilogue on the sums z [C, B, co, H, W] and the
    bias b [C, co] (numpy): each 2x2 window's first maximum in (di, dj)
    order, plus the bias, through relu; and its argmax (uint8)."""
    c, bsz, co, h, w = z.shape
    win = z.reshape(c, bsz, co, h // 2, 2, w // 2, 2).transpose(
        0, 1, 2, 3, 5, 4, 6).reshape(c, bsz, co, h // 2, w // 2, 4)
    q = win.argmax(axis=-1)  # the first maximum
    best = np.take_along_axis(win, q[..., None], axis=-1)[..., 0]
    return np.maximum(best + b[:, None, :, None, None], 0), q.astype(np.uint8)


def conv2_fwd_3xtf32(x, w, b):
    """``conv2_fwd_tf32_kernel``'s arithmetic on conv2's input x [C, B, 32,
    14, 14], weights w [C, 64, 32, 3, 3] and bias b [C, 64] (torch): Z[(oy,
    ox), co] = sum over (ci, kh, kw) of x[ci, oy + kh - 1, ox + kw - 1]
    w[co, ci, kh, kw] in 3xTF32, each (channel half, tap) chunk of 16 ci
    summed afresh and added to the total in the kernel's order; then the
    pooled epilogue. Returns (the pooled map [C, B, 64, 7, 7] f32, its
    argmax) as numpy."""
    c, bsz = x.shape[:2]
    xp = np.pad(x.float().numpy(), ((0, 0), (0, 0), (0, 0), (1, 1), (1, 1)))
    wn = w.float().numpy()
    z = np.zeros((c, bsz, 196, 64), np.float32)
    for half in range(2):
        ci = slice(16 * half, 16 * half + 16)
        for kh in range(3):
            for kw in range(3):
                a = xp[:, :, ci, kh:kh + 14, kw:kw + 14].reshape(
                    c, bsz, 16, 196).transpose(0, 1, 3, 2)
                z += products_3xtf32(
                    a, wn[:, None, :, ci, kh, kw].transpose(0, 1, 3, 2))
    z = z.reshape(c, bsz, 14, 14, 64).transpose(0, 1, 4, 2, 3)
    return pool_epilogue(z, b.float().numpy())


def stem_fwd_f32_order(x, w, b):
    """``stem_fwd_f32_kernel``'s arithmetic on the images x [C, B, cin, H,
    W], weights w [C, 32, cin, 3, 3] and bias b [C, 32] (torch, f32): each
    output's 9 cin products summed by FMA in (ci, kh, kw) order (an FMA
    emulated as the f64 sum of the exact product and the f32 total, rounded
    to f32), then the pooled epilogue. Returns (the pooled map [C, B, 32,
    H/2, W/2] f32, its argmax) as numpy."""
    c, bsz, cin, h, ww = x.shape
    xp = np.pad(x.numpy().astype(np.float64),
                ((0, 0), (0, 0), (0, 0), (1, 1), (1, 1)))
    wn = w.numpy().astype(np.float64)
    z = np.zeros((c, bsz, w.shape[1], h, ww), np.float32)
    for ci in range(cin):
        for kh in range(3):
            for kw in range(3):
                prod = xp[:, :, None, ci, kh:kh + h, kw:kw + ww] * \
                    wn[:, None, :, ci, kh, kw, None, None]
                z = (prod + z).astype(np.float32)
    return pool_epilogue(z, b.numpy())


def pooled_f64(x, w, b):
    """The exact pooled map: the convolution in f64 (grouped
    ``F.conv2d``), then the pooled epilogue in f64 (numpy)."""
    c = x.shape[0]
    z = _ungrouped(F.conv2d(_grouped(x.double()),
                            w.double().reshape(-1, *w.shape[2:]), padding=1,
                            groups=c), c)
    return pool_epilogue(z.cpu().numpy(), b.double().cpu().numpy())[0]


def jax_forward(case):
    """The JAX SimpleCNN's stem (``ConvPoolFused_0``) and conv2 (``Conv_0``
    through relu and the 2x2 max) of every client, NHWC numpy."""
    jax, jnp, *_ = jax_side()
    h1, h3 = [], []
    for c in range(C):
        _, state = case["jmodel"].apply(
            {"params": client_tree(case["stacked"], c)},
            {"image_s2d": jnp.asarray(case["blocks"][c])},
            capture_intermediates=True, mutable=["intermediates"])
        inter = state["intermediates"]
        h1.append(np.asarray(inter["ConvPoolFused_0"]["__call__"][0]))
        z2 = np.maximum(np.asarray(inter["Conv_0"]["__call__"][0]), 0.0)
        h3.append(z2.reshape(z2.shape[0], 7, 2, 7, 2, 64).max(axis=(2, 4)))
    return np.stack(h1), np.stack(h3)


def step_operands(case):
    """The step's forward operands on the port's plain path: the images,
    conv2's input (the stem's pooled map, NHWC) and the two layers'
    weights and biases."""
    views = case["model"].layout(CIN).views(case["params"])
    x = nchw(case["images"])
    h1, _ = conv_fwd(x, views["conv1.weight"], views["conv1.bias"],
                     channels_last=True)
    return (x, views["conv1.weight"], views["conv1.bias"], h1,
            views["conv2.weight"], views["conv2.bias"])


def test_conv2_fwd_3xtf32_matches_jax_conv2(case):
    """The emulated kernel on the step's conv2 input against the JAX side's
    ``Conv_0`` pooled through relu, at the tolerance of
    ``test_stem_and_conv2_forward_match_jax`` (rtol 1e-4, atol 1e-5: the
    two packages sum in other orders)."""
    *_, h1, w2, b2 = step_operands(case)
    got, arg = conv2_fwd_3xtf32(h1, w2, b2)
    assert got.dtype == np.float32 and got.shape == (C, 32, 64, 7, 7)
    assert arg.dtype == np.uint8 and int(arg.max()) <= 3
    np.testing.assert_allclose(got.transpose(0, 1, 3, 4, 2),
                               jax_forward(case)[1], rtol=1e-4, atol=1e-5)


def test_stem_fwd_f32_order_matches_jax_stem(case):
    """The emulated stem kernel on the step's images (8 channels) against
    the JAX side's ``ConvPoolFused_0`` at rtol 1e-4, atol 1e-5."""
    x, w1, b1, *_ = step_operands(case)
    got, _ = stem_fwd_f32_order(x, w1, b1)
    assert got.dtype == np.float32 and got.shape == (C, 32, 32, 14, 14)
    np.testing.assert_allclose(got.transpose(0, 1, 3, 4, 2),
                               jax_forward(case)[0], rtol=1e-4, atol=1e-5)


def random_operands(layer, gen, c=3, b=5, cin=1, ints=False):
    """x, w, bias of conv2 ([C, B, 32, 14, 14] post-relu, NHWC) or a stem
    ([C, B, cin, 28, 28]); ``ints``: small integers."""
    def draw(shape, lo, hi, scale):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen).float()
        return scale * torch.randn(shape, generator=gen)

    if layer == "conv2":
        x = draw((c, b, 14, 14, 32), -3, 4, 1.0).permute(0, 1, 4, 2, 3)
        x = x if ints else torch.relu(x)
        cin, cout = 32, 64
    else:
        x = draw((c, b, cin, 28, 28), -3, 4, 1.0)
        cout = 32
    return x, draw((c, cout, cin, 3, 3), -2, 3, 0.3), draw((c, cout), -2, 3,
                                                           0.1)


EMULATIONS = {"conv2": conv2_fwd_3xtf32, "stem": stem_fwd_f32_order}


@pytest.mark.parametrize("layer", ["conv2", "stem"])
@pytest.mark.parametrize("operands", ["random", "the step's"])
def test_fwd_emulation_keeps_f32_accuracy(request, layer, operands):
    """Against the exact (f64) pooled map, each emulated kernel is within
    rtol 1e-5 / atol 1e-5 of max|f64| and off by at most 4x the f32 plain
    version's error: on random operands at C = 3, B = 5 (the stem at one
    input channel, the main path's) and on the step's operands."""
    if operands == "random":
        x, w, b = random_operands(layer, torch.Generator().manual_seed(1))
    else:
        x, w1, b1, h1, w2, b2 = step_operands(request.getfixturevalue("case"))
        x, w, b = (h1, w2, b2) if layer == "conv2" else (x, w1, b1)
    ref = pooled_f64(x, w, b)
    got, _ = EMULATIONS[layer](x, w, b)
    plain, _ = conv_fwd_plain(x, w, b)
    plain = plain.numpy()
    assert got.shape == plain.shape and got.dtype == np.float32
    assert_f32_close(got, ref, "the emulated kernel against f64")
    err, err_plain = (float(np.abs(v - ref).max()) for v in (got, plain))
    assert err <= F64_FACTOR * err_plain, (err, err_plain)


@pytest.mark.parametrize("layer,cin", [("conv2", 32), ("stem", 1),
                                       ("stem", 8)])
def test_fwd_emulation_exact_on_integers(layer, cin):
    """On small integers hi = a and lo = 0, and every product and sum is
    exact: each emulation equals the plain version bitwise, its argmax
    included (interior windows tie often; both take the first)."""
    x, w, b = random_operands(layer, torch.Generator().manual_seed(5), 2, 3,
                              cin, ints=True)
    _, lo = split(w.numpy())
    assert not lo.any()
    want, warg = conv_fwd_plain(x, w, b)
    assert float(want.abs().max()) > 20  # sums large enough to test
    got, arg = EMULATIONS[layer](x, w, b)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(arg, warg.numpy())


# ---------------------------------------------------------------- CUDA

#: (C, B): B = 1, 5 and 7 leave blocks short of whole runs of samples and
#: windows; C = 100, B = 32 is the main path's
CASES = [(1, 1), (3, 5), (2, 7), (100, 32)]
#: (layer, input channels, the f32 kernel)
LAYERS = [("conv2", 32, "conv2_fwd_tf32"), ("stem", 1, "stem_fwd_f32"),
          ("stem", 8, "stem_fwd_f32")]


def card_operands(gen, layer, c, b, cin, main_layout, ints=False):
    """x, w, bias on the card, and the output layout: the main path's
    (conv2: x NHWC, maps NCHW; the stem: x NCHW, maps NHWC) or the other
    (x and maps the other way round). Returns (x, w, bias,
    channels_last)."""
    def draw(shape, lo, hi, scale):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen,
                                 device="cuda").float()
        return scale * torch.randn(shape, generator=gen, device="cuda")

    if layer == "conv2":
        x = draw((c, b, 14, 14, 32), -3, 4, 1.0).permute(0, 1, 4, 2, 3)
        x = x if ints else torch.relu(x)
        cout = 64
    else:
        x = draw((c, b, 28, 28, cin), -3, 4, 1.0).permute(0, 1, 4, 2, 3)
        cout = 32
    nhwc_in = main_layout == (layer == "conv2")
    x = x if nhwc_in else x.contiguous()
    w = draw((c, cout, x.shape[2], 3, 3), -2, 3, 0.3)
    bias = draw((c, cout), -2, 3, 0.1)
    return x, w, bias, main_layout == (layer == "stem")


def argmax_checked(got, want, x, w):
    """The kernel's argmax against the plain version's: equal wherever the
    plain version's window gap (the largest of its four f32 sums less the
    next) exceeds 1e-5 of max|sum|, and on more than 0.99 of outputs."""
    c, bsz = x.shape[:2]
    z = _ungrouped(F.conv2d(_grouped(x.float()),
                            w.float().reshape(-1, *w.shape[2:]), padding=1,
                            groups=c), c)
    co, h, ww = z.shape[2:]
    win = z.reshape(c, bsz, co, h // 2, 2, ww // 2, 2).permute(
        0, 1, 2, 3, 5, 4, 6).reshape(c, bsz, co, h // 2, ww // 2, 4)
    top2 = win.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > RTOL * float(win.abs().max())
    same = got == want
    assert not bool((clear & ~same).any())
    assert float(same.float().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("main_layout", [True, False])
@pytest.mark.parametrize("layer,cin,kernel", LAYERS)
@pytest.mark.parametrize("c,b", CASES)
def test_fwd_kernels_match_f64(cuda, c, b, layer, cin, kernel, main_layout):
    """f32 pooled forwards run conv2_fwd_tf32 (conv2) or stem_fwd_f32 (a
    stem) once a call: within the f32 tolerance of the exact (f64) pooled
    map, the error there at most 4x the f32 plain version's, two calls
    bitwise equal, the argmax equal to the plain version's beyond near
    ties, and on small integers bitwise the plain version, argmax included
    (without cuDNN)."""
    x, w, bias, nhwc = card_operands(cuda, layer, c, b, cin, main_layout)
    (got, arg), launches = counted(lambda: conv_fwd(x, w, bias,
                                                    channels_last=nhwc))
    again, arg2 = conv_fwd(x, w, bias, channels_last=nhwc)
    plain, parg = conv_fwd_plain(x, w, bias, channels_last=nhwc)
    ref = torch.from_numpy(pooled_f64(x, w, bias)).cuda()
    xi, wi, bi, _ = card_operands(cuda, layer, c, b, cin, main_layout,
                                  ints=True)
    got_i, arg_i = conv_fwd(xi, wi, bi, channels_last=nhwc)
    with torch.backends.cudnn.flags(enabled=False):
        want_i, warg_i = conv_fwd_plain(xi, wi, bi, channels_last=nhwc)
    torch.cuda.synchronize()
    assert launches == {kernel: 1}
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert got.stride() == plain.stride() and arg.stride() == parg.stride()
    assert torch.equal(got, again) and torch.equal(arg, arg2)
    close(got, ref)
    err, err_plain = (float((v.double() - ref).abs().max())
                      for v in (got, plain))
    print(f"[{kernel} C={c} B={b} cin={cin} main layout {main_layout}] "
          f"max|kernel-plain| {float((got - plain).abs().max()):.3g}; vs "
          f"f64: kernel {err:.3g}, plain {err_plain:.3g}")
    assert err <= F64_FACTOR * err_plain, (err, err_plain)
    argmax_checked(arg, parg, x, w)
    assert float(want_i.abs().max()) > 20  # sums large enough to test
    assert torch.equal(got_i, want_i) and torch.equal(arg_i, warg_i)


@pytest.mark.cuda
@pytest.mark.parametrize("main_layout", [True, False])
@pytest.mark.parametrize("layer,cin,kernel", LAYERS)
def test_fwd_kernels_planted_ties(cuda, layer, cin, kernel, main_layout):
    """All-ones inputs and integer weights make every sum exact and every
    interior window a four-way tie: both kernels take the first position,
    (0, 0), as the plain version does, and equal it bitwise."""
    x, w, bias, nhwc = card_operands(cuda, layer, 3, 4, cin, main_layout,
                                     ints=True)
    x = torch.ones_like(x)  # the same strides
    bias = torch.full_like(bias, 100.0)  # keep the relu open
    (out, arg), launches = counted(lambda: conv_fwd(x, w, bias,
                                                    channels_last=nhwc))
    with torch.backends.cudnn.flags(enabled=False):
        want, warg = conv_fwd_plain(x, w, bias, channels_last=nhwc)
    torch.cuda.synchronize()
    assert launches == {kernel: 1}
    assert torch.equal(out, want) and torch.equal(arg, warg)
    assert not bool(arg[..., 1:-1, 1:-1].any())


@pytest.mark.cuda
def test_f32_pooled_off_both_geometries_raises(cuda):
    """An f32 pooled forward that neither conv2_fwd_tf32 nor stem_fwd_f32
    takes is refused by the route chosen before the launch: it raises and
    launches nothing."""
    x, w, bias, _ = card_operands(cuda, "conv2", 3, 5, 32, True)
    sx, sw, sb, _ = card_operands(cuda, "stem", 3, 5, 1, True)
    s9 = torch.randn((3, 5, 9, 28, 28), generator=cuda, device="cuda")
    calls = {
        "conv2 at 16 input channels": lambda: conv_fwd(
            x[:, :, :16], w[:, :, :16], bias),
        "conv2 at stride 2": lambda: conv_fwd(x, w, bias, stride=2),
        "conv2 at 12x12": lambda: conv_fwd(x[..., :12, :12], w, bias),
        "a stem of 64 outputs": lambda: conv_fwd(
            sx, torch.cat([sw, sw], 1), torch.cat([sb, sb], 1)),
        "a stem of bf16 input": lambda: conv_fwd(sx.to(torch.bfloat16), sw,
                                                 sb),
        "a stem of 9 input channels": lambda: conv_fwd(
            s9, torch.zeros((3, 32, 9, 3, 3), device="cuda"), sb),
        "a 5x5 stem": lambda: conv_fwd(
            sx, torch.zeros((3, 32, 1, 5, 5), device="cuda"), sb, pad=2),
    }
    before = conv_fwd.launches

    def call_all():
        for what, call in calls.items():
            with pytest.raises(ValueError, match="conv2_fwd_tf32"):
                call()

    _, launches = counted(call_all)
    assert launches == {} and conv_fwd.launches == before
