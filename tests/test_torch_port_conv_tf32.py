"""The f32 convolutions on Hopper's tensor cores in 3xTF32: K3's raw stem
(``stem_raw_tf32``, ``csrc/client_stem_raw.cu``), conv2's weight gradient
(``conv2_wgrad_tf32``) and the stem's (``stem_wgrad_tf32``, both
``csrc/client_conv.cu``).

On the CPU, each kernel's arithmetic is emulated in numpy: every f32 operand
a split into hi = tf32(a) and lo = tf32(a - hi), rounded to nearest even as
``tf32_rne`` does on the bits; lo hi + hi lo + hi hi summed in f32, each chunk
of the kernel's k steps into a fresh sum that is added to the total in chunk
order. The emulated K3 is held to the JAX package's ``client_stem_conv`` in
interpret mode and to ``client_stem_conv_reference``; the emulated conv2 and
stem weight gradients to the JAX side's gradient of one step (``fold_grads``
of ``jax.grad`` of ``packed_ce``; the stem's the fold of w4's four copies),
as ``test_step_grads_match_folded_jax_grads`` builds it. Each emulation's
error against an f64 reference is held to at most 4x that of the same
function computed in f32, and on small integers each equals the plain
version bitwise.

The ``cuda`` cases run on the card at small ragged shapes and at C = 100,
B = 32 (rtol 1e-5, atol 1e-5 of max|reference|, ``close`` of
``tests/test_torch_port_client_ops.py``): K3's kernel against its plain
version, the weight gradients against the exact (f64) gradient, since
the plain version's f32 sums over 32 x 196 positions are themselves off
the exact ones by more than that tolerance at C = 100, B = 32. Each
kernel's error against f64 is held to at most 4x the f32 plain version's,
two calls are bitwise equal, and on small integer operands the kernel is
bitwise equal to the plain version. They skip without a card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_fl_security_tpu_torch.ops._launch import KERNEL_LAUNCHES
from multimodal_fl_security_tpu_torch.ops.client_conv import (
    _dense_dz,
    _grouped,
    _ungrouped,
    client_stem_conv,
    client_stem_conv_plain,
    conv_dgrad,
    conv_fwd,
    conv_fwd_plain,
    conv_wgrad,
    conv_wgrad_plain,
)
from multimodal_fl_security_tpu_torch.ops.client_dense import (
    dense_bwd,
    dense_fwd,
)
from multimodal_fl_security_tpu_torch.ops.client_sgd import client_ce
from test_torch_port_client_ops import (  # noqa: F401 (case: a fixture)
    CIN,
    C,
    case,
    jax_side,
    jax_step,
    min_window_gap,
    nchw,
    stack_trees,
    wgrad_f64,
)

#: the kernels' f32 tolerance against a reference: rtol, and atol over
#: max|reference| (the same sums in another order)
RTOL = 1e-5
#: an emulation's or a kernel's error against f64, over the f32
#: computation's
F64_FACTOR = 4.0


def tf32_rne(a):
    """f32 values rounded to TF32 (10 mantissa bits), to nearest even: the
    kernels' ``mft_tf32_rne`` on the bits."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def split(a):
    """(hi, lo): hi = tf32(a), lo = tf32(a - hi)."""
    a = np.asarray(a, dtype=np.float32)
    hi = tf32_rne(a)
    return hi, tf32_rne(a - hi)


def products_3xtf32(a, b):
    """a @ b of f32 [..., m, k] and [..., k, n] as the kernels form it:
    lo hi + hi lo + hi hi, each product summed in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh) + (ah @ bl) + (ah @ bh)


def assert_f32_close(got, want, what=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------- K3

def stem_im2col(x_flat):
    """[C, B, 28*28*8] NHWC -> [C, B*196, 128] rows of the 4x4, stride-2,
    pad-1 taps, k = (di*4 + dj)*8 + ci: the kernel's GEMM rows."""
    c, b, _ = x_flat.shape
    x = np.pad(x_flat.reshape(c, b, 28, 28, 8),
               ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0)))
    taps = [x[:, :, di:di + 28:2, dj:dj + 28:2, :]
            for di in range(4) for dj in range(4)]  # each [C, B, 14, 14, 8]
    return np.stack(taps, axis=4).reshape(c, b * 196, 128)


def stem_3xtf32(x_flat, w4):
    """``stem_raw_tf32_kernel``'s arithmetic: the [B*196, 128] x [128, 128]
    GEMM of each client in 3xTF32, four chunks of 32 k (4 k8 steps) each
    summed afresh, added in chunk order in f32."""
    c, b, _ = x_flat.shape
    a = stem_im2col(np.asarray(x_flat, np.float32))
    w = np.asarray(w4, np.float32).reshape(c, 128, 128)
    out = np.zeros((c, b * 196, 128), np.float32)
    for k0 in range(0, 128, 32):
        out += products_3xtf32(a[:, :, k0:k0 + 32], w[:, k0:k0 + 32])
    return out.reshape(c, b, 14, 14, 128)


def k3_inputs(c=3, b=4, seed=1):
    """The inputs of ``test_client_stem_conv_matches_k3``."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(c, b, 28 * 28 * 8)).astype(np.float32)
    w4 = (0.1 * rng.normal(size=(c, 4, 4, 8, 128))).astype(np.float32)
    return x, w4


def test_stem_3xtf32_matches_k3():
    """The emulated kernel against K3 in interpret mode and its reference,
    at rtol 1e-5 / atol 1e-5 of max|K3| (f32 sums in another order)."""
    jax, jnp, *_ = jax_side()
    from multimodal_fl_security_tpu.ops.client_conv import (
        client_stem_conv as jax_stem,
    )
    from multimodal_fl_security_tpu.ops.client_conv import (
        client_stem_conv_reference,
    )

    x, w4 = k3_inputs()
    got = stem_3xtf32(x, w4)
    assert got.dtype == np.float32 and got.shape == (3, 4, 14, 14, 128)
    for name, want in (
            ("interpret", jax_stem(jnp.asarray(x), jnp.asarray(w4),
                                   interpret=True)),
            ("reference", client_stem_conv_reference(jnp.asarray(x),
                                                     jnp.asarray(w4)))):
        assert_f32_close(got, np.asarray(want), name)


def test_stem_3xtf32_keeps_f32_accuracy():
    """Against an f64 reference, the emulated kernel's error is at most 4x
    the f32 plain version's (grouped ``F.conv2d`` in f32)."""
    x, w4 = k3_inputs(seed=3)
    ref = np.einsum("cmk,ckn->cmn", stem_im2col(x.astype(np.float64)),
                    w4.astype(np.float64).reshape(3, 128, 128)).reshape(
                        3, 4, 14, 14, 128)
    plain = client_stem_conv_plain(torch.from_numpy(x),
                                   torch.from_numpy(w4)).numpy()
    err = float(np.abs(stem_3xtf32(x, w4) - ref).max())
    err_plain = float(np.abs(plain - ref).max())
    assert err <= F64_FACTOR * err_plain, (err, err_plain)
    assert_f32_close(plain, ref, "the plain version")


def test_stem_3xtf32_exact_on_integers():
    """On small integers hi = a and lo = 0: every product and sum is exact,
    and the emulation equals the plain version bitwise."""
    rng = np.random.RandomState(4)
    x = rng.randint(-3, 4, size=(2, 3, 28 * 28 * 8)).astype(np.float32)
    w4 = rng.randint(-2, 3, size=(2, 4, 4, 8, 128)).astype(np.float32)
    _, lo = split(x)
    assert not lo.any()
    want = client_stem_conv_plain(torch.from_numpy(x),
                                  torch.from_numpy(w4)).numpy()
    assert float(np.abs(want).max()) > 50  # sums large enough to test
    np.testing.assert_array_equal(stem_3xtf32(x, w4), want)


# ---------------------------------------------------------------- conv2

#: ``conv2_wgrad_tf32_kernel``'s constants (``csrc/client_conv.cu``): the
#: blocks of a cluster, which split a client's samples; the k16 steps of a
#: sample (four pooled windows each: 49 windows and 3 of dZ = 0); the steps
#: a fresh accumulator takes; the classes of a channel's windows (j, j + 6,
#: ...) that db sums apart
CONV2_CLUSTER, CONV2_STEPS, CONV2_CHUNK, CONV2_DB_CLASSES = 8, 13, 4, 6


def conv2_window_rows(t):
    """[..., 14, 14] -> [..., 208]: the positions in the kernel's row order,
    row 4 p + q for position q = 2 di + dj of pooled window p, then the 12
    rows of windows 49-51 (0)."""
    lead = t.shape[:-2]
    rows = t.reshape(lead + (7, 2, 7, 2)).swapaxes(-3, -2).reshape(
        lead + (196,))
    return np.concatenate([rows, np.zeros(lead + (12,), rows.dtype)], -1)


def conv2_wgrad_3xtf32(x, dp, h, arg):
    """``conv2_wgrad_tf32_kernel``'s arithmetic on conv2's input x [C, B,
    32, 14, 14] and the pooled gradient, map and argmax [C, B, 64, 7, 7]
    (torch tensors): dW[co, (ci, kh, kw)] = sum over (n, position) of
    dZ[co] x[ci] shifted, in 3xTF32, and db[co] = sum of dZ[co] in f32. The
    kernel's order: rank r of a cluster takes samples [r B / 8, (r + 1) B /
    8); a sample's k16 steps (the sixteen rows of four pooled windows, in
    window order) are summed in chunks of four, each into a fresh sum that
    is added to the rank's total in f32, chunks and samples in order. db:
    class j of a channel's windows (j, j + 6, ...) summed over the rank's
    samples in order, then the classes in order. Then the ranks' totals are
    added in rank order. (The kernel sums a chunk on the tensor cores, whose
    sums do not round to nearest; here each step is one f32 product, added
    in step order.) Returns (dW [C, 64, 32, 3, 3], db [C, 64]) as numpy
    f32."""
    c, b = x.shape[:2]
    dz = _dense_dz(dp, h, arg, 14, 14).numpy()  # [C, B, 64, 14, 14]
    cols = F.unfold(x.reshape(c * b, 32, 14, 14).float(), 3, padding=1)
    cols = cols.numpy().reshape(c, b, 32 * 9, 14, 14)  # k = (ci, kh, kw)
    zt = conv2_window_rows(dz).reshape(c, b, 64, CONV2_STEPS, 16)
    pt = conv2_window_rows(cols).reshape(c, b, 32 * 9, CONV2_STEPS, 16)
    g = torch.where(h > 0, dp, torch.zeros(())).numpy().astype(np.float32)
    g = g.reshape(c, b, 64, 49)
    dw = db = None
    for r in range(CONV2_CLUSTER):
        samples = range(r * b // CONV2_CLUSTER, (r + 1) * b // CONV2_CLUSTER)
        acc = np.zeros((c, 64, 32 * 9), np.float32)
        classes = np.zeros((CONV2_DB_CLASSES, c, 64), np.float32)
        for n in samples:
            parts = products_3xtf32(zt[:, n].transpose(0, 2, 1, 3),
                                    pt[:, n].transpose(0, 2, 3, 1))
            for s0 in range(0, CONV2_STEPS, CONV2_CHUNK):
                chunk = parts[:, s0]
                for s in range(s0 + 1, min(s0 + CONV2_CHUNK, CONV2_STEPS)):
                    chunk = chunk + parts[:, s]
                acc += chunk
            for j in range(CONV2_DB_CLASSES):
                for p in range(j, 49, CONV2_DB_CLASSES):
                    classes[j] += g[:, n, :, p]
        acc_db = classes[0]
        for j in range(1, CONV2_DB_CLASSES):
            acc_db = acc_db + classes[j]
        dw = acc if dw is None else dw + acc
        db = acc_db if db is None else db + acc_db
    return dw.reshape(c, 64, 32, 3, 3), db


def port_step_conv2(case):
    """The port's forward and backward of one step on the case's batch up
    to conv2's weight gradient (as ``ops/fused_kernel.py::step_backward`` runs
    it, on the CPU's plain versions): conv2's input, the pooled gradient,
    map and argmax."""
    t = port_step(case)
    return t["h1"], t["dh3"], t["h3"], t["a3"]


def port_step(case):
    """The tape of :func:`port_step_conv2`'s step, with the stem's input
    ``x`` and pooled argmax ``a1`` and conv2's weights ``w2``."""
    f32 = torch.float32
    views = case["model"].layout(CIN).views(case["params"])
    grads = case["model"].layout(CIN).views(
        torch.zeros_like(case["params"]))
    x = nchw(case["images"])
    h1, a1 = conv_fwd(x, views["conv1.weight"], views["conv1.bias"],
                      dtype=f32, channels_last=True)
    h3, a3 = conv_fwd(h1, views["conv2.weight"], views["conv2.bias"],
                      dtype=f32)
    f3 = h3.view(C, h3.shape[1], -1)
    h4 = dense_fwd(f3, views["fc1.weight"], views["fc1.bias"], relu=True,
                   wdtype=f32, out_dtype=f32)
    logits = dense_fwd(h4, views["fc2.weight"], views["fc2.bias"],
                       wdtype=f32, out_dtype=f32)
    _, dl = client_ce(logits, torch.from_numpy(case["labels"]).long(),
                      torch.from_numpy(case["mask"]))
    dz4 = dense_bwd(dl, h4, views["fc2.weight"], grads["fc2.weight"],
                    grads["fc2.bias"], mask=h4, wdtype=f32, gdtype=f32,
                    dx_dtype=f32)
    dh3 = dense_bwd(dz4, f3, views["fc1.weight"], grads["fc1.weight"],
                    grads["fc1.bias"], wdtype=f32, gdtype=f32,
                    dx_dtype=f32).view(h3.shape)
    return dict(x=x, h1=h1, a1=a1, dh3=dh3, h3=h3, a3=a3,
                w2=views["conv2.weight"])


def test_conv2_wgrad_3xtf32_matches_folded_jax_grads(case):
    """The emulated kernel on one step's conv2 operands against the JAX
    side's folded conv2 gradient of the same step, at the tolerance of
    ``test_step_grads_match_folded_jax_grads`` (rtol 1e-4, atol 1e-5: the
    two packages' forward and backward sum in other orders)."""
    from multimodal_fl_security_tpu_torch.models.from_jax import (
        params_from_jax,
    )

    assert min_window_gap(case) > 2e-6  # the comparison's premise
    steps = [jax_step(case, c) for c in range(C)]
    want = case["model"].layout(CIN).views(params_from_jax(
        case["model"], stack_trees([s[1] for s in steps]), device="cpu"))
    dw, db = conv2_wgrad_3xtf32(*port_step_conv2(case))
    np.testing.assert_allclose(dw, want["conv2.weight"].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(db, want["conv2.bias"].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_conv2_wgrad_3xtf32_keeps_f32_accuracy(case):
    """Against an f64 reference, the emulated kernel's dW is off by at most
    4x the f32 plain version's (``conv2d_weight`` in f32)."""
    x, dp, h, arg = port_step_conv2(case)
    ref = wgrad_f64(x, dp, h, arg, (C, 64, 32, 3, 3))[0].numpy()
    gw, gb = torch.empty(C, 64, 32, 3, 3), torch.empty(C, 64)
    conv_wgrad_plain(x, dp, h, arg, gw, gb)
    dw, _ = conv2_wgrad_3xtf32(x, dp, h, arg)
    err, err_f32 = (float(np.abs(v - ref).max()) for v in (dw, gw.numpy()))
    assert err <= F64_FACTOR * err_f32, (err, err_f32)


def test_conv2_wgrad_3xtf32_exact_on_integers():
    """On small integers every product and sum is exact: the emulation
    equals the plain version bitwise."""
    gen = torch.Generator().manual_seed(5)
    c, b = 2, 3
    x = torch.randint(-3, 4, (c, b, 14, 14, 32), generator=gen).float()
    x = x.permute(0, 1, 4, 2, 3)  # NHWC, as the main path's
    w = torch.randint(-2, 3, (c, 64, 32, 3, 3), generator=gen).float()
    bias = torch.randint(-2, 3, (c, 64), generator=gen).float()
    h, arg = conv_fwd_plain(x, w, bias)
    dp = torch.randint(-4, 5, h.shape, generator=gen).float()
    gw, gb = torch.empty_like(w), torch.empty_like(bias)
    conv_wgrad_plain(x, dp, h, arg, gw, gb)
    dw, db = conv2_wgrad_3xtf32(x, dp, h, arg)
    assert float(gw.abs().max()) > 100  # sums large enough to test
    np.testing.assert_array_equal(dw, gw.numpy())
    np.testing.assert_array_equal(db, gb.numpy())


# ---------------------------------------------------------------- the stem

#: ``stem_wgrad_tf32_kernel``'s constants (``csrc/client_conv.cu``): the
#: blocks of a cluster, which split a client's samples; the warps of a
#: block, which split each chunk's rows; the pooled windows a chunk; the
#: chunks whose sums are added before the block's total
STEM_CLUSTER, WARPS, CHUNK_WINDOWS, GROUP = 8, 4, 32, 8


def stem_rows(x, dp, h, arg):
    """The stem's dense rows in the kernel's order, row (n, oi, oj, q) for
    position q = di * 2 + dj of window (oi, oj) of sample n: dZ [C, rows,
    32] and the patch [C, rows, 9 cin + 1], its taps in (ci, kh, kw) order,
    then the ones column."""
    c, b, cin, hh, ww = x.shape

    def window_rows(t):  # [C, B, k, H, W] -> [C, B * H * W, k]
        k = t.shape[2]
        return t.reshape(c, b, k, hh // 2, 2, ww // 2, 2).transpose(
            0, 1, 3, 5, 4, 6, 2).reshape(c, -1, k)

    z = window_rows(_dense_dz(dp, h, arg, hh, ww).numpy())
    taps = F.unfold(x.reshape(c * b, cin, hh, ww).float(), 3, padding=1)
    p = window_rows(taps.numpy().reshape(c, b, cin * 9, hh, ww))
    ones = np.ones(p.shape[:-1] + (1,), np.float32)
    return z.astype(np.float32), np.concatenate([p, ones], axis=-1)


def stem_wgrad_3xtf32(x, dp, h, arg):
    """``stem_wgrad_tf32_kernel``'s arithmetic on the stem's input x [C, B,
    cin, H, W] and the pooled gradient, map and argmax [C, B, 32, H/2, W/2]
    (torch tensors): dW[co, (ci, kh, kw)] and db[co] = sum over the dense
    rows of dZ[row, co] times the patch row, in 3xTF32. The kernel's order:
    rank r of a cluster takes samples [r B / 8, (r + 1) B / 8); its rows go
    in chunks of 4 x 32, each chunk's rows split evenly among the warps; a
    warp sums its rows of a chunk afresh, adds them to the sum of its
    current group of 8 chunks and each group's sum to its total, in f32;
    then the warps' totals are added in warp order, and the ranks' in rank
    order. (The kernel sums a warp's rows of a chunk as two fresh k16 steps
    on the tensor cores, whose sums do not round to nearest; here they are
    one f32 product.) Returns (dW [C, 32, cin, 3, 3], db [C, 32]) as numpy
    f32."""
    c, b, cin = x.shape[:3]
    z, p = stem_rows(x, dp, h, arg)
    per_sample = z.shape[1] // b
    chunk = 4 * CHUNK_WINDOWS
    total = None
    for r in range(STEM_CLUSTER):
        rows = slice(r * b // STEM_CLUSTER * per_sample,
                     (r + 1) * b // STEM_CLUSTER * per_sample)
        pad = ((0, 0), (0, -(rows.stop - rows.start) % chunk), (0, 0))
        zr, pr = np.pad(z[:, rows], pad), np.pad(p[:, rows], pad)
        chunks = zr.shape[1] // chunk
        parts = products_3xtf32(
            zr.reshape(c, chunks, WARPS, -1, 32).transpose(0, 1, 2, 4, 3),
            pr.reshape(c, chunks, WARPS, chunk // WARPS, p.shape[-1]))
        acc = np.zeros((c, WARPS, 32, p.shape[-1]), np.float32)
        grp = np.zeros_like(acc)
        for k in range(chunks):
            grp += parts[:, k]
            if (k + 1) % GROUP == 0 or k + 1 == chunks:
                acc += grp
                grp[:] = 0
        red = acc[:, 0].copy()
        for w in range(1, WARPS):
            red += acc[:, w]
        total = red if total is None else total + red
    return total[..., :-1].reshape(c, 32, cin, 3, 3), total[..., -1]


def stem_operands(cin, ints=False, c=2, b=32, seed=6):
    """The stem's weight-gradient operands at ``cin`` input channels: x
    [C, B, cin, 28, 28], the pooled map and argmax of the plain forward
    (NHWC, as the main path's) and a pooled gradient of the map's strides;
    ``ints``: small integers."""
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, lo, hi, scale):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen).float()
        return scale * torch.randn(shape, generator=gen)

    x = draw((c, b, cin, 28, 28), -3, 4, 1.0)
    w = draw((c, 32, cin, 3, 3), -2, 3, 0.3)
    bias = draw((c, 32), -2, 3, 0.1)
    h, arg = conv_fwd_plain(x, w, bias, channels_last=True)
    dp = torch.empty_like(h).copy_(draw(h.shape, -4, 5, 0.1))
    return x, w, bias, h, arg, dp


def test_stem_wgrad_3xtf32_matches_folded_jax_grads(case):
    """The emulated kernel on one step's stem operands (eight input
    channels) against the JAX side's folded stem gradient of the same step
    (the fold of w4's four copies), at the tolerance of
    ``test_step_grads_match_folded_jax_grads``."""
    from multimodal_fl_security_tpu_torch.models.from_jax import (
        params_from_jax,
    )

    assert min_window_gap(case) > 2e-6  # the comparison's premise
    steps = [jax_step(case, c) for c in range(C)]
    want = case["model"].layout(CIN).views(params_from_jax(
        case["model"], stack_trees([s[1] for s in steps]), device="cpu"))
    t = port_step(case)
    dh1 = conv_dgrad(t["dh3"], t["h3"], t["a3"], t["w2"], (14, 14),
                     channels_last=True)
    dw, db = stem_wgrad_3xtf32(t["x"], dh1, t["h1"], t["a1"])
    np.testing.assert_allclose(dw, want["conv1.weight"].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(db, want["conv1.bias"].numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("cin", [1, 8])
def test_stem_wgrad_3xtf32_keeps_f32_accuracy(cin):
    """Against an f64 reference, the emulated kernel's dW and db are off by
    at most 4x the f32 plain version's (``conv2d_weight`` in f32) at C = 2,
    B = 32: 25,088 rows a client."""
    x, w, bias, h, arg, dp = stem_operands(cin)
    ref = [v.numpy() for v in wgrad_f64(x, dp, h, arg, w.shape)]
    gw, gb = torch.empty_like(w), torch.empty_like(bias)
    conv_wgrad_plain(x, dp, h, arg, gw, gb)
    for got, plain, want in zip(stem_wgrad_3xtf32(x, dp, h, arg),
                                (gw.numpy(), gb.numpy()), ref):
        err, err_f32 = (float(np.abs(v - want).max()) for v in (got, plain))
        assert err <= F64_FACTOR * err_f32, (err, err_f32)


@pytest.mark.parametrize("cin", [1, 8])
def test_stem_wgrad_3xtf32_exact_on_integers(cin):
    """On small integers hi = a and lo = 0, and every product and sum is
    exact: the emulation equals the plain version bitwise, over a ragged
    batch (B = 11: the eight ranks take 1 or 2 samples)."""
    x, w, bias, h, arg, dp = stem_operands(cin, ints=True, b=11)
    gw, gb = torch.empty_like(w), torch.empty_like(bias)
    conv_wgrad_plain(x, dp, h, arg, gw, gb)
    dw, db = stem_wgrad_3xtf32(x, dp, h, arg)
    assert float(gw.abs().max()) > 100  # sums large enough to test
    np.testing.assert_array_equal(dw, gw.numpy())
    np.testing.assert_array_equal(db, gb.numpy())


# ---------------------------------------------------------------- CUDA

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def close(got, want):
    """f32: rtol 1e-5, atol 1e-5 of max|want| (``close`` of
    ``tests/test_torch_port_client_ops.py``)."""
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))


def counted(call):
    """(call's result, the launches it made by kernel)."""
    before = dict(KERNEL_LAUNCHES)
    out = call()
    return out, {k: KERNEL_LAUNCHES[k] - before[k] for k in KERNEL_LAUNCHES
                 if KERNEL_LAUNCHES[k] != before[k]}


def stem_f64(x, w4):
    """K3 in f64 on the card: the reference of the accuracy checks."""
    c, b = x.shape[:2]
    xx = x.double().view(c, b, 28, 28, 8).permute(0, 1, 4, 2, 3)
    ww = w4.double().permute(0, 4, 3, 1, 2).reshape(-1, 8, 4, 4)
    return _ungrouped(F.conv2d(_grouped(xx), ww, stride=2, padding=1,
                               groups=c), c).permute(0, 1, 3, 4, 2)


#: (C, B) of K3: B = 1 and 7 end each client in a ragged 64-row tile (196
#: and 1,372 rows), C = 100 puts client boundaries inside the persistent
#: blocks' ranges
STEM_CASES = [(1, 1), (3, 4), (3, 7), (100, 7), (100, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,b", STEM_CASES)
def test_stem_raw_tf32_matches_plain(cuda, c, b):
    """f32 K3 runs stem_raw_tf32 once a call: within the f32 tolerance of
    the plain version, its error against f64 at most 4x the plain's, two
    calls bitwise equal, and on small integers bitwise the plain version
    (without cuDNN)."""
    x = torch.randn((c, b, 28 * 28 * 8), generator=cuda, device="cuda")
    w4 = 0.1 * torch.randn((c, 4, 4, 8, 128), generator=cuda, device="cuda")
    got, launches = counted(lambda: client_stem_conv(x, w4))
    again = client_stem_conv(x, w4)
    want = client_stem_conv_plain(x, w4)
    ref = stem_f64(x, w4)
    xi = torch.randint(-3, 4, x.shape, generator=cuda, device="cuda").float()
    wi = torch.randint(-2, 3, w4.shape, generator=cuda,
                       device="cuda").float()
    got_i = client_stem_conv(xi, wi)
    with torch.backends.cudnn.flags(enabled=False):
        want_i = client_stem_conv_plain(xi, wi)
    torch.cuda.synchronize()
    assert launches == {"stem_raw_tf32": 1}
    assert got.shape == (c, b, 14, 14, 128) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert torch.equal(got, again)
    close(got, want)
    err, err_plain = (float((v.double() - ref).abs().max())
                      for v in (got, want))
    print(f"[stem_raw_tf32 C={c} B={b}] max|kernel-plain| "
          f"{float((got - want).abs().max()):.3g}; vs f64: kernel {err:.3g}, "
          f"plain {err_plain:.3g}")
    assert err <= F64_FACTOR * err_plain, (err, err_plain)
    assert float(want_i.abs().max()) > 50  # sums large enough to test
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
def test_f32_raw_off_k3_geometry_runs_conv_fwd(cuda):
    """An f32 raw conv that stem_raw_tf32 does not take goes, by the route
    chosen before the launch, to conv_fwd: one input channel, a misaligned
    x_flat, stride 1, an NCHW output."""
    f32 = torch.float32
    x = torch.randn((3, 4, 6273), generator=cuda, device="cuda")
    w4 = 0.1 * torch.randn((3, 4, 4, 8, 128), generator=cuda, device="cuda")
    x1 = torch.randn((3, 4, 784), generator=cuda, device="cuda")
    w1 = 0.1 * torch.randn((3, 4, 4, 1, 128), generator=cuda, device="cuda")
    xc = x[:, :, :6272].view(3, 4, 28, 28, 8).permute(0, 1, 4, 2, 3)
    wc = w4.permute(0, 4, 3, 1, 2)  # (out, in, kh, kw)
    calls = {
        "one input channel": (lambda: client_stem_conv(x1, w1),
                              lambda: client_stem_conv_plain(x1, w1)),
        "a misaligned x_flat": (
            lambda: client_stem_conv(x[:, :, 1:], w4),
            lambda: client_stem_conv_plain(x[:, :, 1:], w4)),
        "stride 1": (
            lambda: conv_fwd(xc, wc, None, stride=1, pool=False, dtype=f32,
                             channels_last=True)[0],
            lambda: conv_fwd_plain(xc, wc, None, stride=1, pool=False,
                                   dtype=f32, channels_last=True)[0]),
        "an NCHW output": (
            lambda: conv_fwd(xc, wc, None, stride=2, pool=False,
                             dtype=f32)[0],
            lambda: conv_fwd_plain(xc, wc, None, stride=2, pool=False,
                                   dtype=f32)[0]),
    }
    for what, (kernel, plain) in calls.items():
        got, launches = counted(kernel)
        want = plain()
        torch.cuda.synchronize()
        assert launches == {"conv_fwd": 1}, what
        close(got, want)


def conv2_case(gen, c, b, main_layout, ints=False, dead=False):
    """conv2's f32 weight-gradient operands: x [C, B, 32, 14, 14] (NHWC in
    the main path's layout, else NCHW), the pooled map and argmax of the
    plain forward (NCHW in the main path's layout, else NHWC) and a pooled
    gradient of the map's strides; ``ints``: small integers; ``dead``: a
    bias that puts the whole pooled map below 0, so that the relu passes no
    gradient (dZ = 0)."""
    def draw(shape, lo, hi, scale):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen,
                                 device="cuda").float()
        return scale * torch.randn(shape, generator=gen, device="cuda")

    x = draw((c, b, 14, 14, 32), -3, 4, 1.0).permute(0, 1, 4, 2, 3)
    x = x if main_layout else x.contiguous()
    if not ints:
        x = torch.relu(x)
    w = draw((c, 64, 32, 3, 3), -2, 3, 0.3)
    bias = draw((c, 64), -2, 3, 0.1) - (10_000 if dead else 0)
    h, arg = conv_fwd_plain(x, w, bias, channels_last=not main_layout)
    dp = torch.empty_like(h).copy_(draw(h.shape, -4, 5, 0.1))
    return x, w, bias, h, arg, dp


@pytest.mark.cuda
@pytest.mark.parametrize("main_layout", [True, False])
@pytest.mark.parametrize("c,b,dead", [
    pytest.param(3, 5, False, id="3-5"),
    pytest.param(100, 32, False, id="100-32"),
    # ragged: the cluster's eight ranks take 0 or 1 samples
    pytest.param(1, 1, False, id="1-1"),
    pytest.param(3, 7, False, id="3-7"),
    # the whole pooled map relu-dead: dW = 0, db = 0
    pytest.param(3, 5, True, id="3-5-dead")])
def test_conv2_wgrad_tf32_matches_f64(cuda, c, b, dead, main_layout):
    """f32 conv2 weight gradients run conv2_wgrad_tf32 once a call: within
    the f32 tolerance of the exact (f64) gradient, the error against it at
    most 4x the f32 plain version's, two calls bitwise equal, and on small
    integers bitwise the plain version (without cuDNN). Prints the
    kernel's distance from the f32 plain version, which is not held: at
    C=100, B=32 the plain version's own error exceeds the tolerance. With
    the map relu-dead, every output is 0."""
    x, w, bias, h, arg, dp = conv2_case(cuda, c, b, main_layout, dead=dead)
    grads = [torch.full_like(w, float("nan")), torch.full_like(bias, 0.5)]
    again = [torch.empty_like(w), torch.empty_like(bias)]
    plain = [torch.empty_like(w), torch.empty_like(bias)]
    _, launches = counted(lambda: conv_wgrad(x, dp, h, arg, *grads))
    conv_wgrad(x, dp, h, arg, *again)
    conv_wgrad_plain(x, dp, h, arg, *plain)
    ref = wgrad_f64(x, dp, h, arg, w.shape)
    xi, wi, bi, hi, ai, dpi = conv2_case(cuda, c, b, main_layout, ints=True,
                                         dead=dead)
    got_i = [torch.empty_like(wi), torch.empty_like(bi)]
    want_i = [torch.empty_like(wi), torch.empty_like(bi)]
    conv_wgrad(xi, dpi, hi, ai, *got_i)
    with torch.backends.cudnn.flags(enabled=False):
        conv_wgrad_plain(xi, dpi, hi, ai, *want_i)
    torch.cuda.synchronize()
    assert launches == {"conv2_wgrad_tf32": 1}
    for got, rep, ref_ in zip(grads, again, ref):
        assert torch.equal(got, rep)  # fixed-order sums
        close(got, ref_)
    err, err_plain = (float((v.double() - ref[0]).abs().max())
                      for v in (grads[0], plain[0]))
    tol = RTOL * float(ref[0].abs().max())
    print(f"[conv2_wgrad_tf32 C={c} B={b} main layout {main_layout}] "
          f"max|kernel-plain| {float((grads[0] - plain[0]).abs().max()):.3g}"
          f" (tolerance {tol:.3g}); vs f64: kernel {err:.3g}, plain "
          f"{err_plain:.3g}")
    assert err <= F64_FACTOR * err_plain, (err, err_plain)
    if dead:
        assert not (h > 0).any() and not grads[0].any() and \
            not grads[1].any()
    else:  # sums large enough to test
        assert float(want_i[0].abs().max()) > 100
    assert torch.equal(got_i[0], want_i[0]) and torch.equal(got_i[1],
                                                            want_i[1])


def stem_case(gen, c, b, cin, layout, ints=False):
    """The stem's f32 weight-gradient operands on the card: x [C, B, cin,
    28, 28] and the pooled map, argmax and a gradient of the map's strides.
    ``layout``: "main", the main path's (x NCHW, the maps NHWC with the
    samples back to back, read with vector loads); "nchw", the maps NCHW;
    "strided", every other sample of twice the batch (x and the maps NHWC
    but not back to back). The last two are read one element at a time.
    ``ints``: small integers."""
    def draw(shape, lo, hi, scale):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen,
                                 device="cuda").float()
        return scale * torch.randn(shape, generator=gen, device="cuda")

    step = 2 if layout == "strided" else 1
    x = draw((c, step * b, cin, 28, 28), -3, 4, 1.0)[:, ::step]
    w = draw((c, 32, cin, 3, 3), -2, 3, 0.3)
    bias = draw((c, 32), -2, 3, 0.1)
    with torch.backends.cudnn.flags(enabled=not ints):
        h, arg = conv_fwd_plain(x, w, bias, channels_last=layout != "nchw")
    dp = torch.empty_like(h).copy_(draw(h.shape, -4, 5, 0.1))
    if layout == "strided":
        def spread(v):  # v's values at every other sample of a 2B buffer
            big = torch.zeros((c, 2 * b, 14, 14, 32), dtype=v.dtype,
                              device="cuda").permute(0, 1, 4, 2, 3)
            big[:, ::2] = v
            return big[:, ::2]

        h, arg, dp = spread(h), spread(arg), spread(dp)
    return x, w, bias, h, arg, dp


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["main", "nchw", "strided"])
@pytest.mark.parametrize("c,b", [(3, 5), (100, 32)])
@pytest.mark.parametrize("cin", range(1, 9))
def test_stem_wgrad_tf32_matches_f64(cuda, cin, c, b, layout):
    """f32 stem weight gradients run stem_wgrad_tf32 once a call, at one to
    eight input channels, in the main path's layout and two others: within
    the f32 tolerance of the exact (f64) gradient, the error against it at
    most 4x the f32 plain version's, two calls bitwise equal, and on small
    integers bitwise the plain version (without cuDNN)."""
    x, w, bias, h, arg, dp = stem_case(cuda, c, b, cin, layout)
    grads = [torch.full_like(w, float("nan")), torch.full_like(bias, 0.5)]
    again = [torch.empty_like(w), torch.empty_like(bias)]
    plain = [torch.empty_like(w), torch.empty_like(bias)]
    _, launches = counted(lambda: conv_wgrad(x, dp, h, arg, *grads))
    conv_wgrad(x, dp, h, arg, *again)
    conv_wgrad_plain(x, dp, h, arg, *plain)
    ref = wgrad_f64(x, dp, h, arg, w.shape)
    xi, wi, bi, hi, ai, dpi = stem_case(cuda, c, b, cin, layout, ints=True)
    got_i = [torch.empty_like(wi), torch.empty_like(bi)]
    want_i = [torch.empty_like(wi), torch.empty_like(bi)]
    conv_wgrad(xi, dpi, hi, ai, *got_i)
    with torch.backends.cudnn.flags(enabled=False):
        conv_wgrad_plain(xi, dpi, hi, ai, *want_i)
    torch.cuda.synchronize()
    assert launches == {"stem_wgrad_tf32": 1}
    for got, rep, ref_, pl in zip(grads, again, ref, plain):
        assert torch.equal(got, rep)  # fixed-order sums
        close(got, ref_)
        err, err_plain = (float((v.double() - ref_).abs().max())
                          for v in (got, pl))
        assert err <= F64_FACTOR * err_plain, (err, err_plain)
    print(f"[stem_wgrad_tf32 cin={cin} C={c} B={b} {layout}] vs f64: dW "
          f"kernel {float((grads[0].double() - ref[0]).abs().max()):.3g}, "
          f"plain {float((plain[0].double() - ref[0]).abs().max()):.3g}")
    assert float(want_i[0].abs().max()) > 50  # sums large enough to test
    assert torch.equal(got_i[0], want_i[0]) and torch.equal(got_i[1],
                                                            want_i[1])
