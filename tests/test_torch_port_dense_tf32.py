"""fc1's f32 forward and backward on Hopper's tensor cores in 3xTF32:
``dense_fwd_tf32`` and ``dense_bwd_tf32`` (``csrc/client_dense.cu``).

On the CPU, each kernel's arithmetic is emulated in numpy with the helpers of
``tests/test_torch_port_conv_tf32.py``: every f32 operand split into hi =
tf32(a) and lo = tf32(a - hi); lo hi + hi lo + hi hi summed in f32, each
chunk of 32 k (4 k8 steps) into a fresh sum added to the total in chunk
order; the forward's 7 ranks each sum their share of K that way and are
added in rank order; the backward's dW is one chunk (K = the 32 rows), its
dx two feature halves of two chunks each, the upper half added last. The
emulations stand in for the plain versions in a port step held to the JAX
package's folded gradients of the same step, are held to f64 (their error
at most 4x the f32 plain version's) and, on small integers, bitwise to the
plain versions. The route (which f32 calls the kernels take) is mirrored in
Python and held to the C entries' rule on the card.

The ``cuda`` cases run the kernels at fc1's full shape [100, 32, 3136] x
[100, 128, 3136], at a ragged shape the route takes (C = 3, 7 rows, K = 200,
F = 64) and in the flat buffer's layout (an odd client's weight rows 8-byte
aligned only): within rtol 1e-5 and atol 1e-5 of max|f64| of the f64
result, the error at most 4x the f32 plain version's, two calls bitwise
equal, bitwise the plain version on small integers, one launch a call and
the relu mask honoured. They skip without a card.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.ops import fused_kernel
from multimodal_fl_security_tpu_torch.ops._launch import DTYPE_CODES, view
from multimodal_fl_security_tpu_torch.ops.client_dense import (
    _MAT_AXES,
    _library,
    dense_bwd,
    dense_bwd_plain,
    dense_fwd,
    dense_fwd_plain,
)
from test_torch_port_client_ops import (  # noqa: F401 (case: a fixture)
    CIN,
    C,
    case,
    flat_views,
    jax_step,
    min_window_gap,
    nchw,
    stack_trees,
)
from test_torch_port_conv_tf32 import (  # noqa: F401 (cuda: a fixture)
    F64_FACTOR,
    RTOL,
    assert_f32_close,
    counted,
    cuda,
    products_3xtf32,
)

#: k a fresh accumulator takes (4 k8 steps), the forward's K splits (the
#: blocks of a cluster) and the slice a rank's share is a multiple of
CHUNK, SPLITS, SLICE = 32, 7, 64
#: (C, rows, K, F): fc1 at two clients, and a ragged shape the route takes
FC1, RAGGED = (2, 32, 3136, 128), (3, 7, 200, 64)


def chunked(a, b, k0, k1):
    """sum over k in [k0, k1) of a[..., k] b[..., k, :] (f32 numpy) as the
    kernels form it: chunks of CHUNK k from k0, each in 3xTF32 into a fresh
    sum, added in order."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for c0 in range(k0, k1, CHUNK):
        c1 = min(c0 + CHUNK, k1)
        acc += products_3xtf32(a[..., c0:c1], b[..., c0:c1, :])
    return acc


def fwd_3xtf32(x, w, b, relu=True):
    """``dense_fwd_tf32_kernel``'s arithmetic on x [C, rows, K], w [C, F, K]
    and b [C, F] (f32 numpy): rank r of the cluster sums k in [r kspan,
    (r + 1) kspan), kspan the K / 7 rounded up to a multiple of 64; rank 0
    adds the ranks' sums in rank order, then the bias, then relu."""
    k = x.shape[-1]
    kspan = -(-(-(-k // SPLITS)) // SLICE) * SLICE
    wt = np.ascontiguousarray(np.swapaxes(w, 1, 2))
    total = None
    for r in range(SPLITS):
        k0, k1 = r * kspan, min(k, (r + 1) * kspan)
        part = chunked(x, wt, k0, k1) if k0 < k1 else \
            np.zeros(x.shape[:2] + w.shape[1:2], np.float32)
        total = part if total is None else total + part
    y = total + b[:, None, :]
    return np.maximum(y, np.float32(0)) if relu else y


def bwd_3xtf32(dz, x, w, mask=None):
    """``dense_bwd_tf32_kernel``'s arithmetic on dz [C, rows, F], x [C, rows,
    K] and w [C, F, K] (f32 numpy): dW = dz^T x in one chunk (K = rows <=
    32), db the sum over rows in order, dx = dz W as two feature halves
    (0-63, 64-127) of chunks, the upper half added last, then zeroed where
    mask <= 0. Returns (dW, db, dx)."""
    f = w.shape[1]
    gw = products_3xtf32(np.ascontiguousarray(np.swapaxes(dz, 1, 2)), x)
    gb = np.zeros(dz.shape[::2], np.float32)
    for r in range(dz.shape[1]):
        gb += dz[:, r]
    dx = chunked(dz, w, 0, min(f, 64))
    if f > 64:
        dx = dx + chunked(dz, w, 64, f)
    if mask is not None:
        dx = np.where(mask > 0, dx, np.float32(0))
    return gw, gb, dx


def draw(shape, seed, ints=False):
    """x [C, rows, K] (post-relu), w [C, F, K], b [C, F] and dz [C, rows, F]
    in f32 from numpy's generator; ``ints``: small integers."""
    c, rows, k, f = shape
    rng = np.random.RandomState(seed)
    if ints:
        return (rng.randint(0, 4, (c, rows, k)).astype(np.float32),
                rng.randint(-2, 3, (c, f, k)).astype(np.float32),
                rng.randint(-2, 3, (c, f)).astype(np.float32),
                rng.randint(-3, 4, (c, rows, f)).astype(np.float32))
    return (np.maximum(rng.normal(size=(c, rows, k)), 0).astype(np.float32),
            (rng.normal(size=(c, f, k)) / k ** 0.5).astype(np.float32),
            rng.normal(size=(c, f)).astype(np.float32),
            (0.1 * rng.normal(size=(c, rows, f))).astype(np.float32))


def max_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max())


@pytest.mark.parametrize("shape", [FC1, RAGGED])
def test_fwd_3xtf32_keeps_f32_accuracy(shape):
    """Against f64, the emulated forward is within rtol 1e-5 / atol 1e-5 of
    max|f64| and off by at most 4x the f32 plain version (``baddbmm``)."""
    x, w, b, _ = draw(shape, seed=1)
    ref = np.maximum(np.einsum("crk,cfk->crf", x.astype(np.float64),
                               w.astype(np.float64)) + b[:, None], 0)
    plain = dense_fwd_plain(*map(torch.from_numpy, (x, w, b)),
                            relu=True).numpy()
    got = fwd_3xtf32(x, w, b)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert_f32_close(got, ref, "the emulated forward")
    err, err_plain = max_err(got, ref), max_err(plain, ref)
    assert err <= F64_FACTOR * err_plain, (err, err_plain)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [FC1, RAGGED])
def test_bwd_3xtf32_keeps_f32_accuracy(shape, masked):
    """Against f64, the emulated dW, db and dx are within rtol 1e-5 / atol
    1e-5 of max|f64|, each off by at most 4x the f32 plain version (two
    ``bmm`` and the sum); ``masked``: dx through x's relu mask."""
    x, w, _, dz = draw(shape, seed=2)
    mask = x if masked else None
    d64, x64, w64 = (a.astype(np.float64) for a in (dz, x, w))
    dx64 = np.einsum("crf,cfk->crk", d64, w64)
    refs = (np.einsum("crf,crk->cfk", d64, x64), d64.sum(axis=1),
            np.where(mask > 0, dx64, 0) if masked else dx64)
    gw, gb = torch.empty(w.shape), torch.empty(w.shape[:2])
    dx = dense_bwd_plain(*map(torch.from_numpy, (dz, x, w)), gw, gb,
                         mask=None if mask is None else torch.from_numpy(mask))
    got = bwd_3xtf32(dz, x, w, mask)
    for name, g, p, ref in zip(("dW", "db", "dx"), got,
                               (gw.numpy(), gb.numpy(), dx.numpy()), refs):
        assert g.dtype == np.float32 and g.shape == ref.shape, name
        assert_f32_close(g, ref, name)
        err, err_plain = max_err(g, ref), max_err(p, ref)
        assert err <= F64_FACTOR * err_plain, (name, err, err_plain)


@pytest.mark.parametrize("shape", [FC1, RAGGED])
def test_3xtf32_exact_on_integers(shape):
    """On small integers hi = a and lo = 0: every product and sum is exact,
    and both emulations equal the plain versions bitwise."""
    x, w, b, dz = draw(shape, seed=3, ints=True)
    tx, tw, tb, tdz = map(torch.from_numpy, (x, w, b, dz))
    want = dense_fwd_plain(tx, tw, tb, relu=True).numpy()
    assert float(np.abs(want).max()) > 20  # sums large enough to test
    np.testing.assert_array_equal(fwd_3xtf32(x, w, b), want)
    gw, gb = torch.empty(w.shape), torch.empty(w.shape[:2])
    dx = dense_bwd_plain(tdz, tx, tw, gw, gb, mask=tx)
    for got, ref in zip(bwd_3xtf32(dz, x, w, x), (gw, gb, dx)):
        np.testing.assert_array_equal(got, ref.numpy())


# ---------------------------------------------------------------- the route

def f32_rows(t, align):
    """A tensor the kernels read as vectors: f32, its last axis contiguous,
    its other strides and its address ``align`` floats aligned."""
    return (t.dtype == torch.float32 and t.stride(2) == 1
            and t.stride(0) % align == 0 and t.stride(1) % align == 0
            and t.data_ptr() % (4 * align) == 0)


def takes_fwd(x, w, wdtype):
    """``mft_dense_fwd_tf32_takes``'s rule: f32 compute, K a multiple of 8,
    F of 64, x's rows 16-byte aligned and w's 8-byte aligned."""
    c, rows, k = x.shape
    f = w.shape[1]
    return (wdtype == torch.float32 and 0 < c <= 65535 and rows > 0
            and k > 0 and k % 8 == 0 and f > 0 and f % 64 == 0
            and f32_rows(x, 4) and f32_rows(w, 2))


def takes_bwd(dz, x, w, gw, dx, wdtype, gdtype):
    """``mft_dense_bwd_tf32_takes``'s rule: f32 compute and gradients, rows
    <= 32, F 64 or 128, K a multiple of 8, dz's and x's rows 16-byte
    aligned, w's, dW's and dx's 8-byte aligned."""
    c, rows, k = x.shape
    f = w.shape[1]
    return (wdtype == gdtype == torch.float32 and 0 < c <= 65535
            and 0 < rows <= 32 and k > 0 and k % 8 == 0 and f in (64, 128)
            and f32_rows(dz, 4) and f32_rows(x, 4) and f32_rows(w, 2)
            and f32_rows(gw, 2) and f32_rows(dx, 2))


def route_cases(device):
    """(what, x, w, dz, wdtype, the route's verdict) of fc1, fc2 and of
    layouts and dtypes the route refuses."""
    f32, bf16 = torch.float32, torch.bfloat16

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    fw, _, _ = flat_views(z(3, 128, 3136), z(3, 128))
    wide = z(3, 7, 3137)
    return [
        ("fc1", z(3, 32, 3136), z(3, 128, 3136), z(3, 32, 128), f32, True),
        ("fc1, flat weights", z(3, 32, 3136), fw, z(3, 32, 128), f32, True),
        ("ragged", z(3, 7, 200), z(3, 64, 200), z(3, 7, 64), f32, True),
        ("fc2", z(3, 32, 128), z(3, 10, 128), z(3, 32, 10), f32, False),
        ("K 100, F 37", z(3, 7, 100), z(3, 37, 100), z(3, 7, 37), f32, False),
        ("F 192", z(3, 7, 200), z(3, 192, 200), z(3, 7, 192), f32, None),
        ("33 rows", z(3, 33, 200), z(3, 64, 200), z(3, 33, 64), f32, None),
        ("bf16 compute", z(3, 32, 3136, dtype=bf16), z(3, 128, 3136),
         z(3, 32, 128, dtype=bf16), bf16, False),
        ("x at a 4-byte offset", wide[:, :, 1:3137 - 8], z(3, 64, 3128),
         z(3, 7, 64), f32, False),
    ]


def test_route_sends_fc1_to_the_3xtf32_kernels():
    """fc1's f32 geometry (also with its weights in the flat buffer) and the
    ragged shape go to dense_fwd_tf32 and dense_bwd_tf32; fc2 and the other
    f32 shapes to the CUDA-core kernels; the backward takes F 64 or 128 and
    rows <= 32 only (None: the forward takes the call, the backward not)."""
    for what, x, w, dz, wdt, verdict in route_cases("cpu"):
        gw = torch.zeros(w.shape)
        dx = torch.zeros(x.shape)
        assert takes_fwd(x, w, wdt) == (verdict is not False), what
        assert takes_bwd(dz, x, w, gw, dx, wdt, wdt) == bool(verdict), what
    x, w, _, dz = (torch.zeros(s) for s in ((3, 32, 3136), (3, 128, 3136),
                                            (1,), (3, 32, 128)))
    gw, dx = torch.zeros(w.shape), torch.zeros(x.shape)
    assert not takes_bwd(dz, x, w, gw, dx, torch.float32, torch.bfloat16)
    assert not takes_bwd(dz, x, w, gw, dx.to(torch.bfloat16), torch.float32,
                         torch.float32)


# ------------------------------------------------- the port step, emulated

def test_step_grads_with_emulated_fc1_match_folded_jax_grads(case,
                                                             monkeypatch):
    """One port step (``fused_kernel.step_forward`` and ``step_backward``,
    f32) with fc1's forward and backward emulated as the 3xTF32 kernels
    compute them (fc2 on the plain versions, as the route sends it to the
    CUDA-core kernels): the
    loss and every layer's gradient (fc1's dW and db, and through dh3
    conv2's and the stem's) against the JAX side's folded gradients of the
    same step, at ``test_step_grads_match_folded_jax_grads``'s tolerance
    (rtol 1e-4, atol 1e-5: the two packages sum in other orders)."""
    from multimodal_fl_security_tpu_torch.models.from_jax import (
        params_from_jax,
    )

    emulated = []

    def fwd(x, w, b, *, relu=False, wdtype=torch.float32,
            out_dtype=torch.float32):
        if not takes_fwd(x, w, wdtype):
            return dense_fwd_plain(x, w, b, relu=relu, wdtype=wdtype,
                                   out_dtype=out_dtype)
        emulated.append("fwd")
        return torch.from_numpy(fwd_3xtf32(x.numpy(), w.numpy(), b.numpy(),
                                           relu=relu))

    def bwd(dz, x, w, gw, gb, *, mask=None, wdtype=torch.float32,
            gdtype=torch.float32, dx_dtype=torch.float32):
        dx = torch.empty(x.shape, dtype=dx_dtype)
        if not takes_bwd(dz, x, w, gw, dx, wdtype, gdtype):
            return dense_bwd_plain(dz, x, w, gw, gb, mask=mask, wdtype=wdtype,
                                   gdtype=gdtype, dx_dtype=dx_dtype)
        emulated.append("bwd")
        got = bwd_3xtf32(dz.numpy(), x.numpy(), w.numpy(),
                         None if mask is None else mask.numpy())
        gw.copy_(torch.from_numpy(got[0]))
        gb.copy_(torch.from_numpy(got[1]))
        return dx.copy_(torch.from_numpy(got[2]))

    monkeypatch.setattr(fused_kernel, "dense_fwd", fwd)
    monkeypatch.setattr(fused_kernel, "dense_bwd", bwd)
    assert min_window_gap(case) > 2e-6  # the comparison's premise
    model = case["model"]
    layout = model.layout(CIN)
    steps = [jax_step(case, c) for c in range(C)]
    want = params_from_jax(model, stack_trees([s[1] for s in steps]),
                           device="cpu")
    grad = torch.full_like(case["params"], float("nan"))
    views = layout.views(case["params"])
    loss, tape = fused_kernel.step_forward(
        views, nchw(case["images"]), torch.from_numpy(case["labels"]).long(),
        torch.from_numpy(case["mask"]), torch.float32)
    fused_kernel.step_backward(views, layout.views(grad), tape, torch.float32)
    assert emulated == ["fwd", "bwd"]  # fc1 only, once each
    np.testing.assert_allclose(loss.numpy(), [s[0] for s in steps],
                               rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(grad).all())  # every element written
    got_v, want_v = layout.views(grad), layout.views(want)
    for name in got_v:
        np.testing.assert_allclose(got_v[name].numpy(), want_v[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------- CUDA

def close_f64(got, ref):
    """rtol 1e-5, atol 1e-5 of max|ref| against the f64 result."""
    torch.testing.assert_close(got.double(), ref, rtol=RTOL,
                               atol=RTOL * float(ref.abs().max()))


def held(what, got, plain, ref):
    """got within the f64 tolerance of ref, its error there at most 4x the
    f32 plain version's; prints both."""
    close_f64(got, ref)
    err, err_plain = (float((v.double() - ref).abs().max())
                      for v in (got, plain))
    print(f"[{what}] vs f64: kernel {err:.3g}, plain {err_plain:.3g}; "
          f"max|kernel-plain| {float((got - plain).abs().max()):.3g}")
    assert err <= F64_FACTOR * err_plain, (what, err, err_plain)


#: (C, rows, K, F, flat): fc1's full shape, the ragged shape, and fc1 with W,
#: dW and db views of flat [C, D] buffers
CUDA_CASES = [(100, 32, 3136, 128, False), (3, 7, 200, 64, False),
              (100, 32, 3136, 128, True)]


def cuda_operands(gen, c, rows, k, f, flat, ints=False):
    """x, w, b, dz on the card and a maker of (gw, gb) gradient views."""
    if ints:
        x = torch.randint(0, 4, (c, rows, k), generator=gen,
                          device="cuda").float()
        w = torch.randint(-2, 3, (c, f, k), generator=gen,
                          device="cuda").float()
        b = torch.randint(-2, 3, (c, f), generator=gen, device="cuda").float()
        dz = torch.randint(-3, 4, (c, rows, f), generator=gen,
                           device="cuda").float()
    else:
        x = torch.relu(torch.randn((c, rows, k), generator=gen,
                                   device="cuda"))
        w = torch.randn((c, f, k), generator=gen, device="cuda") / k ** 0.5
        b = torch.randn((c, f), generator=gen, device="cuda")
        dz = 0.1 * torch.randn((c, rows, f), generator=gen, device="cuda")

    def grads():
        return torch.full_like(w, float("nan")), torch.full_like(b, 0.5)

    if flat:
        w, b, grads = flat_views(w, b)
    return x, w, b, dz, grads


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows,k,f,flat", CUDA_CASES)
def test_dense_fwd_tf32_matches_f64(cuda, c, rows, k, f, flat):
    """An f32 forward at fc1's geometry runs dense_fwd_tf32 once: within the
    f32 tolerance of f64, its error at most 4x the plain version's, two
    calls bitwise equal, bitwise the plain version on small integers."""
    x, w, b, _, _ = cuda_operands(cuda, c, rows, k, f, flat)
    y, launches = counted(lambda: dense_fwd(x, w, b, relu=True))
    again = dense_fwd(x, w, b, relu=True)
    plain = dense_fwd_plain(x, w, b, relu=True)
    ref = torch.relu(torch.baddbmm(b.double().unsqueeze(1), x.double(),
                                   w.double().transpose(1, 2)))
    xi, wi, bi, _, _ = cuda_operands(cuda, c, rows, k, f, flat, ints=True)
    yi = dense_fwd(xi, wi, bi, relu=True)
    yi_want = dense_fwd_plain(xi, wi, bi, relu=True)
    torch.cuda.synchronize()
    assert launches == {"dense_fwd_tf32": 1}
    assert y.shape == (c, rows, f) and y.dtype == torch.float32
    assert torch.equal(y, again)
    held(f"dense_fwd_tf32 C={c} rows={rows} K={k} F={f} flat {flat}", y,
         plain, ref)
    assert float(yi_want.abs().max()) > 20  # sums large enough to test
    assert torch.equal(yi, yi_want)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c,rows,k,f,flat", CUDA_CASES)
def test_dense_bwd_tf32_matches_f64(cuda, c, rows, k, f, flat, masked):
    """An f32 backward at fc1's geometry runs dense_bwd_tf32 once: dW, db
    and dx within the f32 tolerance of f64, each error at most 4x the plain
    version's, two calls bitwise equal, the relu mask honoured (``masked``:
    dx zero wherever x is), bitwise the plain version on small integers."""
    x, w, _, dz, grads = cuda_operands(cuda, c, rows, k, f, flat)
    mask = x if masked else None
    outs = []
    for fn in (dense_bwd, dense_bwd, dense_bwd_plain):
        gw, gb = grads()
        dx, launches = counted(
            lambda: fn(dz, x, w, gw, gb, mask=mask))  # noqa: B023
        outs.append(((gw, gb, dx), launches))
    dx64 = torch.bmm(dz.double(), w.double())
    refs = (torch.bmm(dz.double().transpose(1, 2), x.double()),
            dz.double().sum(dim=1),
            torch.where(x > 0, dx64, 0.0) if masked else dx64)
    xi, wi, _, dzi, grads_i = cuda_operands(cuda, c, rows, k, f, flat,
                                            ints=True)
    got_i, want_i = grads_i(), grads_i()
    got_i = (*got_i, dense_bwd(dzi, xi, wi, *got_i, mask=xi))
    want_i = (*want_i, dense_bwd_plain(dzi, xi, wi, *want_i, mask=xi))
    torch.cuda.synchronize()
    (got, launches), (again, _), (plain, _) = outs
    assert launches == {"dense_bwd_tf32": 1}
    for name, g, a, p, ref in zip(("dW", "db", "dx"), got, again, plain,
                                  refs):
        assert torch.equal(g, a), name  # fixed-order sums
        held(f"dense_bwd_tf32 {name} C={c} rows={rows} K={k} F={f} flat "
             f"{flat} masked {masked}", g, p, ref)
    if masked:
        assert not bool(got[2][x <= 0].any())
    assert float(want_i[0].abs().max()) > 20  # sums large enough to test
    for g, want in zip(got_i, want_i):
        assert torch.equal(g, want)


@pytest.mark.cuda
def test_route_mirror_is_the_c_rule(cuda):
    """The Python mirror of the route (``takes_fwd``, ``takes_bwd``) gives
    the C entries' verdicts, and each verdict picks the kernel launched."""
    lib = _library()
    for what, x, w, dz, wdt, verdict in route_cases("cuda"):
        gw = torch.zeros(w.shape, device="cuda")
        dx = torch.zeros(x.shape, device="cuda")
        vx, vw, vdz, vgw, vdx = (view(t, _MAT_AXES) for t in (x, w, dz, gw,
                                                                dx))
        c, rows, k = x.shape
        f = w.shape[1]
        code = DTYPE_CODES[wdt]
        takes = bool(lib.mft_dense_fwd_tf32_takes(vx, vw, c, rows, k, f,
                                                  code))
        assert takes == takes_fwd(x, w, wdt), what
        takes_b = bool(lib.mft_dense_bwd_tf32_takes(vdz, vx, vw, vgw, vdx,
                                                    c, rows, k, f, code,
                                                    code))
        assert takes_b == takes_bwd(dz, x, w, gw, dx, wdt, wdt), what
        if wdt == torch.float32:
            b = torch.zeros(w.shape[:2], device="cuda")
            _, launches = counted(lambda: dense_fwd(x, w, b))  # noqa: B023
            assert launches == {
                "dense_fwd_tf32" if takes else "dense_fwd": 1}, what
            _, launches = counted(
                lambda: dense_bwd(dz, x, w, gw, b))  # noqa: B023
            assert launches == {
                "dense_bwd_tf32" if takes_b else "dense_bwd": 1}, what
    torch.cuda.synchronize()
