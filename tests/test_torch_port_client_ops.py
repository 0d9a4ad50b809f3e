"""The local-training ops of the port against the JAX package's quantities.

Each op's plain version (the CPU path of its wrapper) is held, in f32, to
what it stands for in the JAX package: K3 (``client_stem_conv``, interpret
mode and its reference), the stem and conv2 forward of the JAX SimpleCNN on
the s2d path (the values ``fused_train.forward_impl`` computes, shown equal
by ``tests/test_fused_train.py``), one step's per-layer gradients against
``fold_grads`` of ``jax.grad`` of ``packed_ce``, the loss against
``packed_ce``, and the clip / momentum / update against
``packed_sgd_step``. Tolerances: rtol 1e-4 and atol 1e-5 for values summed
in another order, 1e-6 for the loss and the optimizer's elementwise step.
In bf16, the plain forward chain the tensor-core kernels are held to
against ``forward_impl``'s bf16 mirror, within the roundings JAX adds (see
``test_bf16_forward_oracle_matches_jax_mirror``).

The ``cuda`` cases hold each hand-written kernel to its plain version on the
card, at small ragged shapes and at the main path's shapes, on planted ties,
and for two calls being bitwise equal; they skip without a card. JAX is
imported inside the JAX-side helpers, so they run where JAX is missing.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.models import create_model
from multimodal_fl_security_tpu_torch.models.from_jax import params_from_jax
from multimodal_fl_security_tpu_torch.ops._launch import KERNEL_LAUNCHES
from multimodal_fl_security_tpu_torch.ops.client_conv import (
    _dense_dz,
    _grouped,
    client_stem_conv,
    client_stem_conv_plain,
    conv_dgrad,
    conv_dgrad_plain,
    conv_fwd,
    conv_fwd_plain,
    conv_wgrad,
    conv_wgrad_plain,
    embed_stem,
)
from multimodal_fl_security_tpu_torch.ops.client_dense import (
    dense_bwd,
    dense_bwd_plain,
    dense_fwd,
    dense_fwd_plain,
)
from multimodal_fl_security_tpu_torch.ops.client_sgd import (
    client_ce,
    client_ce_plain,
    client_sgd_update,
    client_sgd_update_plain,
    client_sq_norm,
    client_sq_norm_plain,
    clip_scale,
    kernel_clip_scale,
    sgd_update_bounds,
    ulp,
)
from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
    step_backward,
    step_forward,
)

C, B, CIN = 2, 32, 8


def jax_side():
    import jax
    import jax.numpy as jnp

    from multimodal_fl_security_tpu.models.simple_cnn import SimpleCNN
    from multimodal_fl_security_tpu.ops import fused_train as ft
    from multimodal_fl_security_tpu.ops.s2d import space_to_depth

    return jax, jnp, SimpleCNN, ft, space_to_depth


def nchw(x):
    """NHWC numpy images (any leading axes) as an NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


@pytest.fixture(scope="module")
def case():
    jax, jnp, SimpleCNN, ft, space_to_depth = jax_side()
    # A seed whose pooling windows hold no near tie (see min_window_gap).
    rng = np.random.RandomState(2)
    images = rng.normal(size=(C, B, 28, 28, CIN)).astype(np.float32)
    labels = rng.randint(0, 10, size=(C, B)).astype(np.int32)
    mask = np.ones((C, B), np.float32)
    mask[1, -3:] = 0.0  # padded rows
    jmodel = SimpleCNN(num_classes=10, dtype=jnp.float32)
    blocks = np.asarray(space_to_depth(images))
    base = jmodel.init(jax.random.PRNGKey(0),
                       {"image_s2d": jnp.asarray(blocks[0])})["params"]
    # Distinct parameters per client.
    stacked = jax.tree_util.tree_map(
        lambda p: np.asarray(p)[None]
        + 0.05 * rng.normal(size=(C,) + p.shape).astype(np.float32), base)
    model = create_model("simple_cnn", num_classes=10)
    return dict(images=images, labels=labels, mask=mask, blocks=blocks,
                jmodel=jmodel, stacked=stacked, model=model,
                params=params_from_jax(model, stacked, device="cpu"))


def client_tree(stacked, c):
    import jax

    return jax.tree_util.tree_map(lambda a: a[c], stacked)


def stack_trees(trees):
    import jax

    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


# ---------------------------------------------------------------- K3

def test_client_stem_conv_matches_k3():
    jax, jnp, *_ = jax_side()
    from multimodal_fl_security_tpu.ops.client_conv import (
        client_stem_conv as jax_stem,
    )
    from multimodal_fl_security_tpu.ops.client_conv import (
        client_stem_conv_reference,
    )

    rng = np.random.RandomState(1)
    c, b = 3, 4
    x = rng.normal(size=(c, b, 28 * 28 * 8)).astype(np.float32)
    w4 = (0.1 * rng.normal(size=(c, 4, 4, 8, 128))).astype(np.float32)
    before = conv_fwd.launches
    got = client_stem_conv(torch.from_numpy(x), torch.from_numpy(w4))
    assert conv_fwd.launches == before  # the plain version on the CPU
    assert got.shape == (c, b, 14, 14, 128) and got.is_contiguous()
    for want in (jax_stem(jnp.asarray(x), jnp.asarray(w4), interpret=True),
                 client_stem_conv_reference(jnp.asarray(x), jnp.asarray(w4))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_client_stem_conv_bf16_matches_k3():
    """bf16 in, bf16 out: the JAX kernel sums each output in f32 on the MXU
    (interpret mode here) and rounds it once; the port's plain version (the
    CPU path of the kernel ``stem_raw_tc`` is held to on the card) sums the
    same products in f32 in another order and rounds once. So each output
    agrees within one bf16 rounding, 2^-7 of its value, and almost all are
    equal."""
    jax, jnp, *_ = jax_side()
    from multimodal_fl_security_tpu.ops.client_conv import (
        client_stem_conv as jax_stem,
    )

    rng = np.random.RandomState(3)
    c, b = 3, 4
    x = rng.normal(size=(c, b, 28 * 28 * 8)).astype(np.float32)
    w4 = (0.1 * rng.normal(size=(c, 4, 4, 8, 128))).astype(np.float32)
    got = client_stem_conv(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(w4).to(torch.bfloat16))
    want = np.asarray(jax_stem(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w4, jnp.bfloat16),
                               interpret=True)).astype(np.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (c, b, 14, 14, 128)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0.0)
    assert float(np.mean(got != want)) < 1e-3


def test_pooled_stem_is_k3_on_the_embedded_kernel(case):
    """The stem's epilogue form equals K3's raw conv on w4, then the max
    over w4's four channel groups, the bias and the relu (ConvPoolFused)."""
    views = case["model"].layout(CIN).views(case["params"])
    w, b = views["conv1.weight"], views["conv1.bias"]
    x = nchw(case["images"])
    pooled, arg = conv_fwd(x, w, b, channels_last=True)
    raw = client_stem_conv(
        torch.from_numpy(case["images"]).reshape(C, B, -1), embed_stem(w))
    want = torch.relu(raw.view(C, B, 14, 14, 4, 32).amax(dim=4)
                      + b[:, None, None, None, :])
    np.testing.assert_allclose(pooled.permute(0, 1, 3, 4, 2).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)
    assert arg.dtype == torch.uint8 and int(arg.max()) <= 3


# ---------------------------------------------------------------- forward

def test_stem_and_conv2_forward_match_jax(case):
    jax, jnp, *_ = jax_side()
    jmodel = case["jmodel"]
    h1_want, h3_want = [], []
    for c in range(C):
        _, state = jmodel.apply(
            {"params": client_tree(case["stacked"], c)},
            {"image_s2d": jnp.asarray(case["blocks"][c])},
            capture_intermediates=True, mutable=["intermediates"])
        inter = state["intermediates"]
        h1_want.append(np.asarray(inter["ConvPoolFused_0"]["__call__"][0]))
        z2 = np.maximum(np.asarray(inter["Conv_0"]["__call__"][0]), 0.0)
        h3_want.append(z2.reshape(B, 7, 2, 7, 2, 64).max(axis=(2, 4)))
    views = case["model"].layout(CIN).views(case["params"])
    h1, _ = conv_fwd(nchw(case["images"]), views["conv1.weight"],
                     views["conv1.bias"], channels_last=True)
    h3, _ = conv_fwd(h1, views["conv2.weight"], views["conv2.bias"])
    assert h1.shape == (C, B, 32, 14, 14) and h3.shape == (C, B, 64, 7, 7)
    assert h3.is_contiguous()  # fc1 reads its (c, h, w) flatten in place
    np.testing.assert_allclose(h1.permute(0, 1, 3, 4, 2).numpy(),
                               np.stack(h1_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h3.permute(0, 1, 3, 4, 2).numpy(),
                               np.stack(h3_want), rtol=1e-4, atol=1e-5)


def packed_map(a, groups, ch, hw):
    """A packed [B, rows, groups * ch] map of fused_train.py's layout (row
    = (i, jq), lane = (g, ch), column j = jq * groups + g: groups 4 for the
    14x14 maps, 2 for the pooled map) as numpy [B, ch, hw, hw] f32."""
    a = np.asarray(a.astype(np.float32)).reshape(a.shape[0], -1, 4, groups,
                                                 ch)
    a = a.reshape(a.shape[0], a.shape[1], 4 * groups, ch)[:, :hw, :hw]
    return a.transpose(0, 3, 1, 2)


def window_gap(z):
    """[..., 4] window values -> the gap between the two largest."""
    top = np.sort(z, axis=-1)
    return top[..., 3] - top[..., 2]


def test_bf16_forward_oracle_matches_jax_mirror(case):
    """The plain bf16 chain the kernels are held to (the stem and conv2
    through ``conv_fwd_plain``, fc1 and fc2 through ``dense_fwd_plain``:
    ``step_forward`` on the CPU) against the JAX package's
    ``forward_impl`` in bf16 (``mirror_forward``'s, captured through its
    dot callables). JAX rounds each tap partial and each running sum to
    bf16 (the stem's 4 taps per group, conv2's 9, fc1's 28 row partials;
    ``fused_train.py:384-394, 409-410``); the port rounds once from f32 sums.
    Measured on this seed: the pooled maps differ by at most 2 bf16 ulps
    (0.0625 at values up to 7.6), the logits by 0.077 at values up to 9.8.
    Tolerance: 2e-2 of each map's largest value, compared where JAX's window
    gap exceeds it (elsewhere the two may pick another position of a near
    tie; their values then still agree), and 3e-2 of the largest logit."""
    jax, jnp, _, ft, _ = jax_side()
    bf16 = torch.bfloat16
    views = case["model"].layout(CIN).views(case["params"])
    h1, _ = conv_fwd(nchw(case["images"]), views["conv1.weight"],
                     views["conv1.bias"], dtype=bf16, channels_last=True)
    h3, _ = conv_fwd(h1, views["conv2.weight"], views["conv2.bias"],
                     dtype=bf16)
    h4 = dense_fwd(h3.view(C, B, -1), views["fc1.weight"], views["fc1.bias"],
                   relu=True, wdtype=bf16, out_dtype=bf16)
    logits = dense_fwd(h4, views["fc2.weight"], views["fc2.bias"])
    assert logits.dtype == torch.float32 and logits.shape == (C, B, 10)
    for c in range(C):
        pk = ft.pack_params(client_tree(case["stacked"], c))
        xblk = ft.pack_blocks(jnp.asarray(case["blocks"][c]))
        dots, pooled = [], []

        def dot3d(a, w):
            dots.append((a, ft._dot3d(a, w)))
            return dots[-1][1]

        def bdot(a, w):
            pooled.append(jnp.swapaxes(a, 0, 1))  # h3 [B, 28, 128]
            return ft._bdot(a, w)

        want = ft.forward_impl(pk, xblk, compute_dtype=jnp.bfloat16,
                               dot3d=dot3d, bdot=bdot)
        assert bool(jnp.array_equal(
            want, ft.mirror_forward(pk, xblk, compute_dtype=jnp.bfloat16)))
        # The stem's four groups (4 taps each) and conv2's 9 taps, summed in
        # bf16 in forward_impl's order; conv2's tap 4 reads h1 unshifted.
        zs = []
        for g in range(4):
            acc = dots[4 * g][1]
            for t in range(1, 4):
                acc = acc + dots[4 * g + t][1]
            zs.append(packed_map(acc, 4, 32, 14))
        z2 = jnp.zeros(dots[16][1].shape, jnp.bfloat16)
        for _, out in dots[16:25]:
            z2 = z2 + out
        z2 = packed_map(z2, 4, 64, 14)
        gaps = {
            "h1": window_gap(np.stack(zs, axis=-1)),
            "h3": window_gap(z2.reshape(B, 64, 7, 2, 7, 2).transpose(
                0, 1, 2, 4, 3, 5).reshape(B, 64, 7, 7, 4)),
        }
        maps = {"h1": (h1[c], packed_map(dots[20][0], 4, 32, 14)),
                "h3": (h3[c], packed_map(pooled[0], 2, 64, 7))}
        for name, (got, jmap) in maps.items():
            tol = 2e-2 * float(np.abs(jmap).max())
            live = gaps[name] > tol
            assert live.mean() > 0.8, name  # most windows are compared
            np.testing.assert_allclose(got.float().numpy()[live], jmap[live],
                                       rtol=0, atol=tol, err_msg=name)
        jl = np.asarray(want)[:, :10]
        np.testing.assert_allclose(logits[c].numpy(), jl, rtol=0,
                                   atol=3e-2 * float(np.abs(jl).max()))


# ---------------------------------------------------------------- gradients

def jax_step(case, c, compute_dtype=None):
    """(loss, folded logical gradients) of client c's packed loss, with the
    mirror's compute dtype (f32 unless given)."""
    jax, jnp, _, ft, _ = jax_side()
    p = client_tree(case["stacked"], c)
    xblk = ft.pack_blocks(jnp.asarray(case["blocks"][c]))
    onehot = jax.nn.one_hot(case["labels"][c], 128)
    bmask = jnp.asarray(case["mask"][c])
    cd = jnp.float32 if compute_dtype is None else compute_dtype

    def loss(pk):
        return ft.packed_ce(ft.mirror_forward(pk, xblk, compute_dtype=cd),
                            onehot, bmask)

    pk = ft.pack_params(p)
    value, g = jax.value_and_grad(loss)(pk)
    return float(value), ft.fold_grads(g, p), g


def min_window_gap(case) -> float:
    """The least gap between the two largest conv outputs of a pooling
    window whose max passes the relu, over both layers and clients. The two
    packages sum the convolutions in other orders (~1e-6 apart here), so a
    smaller gap could route a window's gradient to another position."""
    import torch.nn.functional as F

    views = case["model"].layout(CIN).views(case["params"])
    x = nchw(case["images"])
    h1, _ = conv_fwd(x, views["conv1.weight"], views["conv1.bias"])
    gaps = []
    for inp, layer in ((x, "conv1"), (h1, "conv2")):
        for c in range(C):
            z = F.conv2d(inp[c], views[layer + ".weight"][c], padding=1)
            b, co, h, w = z.shape
            win = z.view(b, co, h // 2, 2, w // 2, 2).permute(
                0, 1, 2, 4, 3, 5).reshape(b, co, h // 2, w // 2, 4)
            top = win.topk(2, dim=-1).values
            live = top[..., 0] + views[layer + ".bias"][c][:, None, None] > 0
            gaps.append(float((top[..., 0] - top[..., 1])[live].min()))
    return min(gaps)


def test_step_grads_match_folded_jax_grads(case):
    assert min_window_gap(case) > 2e-6  # the comparison's premise
    model = case["model"]
    layout = model.layout(CIN)
    steps = [jax_step(case, c) for c in range(C)]
    want = params_from_jax(model, stack_trees([s[1] for s in steps]),
                           device="cpu")
    grad = torch.full_like(case["params"], float("nan"))
    views = layout.views(case["params"])
    loss, tape = step_forward(views, nchw(case["images"]),
                              torch.from_numpy(case["labels"]).long(),
                              torch.from_numpy(case["mask"]), torch.float32)
    step_backward(views, layout.views(grad), tape, torch.float32)
    np.testing.assert_allclose(loss.numpy(), [s[0] for s in steps],
                               rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(grad).all())  # every element written
    got_v, want_v = layout.views(grad), layout.views(want)
    for name in got_v:
        np.testing.assert_allclose(got_v[name].numpy(), want_v[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_fc1_backward_oracle_matches_jax_grad(case):
    """The plain bf16 fc1 backward the tensor-core kernel ``dense_bwd_tc``
    is held to (``dense_bwd_plain`` with wdtype, gdtype and dx in bf16:
    ``step_backward``'s on the CPU) against the JAX package's bf16 gradient of
    ``mirror_forward`` (``jax.grad`` of ``packed_ce``, folded). Both sides
    get the same operands: JAX's pooled map and the cotangent of fc1's
    product, read through ``forward_impl``'s ``bdot`` (zero taps whose
    gradients are dz and dx; the loss is ``mirror_forward``'s bitwise), and
    fc1's weights. Measured on this seed: dW and dx bitwise equal (both
    round once from f32 sums), db up to 0.0039 apart at values up to 0.31:
    JAX sums the 32 rows in bf16 (``fused_train.py:410``'s VJP), the port
    rounds once. Tolerance: one bf16 rounding (2^-8 of each value) for dW
    and dx; for db the bf16 running sum's error bound, 32 roundings of half
    an ulp of at most max sum|dz|."""
    jax, jnp, _, ft, _ = jax_side()
    bf16, jbf16 = torch.bfloat16, jnp.bfloat16
    layout = case["model"].layout(CIN)
    folded, xs, dzs, dxs = [], [], [], []
    for c in range(C):
        p = client_tree(case["stacked"], c)
        pk = ft.pack_params(p)
        xblk = ft.pack_blocks(jnp.asarray(case["blocks"][c]))
        onehot = jax.nn.one_hot(case["labels"][c], 128)
        bmask = jnp.asarray(case["mask"][c])
        taken = []

        def loss(pk, e_in, e_out, taken=taken):
            def bdot(a, w):  # fc1's product; the zero taps read its VJP
                taken.append(a)
                return ft._bdot(a + e_in, w) + e_out
            return ft.packed_ce(ft.forward_impl(
                pk, xblk, compute_dtype=jbf16, bdot=bdot), onehot, bmask)

        zero = jnp.zeros((28, B, 128), jbf16)
        assert float(loss(pk, zero, zero)) == float(ft.packed_ce(
            ft.mirror_forward(pk, xblk, compute_dtype=jbf16), onehot, bmask))
        h3 = taken[0]  # [28, B, 128], bf16
        g, d_in, d_out = jax.grad(loss, argnums=(0, 1, 2))(pk, zero, zero)
        assert bool(jnp.all(d_out == d_out[0]))  # part.sum(-3)'s VJP
        folded.append(ft.fold_grads(g, p))
        xs.append(packed_map(jnp.swapaxes(h3, 0, 1), 2, 64, 7).reshape(B, -1))
        dzs.append(np.asarray(d_out[0].astype(jnp.float32)))
        dxs.append(packed_map(jnp.swapaxes(d_in, 0, 1), 2, 64, 7)
                   .reshape(B, -1))
    want = layout.views(params_from_jax(case["model"], stack_trees(folded),
                                        device="cpu"))
    w = layout.views(case["params"])["fc1.weight"]
    gw, gb = torch.empty_like(w), torch.empty((C, 128))
    dx = dense_bwd_plain(torch.from_numpy(np.stack(dzs)).to(bf16),
                         torch.from_numpy(np.stack(xs)).to(bf16), w, gw, gb,
                         wdtype=bf16, gdtype=bf16, dx_dtype=bf16)
    assert dx.dtype == bf16
    ulp = 2.0 ** -8  # one bf16 rounding, relative
    for got, ref in ((gw, want["fc1.weight"]),
                     (dx.float(), torch.from_numpy(np.stack(dxs)))):
        assert float(ref.abs().max()) > 0
        assert bool(((got - ref).abs() <= ulp * ref.abs()).all())
    sum_dz = torch.from_numpy(np.stack(dzs)).abs().sum(dim=1)  # [C, 128]
    torch.testing.assert_close(gb, want["fc1.bias"], rtol=0,
                               atol=ulp / 2 * B * float(sum_dz.max()))


@pytest.mark.parametrize("clip_norm", [0.01, 100.0, 0.0])
def test_sgd_update_matches_packed_sgd_step(case, clip_norm):
    jax, jnp, _, ft, _ = jax_side()
    model = case["model"]
    rng = np.random.RandomState(2)
    new_p, new_m, grads, moms = [], [], [], []
    for c in range(C):
        p = client_tree(case["stacked"], c)
        _, g_logical, g_packed = jax_step(case, c)
        mom = jax.tree_util.tree_map(
            lambda a: 0.01 * rng.normal(size=a.shape).astype(np.float32), p)
        pk, m = ft.packed_sgd_step(ft.pack_params(p), g_packed, mom, p,
                                   lr=0.05, momentum=0.9,
                                   clip_norm=clip_norm)
        new_p.append(ft.unpack_params(pk, p))
        new_m.append(m)
        grads.append(g_logical)
        moms.append(mom)
    params = case["params"].clone()
    mom = params_from_jax(model, stack_trees(moms), device="cpu")
    grad = params_from_jax(model, stack_trees(grads), device="cpu")
    client_sgd_update(params, mom, grad, client_sq_norm(grad), lr=0.05,
                      momentum=0.9, clip_norm=clip_norm)
    np.testing.assert_allclose(
        params.numpy(),
        params_from_jax(model, stack_trees(new_p), device="cpu").numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        mom.numpy(),
        params_from_jax(model, stack_trees(new_m), device="cpu").numpy(),
        rtol=1e-6, atol=1e-6)


def test_client_ce_matches_packed_ce():
    jax, jnp, _, ft, _ = jax_side()
    rng = np.random.RandomState(3)
    logits = rng.normal(size=(3, B, 10)).astype(np.float32)
    labels = rng.randint(0, 10, size=(3, B))
    mask = np.ones((3, B), np.float32)
    mask[1, 5:] = 0.0
    mask[2] = 0.0  # a client with no real row: loss and gradient 0
    loss, dlogits = client_ce(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask))
    for c in range(3):
        junk = rng.normal(size=(B, 118)).astype(np.float32)  # lanes >= 10

        def f(lg, c=c):
            full = jnp.concatenate([lg, jnp.asarray(junk)], axis=1)
            return ft.packed_ce(full, jax.nn.one_hot(labels[c], 128),
                                jnp.asarray(mask[c]))

        value, grad = jax.value_and_grad(f)(jnp.asarray(logits[c]))
        assert float(loss[c]) == pytest.approx(float(value), abs=1e-6)
        np.testing.assert_allclose(dlogits[c].numpy(), np.asarray(grad),
                                   rtol=1e-6, atol=1e-7)
    assert float(loss[2]) == 0.0 and not bool(dlogits[2].any())


# ---------------------------------------------------------------- CUDA

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def close(got, want, dtype, scale=1.0):
    """f32: the same sums in another order; bf16: one rounding apart."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


def conv_case(gen, layer, c, b, cin=1):
    """x, w, b of the stem ([C, B, cin, 28, 28]) or conv2 ([C, B, 32, 14,
    14], NHWC like the stem's output)."""
    if layer == "stem":
        x = torch.randn((c, b, cin, 28, 28), generator=gen, device="cuda")
        cout = 32
    else:
        cin, cout = 32, 64
        x = torch.relu(torch.randn((c, b, 14, 14, 32), generator=gen,
                                   device="cuda")).permute(0, 1, 4, 2, 3)
    w = 0.3 * torch.randn((c, cout, cin, 3, 3), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((c, cout), generator=gen, device="cuda")
    return x, w, bias


def wgrad_f64(x, dp, h, arg, shape):
    """The exact weight gradient of a 3x3 SAME stride-1 conv: (dW of
    ``shape``, db [C, C_out]) of ``conv_wgrad``'s operands, summed in f64
    (``conv2d_weight`` and dz's sum)."""
    c = x.shape[0]
    dz = _dense_dz(dp, h, arg, *x.shape[-2:]).double()
    gw = torch.nn.grad.conv2d_weight(
        _grouped(x.float()).double(), (c * shape[1], *shape[2:]),
        _grouped(dz), padding=1, groups=c)
    return gw.view(shape), dz.sum(dim=(1, 3, 4))


SHAPES = [("stem", 3, 5, 1), ("stem", 3, 5, 8), ("conv2", 3, 5, 32),
          ("stem", 100, 32, 1), ("conv2", 100, 32, 32)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("layer,c,b,cin", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_fwd_kernel_matches_plain(cuda, layer, c, b, cin, dtype):
    x, w, bias = conv_case(cuda, layer, c, b, cin)
    before = conv_fwd.launches
    out, arg = conv_fwd(x.to(dtype) if layer == "conv2" else x, w, bias,
                        dtype=dtype, channels_last=layer == "stem")
    again, arg2 = conv_fwd(x.to(dtype) if layer == "conv2" else x, w, bias,
                           dtype=dtype, channels_last=layer == "stem")
    assert conv_fwd.launches == before + 2
    want, warg = conv_fwd_plain(x.to(dtype) if layer == "conv2" else x, w,
                                bias, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(arg, arg2)
    close(out, want, dtype)
    # Argmax differs only where two window positions (nearly) tie.
    assert float((arg == warg).float().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["stem", "conv2"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_fwd_kernel_planted_ties(cuda, layer, dtype):
    """Integer operands make every sum exact: interior windows tie in all
    four positions, and both versions take the first, (0, 0). bf16 runs the
    tensor-core kernels; the plain version runs without cuDNN, whose
    forward is not exact on integers."""
    x, w, bias = conv_case(cuda, layer, 3, 4, 1)
    x = torch.ones_like(x)
    w = torch.randint(-2, 3, w.shape, generator=cuda, device="cuda").float()
    bias = torch.zeros_like(bias).add_(100.0)  # keep the relu open
    out, arg = conv_fwd(x, w, bias, dtype=dtype)
    with torch.backends.cudnn.flags(enabled=False):
        want, warg = conv_fwd_plain(x, w, bias, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(arg, warg)
    assert not bool(arg[..., 1:-1, 1:-1].any())


def pooled_case(gen, layer, c, b, cin, dtype):
    x, w, bias = conv_case(gen, layer, c, b, cin)
    x = x.to(dtype) if layer == "conv2" else x
    h, arg = conv_fwd_plain(x, w, bias, dtype=dtype)
    dp = (0.1 * torch.randn(h.shape, generator=gen, device="cuda")).to(dtype)
    return x, w, bias, h, arg, dp


@pytest.mark.cuda
@pytest.mark.parametrize("layer,c,b,cin", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_wgrad_kernel_matches_plain(cuda, layer, c, b, cin, dtype):
    """The f32 gradients run conv2_wgrad_tf32 and stem_wgrad_tf32, whose
    3xTF32 sums in a fixed order keep f32's accuracy; the plain version's
    f32 sums over 32 x 196 positions need not (at C=100, B=32 conv2's are
    off the exact ones by more than the tolerance), so both kernels are
    held to the exact (f64) gradient at the same tolerance."""
    x, w, bias, h, arg, dp = pooled_case(cuda, layer, c, b, cin, dtype)
    grads = [torch.full_like(w, float("nan")), torch.full_like(bias, 0.5)]
    again = [torch.empty_like(w), torch.empty_like(bias)]
    want = [torch.empty_like(w), torch.empty_like(bias)]
    before = conv_wgrad.launches
    conv_wgrad(x, dp, h, arg, *grads, dtype=dtype)
    conv_wgrad(x, dp, h, arg, *again, dtype=dtype)
    assert conv_wgrad.launches == before + 2
    if dtype == torch.float32:
        want = wgrad_f64(x, dp, h, arg, w.shape)
    else:
        conv_wgrad_plain(x, dp, h, arg, *want, dtype=dtype)
    torch.cuda.synchronize()
    for got, rep, ref in zip(grads, again, want):
        assert torch.equal(got, rep)  # fixed-order sums
        close(got, ref, dtype, scale=float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,b", [(3, 5), (100, 32)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_dgrad_kernel_matches_plain(cuda, c, b, dtype):
    _, w, _, h, arg, dp = pooled_case(cuda, "conv2", c, b, 32, dtype)
    before = conv_dgrad.launches
    got = conv_dgrad(dp, h, arg, w, (14, 14), dtype=dtype,
                     channels_last=True)
    again = conv_dgrad(dp, h, arg, w, (14, 14), dtype=dtype,
                       channels_last=True)
    assert conv_dgrad.launches == before + 2
    want = conv_dgrad_plain(dp, h, arg, w, (14, 14), dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    close(got, want, dtype, scale=float(want.float().abs().max()))


def integer_case(gen, layer, c, b, cin, main_layout, drop):
    """Small-integer operands of a pooled layer's gradients: every product
    and sum is exact in bf16 operands and f32 sums. ``main_layout``: the
    main path's strides (conv2's input NHWC and its maps NCHW, the stem's
    input NCHW and its maps NHWC), which the tensor-core kernels read with
    vector loads; else the other ones, read element by element. ``drop``
    zeroes a quarter of the pooled gradient, as dropout does."""
    hw, cout = (28, 32) if layer == "stem" else (14, 64)
    cin = cin if layer == "stem" else 32
    x = torch.randint(-3, 4, (c, b, hw, hw, cin), generator=gen,
                      device="cuda").float().permute(0, 1, 4, 2, 3)
    if (layer == "stem") == main_layout:
        x = x.contiguous()  # NCHW
    x = x if layer == "stem" else x.to(torch.bfloat16)
    w = torch.randint(-2, 3, (c, cout, cin, 3, 3), generator=gen,
                      device="cuda").float()
    bias = torch.randint(-2, 3, (c, cout), generator=gen,
                         device="cuda").float()
    maps_nhwc = (layer == "stem") == main_layout
    h, arg = conv_fwd_plain(x, w, bias, dtype=torch.bfloat16,
                            channels_last=maps_nhwc)
    g = torch.randint(-4, 5, h.shape, generator=gen, device="cuda")
    if drop:
        g = g * (torch.rand(h.shape, generator=gen, device="cuda") >= 0.25)
    dp = torch.empty_like(h).copy_(g)  # h's strides
    return x, w, bias, h, arg, dp


TC_CASES = [("stem", 1), ("stem", 8), ("conv2", 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("main_layout", [True, False])
@pytest.mark.parametrize("layer,cin", TC_CASES)
def test_tc_kernels_exact_on_integers(cuda, layer, cin, main_layout, drop):
    """bf16 runs the tensor-core kernels: on exact operands they equal the
    plain versions bitwise, whatever order either sums in, at the ragged
    C=3, B=5, in both layouts, with and without dropped gradients: the
    forward (pooled map and argmax) and the gradients. The plain versions
    run without cuDNN here: its f32 weight gradient at conv2's grouped
    shape is not exact on integers (one bf16 ulp off a 338, measured on the
    card), PyTorch's own im2col and GEMM are."""
    bf16 = torch.bfloat16
    x, w, bias, h, arg, dp = integer_case(cuda, layer, 3, 5, cin,
                                          main_layout, drop)
    maps_nhwc = h.stride(2) == 1
    fwd = conv_fwd(x, w, bias, dtype=bf16, channels_last=maps_nhwc)
    got = [torch.full_like(w, float("nan")), torch.full_like(bias, 0.5)]
    want = [torch.empty_like(w), torch.empty_like(bias)]
    conv_wgrad(x, dp, h, arg, *got, dtype=bf16)
    with torch.backends.cudnn.flags(enabled=False):
        fwd_want = conv_fwd_plain(x, w, bias, dtype=bf16,
                                  channels_last=maps_nhwc)
        conv_wgrad_plain(x, dp, h, arg, *want, dtype=bf16)
        dx_want = conv_dgrad_plain(dp, h, arg, w, (14, 14), dtype=bf16) \
            if layer == "conv2" else None
    if layer == "conv2":
        dx = conv_dgrad(dp, h, arg, w, (14, 14), dtype=bf16,
                        channels_last=True)
    torch.cuda.synchronize()
    assert fwd[0].stride() == fwd_want[0].stride()
    assert torch.equal(fwd[0], fwd_want[0]) and torch.equal(fwd[1],
                                                            fwd_want[1])
    assert float(want[0].abs().max()) > 100  # sums large enough to test
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if layer == "conv2":
        assert torch.equal(dx, dx_want)


def dense_case(gen, c, rows, k, f, dtype, ints=False):
    """x [C, rows, K] (in dtype, post-relu), w [C, F, K] and b [C, F] f32;
    ``ints``: small integers, so every product and sum is exact."""
    if ints:
        x = torch.randint(0, 4, (c, rows, k), generator=gen, device="cuda")
        w = torch.randint(-2, 3, (c, f, k), generator=gen, device="cuda")
        b = torch.randint(-2, 3, (c, f), generator=gen, device="cuda")
        return x.to(dtype), w.float(), b.float()
    x = torch.relu(torch.randn((c, rows, k), generator=gen, device="cuda"))
    w = torch.randn((c, f, k), generator=gen, device="cuda") / k ** 0.5
    b = torch.randn((c, f), generator=gen, device="cuda")
    return x.to(dtype), w, b


@pytest.mark.cuda
def test_kernel_choice_follows_the_dtype(cuda):
    """f32 launches the CUDA-core kernels but for conv2's forward, weight
    and input gradients (conv2_fwd_tf32, conv2_wgrad_tf32,
    conv2_dgrad_tf32: 3xTF32), the stem's weight gradient
    (stem_wgrad_tf32) and a dense layer at fc1's geometry (dense_fwd_tf32,
    dense_bwd_tf32); its pooled stem forward runs the CUDA-core
    stem_fwd_f32. bf16 launches the tensor-core ones; the raw mode, K3, runs stem_raw_tf32 in f32 and
    stem_raw_tc in bf16. Each kernel has its own count, the wrappers count
    all of theirs."""
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        for layer, cin in TC_CASES:
            x, w, bias, h, arg, dp = pooled_case(cuda, layer, 3, 5, cin,
                                                 dtype)
            before = dict(KERNEL_LAUNCHES)
            fwd_before = conv_fwd.launches
            conv_fwd(x, w, bias, dtype=dtype)
            assert conv_fwd.launches == fwd_before + 1
            wgrad_before = conv_wgrad.launches
            conv_wgrad(x, dp, h, arg, torch.empty_like(w),
                       torch.empty_like(bias), dtype=dtype)
            assert conv_wgrad.launches == wgrad_before + 1
            if layer == "conv2":
                dgrad_before = conv_dgrad.launches
                conv_dgrad(dp, h, arg, w, (14, 14), dtype=dtype)
                assert conv_dgrad.launches == dgrad_before + 1
            counts[dtype, layer, cin] = {
                k: KERNEL_LAUNCHES[k] - before[k] for k in KERNEL_LAUNCHES}
        before = dict(KERNEL_LAUNCHES)
        x4 = torch.randn((3, 4, 28 * 28 * 8), generator=cuda, device="cuda")
        w4 = torch.randn((3, 4, 4, 8, 128), generator=cuda, device="cuda")
        client_stem_conv(x4.to(dtype), w4.to(dtype))
        counts[dtype, "raw", 8] = {
            k: KERNEL_LAUNCHES[k] - before[k] for k in KERNEL_LAUNCHES}
        for f, k in ((37, 100), (64, 200)):  # off fc1's geometry, on it
            before = dict(KERNEL_LAUNCHES)
            dx, dw, db = dense_case(cuda, 3, 7, k, f, dtype)
            dense_fwd(dx, dw, db, wdtype=dtype)
            counts[dtype, "dense", f] = {
                k: KERNEL_LAUNCHES[k] - before[k] for k in KERNEL_LAUNCHES}
            before = dict(KERNEL_LAUNCHES)
            bwd_before = dense_bwd.launches
            dz = torch.randn((3, 7, f), generator=cuda,
                             device="cuda").to(dtype)
            dense_bwd(dz, dx, dw, torch.empty_like(dw), torch.empty_like(db),
                      wdtype=dtype, gdtype=dtype, dx_dtype=dtype)
            assert dense_bwd.launches == bwd_before + 1
            counts[dtype, "dense_bwd", f] = {
                k: KERNEL_LAUNCHES[k] - before[k] for k in KERNEL_LAUNCHES}
    torch.cuda.synchronize()
    zero = dict.fromkeys(KERNEL_LAUNCHES, 0)
    for dtype in (torch.float32, torch.bfloat16):
        tc = dtype == torch.bfloat16
        for layer, cin in TC_CASES:
            dgrad = int(layer == "conv2")
            fwd = {True: {"conv2": "conv2_fwd_tc", "stem": "stem_fwd_tc"},
                   False: {"conv2": "conv2_fwd_tf32",
                           "stem": "stem_fwd_f32"}}[tc][layer]
            wgrad32 = "conv2_wgrad_tf32" if layer == "conv2" else \
                "stem_wgrad_tf32"
            want = {**zero, wgrad32: int(not tc), "conv_wgrad_tc": int(tc),
                    "conv2_dgrad_tf32": dgrad * int(not tc),
                    "conv_dgrad_tc": dgrad * int(tc)}
            want[fwd] = 1
            assert counts[dtype, layer, cin] == want, (dtype, layer, cin)
        assert counts[dtype, "raw", 8] == {
            **zero, ("stem_raw_tc" if tc else "stem_raw_tf32"): 1}
        # f32 at K 100, F 37 on the CUDA-core kernels; at K 200, F 64
        # (fc1's geometry: K a multiple of 8, F of 64) on the 3xTF32 ones.
        for f, f32_kernel in ((37, ""), (64, "_tf32")):
            assert counts[dtype, "dense", f] == {
                **zero, "dense_fwd" + f32_kernel: int(not tc),
                "dense_fwd_tc": int(tc)}, f
            assert counts[dtype, "dense_bwd", f] == {
                **zero, "dense_bwd" + f32_kernel: int(not tc),
                "dense_bwd_tc": int(tc)}, f


@pytest.mark.cuda
def test_tc_kernels_refuse_other_bf16_calls(cuda):
    """A bf16 call the tensor-core kernels do not take raises, and nothing
    is launched: it never drops to the CUDA-core kernel."""
    bf16 = torch.bfloat16
    x, w, bias, h, arg, dp = pooled_case(cuda, "conv2", 3, 5, 32, bf16)
    sx, sw, sb, sh, sarg, sdp = pooled_case(cuda, "stem", 3, 5, 1, bf16)
    gw, gb = torch.empty_like(w), torch.empty_like(bias)
    dx, dw, db = dense_case(cuda, 3, 7, 100, 37, torch.float32)
    gw_d, gb_d = torch.empty_like(dw), torch.empty_like(db)
    dz = torch.randn((3, 7, 37), generator=cuda, device="cuda")
    dz33 = torch.zeros((3, 33, 37), device="cuda", dtype=bf16)
    dx33 = torch.zeros((3, 33, 100), device="cuda", dtype=bf16)
    dz129 = torch.zeros((3, 7, 129), device="cuda", dtype=bf16)
    dw129 = torch.zeros((3, 129, 100), device="cuda")
    gw129, gb129 = torch.empty_like(dw129), torch.zeros((3, 129),
                                                         device="cuda")
    calls = {
        "conv2 at 16 input channels": lambda: conv_wgrad(
            x[:, :, :16], dp, h, arg, gw[:, :, :16], gb, dtype=bf16),
        "stride 2": lambda: conv_wgrad(x, dp, h, arg, gw, gb, stride=2,
                                       dtype=bf16),
        "a stem of 64 outputs": lambda: conv_wgrad(
            sx, torch.cat([sdp, sdp], 2), torch.cat([sh, sh], 2),
            torch.cat([sarg, sarg], 2), torch.cat([sw, sw], 1),
            torch.cat([sb, sb], 1), dtype=bf16),
        "f32 pooled gradient": lambda: conv_wgrad(x, dp.float(), h, arg, gw,
                                                  gb, dtype=bf16),
        "a stem of bf16 input": lambda: conv_wgrad(
            sx.to(bf16), sdp, sh, sarg, sw, sb, dtype=bf16),
        "the stem's input gradient": lambda: conv_dgrad(
            sdp, sh, sarg, sw, (28, 28), dtype=bf16),
        "forward: conv2 at 16 input channels": lambda: conv_fwd(
            x[:, :, :16], w[:, :, :16], bias, dtype=bf16),
        "forward: stride 2": lambda: conv_fwd(x, w, bias, stride=2,
                                              dtype=bf16),
        "forward: a stem of 64 outputs": lambda: conv_fwd(
            sx, torch.cat([sw, sw], 1), torch.cat([sb, sb], 1), dtype=bf16),
        "forward: a stem of bf16 input": lambda: conv_fwd(
            sx.to(bf16), sw, sb, dtype=bf16),
        "forward: a 5x5 stem": lambda: conv_fwd(
            sx, torch.zeros((3, 32, 1, 5, 5), device="cuda"), sb, pad=2,
            dtype=bf16),
        "fc1 forward of an f32 x": lambda: dense_fwd(dx, dw, db,
                                                     wdtype=bf16),
        "fc1 backward of an f32 dz": lambda: dense_bwd(
            dz, dx.to(bf16), dw, gw_d, gb_d, wdtype=bf16, gdtype=bf16),
        "fc1 backward of an f32 x": lambda: dense_bwd(
            dz.to(bf16), dx, dw, gw_d, gb_d, wdtype=bf16, gdtype=bf16),
        "fc1 backward of 33 rows": lambda: dense_bwd(
            dz33, dx33, dw, gw_d, gb_d, wdtype=bf16, gdtype=bf16),
        "fc1 backward of 129 outputs": lambda: dense_bwd(
            dz129, dx.to(bf16), dw129, gw129, gb129, wdtype=bf16,
            gdtype=bf16),
    }

    def counted():
        return (dict(KERNEL_LAUNCHES), conv_fwd.launches,
                conv_wgrad.launches, conv_dgrad.launches, dense_fwd.launches,
                dense_bwd.launches)

    before = counted()
    for what, call in calls.items():
        with pytest.raises(ValueError, match="tensor-core"):
            call()
    assert counted() == before


@pytest.mark.cuda
def test_tc_kernels_refuse_other_f32_calls(cuda):
    """An f32 weight gradient that neither conv2_wgrad_tf32 nor
    stem_wgrad_tf32 takes raises, and nothing is launched: no other kernel
    serves it."""
    f32 = torch.float32
    x, w, bias, h, arg, dp = pooled_case(cuda, "conv2", 3, 5, 32, f32)
    sx, sw, sb, sh, sarg, sdp = pooled_case(cuda, "stem", 3, 5, 1, f32)
    gw, gb = torch.empty_like(w), torch.empty_like(bias)
    s9 = torch.randn((3, 5, 9, 28, 28), generator=cuda, device="cuda")
    two = [torch.cat([v, v], 2) for v in (sdp, sh, sarg)]
    calls = {
        "conv2 at 16 input channels": lambda: conv_wgrad(
            x[:, :, :16], dp, h, arg, gw[:, :, :16], gb),
        "conv2 at stride 2": lambda: conv_wgrad(x, dp, h, arg, gw, gb,
                                                stride=2),
        "a stem of 64 outputs": lambda: conv_wgrad(
            sx, *two, torch.empty((3, 64, 1, 3, 3), device="cuda"),
            torch.empty((3, 64), device="cuda")),
        "a stem of bf16 input": lambda: conv_wgrad(
            sx.to(torch.bfloat16), sdp, sh, sarg, torch.empty_like(sw),
            torch.empty_like(sb)),
        "a stem of 9 input channels": lambda: conv_wgrad(
            s9, sdp, sh, sarg, torch.empty((3, 32, 9, 3, 3), device="cuda"),
            torch.empty_like(sb)),
        "a 5x5 stem": lambda: conv_wgrad(
            sx, sdp, sh, sarg, torch.empty((3, 32, 1, 5, 5), device="cuda"),
            torch.empty_like(sb), pad=2),
    }
    before = (dict(KERNEL_LAUNCHES), conv_wgrad.launches)
    for what, call in calls.items():
        with pytest.raises(ValueError, match="stem_wgrad_tf32"):
            call()
    assert (dict(KERNEL_LAUNCHES), conv_wgrad.launches) == before


DENSE = [(3, 7, 100, 37, False, False), (100, 32, 3136, 128, False, False),
         (100, 32, 128, 10, False, False), (3, 7, 100, 37, True, False),
         (100, 32, 3136, 128, True, False),
         (100, 32, 3136, 128, False, True)]


def flat_views(w, b):
    """fc1's weight and bias copied into views of a flat [C, D] buffer of
    SimpleCNN's layout, as the fused path reads them: a client's rows are
    1,686,568 bytes apart, so an odd client's are 8-byte aligned only.
    Returns (w, b, and a function that makes gradient views alike)."""
    from multimodal_fl_security_tpu_torch.models.simple_cnn import SimpleCNN

    layout = SimpleCNN().layout(1)

    def views():
        flat = torch.full((w.shape[0], layout.dim), float("nan"),
                          device=w.device)
        v = layout.views(flat)
        return v["fc1.weight"], v["fc1.bias"]

    fw, fb = views()
    fw.copy_(w)
    fb.copy_(b)
    assert fw.data_ptr() % 8 == 0 and fw[1].data_ptr() % 16 != 0
    return fw, fb, views


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows,k,f,ints,flat", DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_kernels_match_plain(cuda, c, rows, k, f, ints, flat, dtype):
    """Within one rounding of the plain versions on random operands,
    bitwise on small integers (every sum exact; bf16 runs the forward and
    the backward on the tensor-core kernels, the forward with K split over
    a cluster), and two calls bitwise equal; ``flat``: W, dW and db are
    views of flat [C, D] buffers, whose odd clients' rows are 8-byte
    aligned only. f32 at fc1's geometry runs the 3xTF32 kernels
    (dense_fwd_tf32, dense_bwd_tf32), held on random operands to the f64
    result instead: rtol 1e-5, atol 1e-5 of max|f64|, each error at most 4x
    the f32 plain version's (``tests/test_torch_port_dense_tf32.py``)."""
    tf32 = dtype == torch.float32 and k % 8 == 0 and f % 64 == 0 and not ints
    x, w, b = dense_case(cuda, c, rows, k, f, dtype, ints)
    grads = lambda: (torch.empty_like(w), torch.empty_like(b))  # noqa: E731
    if flat:
        w, b, grads = flat_views(w, b)
    y = dense_fwd(x, w, b, relu=True, wdtype=dtype, out_dtype=dtype)
    y_again = dense_fwd(x, w, b, relu=True, wdtype=dtype, out_dtype=dtype)
    y_want = dense_fwd_plain(x, w, b, relu=True, wdtype=dtype,
                             out_dtype=dtype)
    dz = torch.randn((c, rows, f), generator=cuda, device="cuda")
    dz = (dz.round() if ints else dz).to(dtype)
    outs = []
    for fn in (dense_bwd, dense_bwd, dense_bwd_plain):
        gw, gb = grads()
        dx = fn(dz, x, w, gw, gb, mask=x, wdtype=dtype, gdtype=dtype,
                dx_dtype=dtype)
        outs.append((gw, gb, dx))
    dx64 = torch.bmm(dz.double(), w.double())
    refs64 = (torch.relu(torch.baddbmm(b.double().unsqueeze(1), x.double(),
                                       w.double().transpose(1, 2))),
              torch.bmm(dz.double().transpose(1, 2), x.double()),
              dz.double().sum(dim=1), torch.where(x > 0, dx64, 0.0))
    torch.cuda.synchronize()
    assert torch.equal(y, y_again)
    if ints:
        assert float(y_want.float().abs().max()) > 20  # not all clipped
        assert torch.equal(y, y_want)
    elif tf32:
        close_f64(y, y_want, refs64[0])
    else:
        close(y, y_want, dtype, scale=4.0)
    for got, rep, ref, ref64 in zip(*outs, refs64[1:]):
        assert torch.equal(got, rep)
        if tf32:
            close_f64(got, ref, ref64)
        else:
            close(got, ref, dtype, scale=float(ref.float().abs().max()))


def close_f64(got, plain, ref64):
    """A 3xTF32 kernel's f32 result: within rtol 1e-5 and atol 1e-5 of
    max|ref64| of the f64 result, its error at most 4x the plain
    version's."""
    torch.testing.assert_close(got.double(), ref64, rtol=1e-5,
                               atol=1e-5 * float(ref64.abs().max()))
    err, err_plain = (float((v.double() - ref64).abs().max())
                      for v in (got, plain))
    assert err <= 4 * err_plain, (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", [(3, 7), (100, 32)])
def test_client_ce_kernel_matches_plain(cuda, c, rows):
    logits = 3 * torch.randn((c, rows, 10), generator=cuda, device="cuda")
    labels = torch.randint(0, 10, (c, rows), generator=cuda, device="cuda")
    mask = (torch.rand((c, rows), generator=cuda, device="cuda")
            > 0.2).float()
    mask[0] = 0.0
    loss, dl = client_ce(logits, labels, mask)
    loss2, dl2 = client_ce(logits, labels, mask)
    want_loss, want_dl = client_ce_plain(logits, labels, mask)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(dl, dl2)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dl, want_dl, rtol=1e-6, atol=1e-7)
    assert float(loss[0]) == 0.0 and not bool(dl[0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(7, 1000), (3, 1), (100, 421_642)])
@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_sgd_kernels_match_plain(cuda, c, d, clip_norm):
    p = torch.randn((c, d), generator=cuda, device="cuda")
    m = 0.1 * torch.randn((c, d), generator=cuda, device="cuda")
    g = 0.01 * torch.randn((c, d), generator=cuda, device="cuda")
    partial = client_sq_norm(g)
    torch.testing.assert_close(partial.sum(1, keepdim=True),
                               client_sq_norm_plain(g), rtol=1e-5, atol=0)
    assert torch.equal(partial, client_sq_norm(g))
    p_ref, m_ref = p.clone(), m.clone()
    client_sgd_update(p, m, g, partial, lr=0.05, momentum=0.9,
                      clip_norm=clip_norm)
    client_sgd_update_plain(p_ref, m_ref, g, partial, lr=0.05, momentum=0.9,
                            clip_norm=clip_norm)
    torch.cuda.synchronize()
    # Same formula, each operation rounded alone. The two differ only in the
    # clip scale s, which they take in other orders (29 of the 100 scales
    # differ in their last bits on the card at [100, 421,642]): each element
    # is held to the bound that follows from its operands
    # (sgd_update_bounds). Where p - lr*m nearly cancels (p
    # ~1e-3 at m ~0.26) a one-ulp change of m moves p by lr * ulp(m) ~1.5e-9,
    # over any flat 1e-9; where g*s and mu*m cancel, m moves by ulp(g*s),
    # many ulps of m: a bound of one ulp of m would not hold.
    bound_m, bound_p = sgd_update_bounds(g, m_ref, p_ref, partial, lr=0.05,
                                         clip_norm=clip_norm)
    dm, dp = (m - m_ref).abs(), (p - p_ref).abs()
    s_k, s_ref = (kernel_clip_scale(partial, clip_norm),
                  clip_scale(partial, clip_norm))
    flat = 1e-9 + 2e-7 * p_ref.abs()  # the former bound on |dp|
    i, j = divmod(int((dp / flat).argmax()), d)
    over_ulp = int((dm > ulp(m_ref)).sum())
    print(f"[sgd {c}x{d} clip {clip_norm}] {int((s_k != s_ref).sum())} of "
          f"{c} clip scales differ; {int((dp > flat).sum())} elements over "
          f"the former flat bound, the worst |dp| {float(dp[i, j]):.3g} "
          f"(bound {float(flat[i, j]):.3g}) at ({i}, {j}): g "
          f"{float(g[i, j])!r}, m {float(m[i, j])!r} / "
          f"{float(m_ref[i, j])!r}, p {float(p[i, j])!r} / "
          f"{float(p_ref[i, j])!r}, scale {float(s_k[i])!r} / "
          f"{float(s_ref[i])!r} (kernel / plain); {over_ulp} elements of m "
          f"over one ulp")
    assert bool((dm <= bound_m).all()) and bool((dp <= bound_p).all())
    torch.testing.assert_close(m, m_ref, rtol=1e-6, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("c,b", [(3, 4), (100, 32)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_client_stem_conv_kernel_matches_plain(cuda, c, b, dtype):
    x = torch.randn((c, b, 28 * 28 * 8), generator=cuda,
                    device="cuda").to(dtype)
    w4 = (0.1 * torch.randn((c, 4, 4, 8, 128), generator=cuda,
                            device="cuda")).to(dtype)
    got = client_stem_conv(x, w4)
    want = client_stem_conv_plain(x, w4)
    torch.cuda.synchronize()
    assert got.shape == (c, b, 14, 14, 128) and got.dtype == dtype
    assert torch.equal(got, client_stem_conv(x, w4))
    close(got, want, dtype, scale=float(want.float().abs().max()))


#: (C, B) of K3 on stem_raw_tc: B = 1 and 7 end each client in a ragged
#: tile (196 and 1,372 rows), C = 100 at B = 4 and 7 puts client boundaries
#: inside the persistent blocks' ranges (700 and 1,100 tiles), and every
#: tile's first rows read the zero-padded border
STEM_RAW_CASES = [(1, 1), (3, 4), (3, 7), (1, 32), (100, 4), (100, 7),
                  (100, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,b", STEM_RAW_CASES)
def test_stem_raw_tc_matches_plain(cuda, c, b):
    """bf16 K3 runs stem_raw_tc: within one rounding of the plain version on
    random operands, bitwise equal to it on small integers (every sum exact
    in f32, rounded once to bf16 by both; the plain version without cuDNN),
    and two calls bitwise equal."""
    bf16 = torch.bfloat16
    x = torch.randn((c, b, 28 * 28 * 8), generator=cuda,
                    device="cuda").to(bf16)
    w4 = (0.1 * torch.randn((c, 4, 4, 8, 128), generator=cuda,
                            device="cuda")).to(bf16)
    xi = torch.randint(-3, 4, x.shape, generator=cuda, device="cuda").to(bf16)
    wi = torch.randint(-2, 3, w4.shape, generator=cuda,
                       device="cuda").to(bf16)
    before = KERNEL_LAUNCHES["stem_raw_tc"]
    got, again, got_i = (client_stem_conv(x, w4), client_stem_conv(x, w4),
                         client_stem_conv(xi, wi))
    assert KERNEL_LAUNCHES["stem_raw_tc"] == before + 3
    want = client_stem_conv_plain(x, w4)
    with torch.backends.cudnn.flags(enabled=False):
        want_i = client_stem_conv_plain(xi, wi)
    torch.cuda.synchronize()
    assert got.shape == (c, b, 14, 14, 128) and got.dtype == bf16
    assert got.is_contiguous()
    assert torch.equal(got, again)
    close(got, want, bf16, scale=float(want.float().abs().max()))
    assert float(want_i.float().abs().max()) > 50  # sums large enough to test
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
def test_stem_raw_tc_refuses_other_geometries(cuda):
    """A bf16 raw conv outside K3's geometry raises and launches nothing: it
    never drops to the CUDA-core kernel."""
    bf16 = torch.bfloat16
    x = torch.randn((3, 4, 6273), generator=cuda, device="cuda").to(bf16)
    w4 = torch.randn((3, 4, 4, 8, 128), generator=cuda, device="cuda").to(bf16)
    x1 = torch.randn((3, 4, 784), generator=cuda, device="cuda").to(bf16)
    w1 = torch.randn((3, 4, 4, 1, 128), generator=cuda,
                     device="cuda").to(bf16)
    xc = x[:, :, :6272].view(3, 4, 28, 28, 8).permute(0, 1, 4, 2, 3)
    wc = w4.permute(0, 4, 3, 1, 2)  # (out, in, kh, kw)
    calls = {
        "one input channel": lambda: client_stem_conv(x1, w1),
        "a misaligned x_flat": lambda: client_stem_conv(x[:, :, 1:], w4),
        "stride 1": lambda: conv_fwd(xc, wc, None, stride=1, pool=False,
                                     dtype=bf16, channels_last=True),
        "an NCHW output": lambda: conv_fwd(xc, wc, None, stride=2,
                                           pool=False, dtype=bf16),
    }
    before = (dict(KERNEL_LAUNCHES), conv_fwd.launches)
    for what, call in calls.items():
        with pytest.raises(ValueError, match="stem_raw_tc"):
            call()
    assert (dict(KERNEL_LAUNCHES), conv_fwd.launches) == before
