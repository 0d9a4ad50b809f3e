"""K4's dropout on the port against the JAX package's mirror fed the same
masks.

The JAX kernel draws its dropout masks from the TPU's own generator
(``ops/fused_kernel.py:403-413``), which no other device reproduces; its
oracle ``ops/fused_train.py::mirror_local_train`` takes the masks
explicitly, pre-scaled, in its packed [28, 128] layout. The port draws them
from Philox4x32-10 (``ops/philox.py``). The test builds the port's masks
with the plain generator (``dropout_masks_plain``), moves fc1's input mask
from the port's (c, h, w) flatten to the packed layout with a map read off
the JAX package's own ``pack_params`` (applied to a ``Dense_0`` kernel whose
rows hold their own indices), and holds ``fused_local_train(use_dropout=
True)`` on the CPU (every kernel's plain version) and the port's mirror to
JAX's ``mirror_local_train``, 2 clients x 4 steps in f32, at the tolerance
of the no-dropout whole-loop test (atol 1e-5, rtol 1e-4).

The ``cuda`` cases hold the kernel path to the mirror on the card
(``run_check(use_dropout=True)``), the dropout kernel bitwise to its plain
version, and count the launches; they skip without a card. JAX is
imported inside the JAX-side helpers.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.models import create_model
from multimodal_fl_security_tpu_torch.models.from_jax import params_from_jax
from multimodal_fl_security_tpu_torch.ops.client_dropout import (
    RoundDraws,
    drawn_dropout,
    drawn_dropout_plain,
    dropout_apply,
    dropout_apply_plain,
    dropout_mask_plain,
    mask_scale,
)
from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
    DROPOUT_STEP_KERNELS,
    LAUNCHES_PER_DROPOUT_STEP,
    LAUNCHES_PER_STEP,
    fused_local_train,
)
from multimodal_fl_security_tpu_torch.ops.fused_train import (
    dropout_masks_plain,
    mirror_local_train,
)
from multimodal_fl_security_tpu_torch.ops.philox import STREAM_FC1_IN

KW = dict(learning_rate=0.05, momentum=0.9, clip_norm=1.0,
          compute_dtype=torch.float32)
SEED = 20261016


def make_case(c, n, seed, cin=8):
    """As ``tests/test_torch_port_fused_train.py`` makes it."""
    import jax
    import jax.numpy as jnp

    from multimodal_fl_security_tpu.models.simple_cnn import SimpleCNN
    from multimodal_fl_security_tpu.ops.s2d import space_to_depth

    rng = np.random.RandomState(seed)
    images = rng.normal(size=(c, n, 28, 28, cin)).astype(np.float32)
    labels = rng.randint(0, 10, size=(c, n)).astype(np.int32)
    mask = np.ones((c, n), np.float32)
    mask[:, -8:] = 0.0
    blocks = space_to_depth(np.pad(
        images, [(0, 0)] * 4 + [(0, 8 - cin)]))
    params = SimpleCNN(num_classes=10, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), {"image_s2d": jnp.asarray(blocks[0])})["params"]
    return images, labels, mask, blocks, params


def packed_fc1_index(params):
    """[28, 128] int: the port's (c, h, w) flatten index of fc1's input at
    each position of the JAX packed layout, -1 at its holes; read off
    ``pack_params`` of a ``Dense_0`` kernel whose row r holds r + 1."""
    import jax

    from multimodal_fl_security_tpu.ops.fused_train import pack_params

    rows = np.arange(1, 3137, dtype=np.float32)[:, None].repeat(128, 1)
    p = jax.tree_util.tree_map(lambda a: a, params)
    p["Dense_0"] = dict(p["Dense_0"], kernel=rows)
    flax = np.asarray(pack_params(p)["w_fc1"])[:, :, 0].astype(np.int64) - 1
    h, rest = flax // (7 * 64), flax % (7 * 64)
    w, ch = rest // 64, rest % 64
    return np.where(flax >= 0, ch * 49 + h * 7 + w, -1)


def test_packed_map_is_a_bijection_onto_the_pooled_map():
    *_, params = make_case(1, 32, seed=0)
    idx = packed_fc1_index(params)
    assert (idx < 0).sum() == 28 * 128 - 3136  # the (jq=3, s=1) holes
    assert sorted(idx[idx >= 0].tolist()) == list(range(3136))


def test_whole_loop_with_dropout_matches_jax_mirror():
    import jax
    import jax.numpy as jnp

    from multimodal_fl_security_tpu.ops import fused_train as ft

    c, n, epochs = 2, 64, 2
    steps = epochs * n // 32
    images, labels, mask, blocks, params = make_case(c, n, seed=11)
    m1, m2 = dropout_masks_plain(SEED, c, 32, steps, (0.25, 0.5),
                                 torch.float32)
    idx = packed_fc1_index(params)
    m1p = np.where(idx >= 0, m1.numpy()[..., np.maximum(idx, 0)], 0.0)
    model = create_model("simple_cnn", num_classes=10)
    xp = ft.pack_blocks(jnp.asarray(blocks))
    want = torch.stack([
        params_from_jax(model, ft.mirror_local_train(
            params, xp[i], jax.nn.one_hot(labels[i], 128),
            jnp.asarray(mask[i]), lr=0.05, momentum=0.9, clip_norm=1.0,
            local_epochs=epochs,
            dropout_masks=(jnp.asarray(m1p[:, i]), jnp.asarray(m2[:, i]))),
            device="cpu")
        for i in range(c)])
    p0 = params_from_jax(model, params, device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(images, -1, -3)))
    args = (p0, x, torch.from_numpy(labels).long(), torch.from_numpy(mask))
    got = fused_local_train(*args, local_epochs=epochs, use_dropout=True,
                            seed=SEED, **KW)
    mirror = mirror_local_train(*args, local_epochs=epochs,
                                dropout_masks=(m1, m2), **KW)
    no_drop = mirror_local_train(*args, local_epochs=epochs, **KW)
    assert float((no_drop - want).abs().max()) > 1e-4  # the masks matter
    for what, out in (("fused_local_train", got), ("mirror", mirror)):
        err = float((out - want).abs().max())
        print(f"{what} with dropout: max|port - JAX| {err:.3g}")
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=what)


def test_masks_at_full_size_keep_their_rates_and_follow_the_seed():
    m1, m2 = dropout_masks_plain(SEED, 100, 32, 1, (0.25, 0.5),
                                 torch.float32)
    assert m1.shape == (1, 100, 32, 3136) and m2.shape == (1, 100, 32, 128)
    assert abs(float((m1 > 0).float().mean()) - 0.75) < 0.01
    assert abs(float((m2 > 0).float().mean()) - 0.5) < 0.01
    assert set(torch.unique(m1).tolist()) == {
        0.0, float(np.float32(1.0) / np.float32(0.75))}
    other = dropout_masks_plain(SEED + 1, 100, 32, 1, (0.25, 0.5),
                                torch.float32)
    assert not torch.equal(m1, other[0]) and not torch.equal(m2, other[1])
    # Clients and steps draw their own masks.
    assert not torch.equal(m1[0, 0], m1[0, 1])
    later = dropout_mask_plain(SEED, (100, 32, 3136), 1, STREAM_FC1_IN, 0.75,
                               torch.float32)
    assert not torch.equal(m1[0], later)


def test_mask_rounds_to_the_compute_dtype():
    assert mask_scale(0.75, torch.float32) == np.float32(1.0) / np.float32(0.75)
    assert mask_scale(0.75, torch.bfloat16) == 1.3359375  # bf16(4/3)
    x = torch.randn((2, 32, 128)).to(torch.bfloat16)
    y = dropout_apply(x, seed=3, step=5, stream=1, keep=0.5,
                      dtype=torch.bfloat16)
    m = dropout_mask_plain(3, (2, 32, 128), 5, 1, 0.5, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, x * m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.25, 0.5, 0.1])
def test_drawn_dropout_is_the_engines_dropout(dtype, rate):
    """The mask from data (the kernel step's) against the models' dropout
    (``RoundDraws`` called by the model) on the uniforms drawn from one
    seed: bitwise on the CPU, the kept elements divided by keep."""
    x = torch.randn((3, 32, 200), generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    want = RoundDraws(torch.Generator().manual_seed(2), (rate,))(x, 0)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(2))
    got = drawn_dropout(x, u, keep=1.0 - rate, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got == 0, (u >= 1.0 - rate) | (x == 0))


# ---------------------------------------------------------------- CUDA

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7), (100, 32, 3136),
                                   (100, 32, 128)])
def test_dropout_kernel_is_its_plain_version(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kw = dict(seed=SEED, step=7, stream=1, keep=0.75, dtype=dtype)
    got = dropout_apply(x, **kw)
    assert torch.equal(got, dropout_apply_plain(x, **kw))
    # A strided view reads in place.
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(dropout_apply(xt, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7), (100, 32, 3136),
                                   (100, 32, 128)])
def test_drawn_dropout_kernel_is_its_plain_version(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    x[0, 0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    u = torch.rand(shape, generator=gen, device="cuda")
    u[0, 0, :3] = torch.tensor([0.9, 0.1, 0.1])  # NaN dropped, inf kept
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for keep in (0.75, 0.5, 0.9):
        got = drawn_dropout(x, u, keep=keep, dtype=dtype)
        want = drawn_dropout_plain(x, u, keep=keep, dtype=dtype)
        assert torch.equal(got.view(bits), want.view(bits))  # -0.0 too
        assert got[0, 0, 0] == 0 and got[0, 0, 1] == float("inf")
        # A strided view reads in place.
        xt = x.transpose(0, 1).contiguous().transpose(0, 1)
        assert torch.equal(drawn_dropout(xt, u, keep=keep, dtype=dtype)
                           .view(bits), got.view(bits))


@pytest.mark.cuda
def test_kernel_path_with_dropout_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multimodal_fl_security_tpu_torch.benchmarks.fused_kernel_bench import (
        run_check,
    )

    # Against the mirror fed the plain generator's masks (C=4, f32).
    result = run_check(use_dropout=True)
    assert result["ok"], result
    # Launches, and a bitwise repeat, on other clients in bf16.
    gen = torch.Generator("cuda").manual_seed(0)
    c, n = 3, 64
    x = torch.randn((c, n, 1, 28, 28), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (c, n), generator=gen, device="cuda")
    mask = torch.ones((c, n), device="cuda")
    mask[:, -5:] = 0.0
    model = create_model("simple_cnn", num_classes=10)
    params = 0.05 * torch.randn(model.layout(1).dim, generator=gen,
                                device="cuda")
    kw = dict(learning_rate=0.05, local_epochs=2, use_dropout=True, seed=SEED)
    for fn in DROPOUT_STEP_KERNELS:
        fn.launches = 0
    out = fused_local_train(params, x, labels, mask, **kw)
    launches = {fn.__name__: fn.launches for fn in DROPOUT_STEP_KERNELS}
    again = fused_local_train(params, x, labels, mask, **kw)
    other = fused_local_train(params, x, labels, mask, **dict(kw, seed=1))
    torch.cuda.synchronize()
    steps = 2 * n // 32
    assert launches == {fn.__name__: k * steps
                        for fn, k in DROPOUT_STEP_KERNELS.items()}
    assert sum(launches.values()) == LAUNCHES_PER_DROPOUT_STEP * steps
    assert LAUNCHES_PER_DROPOUT_STEP == LAUNCHES_PER_STEP + 4
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    assert not torch.equal(out, other)
