"""Port fused local training against the JAX package's K4 and its mirror.

The JAX side runs ``ops/fused_train.py::mirror_local_train`` and the K4
kernel itself (``ops/fused_kernel.py::fused_local_train`` in interpret
mode) on ``pack_blocks(space_to_depth(images))``; the port side runs
``fused_local_train`` on CPU tensors (every kernel's plain version, in the
kernel path's sequence of steps) and its own ``mirror_local_train``, on the
same numpy images in NCHW. Each client's result is converted with
``params_from_jax``. Tolerance: atol 1e-5, rtol 1e-4, because f32 sums run
in another order over the SGD steps (measured maximum: PERF.md, PR 3).

The ``cuda`` cases run on the card and skip without one. JAX is imported
inside the JAX-side helpers, so they run where JAX is missing.
"""

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.models import create_model
from multimodal_fl_security_tpu_torch.models.from_jax import params_from_jax
from multimodal_fl_security_tpu_torch.ops._launch import (
    kernel_launches,
    reset_kernel_launches,
)
from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
    LAUNCHES_PER_STEP,
    STEP_KERNELS,
    fused_local_train,
)
from multimodal_fl_security_tpu_torch.ops.fused_train import (
    dropout_masks_plain,
    mirror_local_train,
)

KW = dict(learning_rate=0.05, momentum=0.9, clip_norm=1.0,
          compute_dtype=torch.float32)


def jax_side():
    import jax
    import jax.numpy as jnp

    from multimodal_fl_security_tpu.models.simple_cnn import SimpleCNN
    from multimodal_fl_security_tpu.ops import fused_kernel as fk
    from multimodal_fl_security_tpu.ops import fused_train as ft
    from multimodal_fl_security_tpu.ops.s2d import space_to_depth

    return jax, jnp, SimpleCNN, fk, ft, space_to_depth


def make_case(c, n, seed, cin=8):
    """Numpy images [C, n, 28, 28, cin], labels, a mask with the last 8
    rows padded, and flax params of the s2d SimpleCNN at 8 channels."""
    jax, jnp, SimpleCNN, _, _, space_to_depth = jax_side()
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


def port_inputs(images, labels, mask):
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(images, -1, -3)))
    return x, torch.from_numpy(labels).long(), torch.from_numpy(mask)


def assert_close_clients(got, want, what):
    err = float((got - want).abs().max())
    print(f"{what}: max|port - JAX| {err:.3g}")  # shown with pytest -s
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: max err {err}")


def test_whole_loop_matches_jax_mirror():
    jax, jnp, _, _, ft, _ = jax_side()
    c, n, epochs = 2, 64, 2
    images, labels, mask, blocks, params = make_case(c, n, seed=11)
    model = create_model("simple_cnn", num_classes=10)
    xp = ft.pack_blocks(jnp.asarray(blocks))
    want = torch.stack([
        params_from_jax(model, ft.mirror_local_train(
            params, xp[i], jax.nn.one_hot(labels[i], 128),
            jnp.asarray(mask[i]), lr=0.05, momentum=0.9, clip_norm=1.0,
            local_epochs=epochs), device="cpu")
        for i in range(c)])
    p0 = params_from_jax(model, params, device="cpu")
    args = (p0, *port_inputs(images, labels, mask))
    got = fused_local_train(*args, local_epochs=epochs, **KW)
    mirror = mirror_local_train(*args, local_epochs=epochs, **KW)
    assert got.shape == (c, p0.shape[0])
    assert float((want - p0).abs().max()) > 1e-3  # training moved them
    assert_close_clients(got, want, "fused_local_train")
    assert_close_clients(mirror, want, "mirror_local_train")


def test_matches_the_k4_kernel_in_interpret_mode():
    jax, jnp, _, fk, ft, _ = jax_side()
    images, labels, mask, blocks, params = make_case(1, 32, seed=13)
    mask[:] = 1.0
    out = fk.fused_local_train(
        params, ft.pack_blocks(jnp.asarray(blocks)), jnp.asarray(labels),
        jnp.asarray(mask), learning_rate=0.05, momentum=0.9, clip_norm=1.0,
        local_epochs=1, compute_dtype=jnp.float32, interpret=True)
    model = create_model("simple_cnn", num_classes=10)
    want = params_from_jax(model, out, device="cpu")
    got = fused_local_train(params_from_jax(model, params, device="cpu"),
                            *port_inputs(images, labels, mask),
                            local_epochs=1, **KW)
    assert_close_clients(got, want, "vs K4 (interpret)")


def test_one_channel_equals_eight_zero_padded_channels():
    """The north star carries 1 channel; the JAX bench pads to 8 zeros."""
    images, labels, mask, _, params = make_case(2, 64, seed=17, cin=1)
    model = create_model("simple_cnn", num_classes=10)
    p8 = params_from_jax(model, params, device="cpu")
    v8 = model.layout(8).views(p8)
    layout1 = model.layout(1)
    p1 = layout1.flatten({name: v8[name][:, :1] if name == "conv1.weight"
                          else v8[name] for name, _ in layout1.entries})
    img8 = np.pad(images, [(0, 0)] * 4 + [(0, 7)])
    out8 = fused_local_train(p8, *port_inputs(img8, labels, mask),
                             local_epochs=2, **KW)
    out1 = fused_local_train(p1, *port_inputs(images, labels, mask),
                             local_epochs=2, **KW)
    o8, o1 = model.layout(8).views(out8), layout1.views(out1)
    for name in o1:
        want = o8[name][:, :, :1] if name == "conv1.weight" else o8[name]
        np.testing.assert_allclose(o1[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    # The padded channels' weights get zero gradients: unchanged.
    assert torch.equal(o8["conv1.weight"][:, :, 1:],
                       v8["conv1.weight"][:, 1:].expand(2, -1, -1, -1, -1))


@pytest.mark.parametrize("trainer", [fused_local_train, mirror_local_train])
def test_dropout_and_weight_decay_are_refused(trainer):
    model = create_model("simple_cnn", num_classes=10)
    params = torch.zeros(model.layout(1).dim)
    x = torch.zeros((1, 32, 1, 28, 28))
    labels = torch.zeros((1, 32), dtype=torch.long)
    mask = torch.ones((1, 32))
    # Dropout runs (tests/test_torch_port_dropout.py); a rate outside
    # [0, 1) is refused, by the kernel path and by the mirror's masks.
    with pytest.raises(ValueError, match="dropout rates"):
        if trainer is mirror_local_train:
            dropout_masks_plain(0, 1, 32, 1, rates=(0.25, 1.0))
        else:
            trainer(params, x, labels, mask, learning_rate=0.1,
                    use_dropout=True, dropout_rates=(0.25, 1.0))
    with pytest.raises(TypeError, match="weight_decay"):
        trainer(params, x, labels, mask, learning_rate=0.1, weight_decay=0.1)
    with pytest.raises(ValueError, match="multiple of the batch size"):
        trainer(params, x[:, :20], labels[:, :20], mask[:, :20],
                learning_rate=0.1)


def test_params_must_match_the_layout():
    x = torch.zeros((1, 32, 1, 28, 28))
    with pytest.raises(ValueError, match="SimpleCNN"):
        fused_local_train(torch.zeros(10), x, torch.zeros((1, 32)),
                          torch.ones((1, 32)), learning_rate=0.1)


# ---------------------------------------------------------------- CUDA

@pytest.mark.cuda
def test_run_check_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multimodal_fl_security_tpu_torch.benchmarks.fused_kernel_bench import (
        run_check,
    )

    result = run_check()
    assert result["ok"], result


@pytest.mark.cuda
def test_kernel_path_bf16_is_reproducible_and_counted():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    c, n = 3, 64
    x = torch.randn((c, n, 1, 28, 28), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (c, n), generator=gen, device="cuda")
    mask = torch.ones((c, n), device="cuda")
    mask[:, -5:] = 0.0
    model = create_model("simple_cnn", num_classes=10)
    params = 0.05 * torch.randn(model.layout(1).dim, generator=gen,
                                device="cuda")
    for fn in STEP_KERNELS:
        fn.launches = 0
    reset_kernel_launches()
    kw = dict(learning_rate=0.05, local_epochs=2)
    out = fused_local_train(params, x, labels, mask, **kw)
    launches = {fn.__name__: fn.launches for fn in STEP_KERNELS}
    per_kernel = kernel_launches()
    again = fused_local_train(params, x, labels, mask, **kw)
    ref = mirror_local_train(params, x, labels, mask, **kw)
    torch.cuda.synchronize()
    steps = 2 * n // 32
    assert launches == {fn.__name__: k * steps
                        for fn, k in STEP_KERNELS.items()}
    assert sum(launches.values()) == LAUNCHES_PER_STEP * steps
    # bf16: the forward, the conv gradients and fc1's backward on the
    # tensor-core kernels, fc2 (f32 weights) on the CUDA-core dense_fwd and
    # dense_bwd.
    assert per_kernel == {
        "conv_fwd": 0, "conv2_fwd_tc": steps, "conv2_fwd_tf32": 0,
        "stem_fwd_tc": steps, "stem_fwd_f32": 0, "stem_raw_tc": 0, "stem_raw_tf32": 0,
        "conv_wgrad_tc": 2 * steps, "conv2_wgrad_tf32": 0,
        "stem_wgrad_tf32": 0,
        "conv_dgrad_tc": steps, "conv2_dgrad_tf32": 0, "dense_fwd": steps,
        "dense_fwd_tc": steps, "dense_fwd_tf32": 0, "dense_bwd": steps,
        "dense_bwd_tc": steps, "dense_bwd_tf32": 0}
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    # bf16 rounds at the same places; near ties may route differently.
    assert float((out - ref).abs().max()) < 1e-2
