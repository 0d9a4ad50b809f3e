"""Port SimpleCNN against the JAX package's, on identical inputs.

Inputs come from a numpy seed and go through both frameworks in f32 on the
CPU. Tolerance: logits and per-layer gradients within atol 1e-4 (the two
frameworks sum convolutions and GEMMs in different orders); the parameter
conversion is a pure permutation, so it is held to exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu.core.pytrees import flatten_stacked, flatten_tree
from multimodal_fl_security_tpu.data.datasets import Dataset
from multimodal_fl_security_tpu.models import create_model as jax_create_model
from multimodal_fl_security_tpu.models import init_model as jax_init_model
from multimodal_fl_security_tpu.rounds.engine import (
    cross_entropy as jax_cross_entropy,
)
from multimodal_fl_security_tpu.utils.metrics import (
    evaluate_model as jax_evaluate_model,
)
from multimodal_fl_security_tpu_torch.models import create_model, init_model
from multimodal_fl_security_tpu_torch.models.from_jax import (
    flat_from_jax,
    params_from_jax,
)
from multimodal_fl_security_tpu_torch.rounds.engine import cross_entropy
from multimodal_fl_security_tpu_torch.utils.metrics import evaluate_model

C, B, HW = 3, 8, 28


def nchw(x):
    """NHWC numpy images (any leading axes) as an NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    jmodel = jax_create_model("simple_cnn", num_classes=10)
    images = rng.normal(size=(C, B, HW, HW, 1)).astype(np.float32)
    labels = rng.randint(0, 10, size=(C, B)).astype(np.int32)
    mask = np.ones((C, B), np.float32)
    mask[1, 5:] = 0.0  # a ragged client
    base = jax_init_model(jmodel, {"image": jnp.asarray(images[0])},
                          seed=0)["params"]
    # Distinct parameters per client, so the grouped conv's groups differ.
    stacked = jax.tree_util.tree_map(
        lambda p: np.asarray(p)[None]
        + 0.05 * rng.normal(size=(C,) + p.shape).astype(np.float32), base)
    model = create_model("simple_cnn", num_classes=10, dropout_rates=(0, 0))
    return dict(jmodel=jmodel, model=model, images=images, labels=labels,
                mask=mask, base=base, stacked=stacked)


def jax_client_loss(jmodel):
    def loss(p, x, y, m):
        logits = jmodel.apply({"params": p}, {"image": x}, train=False)
        return jax_cross_entropy(logits, y, m)
    return loss


def test_param_count_matches_jax(case):
    d_jax = int(flatten_tree(case["base"]).shape[0])
    assert case["model"].layout(1).dim == d_jax == 421_642
    flat = init_model(case["model"], in_channels=1, seed=0)
    assert flat.shape == (d_jax,) and flat.dtype == torch.float32
    views = case["model"].layout(1).views(flat)
    for name, v in views.items():
        if name.endswith(".bias"):
            assert torch.count_nonzero(v) == 0, name
        else:  # lecun normal, truncated at 2 sigma
            fan_in = v[0].numel()
            assert v.abs().max() <= 2.0 / 0.8796 / fan_in ** 0.5 + 1e-6
            assert abs(float(v.std()) * fan_in ** 0.5 - 1.0) < 0.1, name


def test_flat_from_jax_is_the_port_buffer(case):
    model, stacked = case["model"], case["stacked"]
    from_tree = params_from_jax(model, stacked)
    from_flat = flat_from_jax(model, np.asarray(flatten_stacked(stacked)), 1)
    assert from_tree.shape == (C, 421_642)
    assert torch.equal(from_tree, from_flat)
    single = flat_from_jax(model, np.asarray(flatten_tree(case["base"])), 1)
    assert torch.equal(single, params_from_jax(model, case["base"]))


def test_logits_match_jax(case):
    jmodel, model = case["jmodel"], case["model"]
    jlogits = jax.vmap(
        lambda p, x: jmodel.apply({"params": p}, {"image": x}, train=False)
    )(case["stacked"], jnp.asarray(case["images"]))
    params = params_from_jax(model, case["stacked"])
    with torch.no_grad():
        logits = model(params, nchw(case["images"]))
    assert logits.shape == (C, B, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    # One model ([D] params, [B, ...] images) takes the same path.
    with torch.no_grad():
        one = model(params[1], nchw(case["images"][1]))
    np.testing.assert_allclose(one.numpy(), np.asarray(jlogits[1]),
                               rtol=0, atol=1e-4)


def test_per_layer_grads_match_jax(case):
    jmodel, model = case["jmodel"], case["model"]
    jgrads = jax.vmap(jax.grad(jax_client_loss(jmodel)))(
        case["stacked"], jnp.asarray(case["images"]),
        jnp.asarray(case["labels"]), jnp.asarray(case["mask"]))
    expected = flat_from_jax(model, np.asarray(flatten_stacked(jgrads)), 1)

    params = params_from_jax(model, case["stacked"]).requires_grad_(True)
    logits = model(params, nchw(case["images"]))
    losses = cross_entropy(logits, torch.from_numpy(case["labels"]),
                           torch.from_numpy(case["mask"]))
    losses.sum().backward()  # disjoint params: row c is client c's gradient
    layout = model.layout(1)
    got, want = layout.views(params.grad), layout.views(expected)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_cross_entropy_matches_jax(case):
    rng = np.random.RandomState(1)
    logits = rng.normal(size=(C, B, 10)).astype(np.float32)
    for smoothing in (0.0, 0.1):
        want = [float(jax_cross_entropy(jnp.asarray(logits[c]),
                                        jnp.asarray(case["labels"][c]),
                                        jnp.asarray(case["mask"][c]),
                                        smoothing=smoothing))
                for c in range(C)]
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(case["labels"]),
                            torch.from_numpy(case["mask"]), smoothing)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_evaluate_model_matches_jax(case):
    images = case["images"].reshape(C * B, HW, HW, 1)
    labels = case["labels"].reshape(-1)
    want = jax_evaluate_model(
        case["jmodel"], case["base"],
        Dataset(arrays={"image": images, "label": labels}, num_classes=10),
        batch_size=16)
    got = evaluate_model(
        case["model"], params_from_jax(case["model"], case["base"]),
        {"image": nchw(images), "label": torch.from_numpy(labels)},
        batch_size=16)
    assert got["num_samples"] == want["num_samples"] == C * B
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)


def test_dropout_draws_from_the_generator():
    model = create_model("simple_cnn", num_classes=10)
    params = init_model(model, in_channels=1, seed=0)
    x = torch.randn(4, 1, HW, HW, generator=torch.Generator().manual_seed(1))
    runs = [model(params, x, train=True,
                  generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="Generator"):
        model(params, x, train=True)
    assert torch.equal(model(params, x), model(params, x))  # eval: no dropout
