"""The round engine's kernel step (``ops/fused_kernel.py::KernelStep``) in
the one local-training loop (``rounds/local_train.py::train_clients``), and
the rule that picks it (``ops/fused_kernel.py::kernel_step_takes``).

On the CPU the kernel step runs every kernel's plain version in the
kernels' sequence of steps. The loop with it is held to the loop with the
engine's autograd step (``rounds/engine.py::AutogradStep``, which the
engine takes on the CPU) from two generators seeded alike, each the
round's draws (``RoundDraws``): C=3 clients x 64 rows, one client's shard
half padded, batch 32, 2 epochs, f32. Both draw each epoch's batch orders
and each step's dropout uniforms from the generator in the same order, so
the rows agree to f32 rounding (atol 1e-5), the losses to 1e-6 plus 1e-6
of their value (a few f32 roundings of lse - z_y, which cancels logits
larger than the loss: 1.2e-6 at 2.38 measured), and the generators end in
the same state. At rates (0, 0) nothing but the batch orders is drawn.

The ``cuda`` cases run on the card and skip without one: the engine takes
the kernel step there (``LAUNCHES_PER_DROPOUT_STEP`` launches a step), and
an f32 call of the benchmark cells' 38 steps runs the stem's weight
gradient on ``stem_wgrad_tf32`` once a step.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_fl_security_tpu_torch.models import create_model
from multimodal_fl_security_tpu_torch.ops._launch import (
    kernel_launches,
    reset_kernel_launches,
)
from multimodal_fl_security_tpu_torch.ops.client_conv import conv_wgrad
from multimodal_fl_security_tpu_torch.ops.client_dropout import RoundDraws
from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
    DRAWN_DROPOUT_STEP_KERNELS,
    LAUNCHES_PER_DROPOUT_STEP,
    KernelStep,
    kernel_step_takes,
)
from multimodal_fl_security_tpu_torch.rounds.engine import (
    AutogradStep,
    TrainSpec,
    make_local_train_fn,
)
from multimodal_fl_security_tpu_torch.rounds.local_train import train_clients
from multimodal_fl_security_tpu_torch.utils import tracing

C, N, B, EPOCHS, LR = 3, 64, 32, 2, 0.05
STEPS = N // B


def make_case(rates, device="cpu"):
    """A SimpleCNN at dropout ``rates``, its [D] parameters, images [C, N,
    1, 28, 28], labels and a mask with client 1's second half padded."""
    model = create_model("simple_cnn", num_classes=10, dropout_rates=rates)
    gen = torch.Generator(device).manual_seed(0)
    params = model.init_params(1, gen)
    images = torch.randn((C, N, 1, 28, 28), generator=gen, device=device)
    labels = torch.randint(0, 10, (C, N), generator=gen, device=device)
    mask = torch.ones((C, N), device=device)
    mask[1, N // 2:] = 0.0
    return model, params, images, labels, mask


def kernel_step(params, images, spec):
    return KernelStep(params, images, torch.float32,
                      learning_rate=spec.learning_rate,
                      momentum=spec.momentum, clip_norm=spec.clip_norm)


def train(step, rates, images, labels, mask):
    """``step`` in the one loop with the round's draws from a generator
    seeded 7: (rows, losses, generator)."""
    gen = torch.Generator().manual_seed(7)
    rows, losses = train_clients(step, RoundDraws(gen, rates), images,
                                 labels, mask, local_epochs=EPOCHS,
                                 batch_size=B)
    return rows, losses, gen


def train_both(rates):
    """The one loop with the autograd step and with the kernel step, from
    generators seeded alike: (rows, losses, generator) of each."""
    model, params, images, labels, mask = make_case(rates)
    spec = TrainSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=B)
    return (train(AutogradStep(model, spec, params, C), rates, images,
                  labels, mask),
            train(kernel_step(params, images, spec), rates, images, labels,
                  mask))


@pytest.mark.parametrize("rates", [(0.25, 0.5), (0.0, 0.0)])
def test_kernel_trainer_draws_as_the_engine(rates):
    (rows, losses, engine_gen), (k_rows, k_losses, kernel_gen) = \
        train_both(rates)
    np.testing.assert_allclose(k_rows.numpy(), rows.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(k_losses.numpy(), losses.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(kernel_gen.get_state(), engine_gen.get_state())
    if rates == (0.0, 0.0):  # the batch orders alone
        orders = torch.Generator().manual_seed(7)
        for _ in range(EPOCHS):
            torch.rand((C, N), generator=orders)
        assert torch.equal(kernel_gen.get_state(), orders.get_state())


def test_kernel_trainer_spans_each_step():
    model, params, images, labels, mask = make_case((0.25, 0.5))
    spec = TrainSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=B)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        train(kernel_step(params, images, spec), model.dropout_rates, images,
              labels, mask)
    names = [s.name for s in tracing.spans()]
    tracing.clear()
    assert names == ["forward", "backward", "optimizer"] * (EPOCHS * STEPS)


class CudaStandIn:
    """What the rule reads of a CUDA tensor, where there is no card."""

    device = torch.device("cuda")

    def __init__(self, shape, dtype=torch.float32):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)


IMAGES = (C, N, 1, 28, 28)


@pytest.mark.parametrize("case, spec, images, admitted", [
    ("admitted", {}, CudaStandIn(IMAGES), True),
    ("batch 16", {"batch_size": 16}, CudaStandIn(IMAGES), False),
    ("weight decay", {"weight_decay": 0.01}, CudaStandIn(IMAGES), False),
    ("label smoothing", {"label_smoothing": 0.1}, CudaStandIn(IMAGES),
     False),
    ("a CPU tensor", {}, torch.zeros(IMAGES), False),
    ("bf16 images", {}, CudaStandIn(IMAGES, torch.bfloat16), False),
    ("9 channels", {}, CudaStandIn((C, N, 9, 28, 28)), False),
    ("32x32 images", {}, CudaStandIn((C, N, 1, 32, 32)), False),
    pytest.param("on the card", {}, None, True, marks=pytest.mark.cuda),
])
def test_kernel_trainer_rule(case, spec, images, admitted):
    model = create_model("simple_cnn", num_classes=10)
    spec = TrainSpec(**{"learning_rate": LR, "local_epochs": EPOCHS,
                        "batch_size": B, **spec})
    if images is not None:
        assert kernel_step_takes(model, spec, images) is admitted
        return
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # The engine's trainer on the card: the kernel step's 16 launches a
    # step, the step's three spans each step.
    model, params, images, labels, mask = make_case((0.25, 0.5), "cuda")
    assert kernel_step_takes(model, spec, images)
    local_train = make_local_train_fn(model, spec, N)
    for fn in DRAWN_DROPOUT_STEP_KERNELS:
        fn.launches = 0
    gen = torch.Generator("cuda").manual_seed(7)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        rows, losses = local_train(params, {"image": images, "label": labels},
                                   mask, gen)
    names = [s.name for s in tracing.spans()]
    tracing.clear()
    steps = EPOCHS * STEPS
    launches = {fn.__name__: fn.launches for fn in DRAWN_DROPOUT_STEP_KERNELS}
    assert launches == {fn.__name__: k * steps
                        for fn, k in DRAWN_DROPOUT_STEP_KERNELS.items()}
    assert sum(launches.values()) == LAUNCHES_PER_DROPOUT_STEP * steps
    assert names == ["forward", "backward", "optimizer"] * steps
    assert bool(torch.isfinite(rows).all()) and bool(
        torch.isfinite(losses).all())
    assert rows.shape == (C, params.numel()) and losses.shape == (C,)


@pytest.mark.cuda
def test_f32_round_runs_stem_wgrad_tf32():
    """One f32 round's local training on the card, at the SimpleCNN cells'
    38 steps (600 rows padded to 608, batch 32, 2 epochs): the stem's weight
    gradient runs stem_wgrad_tf32 once a step and conv2's conv2_wgrad_tf32,
    and the weight-gradient wrapper launches nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 608
    model = create_model("simple_cnn", num_classes=10, dropout_rates=(0.25,
                                                                      0.5))
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init_params(1, gen)
    images = torch.randn((C, n, 1, 28, 28), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (C, n), generator=gen, device="cuda")
    mask = torch.ones((C, n), device="cuda")
    mask[:, 600:] = 0.0
    spec = TrainSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=B)
    assert model.dtype == torch.float32
    assert kernel_step_takes(model, spec, images)
    reset_kernel_launches()
    wgrad_before = conv_wgrad.launches
    rows, _ = make_local_train_fn(model, spec, n)(
        params, {"image": images, "label": labels}, mask,
        torch.Generator("cuda").manual_seed(7))
    torch.cuda.synchronize()
    launches = kernel_launches()
    steps = EPOCHS * n // B
    assert steps == 38
    assert launches["stem_wgrad_tf32"] == steps
    assert launches["conv2_wgrad_tf32"] == steps
    assert conv_wgrad.launches == wgrad_before + 2 * steps
    assert bool(torch.isfinite(rows).all())
