"""Every client's local SGD for SimpleCNN on hand-written Hopper kernels.

Counterpart of ``multimodal_fl_security_tpu/ops/fused_kernel.py::
fused_local_train`` (K4, ``:307-533``), which runs all clients' whole local
training in one Pallas kernel. Here each SGD step is a fixed sequence of
launches over all C clients at once:

    conv_fwd (stem)   3x3 SAME conv at the 4 pool offsets, max, bias, relu
                      (stem_fwd_tc in bf16, stem_fwd_f32 in f32)
    conv_fwd (conv2)  3x3 SAME conv, bias, relu, 2x2 max-pool
                      (conv2_fwd_tc in bf16, conv2_fwd_tf32 in f32)
    dense_fwd (fc1)   + bias, relu
    dense_fwd (fc2)   + bias, in f32
    client_ce         masked mean CE and dlogits
    dense_bwd (fc2)   dW2, db2, dh4 through fc1's relu
    dense_bwd (fc1)   dW1, db1, dh3
    conv_wgrad        conv2's dW, db through its argmax and relu
    conv_dgrad        dh1, conv2's input gradient
    conv_wgrad        the stem's dW (the fold of w4's copies), db
    client_sq_norm    per-client squared-norm partials
    client_sgd_update clip, momentum, update, in place

:data:`LAUNCHES_PER_STEP` counts them. With ``use_dropout`` four more
launches of ``dropout_apply`` (``csrc/client_dropout.cu``) apply the
Philox masks: to fc1's input and to its relu output in the forward, and,
regenerated, to the two gradients in the backward
(:data:`DROPOUT_STEP_KERNELS`, :data:`LAUNCHES_PER_DROPOUT_STEP`). The
dropped activations are new buffers: conv2's gradient kernels read the
pooled map itself. The kernels read each layer's
weights in place from the ``[C, D]`` parameter buffer and write gradients
straight into the ``[C, D]`` gradient buffer's segments (the port's
``FlatLayout``): no per-step copies of weights or gradients. A
:class:`KernelStep` allocates the three ``[C, D]`` buffers (params,
momentum, gradient) once;
each step's activations and argmax maps come from PyTorch's caching
allocator, which hands the same blocks back every step.

On CUDA tensors every step launches the kernels (or raises); on CPU
tensors the same sequence runs with each kernel's plain version in its
place, so the CPU tests exercise this decomposition and its glue.

Semantics of :func:`fused_local_train` are those of the JAX kernel and
``fused_train.py::mirror_local_train``: resident batch order, a fresh zero
momentum per client, masked mean CE, the clip over each client's logical
gradient, m = g*scale + mu*m, p -= lr*m, no weight decay; dropout at rates
(0.25, 0.5) on fc1's input and output, per (client, step), as
``fused_kernel.py:403-413`` draws it, on Philox instead of the TPU's bits.

:class:`KernelStep` is this step in the port's one local-training loop
(``rounds/local_train.py``), which :func:`fused_local_train` runs and the
round engine runs for the input that :func:`kernel_step_takes` admits.
"""

from __future__ import annotations

import torch

from multimodal_fl_security_tpu_torch.models.simple_cnn import SimpleCNN
from multimodal_fl_security_tpu_torch.ops.client_conv import (
    conv_dgrad,
    conv_fwd,
    conv_wgrad,
)
from multimodal_fl_security_tpu_torch.ops.client_dense import (
    dense_bwd,
    dense_fwd,
)
from multimodal_fl_security_tpu_torch.ops.client_dropout import (
    PhiloxDropout,
    check_rate,
    drawn_dropout,
    dropout_apply,
)
from multimodal_fl_security_tpu_torch.ops.client_sgd import (
    client_ce,
    client_sgd_update,
    client_sq_norm,
)
from multimodal_fl_security_tpu_torch.ops.fused_train import (
    B,
    HID,
    NCLS,
    check_inputs,
    kernels_take,
)
from multimodal_fl_security_tpu_torch.rounds.local_train import train_clients

#: the kernel wrappers one SGD step launches, with their launches per step
#: (each wrapper runs the kernel of the compute dtype: ``conv_fwd`` the
#: stem's and conv2's pooled forward kernels, see ``_launch.KERNEL_LAUNCHES``)
STEP_KERNELS = {conv_fwd: 2, dense_fwd: 2, client_ce: 1, dense_bwd: 2,
                conv_wgrad: 2, conv_dgrad: 1, client_sq_norm: 1,
                client_sgd_update: 1}
#: kernel launches of one SGD step over all clients (12)
LAUNCHES_PER_STEP = sum(STEP_KERNELS.values())
#: the same with dropout: each mask applied forward and backward
DROPOUT_STEP_KERNELS = {**STEP_KERNELS, dropout_apply: 4}
#: kernel launches of one SGD step with dropout (16)
LAUNCHES_PER_DROPOUT_STEP = sum(DROPOUT_STEP_KERNELS.values())
#: the same with the round's drawn masks (``RoundDraws``; also 16)
DRAWN_DROPOUT_STEP_KERNELS = {**STEP_KERNELS, drawn_dropout: 4}


def step_forward(views, x, labels, mask, dtype, dropout=None):
    """Forward and loss of every client on batch ``x`` [C, B, cin, 28, 28]
    from the parameters' ``views``: returns each client's loss [C] and the
    tape that :func:`step_backward` reads. ``dropout`` is None or a
    step's masks (``PhiloxDropout``, ``RoundDraws``)."""
    f32 = torch.float32
    c, bsz = x.shape[:2]

    def drop(t, layer):  # the identity without dropout
        return t if dropout is None else dropout.apply(t, layer, dtype)

    h1, a1 = conv_fwd(x, views["conv1.weight"], views["conv1.bias"],
                      dtype=dtype, channels_last=True)
    h3, a3 = conv_fwd(h1, views["conv2.weight"], views["conv2.bias"],
                      dtype=dtype)
    f3 = h3.view(c, bsz, -1)  # (c, h, w) flatten: fc1.weight's input order
    f3d = drop(f3, 0)  # a new buffer: h3 stays as it is
    h4 = dense_fwd(f3d, views["fc1.weight"], views["fc1.bias"], relu=True,
                   wdtype=dtype, out_dtype=dtype)
    h4d = drop(h4, 1)
    logits = dense_fwd(h4d, views["fc2.weight"], views["fc2.bias"],
                       wdtype=f32, out_dtype=f32)
    loss, dlogits = client_ce(logits, labels, mask)
    return loss, (x, h1, a1, h3, a3, f3d, h4d, dlogits, dropout)


def step_backward(views, grads, tape, dtype) -> None:
    """The backward of :func:`step_forward`'s ``tape``: writes each layer's
    gradient into ``grads`` (views of the [C, D] gradient buffer)."""
    f32 = torch.float32
    x, h1, a1, h3, a3, f3d, h4d, dlogits, dropout = tape

    def drop(g, layer):  # the forward's masks again
        return g if dropout is None else dropout.again(g, layer, dtype)

    # mask=h4d zeroes where relu or the dropout did; drop() then scales.
    dz4 = drop(dense_bwd(dlogits, h4d, views["fc2.weight"],
                         grads["fc2.weight"], grads["fc2.bias"], mask=h4d,
                         wdtype=f32, gdtype=f32, dx_dtype=dtype), 1)
    dh3 = drop(dense_bwd(dz4, f3d, views["fc1.weight"], grads["fc1.weight"],
                         grads["fc1.bias"], wdtype=dtype, gdtype=dtype,
                         dx_dtype=dtype), 0).view(h3.shape)
    conv_wgrad(h1, dh3, h3, a3, grads["conv2.weight"], grads["conv2.bias"],
               dtype=dtype)
    dh1 = conv_dgrad(dh3, h3, a3, views["conv2.weight"], tuple(h1.shape[3:]),
                     dtype=dtype, channels_last=True)
    conv_wgrad(x, dh1, h1, a1, grads["conv1.weight"], grads["conv1.bias"],
               dtype=dtype)


def kernel_step_takes(model, spec, images: torch.Tensor) -> bool:
    """Whether :class:`KernelStep` trains this input in the round engine:
    the port's SimpleCNN at the kernels' widths (28x28 images, 10 classes,
    128 hidden) computing in f32 or bf16; ``images`` [C, N, cin, 28, 28]
    f32 on a CUDA device with 1-8 channels; ``spec``
    (``rounds/engine.py::TrainSpec``) at batch 32 with no weight decay and
    no label smoothing."""
    return (type(model) is SimpleCNN
            and model.image_size == (28, 28)
            and model.num_classes == NCLS
            and model.hidden_dim == HID
            and model.dtype in (torch.float32, torch.bfloat16)
            and kernels_take(images)
            and images.dtype == torch.float32
            and images.device.type == "cuda"
            and spec.batch_size == B
            and not spec.weight_decay and not spec.label_smoothing)


class KernelStep:
    """The step of ``rounds/local_train.py::train_clients`` on the kernels
    over three [C, D] buffers made once: the parameters (every client at the
    global ``params`` [D]), a zero momentum and the gradient. ``images``
    [C, N, cin, 28, 28] gives C and cin."""

    def __init__(self, params, images, compute_dtype, *, learning_rate,
                 momentum, clip_norm):
        layout = SimpleCNN(num_classes=NCLS).layout(images.shape[2])
        if params.shape[0] != layout.dim:
            raise ValueError(f"params has {params.shape[0]} elements; "
                             f"SimpleCNN at {images.shape[2]} channel(s) has "
                             f"{layout.dim}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute_dtype must be f32 or bf16, got "
                            f"{compute_dtype}")
        self.params = params.detach().float().expand(images.shape[0], -1) \
            .contiguous()
        self.mom = torch.zeros_like(self.params)
        self.grad = torch.empty_like(self.params)  # all written each step
        self.views, self.grads = (layout.views(self.params),
                                  layout.views(self.grad))
        self.dtype = compute_dtype
        self.sgd = dict(lr=learning_rate, momentum=momentum,
                        clip_norm=clip_norm)

    def forward(self, x, labels, mask, dropout):
        return step_forward(self.views, x, labels, mask, self.dtype, dropout)

    def backward(self, tape):
        step_backward(self.views, self.grads, tape, self.dtype)

    def update(self):
        client_sgd_update(self.params, self.mom, self.grad,
                          client_sq_norm(self.grad), **self.sgd)


def fused_local_train(params: torch.Tensor, images: torch.Tensor,
                      labels: torch.Tensor, bmask: torch.Tensor, *,
                      learning_rate: float, momentum: float = 0.9,
                      clip_norm: float = 1.0, local_epochs: int = 1,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      use_dropout: bool = False,
                      dropout_rates=(0.25, 0.5),
                      seed: int = 0) -> torch.Tensor:
    """Every client's local SGD from the global ``params`` [D] (f32, the
    port's ``FlatLayout`` for SimpleCNN): ``images`` [C, N, cin, 28, 28]
    (f32: the stem's bf16 weight gradient takes no other), ``labels`` and ``bmask`` [C, N] (0 = padded row), N a multiple of 32.
    Step s reads rows ``(s % steps)*32 .. +32``; ``local_epochs`` passes.
    Compute runs in ``compute_dtype`` (fc2 in f32); parameters and momentum
    stay f32. ``use_dropout`` drops fc1's input and output at
    ``dropout_rates`` with the masks of ``seed`` (``ops/philox.py``).
    Returns the clients' parameters [C, D]."""
    check_inputs(params, images, labels, bmask)
    keeps = tuple(check_rate(r) for r in dropout_rates) if use_dropout \
        else ()
    step = KernelStep(params, images, compute_dtype,
                      learning_rate=learning_rate, momentum=momentum,
                      clip_norm=clip_norm)
    return train_clients(step, PhiloxDropout(seed, keeps), images, labels,
                         bmask, local_epochs=local_epochs, batch_size=B)[0]
