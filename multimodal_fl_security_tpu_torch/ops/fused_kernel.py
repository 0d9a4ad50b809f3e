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
``FlatLayout``): no per-step copies of weights or gradients. The call
allocates the three ``[C, D]`` buffers (params, momentum, gradient) once;
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

:func:`kernel_local_train` is the round engine's trainer for the input
that ``rounds/engine.py::kernel_trainer_takes`` admits: the same step on
the same kernels, with the batch orders and dropout uniforms drawn from the
round's ``torch.Generator`` as the engine's autograd trainer draws them
(the masks applied by ``drawn_dropout``), and each client's loss returned.
"""

from __future__ import annotations

import torch

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
    DrawnDropout,
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
    F1,
    HID,
    NCLS,
    check_inputs,
)
from multimodal_fl_security_tpu_torch.utils import tracing

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
#: the same with the drawn masks of :func:`kernel_local_train` (also 16)
DRAWN_DROPOUT_STEP_KERNELS = {**STEP_KERNELS, drawn_dropout: 4}


def step_forward(views, x, labels, mask, dtype, dropout=None):
    """Forward and loss of every client on batch ``x`` [C, B, cin, 28, 28]
    from the parameters' ``views``: returns each client's loss [C] and the
    tape that :func:`step_backward` reads. ``dropout`` is None or a mask
    source (``PhiloxDropout``, ``DrawnDropout``)."""
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
    return loss, (x, h1, a1, h3, a3, f3d, h4d, dlogits, drop)


def step_backward(views, grads, tape, dtype) -> None:
    """The backward of :func:`step_forward`'s ``tape``: writes each layer's
    gradient into ``grads`` (views of the [C, D] gradient buffer)."""
    f32 = torch.float32
    x, h1, a1, h3, a3, f3d, h4d, dlogits, drop = tape
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


def step_grads(views, grads, x, labels, mask, dtype,
               dropout=None) -> torch.Tensor:
    """Forward, loss and backward of every client on batch ``x``
    [C, B, cin, 28, 28]: writes each layer's gradient into ``grads`` (views
    of the [C, D] gradient buffer) from the parameters' ``views``, and
    returns each client's loss [C]. ``dropout`` is None or a mask source
    (``PhiloxDropout``, ``DrawnDropout``)."""
    loss, tape = step_forward(views, x, labels, mask, dtype, dropout)
    step_backward(views, grads, tape, dtype)
    return loss


def _client_buffers(params, clients, cin, compute_dtype):
    """The call's [C, D] parameters (every client at the global
    ``params``), zero momentum and gradient, and the layer views of the
    parameters and the gradient."""
    from multimodal_fl_security_tpu_torch.models.simple_cnn import SimpleCNN

    layout = SimpleCNN(num_classes=NCLS).layout(cin)
    if params.shape[0] != layout.dim:
        raise ValueError(f"params has {params.shape[0]} elements; SimpleCNN "
                         f"at {cin} channel(s) has {layout.dim}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be f32 or bf16, got "
                        f"{compute_dtype}")
    p = params.detach().float().expand(clients, -1).contiguous()
    mom = torch.zeros_like(p)
    grad = torch.empty_like(p)  # every element is written each step
    return p, mom, grad, layout.views(p), layout.views(grad)


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
    c, _, steps, cin = check_inputs(params, images, labels, bmask)
    keeps = tuple(check_rate(r) for r in dropout_rates) if use_dropout \
        else ()
    p, mom, grad, views, grads = _client_buffers(params, c, cin,
                                                 compute_dtype)
    labels = labels.long()
    mask = bmask.float()
    for s in range(local_epochs * steps):
        i = (s % steps) * B
        step_grads(views, grads, images[:, i:i + B], labels[:, i:i + B],
                   mask[:, i:i + B], compute_dtype,
                   PhiloxDropout(seed, s, keeps) if use_dropout else None)
        client_sgd_update(p, mom, grad, client_sq_norm(grad),
                          lr=learning_rate, momentum=momentum,
                          clip_norm=clip_norm)
    return p


def kernel_local_train(params: torch.Tensor, images: torch.Tensor,
                       labels: torch.Tensor, bmask: torch.Tensor,
                       generator: torch.Generator, *, learning_rate: float,
                       momentum: float = 0.9, clip_norm: float = 1.0,
                       local_epochs: int = 1,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       dropout_rates=(0.25, 0.5)):
    """Every client's local SGD from the global ``params`` [D] on the
    kernels, trained and drawn as ``rounds/engine.py``'s autograd trainer
    trains and draws: per epoch a fresh order of each client's rows,
    ``torch.rand(bmask.shape).argsort(dim=1)`` from ``generator``; per step,
    for each of fc1's dropout layers at a rate above 0, its uniforms
    ``torch.rand([C, B, F])`` (fc1's input, then its relu output); step s of
    an epoch reads each client's rows ``order[s*32 : s*32+32]``.
    ``images`` [C, N, cin, 28, 28] f32, ``labels`` [C, N], ``bmask`` [C, N]
    f32 (0 = padded row). Returns the clients' parameters [C, D] and each
    client's loss [C]: the mean over epochs of the mean of its steps'
    losses. On CPU tensors every kernel's plain version runs.
    ``kernel_local_train.calls`` counts calls.

    While a profiler session records, each step is three spans
    (``utils/tracing.py``): ``forward`` (the draws, the gathers and the
    launches through ``client_ce``), ``backward`` and ``optimizer``."""
    c, _, steps, cin = check_inputs(params, images, labels, bmask)
    keeps = tuple(check_rate(r) for r in dropout_rates)
    p, mom, grad, views, grads = _client_buffers(params, c, cin,
                                                 compute_dtype)
    device = bmask.device
    rows = torch.arange(c, device=device).unsqueeze(1)
    labels, mask = labels.long(), bmask.float()
    epoch_losses = []
    for _ in range(local_epochs):
        perm = torch.rand(bmask.shape, generator=generator,
                          device=device).argsort(dim=1)
        step_losses = []
        for s in range(steps):
            with tracing.span("forward", device):
                uniforms = tuple(
                    torch.rand((c, B, width), generator=generator,
                               device=device) if keep < 1.0 else None
                    for width, keep in zip((F1, HID), keeps))
                idx = perm[:, s * B:(s + 1) * B]
                loss, tape = step_forward(
                    views, images[rows, idx], labels.gather(1, idx),
                    mask.gather(1, idx), compute_dtype,
                    DrawnDropout(uniforms, keeps))
            with tracing.span("backward", device):
                step_backward(views, grads, tape, compute_dtype)
            with tracing.span("optimizer", device):
                client_sgd_update(p, mom, grad, client_sq_norm(grad),
                                  lr=learning_rate, momentum=momentum,
                                  clip_norm=clip_norm)
            step_losses.append(loss)
        epoch_losses.append(torch.stack(step_losses).mean(dim=0))
    kernel_local_train.calls += 1
    return p, torch.stack(epoch_losses).mean(dim=0)


kernel_local_train.calls = 0
