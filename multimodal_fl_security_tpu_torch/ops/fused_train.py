"""The plain whole-loop oracle of per-client local training.

Counterpart of ``multimodal_fl_security_tpu/ops/fused_train.py::
mirror_local_train`` (``:527-569``): every client's local SGD, in resident
batch order, built from the port's own ``SimpleCNN.forward``,
``torch.autograd``, ``cross_entropy`` and ``sgd_step``
(``rounds/engine.py``). Tests and ``chip_smoke.py`` hold
:func:`~multimodal_fl_security_tpu_torch.ops.fused_kernel.fused_local_train`
to it; nothing on that function's path calls it.

The JAX module's s2d packed layout (``[C, N, 60, 128]`` blocks,
``fused_train.py:39-52``) and its pack/unpack algebra exist for the TPU's
(8, 128) tiling and are not ported: both functions take logical images.
"""

from __future__ import annotations

import torch

from multimodal_fl_security_tpu_torch.ops.client_dropout import (
    check_rate,
    dropout_mask_plain,
)
from multimodal_fl_security_tpu_torch.ops.philox import (
    STREAM_FC1_IN,
    STREAM_FC1_OUT,
)

#: local batch size (``fused_train.py``'s B)
B = 32
#: classes of the SimpleCNN that local training runs
NCLS = 10

#: fc1's input width: the pooled [64, 7, 7] map, (c, h, w) flattened
F1 = 64 * 7 * 7
#: fc1's output width
HID = 128
#: input channels the stem's kernels take
MAX_CIN = 8


def kernels_take(images) -> bool:
    """Whether ``images`` have the shape the kernels train on:
    [C, N, cin, 28, 28] with 1 <= cin <= :data:`MAX_CIN`."""
    return (images.dim() == 5 and tuple(images.shape[3:]) == (28, 28)
            and 1 <= images.shape[2] <= MAX_CIN)


def check_inputs(params, images, labels, bmask):
    """Validate the trainers' shared arguments; returns (C, N, steps, cin)."""
    if not kernels_take(images):
        raise ValueError(f"images must be [C, N, cin, 28, 28] with 1 <= cin "
                         f"<= {MAX_CIN}, got {tuple(images.shape)}")
    c, n, cin = images.shape[:3]
    if tuple(labels.shape) != (c, n) or tuple(bmask.shape) != (c, n):
        raise ValueError(f"labels and bmask must be [C, N] = {(c, n)}")
    if n % B:
        raise ValueError(f"pad N to a multiple of the batch size {B}, got {n}")
    if params.dim() != 1:
        raise ValueError("params must be the global [D] buffer")
    return c, n, n // B, cin


def dropout_masks_plain(seed: int, clients: int, batch: int, steps: int,
                        rates=(0.25, 0.5), dtype: torch.dtype = torch.bfloat16,
                        device="cpu"):
    """The dropout masks of ``fused_local_train(use_dropout=True)`` for
    ``steps`` global steps, from the plain Philox generator: (m1 [S, C, B,
    3136] on fc1's input, m2 [S, C, B, 128] on its relu output), 1/keep
    where kept, in ``dtype``, as the JAX kernel makes them
    (``fused_kernel.py:403-413``; JAX's mirror takes them pre-scaled,
    ``fused_train.py:538-539``)."""
    keep1, keep2 = (check_rate(r) for r in rates)
    return tuple(torch.stack([
        dropout_mask_plain(seed, (clients, batch, width), s, stream, keep,
                           dtype, device)
        for s in range(steps)])
        for width, stream, keep in ((F1, STREAM_FC1_IN, keep1),
                                    (HID, STREAM_FC1_OUT, keep2)))


def mirror_local_train(params: torch.Tensor, images: torch.Tensor,
                       labels: torch.Tensor, bmask: torch.Tensor, *,
                       learning_rate: float, momentum: float = 0.9,
                       clip_norm: float = 1.0, local_epochs: int = 1,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       dropout_masks=None) -> torch.Tensor:
    """Every client's local SGD from the global ``params`` [D], as the
    engine trains it but in resident order: step s reads rows
    ``(s % steps)*32 .. +32`` of each client's ``images`` [C, N, cin, 28,
    28], ``labels`` and ``bmask`` [C, N]; masked mean CE; clip at global
    norm ``clip_norm`` per client, momentum, lr; a fresh zero momentum per
    client; no weight decay. ``dropout_masks`` = (m1 [S, C, B, 3136],
    m2 [S, C, B, 128]), pre-scaled and indexed by global step (those of
    ``fused_local_train(use_dropout=True, seed=...)`` come from
    :func:`dropout_masks_plain`), or None for no dropout. Returns the
    clients' [C, D]."""
    from multimodal_fl_security_tpu_torch.models.simple_cnn import SimpleCNN
    from multimodal_fl_security_tpu_torch.rounds.engine import (
        TrainSpec,
        cross_entropy,
        sgd_step,
    )

    c, _, steps, _ = check_inputs(params, images, labels, bmask)
    model = SimpleCNN(num_classes=NCLS, dtype=compute_dtype,
                      dropout_rates=(0.0, 0.0))
    spec = TrainSpec(learning_rate=learning_rate, momentum=momentum,
                     weight_decay=0.0, clip_norm=clip_norm,
                     local_epochs=local_epochs, batch_size=B)
    stacked = params.detach().float().expand(c, -1).clone()
    stacked.requires_grad_(True)
    trace = torch.zeros_like(stacked)
    for s in range(local_epochs * steps):
        i = (s % steps) * B
        # the given masks times each layer's activation in the compute
        # dtype, as the JAX package's fused_train.py:404-412 applies them
        drop = None if dropout_masks is None else (
            lambda t, layer, s=s:
            t * dropout_masks[layer][s].to(t.dtype).reshape(t.shape))
        logits = model(stacked, images[:, i:i + B], drop)
        losses = cross_entropy(logits, labels[:, i:i + B], bmask[:, i:i + B])
        stacked.grad = None
        losses.sum().backward()  # disjoint rows: row c is client c's gradient
        with torch.no_grad():
            sgd_step(stacked, stacked.grad, trace, spec)
    stacked.grad = None
    return stacked.detach()
