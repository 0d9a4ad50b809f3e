"""The port's one loop of local training, which the round engine and
``ops/fused_kernel.py::fused_local_train`` run. The caller chooses the step
(``rounds/engine.py::AutogradStep``, ``ops/fused_kernel.py::KernelStep``),
which holds the clients' [C, D] ``params`` and optimizer state, and the
draws (``ops/client_dropout.py``: ``RoundDraws``, ``PhiloxDropout``): an
epoch's batch ``order(mask)`` [C, N], None for the rows as they lie, and
each global step's dropout ``masks(step)``."""

from __future__ import annotations

import torch

from multimodal_fl_security_tpu_torch.utils import tracing


def train_clients(step, draws, images, labels, mask, *, local_epochs: int,
                  batch_size: int):
    """``local_epochs`` passes of ``step`` over every client's ``images``
    [C, N, ...], ``labels`` and ``mask`` [C, N] (0 = padded row); step s of
    an epoch reads rows ``order[:, s*B : s*B+B]``. Returns the clients'
    parameters [C, D] and each client's loss [C], the mean over epochs of
    the mean of its steps' losses. While a profiler session records, each
    step is three spans (``utils/tracing.py``): ``forward`` (the gathers,
    the draws and the forward through the loss), ``backward``,
    ``optimizer``."""
    clients, n = mask.shape
    steps, device = n // batch_size, mask.device
    rows = torch.arange(clients, device=device).unsqueeze(1)
    labels, mask = labels.long(), mask.float()
    epoch_losses = []
    for epoch in range(local_epochs):
        order = draws.order(mask)
        step_losses = []
        for s in range(steps):
            with tracing.span("forward", device):
                lo, hi = s * batch_size, (s + 1) * batch_size
                if order is None:
                    x, y, m = (images[:, lo:hi], labels[:, lo:hi],
                               mask[:, lo:hi])
                else:
                    idx = order[:, lo:hi]
                    x, y, m = (images[rows, idx], labels.gather(1, idx),
                               mask.gather(1, idx))
                loss, tape = step.forward(x, y, m,
                                          draws.masks(epoch * steps + s))
            with tracing.span("backward", device):
                step.backward(tape)
            with tracing.span("optimizer", device):
                step.update()
            step_losses.append(loss)
        epoch_losses.append(torch.stack(step_losses).mean(dim=0))
    return step.params.detach(), torch.stack(epoch_losses).mean(dim=0)
