"""Evaluation metrics.

Counterpart of ``multimodal_fl_security_tpu/utils/metrics.py:35-97``
(``evaluate_model``: clean accuracy and mean cross-entropy over a test set,
in eval mode). The other metrics wait for a later slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F


@torch.no_grad()
def evaluate_model(model, params: torch.Tensor,
                   dataset: Mapping[str, torch.Tensor],
                   batch_size: int = 512) -> Dict[str, float]:
    """Accuracy + mean loss of the global ``[D]`` buffer ``params`` over
    ``dataset`` (``"image"`` ``[N, ch, H, W]`` and ``"label"`` ``[N]``, on
    the params' device), without dropout (reference: metrics.py:14-59)."""
    images, labels = dataset["image"], dataset["label"].long()
    correct = torch.zeros((), dtype=torch.float32, device=params.device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=params.device)
    for lo in range(0, labels.shape[0], batch_size):
        logits = model(params, images[lo:lo + batch_size], train=False)
        y = labels[lo:lo + batch_size]
        correct += (logits.argmax(dim=-1) == y).sum()
        loss_sum += F.cross_entropy(logits.float(), y, reduction="sum")
    count = int(labels.shape[0])
    return {
        "accuracy": float(correct) / max(count, 1),
        "loss": float(loss_sum) / max(count, 1),
        "num_samples": count,
    }
