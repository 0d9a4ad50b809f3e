"""Reductions over the client axis of a [C, D] update matrix.

Counterpart of ``multimodal_fl_security_tpu/ops/reductions.py``; this slice
ports only the FedAvg mean.
"""

from __future__ import annotations

import torch


def weighted_mean(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Example-count-weighted FedAvg (reference: base_defense.py:80-97)."""
    w = weights.to(torch.float32)
    return (w @ updates) / w.sum().clamp_min(1e-12)
