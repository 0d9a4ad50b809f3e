"""Reductions over the client axis of a [C, D] update matrix.

Counterpart of ``multimodal_fl_security_tpu/ops/reductions.py``. The median
takes the lower middle for even C (torch.median's convention, row
(C-1)//2), not the average of the two middles.

The JAX package takes its Pallas sorted reduction only at D >= 2M on a TPU,
a threshold measured there. Here every coordinate median and trimmed mean
of a CUDA tensor goes through the Hopper kernel (``ops/sorted_reduce.py``),
whatever D is, the same rule as the Gram's (``ops/pairwise.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodal_fl_security_tpu_torch.ops.sorted_reduce import sorted_reduce


def weighted_mean(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Example-count-weighted FedAvg (reference: base_defense.py:80-97)."""
    w = weights.to(torch.float32)
    return (w @ updates) / w.sum().clamp_min(1e-12)


def coordinate_median(updates: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median, lower-middle convention for even C."""
    return sorted_reduce(updates, "median")


def trimmed_mean(updates: torch.Tensor, trim_ratio: float = 0.1) -> torch.Tensor:
    """Trim ``max(1, int(C*ratio))`` per end, then mean; median fallback when
    over-trimmed (reference: trimmed_mean.py:66-72,92-103)."""
    c = updates.shape[0]
    t = max(1, int(c * trim_ratio))
    if 2 * t >= c:
        return coordinate_median(updates)
    return sorted_reduce(updates, "trimmed", t)


def weiszfeld(
    updates: torch.Tensor,
    y0: torch.Tensor,
    max_iters: int = 100,
    tol: float = 1e-5,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, int]:
    """Weiszfeld iterations from ``y0``: returns the point and the number of
    iterations run. Stops after the first iteration that moves the point by
    at most ``tol``, or after ``max_iters``: the JAX ``while_loop``
    (reductions.py:94-104), with the move read on the host each iteration."""
    y = y0
    for it in range(max_iters):
        dists = torch.sqrt(((updates - y[None, :]) ** 2).sum(dim=1)
                           .clamp_min(0.0))
        inv = 1.0 / dists.clamp_min(eps)
        y_new = (inv @ updates) / inv.sum()
        move = float(torch.sqrt(((y_new - y) ** 2).sum()))
        y = y_new
        if not move > tol:
            return y, it + 1
    return y, max_iters


def geometric_median(
    updates: torch.Tensor,
    max_iters: int = 100,
    tol: float = 1e-5,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Weiszfeld iterations, initialized at the coordinate median
    (reference: trimmed_mean.py:225-265)."""
    y, _ = weiszfeld(updates, coordinate_median(updates), max_iters, tol, eps)
    return y


def row_norms(updates: torch.Tensor, ord: str = "l2") -> torch.Tensor:
    if ord == "linf":
        return updates.abs().amax(dim=1)
    return torch.sqrt((updates ** 2).sum(dim=1).clamp_min(0.0))


def clip_rows(updates: torch.Tensor, clip_norm: float,
              ord: str = "l2") -> torch.Tensor:
    """Per-client norm clipping (reference: differential_privacy.py:74-95)."""
    norms = row_norms(updates, ord)
    scale = torch.clamp(clip_norm / norms.clamp_min(1e-12), max=1.0)
    return updates * scale[:, None]
