"""Pairwise distance ops over the client axis.

Counterpart of ``multimodal_fl_security_tpu/ops/pairwise.py``. The whole
[C, C] matrix comes from one centered Gram matrix::

    ||u_i - u_j||^2 = ||u_i||^2 + ||u_j||^2 - 2 <u_i, u_j>

Updates are mean-centered first: distances are translation-invariant, and
centering shrinks the vector norms by orders of magnitude, which keeps the
Gram-trick cancellation error negligible in f32 even for near-identical
parameter vectors with large norms.

The JAX package takes its Pallas Gram only at D >= 2M on a TPU, a
threshold measured there. Here :func:`pairwise_dists` sends every CUDA
tensor through the Hopper kernel (``ops/gram.py``), whatever D is, until a
threshold is measured on the card.
"""

from __future__ import annotations

import torch

from multimodal_fl_security_tpu_torch.ops.gram import (
    gram,
    gram_plain,
    sq_dists_from_gram,
)


def pairwise_sq_dists(updates: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance matrix [C, C] from updates [C, D], by the
    plain centered Gram in torch (the reference for the kernel path)."""
    return sq_dists_from_gram(gram_plain(updates))


def pairwise_dists(updates: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix (the reference's Krum uses unsquared L2).
    The Gram kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return torch.sqrt(sq_dists_from_gram(gram(updates)))
