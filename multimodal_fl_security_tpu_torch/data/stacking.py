"""Client-stacked data on one device.

Counterpart of ``multimodal_fl_security_tpu/data/stacking.py:41-64``. Every
modality is stacked to ``[C, N_max, ...]`` with a validity mask, so local
training runs all clients as one batch dimension. Ragged shards are padded
to ``N_max``; the mask zeroes padded samples out of the loss, and the true
example counts weight FedAvg.

Arrays keep their logical shape (images ``[C, N, ch, H, W]``, torch's
channel-first order). The JAX package's flat and space-to-depth resident
layouts exist for the TPU's (8, 128) tiling and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch


@dataclass
class ClientData:
    """Client-stacked tensors, all on one device.

    arrays: modality name -> [C, N_max, ...] (includes "label": [C, N_max])
    mask:   [C, N_max] float32 — 1.0 for real samples, 0.0 for padding
    counts: [C] int32 — true shard sizes (FedAvg weights)
    """

    arrays: Dict[str, torch.Tensor]
    mask: torch.Tensor
    counts: torch.Tensor
    num_classes: int

    @property
    def num_clients(self) -> int:
        return self.mask.shape[0]

    @property
    def max_samples(self) -> int:
        return self.mask.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], mask: np.ndarray,
                   counts: np.ndarray, num_classes: int,
                   device) -> "ClientData":
        """Copy host arrays to ``device`` (labels as int64, mask as f32)."""
        tensors = {k: torch.as_tensor(np.asarray(v), device=device)
                   for k, v in arrays.items()}
        tensors["label"] = tensors["label"].long()
        return cls(
            arrays=tensors,
            mask=torch.as_tensor(np.asarray(mask, np.float32), device=device),
            counts=torch.as_tensor(np.asarray(counts, np.int32), device=device),
            num_classes=int(num_classes),
        )
