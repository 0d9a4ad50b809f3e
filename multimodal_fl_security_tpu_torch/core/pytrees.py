"""Flat parameter buffers with per-layer views.

Counterpart of ``multimodal_fl_security_tpu/core/pytrees.py``. The JAX
package flattens a pytree of arrays into one f32 vector per client and
stacks the clients into a ``[C, D]`` matrix for the robust aggregators.
Here that matrix IS the storage: a model's parameters live in one flat f32
buffer (``[D]`` for the global model, ``[C, D]`` for the client stack), and
each layer is a view of its segment. Local training, the optimizer and
Krum all read and write the same buffer, so no flatten or unflatten copy
is ever made.

Segment order is the JAX package's leaf order (sorted module names, bias
before kernel), so flat vectors of the two packages line up segment by
segment; inside a segment each tensor keeps torch's own layout (OIHW
convolutions, ``[out, in]`` dense weights). ``models/from_jax.py``
converts between the two layouts.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


class FlatLayout:
    """An ordered list of named parameter shapes over one flat buffer."""

    def __init__(self, entries: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.entries = [(name, tuple(shape)) for name, shape in entries]
        self.offsets: Dict[str, Tuple[int, int]] = {}
        offset = 0
        for name, shape in self.entries:
            n = 1
            for s in shape:
                n *= int(s)
            self.offsets[name] = (offset, offset + n)
            offset += n
        self.dim = offset

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-layer views of ``flat`` (``[..., D]``), shaped ``[..., *shape]``.

        The views share storage with ``flat``: writing to one writes to the
        buffer, and gradients taken through them land in ``flat.grad``.
        """
        if flat.shape[-1] != self.dim:
            raise ValueError(
                f"flat buffer has {flat.shape[-1]} elements per row, "
                f"layout needs {self.dim}")
        lead = tuple(flat.shape[:-1])
        return {
            name: flat[..., lo:hi].view(lead + shape)
            for (name, shape), (lo, hi) in zip(self.entries,
                                               self.offsets.values())
        }

    def flatten(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Concatenate per-layer tensors (``[..., *shape]``) into ``[..., D]``."""
        first = tensors[self.entries[0][0]]
        lead = tuple(first.shape[: first.dim() - len(self.entries[0][1])])
        return torch.cat(
            [tensors[name].reshape(lead + (-1,)).to(torch.float32)
             for name, _ in self.entries], dim=-1)
