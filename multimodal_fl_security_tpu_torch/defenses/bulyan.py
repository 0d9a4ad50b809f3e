"""Bulyan (El Mhamdi, Guerraoui, Rouault — ICML'18).

Counterpart of ``multimodal_fl_security_tpu/defenses/bulyan.py``, with the
same semantics (requires n >= 4f + 3):
  1. SELECTION: iterated Krum, theta = n - 2f times; each iteration scores
     the still-active clients (sum of the m - f - 2 nearest active
     distances, m = current active count) and moves the lowest score (the
     first, on a tie) into the selected set.
  2. AGGREGATION: the coordinate-wise trimmed mean of the theta selected
     updates, trimming f per end (the middle beta = theta - 2f values).

The distances come from one centered Gram matrix (the Hopper kernel on a
CUDA tensor, ``ops/pairwise.py``); the selection iterations are masked
sorts of that fixed [C, C] matrix; the aggregate is one sorted reduction
over the gathered [theta, D] block (the Hopper kernel on a CUDA tensor,
``ops/sorted_reduce.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_fl_security_tpu_torch.defenses.base import DEFENSES, BaseDefense
from multimodal_fl_security_tpu_torch.ops.pairwise import pairwise_dists
from multimodal_fl_security_tpu_torch.ops.sorted_reduce import sorted_reduce


@DEFENSES.register("bulyan")
class BulyanDefense(BaseDefense):
    name = "bulyan"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.num_malicious = int(self.config.get("num_malicious", 1))

    def _check(self, n: int) -> None:
        f = self.num_malicious
        if n < 4 * f + 3:
            raise ValueError(
                f"Bulyan requires n >= 4f + 3. Got n={n}, f={f}. "
                f"Need at least {4 * f + 3} clients."
            )

    def select_from_dists(self, dists: torch.Tensor) -> torch.Tensor:
        """Iterated-Krum selection from a precomputed [C, C] distance
        matrix: indices [theta] (int64) of the chosen clients, in order."""
        n = dists.shape[0]
        f = self.num_malicious
        self._check(n)
        theta = n - 2 * f
        inf = torch.tensor(float("inf"), device=dists.device)
        col = torch.arange(n, device=dists.device)
        active = torch.ones(n, dtype=torch.bool, device=dists.device)
        selected = torch.zeros(theta, dtype=torch.int64, device=dists.device)
        for t in range(theta):
            m = n - t  # active count this iteration
            # Distances to inactive clients become +inf; sorted index 0 of
            # an active row is its zero self-distance.
            srt = torch.sort(torch.where(active[None, :], dists, inf),
                             dim=1).values
            take = (col >= 1) & (col <= m - f - 2)
            scores = torch.where(take[None, :], srt, 0.0).sum(dim=1)
            best = torch.argmin(torch.where(active, scores, inf))
            active[best] = False
            selected[t] = best
        return selected

    def select(self, updates: torch.Tensor) -> torch.Tensor:
        """Iterated-Krum selection: indices [theta] of the chosen clients."""
        return self.select_from_dists(pairwise_dists(updates))

    def aggregate_with_aux(self, updates, weights, ctx=None):
        n = updates.shape[0]
        f = self.num_malicious
        selected = self.select(updates)
        theta = selected.shape[0]
        # Sorted mean of the middle beta = theta - 2f rows of the gathered
        # [theta, D] block: jnp.sort + mean at JAX bulyan.py:96-97.
        agg = sorted_reduce(updates.index_select(0, selected), "trimmed", f)
        mask = torch.zeros(n, dtype=torch.float32, device=updates.device)
        mask[selected] = 1.0
        return agg, {"selected_mask": mask,
                     "num_selected": torch.tensor(theta, dtype=torch.int32,
                                                  device=updates.device)}

    def detect(self, updates, weights, ctx=None):
        _, aux = self.aggregate_with_aux(updates, weights, ctx)
        return 1.0 - aux["selected_mask"]

    def get_metrics(self) -> Dict[str, Any]:
        return {"defense_type": self.name,
                "num_malicious": self.num_malicious}
