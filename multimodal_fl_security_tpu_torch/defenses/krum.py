"""Krum / Multi-Krum (Blanchard et al., NeurIPS'17).

Counterpart of ``multimodal_fl_security_tpu/defenses/krum.py``, with the
same semantics:
  - pairwise *Euclidean* (unsquared) distances between flattened updates;
  - score_i = sum of the n - f - 2 smallest distances from i (self excluded);
  - single Krum returns the argmin update; Multi-Krum returns the unweighted
    mean of the ``multi_k`` lowest-scoring updates;
  - requires n >= 2f + 3 (raises);
  - detect = the non-selected clients.

The distance matrix comes from the centered Gram matrix, which runs as the
Hopper kernel on a CUDA tensor (``ops/pairwise.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_fl_security_tpu_torch.defenses.base import DEFENSES, BaseDefense
from multimodal_fl_security_tpu_torch.ops.pairwise import pairwise_dists


class KrumDefense(BaseDefense):
    name = "krum"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.num_malicious = int(self.config.get("num_malicious", 1))
        self.multi_k = int(self.config.get("multi_k", 1))

    def _check(self, n: int) -> None:
        f = self.num_malicious
        if n < 2 * f + 3:
            raise ValueError(
                f"Krum requires n >= 2f + 3. Got n={n}, f={f}. "
                f"Need at least {2 * f + 3} clients."
            )

    def scores_from_dists(self, dists: torch.Tensor) -> torch.Tensor:
        """Krum scores from a precomputed [C, C] distance matrix."""
        n = dists.shape[0]
        self._check(n)
        num_neighbors = n - self.num_malicious - 2
        srt = torch.sort(dists, dim=1).values
        # srt[:, 0] is the zero self-distance; sum the next num_neighbors.
        return srt[:, 1 : num_neighbors + 1].sum(dim=1)

    def scores(self, updates: torch.Tensor) -> torch.Tensor:
        """Krum score per client: sum of n-f-2 nearest neighbor distances."""
        return self.scores_from_dists(pairwise_dists(updates))

    def aggregate_with_aux(self, updates, weights, ctx=None):
        n = updates.shape[0]
        k = min(self.multi_k, n)
        scores = self.scores(updates)
        # Lowest-k scores win; a stable argsort keeps the reference's
        # np.argsort tie order (reference: krum.py:172-175).
        selected = torch.argsort(scores, stable=True)[:k]
        selected_mask = torch.zeros(n, dtype=torch.float32,
                                    device=updates.device)
        selected_mask[selected] = 1.0
        # index_select copies the chosen rows, so the aggregate does not
        # keep the whole [C, D] buffer alive.
        agg = updates.index_select(0, selected).mean(dim=0)
        aux = {
            "krum_scores": scores,
            "selected_mask": selected_mask,
            "selected_first": selected[0],
        }
        return agg, aux

    def detect(self, updates, weights, ctx=None):
        _, aux = self.aggregate_with_aux(updates, weights, ctx)
        return 1.0 - aux["selected_mask"]

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "defense_type": self.name,
            "num_malicious": self.num_malicious,
            "multi_k": self.multi_k,
        }


@DEFENSES.register("krum")
def _make_krum(config):
    return KrumDefense(config)


@DEFENSES.register("multi_krum")
def _make_multi_krum(config):
    cfg = dict(config or {})
    # Reference default: multi_k = default_k (3) when unset (krum.py:225-237).
    cfg.setdefault("multi_k", cfg.get("default_k", 3))
    d = KrumDefense(cfg)
    d.name = "multi_krum"
    return d
