"""Min-Max / Min-Sum AGR-agnostic model-poisoning attacks
(Shejwalkar & Houmansadr, NDSS'21, "Manipulating the Byzantine").

Counterpart of ``multimodal_fl_security_tpu/attacks/agr_agnostic.py``.
Crafted update: ``benign_mean + gamma * p`` where the perturbation ``p`` is
  - "std"  : -std(benign updates) per coordinate (strongest in the paper),
  - "sign" : -sign(benign_mean),
  - "unit" : -benign_mean / ||benign_mean||,
and gamma is the LARGEST value keeping the crafted update inside the benign
spread:
  Min-Max:  max_j ||crafted - u_j||  <=  max_{j,k} ||u_j - u_k||
  Min-Sum:  sum_j ||crafted - u_j||^2  <=  max_j sum_k ||u_j - u_k||^2
(j, k over benign clients).

||(mean - u_j) + gamma p||^2 is quadratic in gamma with coefficients
computed once (||mean - u_j||^2, <mean - u_j, p>, ||p||^2), so the
bisection over gamma is scalar math on 0-d device tensors: the [C, D]
matrix is read a fixed number of times. The uncentered ``updates @
updates.T`` is a plain f32 product, as in the JAX package; it assumes TF32
is off for matmuls (``torch.backends.cuda.matmul.allow_tf32``, PyTorch's
default). All malicious clients emit the same crafted vector.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_fl_security_tpu_torch.attacks.base import (
    ATTACKS,
    BaseAttack,
    masked_mean,
)


class _AGRAgnosticAttack(BaseAttack):
    mode = "min_max"  # overridden by subclasses

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.perturbation = str(self.config.get("perturbation", "std"))
        self.gamma_max = float(self.config.get("gamma_max", 50.0))
        self.bisection_steps = int(self.config.get("bisection_steps", 20))

    def _perturbation(self, updates, benign_mask, mean):
        if self.perturbation == "sign":
            return -torch.sign(mean)
        if self.perturbation == "unit":
            return -mean / torch.linalg.vector_norm(mean).clamp_min(1e-12)
        # "std": coordinate-wise std over benign clients.
        var = masked_mean((updates - mean[None, :]) ** 2, benign_mask)
        return -torch.sqrt(var.clamp_min(0.0))

    def poison_updates(self, generator, updates, global_flat, malicious_mask,
                       num_clients):
        benign = 1.0 - malicious_mask
        mean = masked_mean(updates, benign)
        p = self._perturbation(updates, benign, mean)

        # Quadratic coefficients of ||(mean - u_j) + gamma p||^2 per client.
        a = mean[None, :] - updates                       # [C, D]
        a2 = (a ** 2).sum(dim=1)                          # ||a_j||^2   [C]
        ap = a @ p                                        # <a_j, p>    [C]
        p2 = (p ** 2).sum()                               # ||p||^2     scalar
        del a

        # Benign pairwise squared distances (for the thresholds).
        sq = (updates ** 2).sum(dim=1)
        d2 = (sq[:, None] + sq[None, :] - 2.0 * (updates @ updates.T)
              ).clamp_min(0.0)
        d2b = torch.where(benign[:, None] * benign[None, :] > 0, d2, 0.0)

        if self.mode == "min_max":
            threshold = d2b.max()

            def excess(gamma):
                crafted_d2 = a2 + 2.0 * gamma * ap + gamma * gamma * p2
                crafted_d2 = torch.where(benign > 0, crafted_d2, 0.0)
                return crafted_d2.max() - threshold
        else:  # min_sum
            threshold = (d2b.sum(dim=1) * benign).max()

            def excess(gamma):
                crafted_d2 = a2 + 2.0 * gamma * ap + gamma * gamma * p2
                return (crafted_d2 * benign).sum() - threshold

        # Largest feasible gamma in [0, gamma_max] by bisection (the
        # feasible set {excess <= 0} is an interval containing 0: excess is
        # a max/sum of upward quadratics in gamma).
        lo = torch.zeros((), dtype=torch.float32, device=updates.device)
        hi = torch.full((), self.gamma_max, dtype=torch.float32,
                        device=updates.device)
        for _ in range(self.bisection_steps):
            mid = 0.5 * (lo + hi)
            ok = excess(mid) <= 0.0
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return torch.where(malicious_mask[:, None] > 0, mean + lo * p, updates)

    def is_model_poisoning(self) -> bool:
        return True

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "attack_type": self.name,
            "perturbation": self.perturbation,
            "gamma_max": self.gamma_max,
        }


@ATTACKS.register("min_max")
class MinMaxAttack(_AGRAgnosticAttack):
    name = "min_max"
    mode = "min_max"


@ATTACKS.register("min_sum")
class MinSumAttack(_AGRAgnosticAttack):
    name = "min_sum"
    mode = "min_sum"
