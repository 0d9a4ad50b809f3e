"""ALIE — "A Little Is Enough" (Baruch, Baruch, Goldberg — NeurIPS'19).

Counterpart of ``multimodal_fl_security_tpu/attacks/alie.py``. Every
colluder submits

    crafted = benign_mean - z * benign_std        (coordinate-wise)

with z chosen just small enough that the crafted point still looks like a
plausible benign sample (paper §3): with n clients and m colluders, the
attackers need s = floor(n/2 + 1) - m benign "supporters", which holds when
z <= Phi^-1((n - m - s) / (n - m)), Phi the standard normal CDF. Config
``z`` overrides the derived value. z is host math (``scipy.stats.norm``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from scipy.stats import norm

from multimodal_fl_security_tpu_torch.attacks.base import (
    ATTACKS,
    BaseAttack,
    masked_mean,
)


def alie_z(num_clients: int, num_malicious: int) -> float:
    """The paper's z_max for n clients / m colluders (clipped to >= 0)."""
    n, m = int(num_clients), int(num_malicious)
    s = n // 2 + 1 - m
    denom = max(n - m, 1)
    phi = max(min((n - m - s) / denom, 1.0 - 1e-6), 0.5)
    return float(norm.ppf(phi))


@ATTACKS.register("alie")
class ALIEAttack(BaseAttack):
    name = "alie"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.num_malicious = int(self.config.get("num_malicious", 1))
        self.z = self.config.get("z")  # None = derive from (n, m)

    def poison_updates(self, generator, updates, global_flat, malicious_mask,
                       num_clients):
        benign = 1.0 - malicious_mask
        mean = masked_mean(updates, benign)
        var = masked_mean((updates - mean[None, :]) ** 2, benign)
        std = torch.sqrt(var.clamp_min(0.0))
        z = (float(self.z) if self.z is not None
             else alie_z(num_clients, self.num_malicious))
        return torch.where(malicious_mask[:, None] > 0,
                           mean - z * std, updates)

    def is_model_poisoning(self) -> bool:
        return True

    def get_metrics(self) -> Dict[str, Any]:
        return {"attack_type": self.name,
                "z": self.z if self.z is not None else "derived",
                "num_malicious": self.num_malicious}
