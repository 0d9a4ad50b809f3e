"""Model (update-space) poisoning attacks, vectorized over the client axis.

Counterpart of ``multimodal_fl_security_tpu/attacks/model_poisoning.py``,
with the same semantics:
  - ``ModelReplacementAttack``: delta = update - global, scaled by
    boost_factor or (num_clients / num_malicious) * scale_factor, re-added to
    the global params;
  - ``AdaptiveKrumAttack``: estimate the benign center and emit
    center + perturbation_scale * noise, evading Krum's distance scoring;
    the noise comes from the round's ``torch.Generator``;
  - ``ScalingAttack``: multiply the raw parameter vector by ``scale``;
  - ``InnerProductManipulationAttack``: -epsilon * sign(benign_mean), or
    plain negation when ``use_benign_mean`` is off.

Each attack is one masked transform of the whole [C, D] matrix; benign
statistics are masked reductions over the same matrix.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_fl_security_tpu_torch.attacks.base import (
    ATTACKS,
    BaseAttack,
    masked_mean,
)


@ATTACKS.register("model_replacement")
class ModelReplacementAttack(BaseAttack):
    name = "model_replacement"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.scale_factor = float(self.config.get("scale_factor", 10.0))
        self.num_malicious = int(self.config.get("num_malicious", 1))
        self.boost_factor = self.config.get("boost_factor", None)

    def poison_updates(self, generator, updates, global_flat, malicious_mask,
                       num_clients):
        if self.boost_factor is not None:
            scale = float(self.boost_factor)
        else:
            scale = (num_clients / max(self.num_malicious, 1)) * self.scale_factor
        boosted = global_flat[None, :] + (updates - global_flat[None, :]) * scale
        return torch.where(malicious_mask[:, None] > 0, boosted, updates)

    def is_model_poisoning(self) -> bool:
        return True

    def get_metrics(self):
        return {
            "attack_type": self.name,
            "scale_factor": self.scale_factor,
            "num_malicious": self.num_malicious,
        }


@ATTACKS.register("adaptive_krum")
class AdaptiveKrumAttack(BaseAttack):
    name = "adaptive_krum"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.perturbation_scale = float(self.config.get("perturbation_scale", 0.1))

    def poison_updates(self, generator, updates, global_flat, malicious_mask,
                       num_clients):
        center = masked_mean(updates, 1.0 - malicious_mask)
        noise = self.perturbation_scale * torch.randn(
            updates.shape, generator=generator, device=updates.device,
            dtype=updates.dtype)
        return torch.where(malicious_mask[:, None] > 0,
                           center[None, :] + noise, updates)

    def is_model_poisoning(self) -> bool:
        return True

    def get_metrics(self):
        return {
            "attack_type": self.name,
            "perturbation_scale": self.perturbation_scale,
        }


@ATTACKS.register("scaling")
class ScalingAttack(BaseAttack):
    name = "scaling"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.scale = float(self.config.get("scale", 10.0))

    def poison_updates(self, generator, updates, global_flat, malicious_mask,
                       num_clients):
        return torch.where(malicious_mask[:, None] > 0,
                           updates * self.scale, updates)

    def is_model_poisoning(self) -> bool:
        return True

    def get_metrics(self):
        return {"attack_type": self.name, "scale": self.scale}


@ATTACKS.register("ipm")
class InnerProductManipulationAttack(BaseAttack):
    """Xie et al., "Fall of Empires": negative-inner-product updates."""

    name = "ipm"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.epsilon = float(self.config.get("epsilon", 0.1))
        self.use_benign_mean = bool(self.config.get("use_benign_mean", True))

    def poison_updates(self, generator, updates, global_flat, malicious_mask,
                       num_clients):
        if self.use_benign_mean:
            benign_mean = masked_mean(updates, 1.0 - malicious_mask)
            crafted = -self.epsilon * torch.sign(benign_mean)
        else:
            crafted = -updates
        return torch.where(malicious_mask[:, None] > 0, crafted, updates)

    def is_model_poisoning(self) -> bool:
        return True

    def get_metrics(self):
        return {"attack_type": self.name, "epsilon": self.epsilon}
