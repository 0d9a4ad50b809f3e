"""Attack base contract.

Counterpart of ``multimodal_fl_security_tpu/attacks/base.py:24-84``. The
model-poisoning surface transforms the whole ``[C, D]`` update matrix under
a malicious mask in one call. Data poisoning (``poison_dataset``) waits for
the product-path slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_fl_security_tpu_torch.core.registry import Registry

ATTACKS: Registry = Registry("attack")


def get_attack(attack_type: str, config: Optional[Dict[str, Any]] = None):
    """Factory, mirroring the reference's get_attack (attacks/__init__.py:31-59)."""
    return ATTACKS.create(attack_type or "none", config or {})


class BaseAttack:
    name = "base"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.num_poisoned = 0

    def poison_updates(
        self,
        generator: torch.Generator,
        updates: torch.Tensor,         # [C, D] new parameter vectors
        global_flat: torch.Tensor,     # [D]
        malicious_mask: torch.Tensor,  # [C] 1.0 where malicious
        num_clients: int,
    ) -> torch.Tensor:
        """Transform the stacked update matrix. Default: passthrough."""
        return updates

    def is_data_poisoning(self) -> bool:
        return False

    def is_model_poisoning(self) -> bool:
        return False

    def get_metrics(self) -> Dict[str, Any]:
        return {"attack_type": self.name, "num_poisoned": self.num_poisoned}


@ATTACKS.register("none")
class NoAttack(BaseAttack):
    """Null attack (reference: base_attack.py:79-107)."""

    name = "none"


def masked_mean(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over rows where mask==1 (returns zeros if mask is empty).

    Shared by every update-space attack that estimates benign statistics
    (model_poisoning, alie, agr_agnostic)."""
    return (mask @ updates) / mask.sum().clamp_min(1e-12)

