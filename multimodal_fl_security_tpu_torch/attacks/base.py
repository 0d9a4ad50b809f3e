"""Attack base contract.

Counterpart of ``multimodal_fl_security_tpu/attacks/base.py:24-75``. The
model-poisoning surface transforms the whole ``[C, D]`` update matrix under
a malicious mask in one call. This slice ports the contract and the null
attack; data poisoning waits for a later slice.
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


@ATTACKS.register("none")
class NoAttack(BaseAttack):
    """Null attack (reference: base_attack.py:79-107)."""

    name = "none"
