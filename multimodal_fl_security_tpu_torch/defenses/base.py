"""Defense base contract + FedAvg.

Counterpart of ``multimodal_fl_security_tpu/defenses/base.py``. A defense
consumes the dense ``[C, D]`` f32 matrix of client updates and the example
counts. Updates are *new parameter vectors* (not deltas), matching the
reference's weight-exchange convention.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from multimodal_fl_security_tpu_torch.core.registry import Registry
from multimodal_fl_security_tpu_torch.ops.reductions import weighted_mean

DEFENSES: Registry = Registry("defense")


def get_defense(defense_type: str, config: Optional[Dict[str, Any]] = None):
    """Factory, mirroring the reference's get_defense (defenses/__init__.py:28-59)."""
    return DEFENSES.create(defense_type or "none", config or {})


class BaseDefense:
    """Base class. Subclasses override ``aggregate_with_aux``.

    ``ctx`` carries round context:
      - "global": [D] current global params
      - "generator": ``torch.Generator`` for randomized defenses
    """

    name = "base"
    #: set by defenses that need ctx["server_grad"] (FLTrust; not ported yet)
    needs_server_grad = False
    #: stateful defenses (FoolsGold, centered clipping; not ported yet)
    stateful = False

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})

    def aggregate_with_aux(
        self, updates: torch.Tensor, weights: torch.Tensor,
        ctx: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def detect(self, updates: torch.Tensor, weights: torch.Tensor,
               ctx: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Suspicion mask [C] (1.0 = flagged malicious). Default: none."""
        return torch.zeros(updates.shape[0], dtype=torch.float32,
                           device=updates.device)

    def get_metrics(self) -> Dict[str, Any]:
        return {"defense_type": self.name}


@DEFENSES.register("none", "fedavg")
class NoDefense(BaseDefense):
    """Example-count-weighted FedAvg (reference: base_defense.py:80-97)."""

    name = "fedavg"

    def aggregate_with_aux(self, updates, weights, ctx=None):
        return weighted_mean(updates, weights), {}
