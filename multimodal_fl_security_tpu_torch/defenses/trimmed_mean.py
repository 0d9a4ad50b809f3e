"""Trimmed mean, coordinate median, geometric median defenses.

Counterpart of ``multimodal_fl_security_tpu/defenses/trimmed_mean.py``, with
the same semantics:
  - trimmed mean drops max(1, int(C * trim_ratio)) per end of the sorted
    client axis and means the rest; falls back to the coordinate median when
    over-trimmed;
  - coordinate median uses torch's lower-middle tie convention;
  - geometric median runs Weiszfeld from the coordinate median with distance
    clamp 1e-10, tolerance 1e-5, max 100 iterations.

The sorted reductions run as the Hopper kernel on a CUDA tensor
(``ops/sorted_reduce.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from multimodal_fl_security_tpu_torch.defenses.base import DEFENSES, BaseDefense
from multimodal_fl_security_tpu_torch.ops.reductions import (
    coordinate_median,
    geometric_median,
    trimmed_mean,
)


@DEFENSES.register("trimmed_mean")
class TrimmedMeanDefense(BaseDefense):
    name = "trimmed_mean"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.trim_ratio = float(self.config.get("trim_ratio", 0.1))

    def aggregate_with_aux(self, updates, weights, ctx=None):
        return trimmed_mean(updates, self.trim_ratio), {}

    def get_metrics(self):
        return {"defense_type": self.name, "trim_ratio": self.trim_ratio}


@DEFENSES.register("median")
class MedianDefense(BaseDefense):
    name = "median"

    def aggregate_with_aux(self, updates, weights, ctx=None):
        return coordinate_median(updates), {}


@DEFENSES.register("geometric_median")
class GeometricMedianDefense(BaseDefense):
    name = "geometric_median"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.max_iters = int(self.config.get("max_iters", 100))
        self.tol = float(self.config.get("tol", 1e-5))

    def aggregate_with_aux(self, updates, weights, ctx=None):
        agg = geometric_median(updates, max_iters=self.max_iters, tol=self.tol)
        return agg, {}

    def get_metrics(self):
        return {
            "defense_type": self.name,
            "max_iters": self.max_iters,
            "tol": self.tol,
        }
