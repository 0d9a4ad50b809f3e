"""Robust aggregation defenses: FedAvg, Krum / Multi-Krum, trimmed mean,
coordinate median, geometric median and Bulyan so far.

Registry names match the JAX package's; every defense's
``aggregate(updates [C, D], weights [C], ctx)`` runs on the updates' device.
"""

from multimodal_fl_security_tpu_torch.defenses.base import (  # noqa: F401
    DEFENSES,
    BaseDefense,
    NoDefense,
    get_defense,
)
from multimodal_fl_security_tpu_torch.defenses import krum  # noqa: F401
from multimodal_fl_security_tpu_torch.defenses import trimmed_mean  # noqa: F401
from multimodal_fl_security_tpu_torch.defenses import bulyan  # noqa: F401
