"""Byzantine attacks: the contract, the null attack and the in-round update
transforms (model_replacement, adaptive_krum, scaling, ipm, alie, min_max,
min_sum). Registry names match the JAX package's; data poisoning waits for
the product-path slice.
"""

from multimodal_fl_security_tpu_torch.attacks.base import (  # noqa: F401
    ATTACKS,
    BaseAttack,
    NoAttack,
    get_attack,
)
from multimodal_fl_security_tpu_torch.attacks import model_poisoning  # noqa: F401
from multimodal_fl_security_tpu_torch.attacks import agr_agnostic  # noqa: F401
from multimodal_fl_security_tpu_torch.attacks import alie  # noqa: F401
