"""Byzantine attacks (the contract and the null attack so far)."""

from multimodal_fl_security_tpu_torch.attacks.base import (  # noqa: F401
    ATTACKS,
    BaseAttack,
    NoAttack,
    get_attack,
)
