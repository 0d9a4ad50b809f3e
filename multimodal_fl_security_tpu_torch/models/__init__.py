"""Model families (SimpleCNN so far) over flat parameter buffers."""

from multimodal_fl_security_tpu_torch.models.registry import (  # noqa: F401
    MODELS,
    create_model,
    init_model,
)
from multimodal_fl_security_tpu_torch.models import simple_cnn  # noqa: F401
