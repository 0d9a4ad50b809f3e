"""Model families over flat parameter buffers: SimpleCNN, ResNet-50 with
GroupNorm and ViT-B/16."""

from multimodal_fl_security_tpu_torch.models.registry import (  # noqa: F401
    MODELS,
    create_model,
    init_model,
)
from multimodal_fl_security_tpu_torch.models import simple_cnn  # noqa: F401
from multimodal_fl_security_tpu_torch.models import resnet  # noqa: F401
from multimodal_fl_security_tpu_torch.models import vit  # noqa: F401
