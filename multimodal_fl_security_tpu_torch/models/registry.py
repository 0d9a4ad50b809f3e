"""Model registry + init helper."""

from __future__ import annotations

import torch

from multimodal_fl_security_tpu_torch.core.registry import Registry

MODELS: Registry = Registry("model")


def create_model(name: str, num_classes: int = 10, **kwargs):
    """Instantiate a model by registry name (a parameter-free module;
    :func:`init_model` creates its flat parameter buffer)."""
    return MODELS.create(name, num_classes=num_classes, **kwargs)


def init_model(model, in_channels: int, seed: int = 0,
               device="cpu") -> torch.Tensor:
    """A fresh ``[D]`` f32 parameter buffer on ``device``.

    The draw is made on the CPU from ``seed`` and then moved, so a seed
    gives the same parameters on every device.
    """
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return model.init_params(in_channels, gen).to(device)
