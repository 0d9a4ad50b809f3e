"""Model registry + init helper."""

from __future__ import annotations

import torch

from multimodal_fl_security_tpu_torch.core.registry import Registry

MODELS: Registry = Registry("model")


def create_model(name: str, num_classes: int = 10, **kwargs):
    """Instantiate a model by registry name (a parameter-free module;
    :func:`init_model` creates its flat parameter buffer)."""
    return MODELS.create(name, num_classes=num_classes, **kwargs)


def target_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is visible (the port's entry points default to the card and never
    carry on on the CPU unless the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device=\"cpu\" "
                           "to run on the CPU")
    return device


def init_model(model, in_channels: int, seed: int = 0,
               device="cuda") -> torch.Tensor:
    """A fresh ``[D]`` f32 parameter buffer on ``device`` (the card unless
    the caller names another).

    The draw is made on the CPU from ``seed`` and then moved, so a seed
    gives the same parameters on every device.
    """
    device = target_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return model.init_params(in_channels, gen).to(device)
