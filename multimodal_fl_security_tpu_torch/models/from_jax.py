"""Convert the JAX package's model parameters to the port's layout.

Each leaf of the port's flat vector (``core/pytrees.py``) stands for one
leaf of the flax parameter tree (:func:`jax_paths`); the JAX package's flat
vector orders the flax leaves by their sorted paths (``jax.tree_util``'s
order), which for SimpleCNN is the port's own order and for ResNet a
permutation of it (the port keeps torchvision's ``state_dict`` order).
Inside a leaf each package keeps its own framework's layout:

- convolutions: flax HWIO -> torch OIHW;
- dense layers: flax ``[in, out]`` -> torch ``[out, in]``;
- SimpleCNN's first dense layer's input axis: flax flattens the NHWC
  feature map in (h, w, c) order (``simple_cnn.py:103``), torch flattens
  NCHW in (c, h, w);
- biases and GroupNorm scales as they are.

Inputs are numpy arrays (host copies of JAX arrays), so this module needs no
JAX. Leading axes (a client axis) pass through unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from multimodal_fl_security_tpu_torch.models.registry import target_device

Path = Tuple[str, ...]


def jax_paths(model, in_channels: int) -> List[Tuple[str, tuple, Path]]:
    """``(port name, torch shape, flax path)`` of every leaf, in the port's
    order; each model gives its leaves' flax paths (``jax_path``)."""
    return [(name, shape, model.jax_path(name))
            for name, shape in model.layout(in_channels).entries]


def _jax_shape(shape: tuple) -> tuple:
    """The flax shape of a leaf of torch shape ``shape``."""
    if len(shape) == 4:  # OIHW -> HWIO
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if len(shape) == 2:  # [out, in] -> [in, out]
        return (shape[1], shape[0])
    return shape


def _to_torch(model, name: str, arr: np.ndarray, shape: tuple) -> np.ndarray:
    """One leaf ``arr`` ``[..., *jax_shape]`` in torch layout ``[..., *shape]``."""
    lead = arr.ndim - len(shape)
    ax = list(range(lead))
    if len(shape) == 4:
        return arr.transpose(ax + [lead + 3, lead + 2, lead, lead + 1])
    if name == "fc1.weight":
        fh, fw = model.feature_hw
        out_dim, in_dim = shape
        arr = arr.reshape(arr.shape[:lead] + (fh, fw, in_dim // (fh * fw), out_dim))
        arr = arr.transpose(ax + [lead + 3, lead + 2, lead, lead + 1])
        return arr.reshape(arr.shape[:lead] + shape)
    if len(shape) == 2:
        return arr.swapaxes(-1, -2)
    return arr


def _lookup(params: Mapping, path: Path) -> np.ndarray:
    for key in path:
        params = params[key]
    return np.asarray(params, np.float32)


def params_from_jax(model, params: Mapping, device="cuda") -> torch.Tensor:
    """Flax ``params`` (nested dict of arrays, optionally with a leading
    client axis on every leaf) as the port's flat f32 buffer ``[..., D]``
    on ``device`` (the card unless the caller names another)."""
    device = target_device(device)
    in_channels = _lookup(params, model.jax_path("conv1.weight")).shape[-2]
    tensors: Dict[str, torch.Tensor] = {}
    for name, shape, path in jax_paths(model, in_channels):
        tensors[name] = torch.tensor(
            _to_torch(model, name, _lookup(params, path), shape))
    return model.layout(in_channels).flatten(tensors).to(device)


def flat_from_jax(model, flat: np.ndarray, in_channels: int,
                  device="cuda") -> torch.Tensor:
    """A JAX flat vector ``[..., D]`` (``flatten_tree``/``flatten_stacked``)
    as the port's flat vector, element for element."""
    device = target_device(device)
    flat = np.asarray(flat, np.float32)
    layout = model.layout(in_channels)
    if flat.shape[-1] != layout.dim:
        raise ValueError(f"expected {layout.dim} elements per row, "
                         f"got {flat.shape[-1]}")
    lead = flat.shape[:-1]
    leaves = jax_paths(model, in_channels)
    lo, start = 0, {}
    for name, shape, _ in sorted(leaves, key=lambda leaf: leaf[2]):
        start[name] = lo
        lo += int(np.prod(shape))
    tensors = {}
    for name, shape, _ in leaves:
        seg = flat[..., start[name]:start[name] + int(np.prod(shape))]
        seg = seg.reshape(lead + _jax_shape(shape))
        tensors[name] = torch.tensor(_to_torch(model, name, seg, shape))
    return layout.flatten(tensors).to(device)
