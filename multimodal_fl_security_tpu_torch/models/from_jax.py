"""Convert the JAX package's SimpleCNN parameters to the port's layout.

Both packages order a model's flat vector the same way, segment by segment
(``core/pytrees.py``); inside a segment each keeps its own framework's
layout. Per segment:

- convolutions: flax HWIO -> torch OIHW;
- dense layers: flax ``[in, out]`` -> torch ``[out, in]``;
- the first dense layer's input axis: flax flattens the NHWC feature map in
  (h, w, c) order (``simple_cnn.py:103``), torch flattens NCHW in (c, h, w).

Inputs are numpy arrays (host copies of JAX arrays), so this module needs no
JAX. Leading axes (a client axis) pass through unchanged.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

#: port segment prefix -> flax module name (default fused stem)
JAX_MODULES = {
    "conv1": "ConvPoolFused_0",
    "conv2": "Conv_0",
    "fc1": "Dense_0",
    "fc2": "Dense_1",
}


def _jax_shape(name: str, shape: tuple) -> tuple:
    """The flax shape of the port segment ``name`` of torch shape ``shape``."""
    if name.endswith(".bias"):
        return shape
    if len(shape) == 4:  # OIHW -> HWIO
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    return (shape[1], shape[0])  # [out, in] -> [in, out]


def _to_torch(model, name: str, arr: np.ndarray, shape: tuple) -> np.ndarray:
    """One segment ``arr`` ``[..., *jax_shape]`` in torch layout ``[..., *shape]``."""
    if name.endswith(".bias"):
        return arr
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
    return arr.swapaxes(-1, -2)


def params_from_jax(model, params: Mapping, device="cpu") -> torch.Tensor:
    """Flax ``params`` (nested dict of arrays, optionally with a leading
    client axis on every leaf) as the port's flat f32 buffer ``[..., D]``."""
    first = np.asarray(params[JAX_MODULES["conv1"]]["kernel"])
    in_channels = first.shape[-2]
    layout = model.layout(in_channels)
    tensors = {}
    for name, shape in layout.entries:
        prefix, leaf = name.split(".")
        arr = np.asarray(params[JAX_MODULES[prefix]][
            "bias" if leaf == "bias" else "kernel"], np.float32)
        tensors[name] = torch.tensor(_to_torch(model, name, arr, shape))
    return layout.flatten(tensors).to(device)


def flat_from_jax(model, flat: np.ndarray, in_channels: int,
                  device="cpu") -> torch.Tensor:
    """A JAX flat vector ``[..., D]`` (``flatten_tree``/``flatten_stacked``)
    as the port's flat vector, element for element."""
    flat = np.asarray(flat, np.float32)
    layout = model.layout(in_channels)
    if flat.shape[-1] != layout.dim:
        raise ValueError(f"expected {layout.dim} elements per row, "
                         f"got {flat.shape[-1]}")
    lead = flat.shape[:-1]
    tensors = {}
    for name, shape in layout.entries:
        lo, hi = layout.offsets[name]
        seg = flat[..., lo:hi].reshape(lead + _jax_shape(name, shape))
        tensors[name] = torch.tensor(_to_torch(model, name, seg, shape))
    return layout.flatten(tensors).to(device)
