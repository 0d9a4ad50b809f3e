"""The general traffic generator: a federation made from a seed on the device.

A traffic mix (``traffic/<name>.json``) gives the number of clients, the
samples each holds, the local training hyperparameters, the attack, the
defense and how many clients (``0 .. malicious_clients-1``) are malicious.
From ``--seed`` this module makes, on the device and in a few large calls:

- the clients' images and labels: the port's synthetic MNIST recipe
  (``multimodal_fl_security_tpu_torch/bench.py::build_engine``): one uniform
  prototype per class plus 0.35 N(0, 1) noise, ``[C, N_pad, c_in, H, W]``
  f32, each shard padded to a multiple of the batch with masked rows;
- the initial global parameters ``[D]`` f32 in the configuration's leaf
  order: flax's lecun-normal weights (a normal truncated at 2 sigma, scaled
  to variance 1 / fan_in) and zero biases, drawn in one call;
- the seed of the rounds' ``torch.Generator``, which orders each client's
  batches and draws the dropout masks.

The same seed gives the same federation and the same rounds. The program
under test and the plain reference both start from what this module makes;
neither makes its own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

#: noise scale of the synthetic recipe
NOISE = 0.35
#: a normal truncated at +-2 sigma has this standard deviation
TRUNC_STD = 0.87962566103423978


@dataclass
class Federation:
    images: torch.Tensor      # [C, N_pad, c_in, H, W] f32
    labels: torch.Tensor      # [C, N_pad] int64
    mask: torch.Tensor        # [C, N_pad] f32, 1 for real samples
    counts: torch.Tensor      # [C] int32, real samples per client
    malicious: List[int]      # indices of the malicious clients
    theta0: torch.Tensor      # [D] f32 initial global parameters
    round_seed: int           # seed of the rounds' generator


def stream_seed(seed: int, stream: int) -> int:
    """A distinct 64-bit generator seed for each stream of one ``--seed``."""
    return (int(seed) % (1 << 60)) * 8 + stream


def padded(samples: int, batch: int) -> int:
    return -(-samples // batch) * batch


def leaf_shapes(config: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(name, tuple(shape)) for name, shape in config["leaves"]]


def init_params(config: Dict[str, Any], gen: torch.Generator) -> torch.Tensor:
    """lecun-normal weights and zero biases in one ``[D]`` f32 buffer."""
    shapes = leaf_shapes(config)
    sizes = [math.prod(s) for _, s in shapes]
    scale = torch.tensor(
        [0.0 if name.endswith(".bias")
         else math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD
         for name, shape in shapes], device=gen.device)
    flat = torch.empty(sum(sizes), device=gen.device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return flat * scale.repeat_interleave(
        torch.tensor(sizes, device=gen.device))


def make_federation(config: Dict[str, Any], traffic: Dict[str, Any],
                    seed: int, device) -> Federation:
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 0))
    c = int(traffic["clients"])
    n = int(traffic["samples_per_client"])
    n_pad = padded(n, int(traffic["batch_size"]))
    cin = int(config["in_channels"])
    h, w = config["image_size"]
    k = int(config["num_classes"])
    protos = torch.rand((k, cin * h * w), generator=gen, device=device)
    labels = torch.randint(0, k, (c, n_pad), generator=gen, device=device)
    noise = torch.randn((c, n_pad, cin * h * w), generator=gen, device=device)
    images = (protos[labels] + NOISE * noise).view(c, n_pad, cin, h, w)
    del noise
    mask = torch.zeros((c, n_pad), device=device)
    mask[:, :n] = 1.0
    theta0 = init_params(config, gen)
    if theta0.numel() != int(config["param_count"]):
        raise ValueError(f"the leaves hold {theta0.numel()} parameters, the "
                         f"configuration states {config['param_count']}")
    return Federation(
        images=images, labels=labels, mask=mask,
        counts=torch.full((c,), n, dtype=torch.int32, device=device),
        malicious=list(range(int(traffic["malicious_clients"]))),
        theta0=theta0, round_seed=stream_seed(seed, 1))


def round_generator(fed: Federation, device) -> torch.Generator:
    """A fresh generator for the rounds, in its state before round 1."""
    return torch.Generator(torch.device(device)).manual_seed(fed.round_seed)
