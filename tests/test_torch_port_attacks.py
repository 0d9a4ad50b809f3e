"""Port the in-round update-space attacks against the JAX package's, on
identical [C, D] inputs, on the CPU.

Tolerance: atol 1e-5 * max|U| (f32 sums in different orders; for
min_max / min_sum the bisection may land one step apart when a threshold is
within rounding of the crafted distance, which moves gamma by
gamma_max / 2^20). adaptive_krum draws its noise from a ``torch.Generator``,
which cannot reproduce ``jax.random``: it is exact at perturbation_scale 0
and held by the statistics of its noise otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu.attacks import get_attack as jax_get_attack
from multimodal_fl_security_tpu.attacks.alie import alie_z as jax_alie_z
from multimodal_fl_security_tpu_torch.attacks import ATTACKS, get_attack
from multimodal_fl_security_tpu_torch.attacks.alie import alie_z
from multimodal_fl_security_tpu_torch.attacks.base import masked_mean

C, D = 10, 257
MALICIOUS = [0, 3, 7]


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    glob = rng.normal(size=(D,)).astype(np.float32)
    u = (glob[None, :] + 0.1 * rng.normal(size=(C, D))).astype(np.float32)
    mask = np.zeros(C, np.float32)
    mask[MALICIOUS] = 1.0
    return u, glob, mask


def run_both(name, config, seed=0):
    u, glob, mask = inputs(seed)
    want = np.asarray(jax_get_attack(name, config).poison_updates(
        jax.random.PRNGKey(0), jnp.asarray(u), jnp.asarray(glob),
        jnp.asarray(mask), C))
    got = get_attack(name, config).poison_updates(
        torch.Generator().manual_seed(0), torch.from_numpy(u),
        torch.from_numpy(glob), torch.from_numpy(mask), C)
    return u, mask, want, got.numpy()


CASES = [
    ("alie", {"num_malicious": 3}),
    ("alie", {"num_malicious": 3, "z": 1.5}),
    ("ipm", {"epsilon": 0.1}),
    ("ipm", {"epsilon": 0.5, "use_benign_mean": False}),
    ("scaling", {"scale": 10.0}),
    ("model_replacement", {"num_malicious": 3}),
    ("model_replacement", {"boost_factor": 4.0}),
    ("adaptive_krum", {"perturbation_scale": 0.0}),
] + [(mode, {"perturbation": p}) for mode in ("min_max", "min_sum")
     for p in ("std", "sign", "unit")]


@pytest.mark.parametrize("name,config", CASES)
def test_attack_matches_jax(name, config):
    u, mask, want, got = run_both(name, config)
    assert got.shape == (C, D) and got.dtype == np.float32
    benign = mask == 0
    np.testing.assert_array_equal(got[benign], u[benign])  # untouched
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(u).max()))
    assert not np.allclose(got[~benign], u[~benign])  # really poisoned


@pytest.mark.parametrize("mode", ["min_max", "min_sum"])
def test_agr_agnostic_crafts_inside_the_benign_spread(mode):
    # The bisection's gamma is the largest that keeps the crafted row inside
    # the benign spread: the crafted row moved off the mean, but not beyond.
    u, mask, _, got = run_both(mode, {"perturbation": "std"}, seed=3)
    benign = u[mask == 0]
    crafted = got[MALICIOUS[0]]
    mean = benign.mean(0)
    assert float(np.linalg.norm(crafted - mean)) > 1e-3
    d_crafted = ((benign - crafted) ** 2).sum(1)
    pair = ((benign[:, None] - benign[None]) ** 2).sum(-1)
    if mode == "min_max":
        assert d_crafted.max() <= pair.max() * (1 + 1e-5)
    else:
        assert d_crafted.sum() <= pair.sum(1).max() * (1 + 1e-5)


def test_adaptive_krum_noise_statistics():
    u, glob, mask = inputs(1)
    scale = 0.5
    gen = torch.Generator().manual_seed(5)
    got = get_attack("adaptive_krum", {"perturbation_scale": scale}
                     ).poison_updates(gen, torch.from_numpy(u),
                                      torch.from_numpy(glob),
                                      torch.from_numpy(mask), C).numpy()
    center = np.asarray(jax_get_attack("adaptive_krum", {
        "perturbation_scale": 0.0}).poison_updates(
            jax.random.PRNGKey(0), jnp.asarray(u), jnp.asarray(glob),
            jnp.asarray(mask), C))[MALICIOUS[0]]
    noise = got[MALICIOUS] - center[None, :]  # 3 * 257 N(0, scale^2) draws
    assert abs(float(noise.mean())) < 4 * scale / np.sqrt(noise.size)
    assert abs(float(noise.std()) / scale - 1.0) < 0.1
    np.testing.assert_array_equal(got[mask == 0], u[mask == 0])
    again = get_attack("adaptive_krum", {"perturbation_scale": scale}
                       ).poison_updates(torch.Generator().manual_seed(5),
                                        torch.from_numpy(u),
                                        torch.from_numpy(glob),
                                        torch.from_numpy(mask), C).numpy()
    np.testing.assert_array_equal(got, again)  # the generator decides


@pytest.mark.parametrize("n,m", [(100, 20), (10, 3), (7, 2), (5, 0), (3, 3)])
def test_alie_z_matches_jax(n, m):
    assert alie_z(n, m) == jax_alie_z(n, m)


def test_masked_mean_of_an_empty_mask_is_zero():
    got = masked_mean(torch.ones(4, 3), torch.zeros(4))
    assert torch.equal(got, torch.zeros(3))


@pytest.mark.parametrize("name,config", [
    ("none", {}), ("alie", {"num_malicious": 3}), ("alie", {"z": 1.0}),
    ("ipm", {}), ("scaling", {"scale": 3.0}), ("model_replacement", {}),
    ("adaptive_krum", {}), ("min_max", {"perturbation": "sign"}),
    ("min_sum", {}),
])
def test_attack_metrics_and_flags_match_jax(name, config):
    assert name in ATTACKS
    jatk, tatk = jax_get_attack(name, config), get_attack(name, config)
    assert tatk.name == jatk.name
    assert tatk.get_metrics() == jatk.get_metrics()
    assert tatk.is_model_poisoning() == jatk.is_model_poisoning()
    assert tatk.is_data_poisoning() == jatk.is_data_poisoning()
