"""Port Krum and FedAvg against the JAX package's, on identical [C, D] inputs.

Tolerance: Krum scores within rtol 1e-5 (f32 Gram sums in different
orders); the pick, the selection mask and the aggregate must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu.defenses import get_defense as jax_get_defense
from multimodal_fl_security_tpu_torch.defenses import get_defense


def both(name, config):
    return jax_get_defense(name, config), get_defense(name, config)


def run_both(name, config, u, weights):
    jdef, tdef = both(name, config)
    jagg, jaux = jdef.aggregate_with_aux(jnp.asarray(u), jnp.asarray(weights))
    tagg, taux = tdef.aggregate_with_aux(torch.from_numpy(u),
                                         torch.from_numpy(weights))
    return (np.asarray(jagg), {k: np.asarray(v) for k, v in jaux.items()},
            tagg.numpy(), {k: v.numpy() for k, v in taux.items()})


@pytest.mark.parametrize("name,c,d,f,k", [
    ("krum", 7, 50, 2, 1),
    ("krum", 12, 301, 3, 1),
    ("multi_krum", 12, 301, 3, 4),
    ("krum", 100, 1000, 20, 1),
])
def test_krum_matches_jax(name, c, d, f, k):
    rng = np.random.RandomState(c + d)
    u = (rng.normal(size=(1, d))
         + rng.uniform(0.05, 0.5, size=(c, 1)) * rng.normal(size=(c, d))
         ).astype(np.float32)
    weights = rng.randint(10, 100, size=c).astype(np.float32)
    jagg, jaux, tagg, taux = run_both(
        name, {"num_malicious": f, "multi_k": k}, u, weights)
    assert set(taux) == set(jaux) == {"krum_scores", "selected_mask",
                                      "selected_first"}
    np.testing.assert_allclose(taux["krum_scores"], jaux["krum_scores"],
                               rtol=1e-5)
    assert int(taux["selected_first"]) == int(jaux["selected_first"])
    np.testing.assert_array_equal(taux["selected_mask"], jaux["selected_mask"])
    assert taux["selected_mask"].sum() == k
    np.testing.assert_allclose(tagg, jagg, rtol=1e-6, atol=1e-6)


def test_krum_tie_keeps_the_stable_order():
    # Small integers keep every Gram entry exact in f32, so clients 2 and 5
    # (identical, central) tie exactly; a stable argsort picks the lower.
    rng = np.random.RandomState(3)
    u = rng.randint(-3, 4, size=(8, 16)).astype(np.float32)
    u[2] = 0.0
    u[5] = 0.0
    weights = np.ones(8, np.float32)
    for name, k in (("krum", 1), ("multi_krum", 2)):
        jagg, jaux, tagg, taux = run_both(
            name, {"num_malicious": 2, "multi_k": k}, u, weights)
        assert taux["krum_scores"][2] == taux["krum_scores"][5]
        assert int(taux["selected_first"]) == int(jaux["selected_first"]) == 2
        np.testing.assert_array_equal(taux["selected_mask"],
                                      jaux["selected_mask"])
        np.testing.assert_array_equal(tagg, jagg)


def test_krum_needs_2f_plus_3_clients():
    u = np.zeros((6, 4), np.float32)
    w = np.ones(6, np.float32)
    jdef, tdef = both("krum", {"num_malicious": 2})
    with pytest.raises(ValueError, match="2f \\+ 3"):
        jdef.aggregate_with_aux(jnp.asarray(u), jnp.asarray(w))
    with pytest.raises(ValueError, match="2f \\+ 3"):
        tdef.aggregate_with_aux(torch.from_numpy(u), torch.from_numpy(w))


def test_krum_detect_flags_the_unselected():
    rng = np.random.RandomState(4)
    u = rng.normal(size=(9, 20)).astype(np.float32)
    w = np.ones(9, np.float32)
    jdef, tdef = both("multi_krum", {"num_malicious": 2, "multi_k": 3})
    np.testing.assert_array_equal(
        tdef.detect(torch.from_numpy(u), torch.from_numpy(w)).numpy(),
        np.asarray(jdef.detect(jnp.asarray(u), jnp.asarray(w))))


@pytest.mark.parametrize("name", ["none", "fedavg"])
def test_fedavg_matches_jax(name):
    rng = np.random.RandomState(5)
    u = rng.normal(size=(6, 33)).astype(np.float32)
    weights = rng.randint(1, 50, size=6).astype(np.float32)
    jagg, jaux, tagg, taux = run_both(name, {}, u, weights)
    assert jaux == taux == {}
    np.testing.assert_allclose(tagg, jagg, rtol=1e-6, atol=1e-6)


def test_registry_names_match_jax():
    assert get_defense("multi_krum").multi_k == 3 == \
        jax_get_defense("multi_krum").multi_k
    assert get_defense("median").name == jax_get_defense("median").name
    with pytest.raises(ValueError, match="unknown defense"):
        get_defense("foolsgold")  # not ported yet
