"""Port trimmed mean, median, geometric median and Bulyan against the JAX
package's defenses, on identical [C, D] inputs, on the CPU.

Tolerances: the median equal; the trimmed mean and Bulyan's aggregate within
atol 1e-6 * max|U| (f32 sums in different orders); the geometric median
within atol 1e-5 * max|U|; Bulyan's selected set and ``num_selected``
identical. ``get_metrics()`` equal to the JAX defense's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu.defenses import get_defense as jax_get_defense
from multimodal_fl_security_tpu_torch.defenses import DEFENSES, get_defense


def client_updates(c, d, seed, num_outliers=0):
    rng = np.random.RandomState(seed)
    u = (rng.normal(size=(1, d))
         + rng.uniform(0.05, 0.5, size=(c, 1)) * rng.normal(size=(c, d)))
    u[:num_outliers] += 5.0 * rng.normal(size=(num_outliers, d))
    return u.astype(np.float32)


def run_both(name, config, u):
    weights = np.ones(u.shape[0], np.float32)
    jagg, jaux = jax_get_defense(name, config).aggregate_with_aux(
        jnp.asarray(u), jnp.asarray(weights))
    tagg, taux = get_defense(name, config).aggregate_with_aux(
        torch.from_numpy(u), torch.from_numpy(weights))
    return (np.asarray(jagg), {k: np.asarray(v) for k, v in jaux.items()},
            tagg, {k: v.numpy() for k, v in taux.items()})


def tol(u, rel):
    return rel * float(np.abs(u).max())


@pytest.mark.parametrize("name,config,c,rel", [
    ("trimmed_mean", {}, 10, 1e-6),
    ("trimmed_mean", {"trim_ratio": 0.2}, 25, 1e-6),
    ("trimmed_mean", {"trim_ratio": 0.5}, 6, 0.0),  # over-trimmed: the median
    ("median", {}, 9, 0.0),
    ("median", {}, 100, 0.0),
    ("geometric_median", {}, 12, 1e-5),
    ("geometric_median", {"max_iters": 5, "tol": 1e-3}, 30, 1e-5),
])
def test_coordinatewise_defenses_match_jax(name, config, c, rel):
    u = client_updates(c, 203, seed=c, num_outliers=c // 5)
    jagg, jaux, tagg, taux = run_both(name, config, u)
    assert jaux == {} and taux == {}
    if rel == 0.0:
        assert torch.equal(tagg, torch.from_numpy(jagg.copy()))
    else:
        np.testing.assert_allclose(tagg.numpy(), jagg, rtol=0, atol=tol(u, rel))


@pytest.mark.parametrize("c,f,d", [(15, 3, 64), (100, 20, 500), (7, 1, 33)])
def test_bulyan_matches_jax(c, f, d):
    u = client_updates(c, d, seed=c + f, num_outliers=f)
    jagg, jaux, tagg, taux = run_both("bulyan", {"num_malicious": f}, u)
    assert set(taux) == set(jaux) == {"selected_mask", "num_selected"}
    np.testing.assert_array_equal(taux["selected_mask"], jaux["selected_mask"])
    assert int(taux["num_selected"]) == int(jaux["num_selected"]) == c - 2 * f
    if c >= 15:  # (at C=7, theta=5 of 7 rows leaves room for the outlier)
        assert taux["selected_mask"][:f].sum() == 0  # the outliers are out
    np.testing.assert_allclose(tagg.numpy(), jagg, rtol=0, atol=tol(u, 1e-6))


def test_bulyan_selection_order_matches_jax():
    u = client_updates(15, 64, seed=4, num_outliers=3)
    config = {"num_malicious": 3}
    want = np.asarray(jax_get_defense("bulyan", config).select(jnp.asarray(u)))
    got = get_defense("bulyan", config).select(torch.from_numpy(u))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_bulyan_ties_take_the_first_client_like_jax():
    # Small integers keep every Gram entry exact in f32; rows 4, 6 and 9 are
    # one colluding row, so their scores tie exactly in every iteration and
    # argmin must take the lowest index first, as jnp.argmin does.
    rng = np.random.RandomState(5)
    u = rng.randint(-3, 4, size=(11, 16)).astype(np.float32)
    u[[4, 6, 9]] = 0.0
    config = {"num_malicious": 2}
    want = np.asarray(jax_get_defense("bulyan", config).select(jnp.asarray(u)))
    got = get_defense("bulyan", config).select(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:3]) == [4, 6, 9]


def test_bulyan_needs_4f_plus_3_clients():
    u = torch.from_numpy(client_updates(14, 8, seed=0))
    with pytest.raises(ValueError, match="n >= 4f \\+ 3"):
        get_defense("bulyan", {"num_malicious": 3}).aggregate_with_aux(
            u, torch.ones(14))
    detect = get_defense("bulyan", {"num_malicious": 3}).detect(
        torch.from_numpy(client_updates(15, 8, seed=0, num_outliers=3)),
        torch.ones(15))
    assert detect.tolist()[:3] == [1.0, 1.0, 1.0] and float(detect.sum()) == 6


@pytest.mark.parametrize("name,config", [
    ("none", {}), ("fedavg", {}),
    ("krum", {"num_malicious": 2, "multi_k": 1}),
    ("multi_krum", {"num_malicious": 2}),
    ("trimmed_mean", {"trim_ratio": 0.2}), ("median", {}),
    ("geometric_median", {"max_iters": 7}), ("bulyan", {"num_malicious": 2}),
])
def test_defense_metrics_and_names_match_jax(name, config):
    assert name in DEFENSES
    jdef, tdef = jax_get_defense(name, config), get_defense(name, config)
    assert tdef.name == jdef.name
    assert tdef.get_metrics() == jdef.get_metrics()
