"""One federated round through both packages under attack, with a robust
defense: the slice as a whole.

C=7 clients with N = B = 16 rows each (some masked out), 3 local epochs,
clients 0 and 1 malicious, f32 on the CPU, for ALIE + trimmed mean,
IPM + median and min_max + Bulyan (f=1). As in
``tests/test_torch_port_round.py``, each epoch is one batch of the whole
shard and both models run without dropout, so neither JAX's batch order nor
flax's dropout bits matter.

Tolerance: the poisoned update matrix and the new global within atol 1e-5,
``client_loss_mean`` within 1e-5, and Bulyan's selected set identical
(f32 sums in different orders; no other difference). ``update_norm_mean``
within rtol 1e-5, except under min_max: its gamma is a bisection against a
threshold taken from an uncentered f32 Gram (JAX agr_agnostic.py:375-378),
whose rounding depends on the summation order, by ~3e-4 of the threshold
here (norms^2 ~233 against a largest squared distance ~0.16). Each
coordinate of the crafted row stays within atol 1e-5 of JAX's, but the norm
of the colluders' update adds that shift up over all D coordinates, so it
is held to rtol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu.attacks import get_attack as jax_get_attack
from multimodal_fl_security_tpu.data.stacking import ClientData as JaxClientData
from multimodal_fl_security_tpu.defenses import get_defense as jax_get_defense
from multimodal_fl_security_tpu.models import create_model as jax_create_model
from multimodal_fl_security_tpu.models import init_model as jax_init_model
from multimodal_fl_security_tpu.rounds.engine import RoundEngine as JaxEngine
from multimodal_fl_security_tpu.rounds.engine import TrainSpec as JaxSpec
from multimodal_fl_security_tpu_torch.attacks import get_attack
from multimodal_fl_security_tpu_torch.bench import build_engine
from multimodal_fl_security_tpu_torch.data.stacking import ClientData
from multimodal_fl_security_tpu_torch.defenses import get_defense
from multimodal_fl_security_tpu_torch.models import create_model
from multimodal_fl_security_tpu_torch.models.from_jax import (
    flat_from_jax,
    params_from_jax,
)
from multimodal_fl_security_tpu_torch.ops.gram import gram
from multimodal_fl_security_tpu_torch.ops.sorted_reduce import sorted_reduce
from multimodal_fl_security_tpu_torch.rounds.engine import RoundEngine, TrainSpec

C, N, EPOCHS, LR = 7, 16, 3, 0.05
MALICIOUS = [0, 1]
RUNS = {
    "alie+trimmed_mean": ("alie", {"num_malicious": 2},
                          "trimmed_mean", {"trim_ratio": 0.1}),
    "ipm+median": ("ipm", {"epsilon": 0.1}, "median", {}),
    "min_max+bulyan": ("min_max", {"perturbation": "std"},
                       "bulyan", {"num_malicious": 1}),
}


class EvalModeApply:
    """The flax model, always applied with ``train=False`` (no dropout)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, train=False, rngs=None):
        return self.model.apply(variables, batch, train=False)


def recording(defense):
    """``defense`` whose aux also carries the update matrix it was given."""

    class Recording(type(defense)):
        def aggregate_with_aux(self, updates, weights, ctx=None):
            agg, aux = super().aggregate_with_aux(updates, weights, ctx)
            return agg, {**aux, "updates": updates}

    defense.__class__ = Recording
    return defense


def shards():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 10, size=(C, N)).astype(np.int32)
    protos = rng.uniform(size=(10, 28, 28, 1)).astype(np.float32)
    images = (protos[labels]
              + 0.35 * rng.normal(size=(C, N, 28, 28, 1))).astype(np.float32)
    mask = np.ones((C, N), np.float32)
    mask[2, 11:] = 0.0  # ragged clients: masked rows add nothing
    mask[5, 4:] = 0.0
    return images, labels, mask, mask.sum(1).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(RUNS))
def rounds(request):
    attack, attack_config, defense, defense_config = RUNS[request.param]
    images, labels, mask, counts = shards()

    jmodel = jax_create_model("simple_cnn", num_classes=10)
    jparams = jax_init_model(jmodel, {"image": images[0]}, seed=0)["params"]
    jengine = JaxEngine(
        EvalModeApply(jmodel),
        JaxClientData(arrays={"image": images, "label": labels}, mask=mask,
                      counts=counts, num_classes=10),
        JaxSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=N),
        attack=jax_get_attack(attack, attack_config),
        defense=recording(jax_get_defense(defense, defense_config)),
        malicious_clients=MALICIOUS,
    )
    jnew, jmetrics = jengine.run_round(jparams, jax.random.PRNGKey(0))

    model = create_model("simple_cnn", num_classes=10, dropout_rates=(0, 0))
    engine = RoundEngine(
        model,
        ClientData.from_numpy({"image": np.moveaxis(images, -1, 2),
                               "label": labels}, mask, counts, 10, "cpu"),
        TrainSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=N),
        attack=get_attack(attack, attack_config),
        defense=recording(get_defense(defense, defense_config)),
        malicious_clients=MALICIOUS,
    )
    params = params_from_jax(model, jparams, device="cpu")
    new, metrics = engine.run_round(params, torch.Generator().manual_seed(0))
    return dict(name=request.param, model=model, params=params, jnew=jnew,
                new=new,
                jmetrics={k: np.asarray(v) for k, v in jmetrics.items()},
                metrics={k: v.detach().numpy() for k, v in metrics.items()})


def test_poisoned_updates_match_jax(rounds):
    want = flat_from_jax(rounds["model"], rounds["jmetrics"]["updates"], 1,
                         device="cpu")
    got = torch.from_numpy(rounds["metrics"]["updates"])
    assert got.shape == (C, 421_642)
    # The colluders all sent the one crafted row; the benign clients trained.
    assert torch.equal(got[0], got[1])
    moved = (got[2:] - rounds["params"]).abs().amax(dim=1)
    assert bool((moved > 1e-3).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_robust_aggregate_matches_jax(rounds):
    jm, m = rounds["jmetrics"], rounds["metrics"]
    assert set(m) == set(jm)
    if "selected_mask" in jm:
        np.testing.assert_array_equal(m["selected_mask"], jm["selected_mask"])
        assert int(m["num_selected"]) == int(jm["num_selected"]) == C - 2
    want = params_from_jax(rounds["model"], rounds["jnew"], device="cpu")
    np.testing.assert_allclose(rounds["new"].numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    assert abs(float(m["client_loss_mean"])
               - float(jm["client_loss_mean"])) <= 1e-5
    rtol = 1e-3 if rounds["name"] == "min_max+bulyan" else 1e-5
    np.testing.assert_allclose(float(m["update_norm_mean"]),
                               float(jm["update_norm_mean"]), rtol=rtol)


@pytest.mark.parametrize("attack,attack_config,defense,defense_config", [
    ("alie", {"num_malicious": 20}, "trimmed_mean", {"trim_ratio": 0.1}),
    ("min_max", {"perturbation": "std"}, "bulyan", {"num_malicious": 20}),
])
def test_bench_engine_runs_a_robust_round_on_the_cpu(attack, attack_config,
                                                     defense, defense_config):
    # The bench's own constructor at 83 clients x 32 samples: the smallest
    # Bulyan f=20 takes (n >= 4f + 3), with 20 malicious clients.
    engine, params, _ = build_engine(
        "cpu", num_clients=83, samples_per_client=32, defense=defense,
        defense_config=defense_config, attack=attack,
        attack_config=attack_config, num_malicious_clients=20)
    assert int(engine.malicious_mask.sum()) == 20
    assert float(engine.malicious_mask[19]) == 1.0
    assert float(engine.malicious_mask[20]) == 0.0
    before = (gram.launches, sorted_reduce.launches)
    new, metrics = engine.run_round(params, torch.Generator().manual_seed(0))
    assert (gram.launches, sorted_reduce.launches) == before  # plain on CPU
    assert new.shape == params.shape and bool(torch.isfinite(new).all())
    assert np.isfinite(float(metrics["client_loss_mean"]))
