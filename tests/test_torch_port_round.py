"""One federated round through both packages: the slice as a whole.

C=5 clients with N = B = 16 rows each (some masked out), 3 local epochs,
Krum f=1, f32 on the CPU. JAX draws its batch order with
``jax.random.permutation`` and flax its dropout bits, neither of which torch
can reproduce, so both are made irrelevant: each epoch is one batch of the
whole shard (the masked mean does not depend on row order), and both models
run without dropout (the JAX model through a test-side wrapper that applies
it with ``train=False``; the port's with dropout rates (0, 0)).

Tolerance: client parameters and the new global within atol 1e-5,
``client_loss_mean`` within 1e-5, the same Krum pick (f32 sums in
different orders; no other difference).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu.data.stacking import ClientData as JaxClientData
from multimodal_fl_security_tpu.defenses.krum import KrumDefense as JaxKrum
from multimodal_fl_security_tpu.models import create_model as jax_create_model
from multimodal_fl_security_tpu.models import init_model as jax_init_model
from multimodal_fl_security_tpu.rounds.engine import RoundEngine as JaxEngine
from multimodal_fl_security_tpu.rounds.engine import TrainSpec as JaxSpec
from multimodal_fl_security_tpu_torch.bench import build_engine
from multimodal_fl_security_tpu_torch.data.stacking import ClientData
from multimodal_fl_security_tpu_torch.defenses.krum import KrumDefense
from multimodal_fl_security_tpu_torch.models import create_model
from multimodal_fl_security_tpu_torch.models.from_jax import (
    flat_from_jax,
    params_from_jax,
)
from multimodal_fl_security_tpu_torch.ops.gram import gram
from multimodal_fl_security_tpu_torch.rounds.engine import RoundEngine, TrainSpec

C, N, EPOCHS, LR = 5, 16, 3, 0.05


class EvalModeApply:
    """The flax model, always applied with ``train=False`` (no dropout)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, train=False, rngs=None):
        return self.model.apply(variables, batch, train=False)


class RecordingJaxKrum(JaxKrum):
    def aggregate_with_aux(self, updates, weights, ctx=None):
        agg, aux = super().aggregate_with_aux(updates, weights, ctx)
        return agg, {**aux, "updates": updates}


class RecordingKrum(KrumDefense):
    def aggregate_with_aux(self, updates, weights, ctx=None):
        agg, aux = super().aggregate_with_aux(updates, weights, ctx)
        return agg, {**aux, "updates": updates}


def shards():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 10, size=(C, N)).astype(np.int32)
    protos = rng.uniform(size=(10, 28, 28, 1)).astype(np.float32)
    images = (protos[labels]
              + 0.35 * rng.normal(size=(C, N, 28, 28, 1))).astype(np.float32)
    mask = np.ones((C, N), np.float32)
    mask[1, 11:] = 0.0  # ragged clients: masked rows add nothing
    mask[3, 4:] = 0.0
    return images, labels, mask, mask.sum(1).astype(np.int32)


@pytest.fixture(scope="module")
def rounds():
    images, labels, mask, counts = shards()
    config = {"num_malicious": 1, "multi_k": 1}

    jmodel = jax_create_model("simple_cnn", num_classes=10)
    jparams = jax_init_model(jmodel, {"image": images[0]}, seed=0)["params"]
    jengine = JaxEngine(
        EvalModeApply(jmodel),
        JaxClientData(arrays={"image": images, "label": labels}, mask=mask,
                      counts=counts, num_classes=10),
        JaxSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=N),
        defense=RecordingJaxKrum(config),
    )
    jnew, jmetrics = jengine.run_round(jparams, jax.random.PRNGKey(0))

    model = create_model("simple_cnn", num_classes=10, dropout_rates=(0, 0))
    engine = RoundEngine(
        model,
        ClientData.from_numpy({"image": np.moveaxis(images, -1, 2),
                               "label": labels}, mask, counts, 10, "cpu"),
        TrainSpec(learning_rate=LR, local_epochs=EPOCHS, batch_size=N),
        defense=RecordingKrum(config),
    )
    params = params_from_jax(model, jparams)
    new, metrics = engine.run_round(params, torch.Generator().manual_seed(0))
    return dict(model=model, params=params, jnew=jnew, new=new,
                jmetrics={k: np.asarray(v) for k, v in jmetrics.items()},
                metrics={k: v.detach().numpy() for k, v in metrics.items()})


def test_client_params_match_jax(rounds):
    want = flat_from_jax(rounds["model"], rounds["jmetrics"]["updates"], 1)
    got = torch.from_numpy(rounds["metrics"]["updates"])
    assert got.shape == (C, 421_642)
    moved = (got - rounds["params"]).abs().amax(dim=1)
    assert bool((moved > 1e-3).all())  # every client really trained
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_krum_pick_and_global_match_jax(rounds):
    jm, m = rounds["jmetrics"], rounds["metrics"]
    assert int(m["selected_first"]) == int(jm["selected_first"])
    np.testing.assert_array_equal(m["selected_mask"], jm["selected_mask"])
    np.testing.assert_allclose(m["krum_scores"], jm["krum_scores"],
                               rtol=1e-5)
    want = params_from_jax(rounds["model"], rounds["jnew"])
    np.testing.assert_allclose(rounds["new"].numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def test_round_metrics_match_jax(rounds):
    jm, m = rounds["jmetrics"], rounds["metrics"]
    assert abs(float(m["client_loss_mean"])
               - float(jm["client_loss_mean"])) <= 1e-5
    np.testing.assert_allclose(float(m["update_norm_mean"]),
                               float(jm["update_norm_mean"]), rtol=1e-5)


@pytest.mark.parametrize("spec,kwargs,feature", [
    (TrainSpec(fedprox_mu=0.1), {}, "FedProx"),
    (TrainSpec(frozen_prefixes=("conv1",)), {}, "frozen prefixes"),
    (TrainSpec(augment="flip"), {}, "augmentation"),
    (TrainSpec(), {"clients_per_round": 2}, "subsampling"),
    (TrainSpec(), {"root_data": {}}, "FLTrust"),
    (TrainSpec(), {"server_opt": object()}, "server optimizers"),
])
def test_unported_features_raise(spec, kwargs, feature):
    images, labels, mask, counts = shards()
    data = ClientData.from_numpy({"image": np.moveaxis(images, -1, 2),
                                  "label": labels}, mask, counts, 10, "cpu")
    with pytest.raises(NotImplementedError, match=feature):
        RoundEngine(create_model("simple_cnn"), data,
                    TrainSpec(**{**spec.__dict__, "batch_size": N}), **kwargs)


def test_bench_engine_runs_a_round_on_the_cpu():
    # The bench's own constructor, cut to 45 clients x 32 samples: the
    # smallest Krum f=20 takes (n >= 2f + 3 = 43).
    engine, params, test_set = build_engine("cpu", num_clients=45,
                                            samples_per_client=32)
    assert params.shape == (421_642,)
    assert test_set["image"].shape == (1000, 1, 28, 28)
    before = gram.launches
    new, metrics = engine.run_round(params, torch.Generator().manual_seed(0))
    assert gram.launches == before  # the CPU takes the plain Gram
    assert new.shape == params.shape and bool(torch.isfinite(new).all())
    assert np.isfinite(float(metrics["client_loss_mean"]))
    assert metrics["krum_scores"].shape == (45,)
    assert 0 <= int(metrics["selected_first"]) < 45
    with pytest.raises(NotImplementedError, match="run_rounds"):
        engine.run_rounds(params, torch.Generator(), 2)
    with pytest.raises(NotImplementedError, match="detect_malicious"):
        engine.detect_malicious(params, torch.Generator())
