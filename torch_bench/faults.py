"""Faults planted in the program underneath a run, and the control put in
its place, to show that the correctness check fails them (``tests/``,
``calibrate.py``).

Each is ``plant(engine, fed)``, applied after the engine is built. The
federation the reference reads is left as it is.
"""

from __future__ import annotations

import torch

from torch_bench.reference.round import local_train, module


def unchanged(engine, fed) -> None:
    """A round that returns the global state unchanged."""
    run_round = engine.run_round

    def stuck(params, generator):
        _, metrics = run_round(params, generator)
        return params, metrics

    engine.run_round = stuck


def altered_attack(engine, fed) -> None:
    """The attack's answer altered where it is produced: each malicious
    row moved 1% further from the round's global vector."""
    poison = engine.attack.poison_updates

    def altered(generator, updates, params, malicious, n):
        out = poison(generator, updates, params, malicious, n)
        return torch.where(malicious[:, None] > 0,
                           params + 1.01 * (out - params), out)

    engine.attack.poison_updates = altered


def altered_aggregate(engine, fed) -> None:
    """The defense's answer altered where it is produced: the new global
    vector's change made 1% longer."""
    aggregate = engine.defense.aggregate_with_aux

    def altered(updates, weights, ctx=None):
        new, aux = aggregate(updates, weights, ctx)
        return ctx["global"] + 1.01 * (new - ctx["global"]), aux

    engine.defense.aggregate_with_aux = altered


def half_batch(engine, fed) -> None:
    """Half of every batch left out of the loss, the mean taken over the
    rest: every second sample of each shard is masked."""
    engine.mask = fed.mask.clone()
    engine.mask[:, 1::2] = 0.0


PLANTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_attack": altered_attack,
          "altered_aggregate": altered_aggregate}


def control(config, traffic, precision=None):
    """The plain reference in the configuration's control precision
    (``config["control"]``, or ``precision`` in its layers) put in the
    program's place: its local training, attack and defense stand in for
    the engine's, on the same generator."""
    ctl = config["control"]
    precision = {layer: precision or ctl["precision"]
                 for layer in ctl["layers"]}
    attack = module("attacks", traffic["attack"]["name"])
    defense = module("defenses", traffic["defense"]["name"])

    class Attack:
        def poison_updates(self, generator, rows, params, malicious, n):
            return attack.poison(rows, malicious > 0,
                                 traffic["attack"]["config"])

    class Defense:
        def aggregate_with_aux(self, rows, counts, ctx=None):
            conf = traffic["defense"]["config"]
            aux = {}
            if "selection" in traffic["defense"]:
                mask = torch.zeros(rows.shape[0], device=rows.device)
                mask[defense.select(rows, conf)] = 1.0
                aux[traffic["defense"]["selection"]] = mask
            return defense.aggregate(rows, counts, conf), aux

    def plant(engine, fed):
        engine.attack, engine.defense = Attack(), Defense()

        def run_round(params, generator):
            rows, losses = local_train(params, fed, config, traffic,
                                       generator, precision)
            rows = engine.attack.poison_updates(
                generator, rows, params, engine.malicious_mask,
                engine.num_clients)
            new, aux = engine.defense.aggregate_with_aux(rows, fed.counts)
            norms = torch.linalg.vector_norm(rows - params, dim=1)
            return new, {"client_loss_mean": losses.mean(),
                         "update_norm_mean": norms.mean(), **aux}

        engine.run_round = run_round

    return plant
