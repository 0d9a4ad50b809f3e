"""The plain f32 federated round: local SGD per client, attack, aggregation.

In plain ``torch``, independent of the program; every client's arithmetic
is its own (``models/<model>.py``: unfold and batched products over the
clients), so clients never mix:

- local training (the port's ``rounds/engine.py:47-58`` and the reference
  testbed's ``fl_client.py:76-149``): ``local_epochs`` passes over the
  client's shard in a fresh random order, batches of ``batch_size``; the
  loss is cross-entropy averaged over the batch's real (unpadded) samples;
  each step clips the gradient to global norm ``clip_norm``, adds weight
  decay, folds it into momentum (``trace = g + momentum * trace``, zero at
  the start of a round) and steps by ``learning_rate``; a client's round
  loss is the mean of its steps' losses;
- the attack rewrites the malicious clients' rows
  (``reference/attacks/<name>.py``); the defense aggregates the rows into
  the new global vector (``reference/defenses/<name>.py``).

The round's random draws come from one ``torch.Generator`` in this order,
which the program under test follows too: per epoch the batch orders of all
clients (``torch.rand([C, N_pad]).argsort(dim=1)``), then per step the
model's dropout masks for all clients (``models/<model>.py::draw_masks``).
So the reference and the program, started from one seed, train on the same
batches under the same masks, and what is left between them is arithmetic.

Departure from the testbed: updates are exchanged as new parameter vectors
``[C, D]`` (the port's convention), not as deltas.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F


@dataclass
class Readings:
    """What the first rounds produce, as the comparison reads it."""

    losses: List[float]        # client_loss_mean of each round
    update_norms: List[float]  # mean over clients of ||row - global||
    thetas: List[torch.Tensor]  # the global [D] before round 1, after each
    #: each round's [C, D] rows before and after the attack (the reference
    #: keeps round 1's trained rows only), and the defense's selection (a
    #: [C] mask; None for a defense that selects nothing)
    trained: List[torch.Tensor] = field(default_factory=list)
    attacked: List[torch.Tensor] = field(default_factory=list)
    selections: List[Optional[torch.Tensor]] = field(default_factory=list)


def module(kind: str, name: str):
    return importlib.import_module(f"torch_bench.reference.{kind}.{name}")


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
              smoothing: float) -> torch.Tensor:
    """Each client's CE ``[C]`` averaged over its batch's real samples."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.unsqueeze(-1)).squeeze(-1)
    if smoothing > 0.0:
        nll = (1.0 - smoothing) * nll + smoothing * (-logp.mean(dim=-1))
    return (nll * mask).sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)


def sgd(rows: torch.Tensor, grad: torch.Tensor, traces: torch.Tensor,
        traffic: Dict[str, Any]) -> None:
    """One step for every client, in place on ``[C, D]`` rows."""
    clip = float(traffic["clip_norm"])
    if clip > 0:
        norm = torch.linalg.vector_norm(grad, dim=1, keepdim=True)
        grad = torch.where(norm < clip, grad, grad / norm * clip)
    if traffic["weight_decay"]:
        grad = grad + float(traffic["weight_decay"]) * rows
    traces.mul_(float(traffic["momentum"])).add_(grad)
    rows.sub_(float(traffic["learning_rate"]) * traces)


def local_train(theta: torch.Tensor, fed, config, traffic,
                gen: torch.Generator,
                precision: Optional[Dict[str, str]] = None):
    """Every client's rows ``[C, D]`` and round losses ``[C]``."""
    model = module("models", config["model"])
    c, n_pad = fed.mask.shape
    bsz = int(traffic["batch_size"])
    steps = n_pad // bsz
    smoothing = float(traffic["label_smoothing"])
    clients = torch.arange(c, device=theta.device).unsqueeze(1)
    rows = theta.detach().expand(c, -1).clone()
    traces = torch.zeros_like(rows)
    losses = torch.zeros((c,), dtype=torch.float64, device=theta.device)
    epochs = int(traffic["local_epochs"])
    for _ in range(epochs):
        perm = torch.rand(fed.mask.shape, generator=gen,
                          device=fed.mask.device).argsort(dim=1)
        for s in range(steps):
            idx = perm[:, s * bsz:(s + 1) * bsz]
            masks = model.draw_masks(gen, c, bsz, config, fed.mask.device)
            w = rows.clone().requires_grad_(True)
            loss = masked_ce(
                model.logits(w, fed.images[clients, idx], masks, config,
                             precision),
                fed.labels[clients, idx], fed.mask[clients, idx], smoothing)
            (grad,) = torch.autograd.grad(loss.sum(), w)
            with torch.no_grad():
                sgd(rows, grad, traces, traffic)
            losses += loss.detach().double()
    return rows, (losses / (epochs * steps)).float()


def malicious_mask(fed) -> torch.Tensor:
    out = torch.zeros((fed.mask.shape[0],), dtype=torch.bool,
                      device=fed.mask.device)
    out[fed.malicious] = True
    return out


def run_rounds(fed, config, traffic, gen: torch.Generator, rounds: int,
               precision: Optional[Dict[str, str]] = None,
               follow: Optional[List[Optional[torch.Tensor]]] = None
               ) -> Readings:
    """``rounds`` rounds from ``fed.theta0`` with the round generator
    ``gen`` in its state before round 1.

    ``follow`` gives each round a selection (a ``[C]`` mask) that the
    defense takes instead of its own: the program's. Krum's and Bulyan's
    choices flip on near-ties between two f32 summation orders, and a flip
    would part the two runs for the rounds after; :func:`layer_gaps` holds
    the program's selections to the reference's on the program's own
    rows."""
    attack = module("attacks", traffic["attack"]["name"])
    defense = module("defenses", traffic["defense"]["name"])
    malicious = malicious_mask(fed)
    theta = fed.theta0.clone()
    out = Readings([], [], [theta.clone()])
    for r in range(rounds):
        rows, losses = local_train(theta, fed, config, traffic, gen,
                                   precision)
        if not out.trained:
            out.trained.append(rows.clone())
        rows = attack.poison(rows, malicious, traffic["attack"]["config"])
        norms = torch.linalg.vector_norm((rows - theta).double(), dim=1)
        selected = follow[r] if follow else None
        theta = defense.aggregate(
            rows, fed.counts, traffic["defense"]["config"],
            None if selected is None else selected.to(rows.device) > 0)
        out.losses.append(float(losses.double().mean()))
        out.update_norms.append(float(norms.mean()))
        out.thetas.append(theta.clone())
    return out


def layer_gaps(prog: Readings, fed, traffic, gap) -> Dict[str, float]:
    """The attack and the defense checked one by one on the program's own
    rows, every round: ``attack_gap``, the reference attack of the
    program's trained rows against its attacked rows (the malicious rows);
    ``aggregate_gap``, the reference defense, with its own selection, of the
    program's attacked rows against the program's new global vector; where
    the program's selection differs from the reference's only by rows whose
    scores tie within rounding, the reference takes the program's
    (``defenses/krum.py::tied_pick``), and otherwise its own.
    ``gap(got, want)`` is the worst-leaf measure of ``correctness.py`` over
    ``[rows, D]`` changes from the round's starting vector."""
    attack = module("attacks", traffic["attack"]["name"])
    defense = module("defenses", traffic["defense"]["name"])
    malicious = malicious_mask(fed)
    out = {"aggregate_gap": 0.0}
    if traffic["attack"]["name"] != "none":
        out["attack_gap"] = 0.0
    device = fed.mask.device
    for r, (trained, attacked) in enumerate(zip(prog.trained,
                                                prog.attacked)):
        start = prog.thetas[r].to(device)
        trained, attacked = trained.to(device), attacked.to(device)
        if "attack_gap" in out:
            want = attack.poison(trained, malicious,
                                 traffic["attack"]["config"])
            out["attack_gap"] = max(out["attack_gap"], gap(
                attacked[malicious] - start, want[malicious] - start))
        chosen = prog.selections[r] if prog.selections else None
        want = defense.aggregate(attacked, fed.counts,
                                 traffic["defense"]["config"],
                                 **({} if chosen is None else
                                    {"prefer": chosen.to(device) > 0}))
        got = prog.thetas[r + 1].to(device)
        out["aggregate_gap"] = max(out["aggregate_gap"], gap(
            (got - start)[None], (want - start)[None]))
    return out
