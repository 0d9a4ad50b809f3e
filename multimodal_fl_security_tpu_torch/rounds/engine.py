"""The federated round: every client's local training, then aggregation.

Counterpart of ``multimodal_fl_security_tpu/rounds/engine.py``. Where the
JAX package vmaps one client's training over the client axis inside one
jitted program, here the client axis is a batch dimension written out:

    clients          = one flat [C, D] f32 parameter buffer (core/pytrees.py)
    local training   = one grouped-conv / batched-GEMM forward for all C
                       clients, one backward of the summed per-client losses
                       (the clients' parameters are disjoint, so row c of the
                       gradient is client c's own gradient), and one
                       per-client SGD step on the buffer
    aggregation      = the defense reads that same buffer as its [C, D]
                       update matrix; no flatten copy is made

Local-training semantics match the JAX engine (engine.py:17-25): a fresh
optimizer per client per round; clip at global norm 1.0 (per client), then
weight decay, then momentum 0.9, then the learning rate; cross-entropy
averaged over the real (unpadded) samples of each batch; ``local_epochs``
passes over the shard in a fresh random order per epoch.

Features of the JAX engine that this slice leaves out raise
``NotImplementedError`` naming the JAX lines they would port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_fl_security_tpu_torch.data.stacking import ClientData

_JAX_ENGINE = "multimodal_fl_security_tpu/rounds/engine.py"


def _not_ported(feature: str, lines: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet (JAX: {_JAX_ENGINE}:{lines})")


@dataclass
class TrainSpec:
    """Static hyperparameters of a local training run."""

    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    local_epochs: int = 1
    batch_size: int = 32
    #: label smoothing coefficient for the local CE loss (0 = plain CE)
    label_smoothing: float = 0.0
    #: not ported yet; anything but the defaults raises NotImplementedError
    augment: str = "none"
    fedprox_mu: float = 0.0
    frozen_prefixes: tuple = ()


def sgd_step(params: torch.Tensor, grad: torch.Tensor,
             trace: Optional[torch.Tensor], spec: TrainSpec) -> None:
    """One step of the torch.optim.SGD-equivalent chain of
    ``engine.py:47-58`` on client-stacked ``[C, D]`` buffers, in place:
    clip each client's gradient to global norm ``clip_norm`` -> weight
    decay -> momentum (``trace``, zero at the start of a round) -> lr.
    """
    g = grad
    if spec.clip_norm and spec.clip_norm > 0:
        # optax.clip_by_global_norm, per client: rows are clients.
        norm = torch.linalg.vector_norm(g, dim=1, keepdim=True)
        g = torch.where(norm < spec.clip_norm, g, g / norm * spec.clip_norm)
    if spec.weight_decay and spec.weight_decay > 0:
        g = g + spec.weight_decay * params
    if trace is not None:
        # optax.trace: new_trace = g + momentum * trace
        g = trace.mul_(spec.momentum).add_(g)
    params.add_(g, alpha=-spec.learning_rate)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over real samples (padding masked out), over the last batch
    axis: logits ``[..., B, K]``, labels and mask ``[..., B]`` -> ``[...]``.

    ``smoothing`` > 0 mixes the one-hot target with the uniform
    distribution: loss = (1-s)*NLL(y) + s*mean_k(-log p_k)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    if smoothing and smoothing > 0.0:
        s = float(smoothing)
        nll = (1.0 - s) * nll + s * (-logp.mean(dim=-1))
    denom = mask.sum(dim=-1).clamp_min(1.0)
    return (nll * mask).sum(dim=-1) / denom


def make_local_train_fn(model, spec: TrainSpec, n_samples: int) -> Callable:
    """Build ``local_train(params, data, mask, generator) -> (stacked, losses)``.

    ``params`` is the global ``[D]`` buffer; ``data`` holds every client's
    stacked arrays ``[C, N_max, ...]`` (``"image"`` and ``"label"``) and
    ``mask`` is ``[C, N_max]``. Returns the trained client buffer ``[C, D]``
    and each client's mean training loss ``[C]``. Batch orders and dropout
    masks are drawn from ``generator``. N_max must be a multiple of the
    batch size.
    """
    bsz = spec.batch_size
    if n_samples % bsz != 0:
        raise ValueError("pad N_max to a batch-size multiple")
    steps = n_samples // bsz
    if spec.augment not in (None, "", "none"):
        raise _not_ported("train-time augmentation", "169-171,189-191")
    if spec.fedprox_mu:
        raise _not_ported("FedProx", "199-209")
    if spec.frozen_prefixes:
        raise _not_ported("frozen prefixes", "175-184")

    def local_train(params: torch.Tensor, data: Dict[str, torch.Tensor],
                    mask: torch.Tensor, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        images, labels = data["image"], data["label"]
        clients = mask.shape[0]
        rows = torch.arange(clients, device=mask.device).unsqueeze(1)
        stacked = params.detach().expand(clients, -1).clone()
        stacked.requires_grad_(True)
        trace = torch.zeros_like(stacked) if spec.momentum > 0 else None
        epoch_losses = []
        for _ in range(spec.local_epochs):
            perm = torch.rand(mask.shape, generator=generator,
                              device=mask.device).argsort(dim=1)
            step_losses = []
            for s in range(steps):
                idx = perm[:, s * bsz:(s + 1) * bsz]
                logits = model(stacked, images[rows, idx], train=True,
                               generator=generator)
                losses = cross_entropy(logits, labels.gather(1, idx),
                                       mask.gather(1, idx),
                                       spec.label_smoothing)
                stacked.grad = None
                losses.sum().backward()
                with torch.no_grad():
                    sgd_step(stacked, stacked.grad, trace, spec)
                step_losses.append(losses.detach())
            epoch_losses.append(torch.stack(step_losses).mean(dim=0))
        stacked.grad = None
        return stacked.detach(), torch.stack(epoch_losses).mean(dim=0)

    return local_train


class RoundEngine:
    """Runs federated rounds for one experiment on the data's device."""

    def __init__(
        self,
        model,
        client_data: ClientData,
        spec: TrainSpec,
        attack=None,
        defense=None,
        malicious_clients: Optional[list] = None,
        root_data=None,
        clients_per_round: Optional[int] = None,
        server_opt=None,
    ):
        from multimodal_fl_security_tpu_torch.attacks.base import NoAttack
        from multimodal_fl_security_tpu_torch.defenses.base import NoDefense

        self.model = model
        self.spec = spec
        self.attack = attack or NoAttack()
        self.defense = defense or NoDefense()
        self.num_clients = client_data.num_clients
        if clients_per_round and clients_per_round < self.num_clients:
            raise _not_ported("client subsampling", "286-293,450-460")
        if root_data is not None or getattr(self.defense, "needs_server_grad",
                                            False):
            raise _not_ported("FLTrust's root-dataset training",
                              "337-344,371-392")
        if getattr(self.defense, "stateful", False):
            raise _not_ported("stateful defenses", "346-350,482-502")
        if server_opt is not None:
            raise _not_ported("server optimizers", "352-356,507-510")

        self.device = client_data.device
        mal = torch.zeros(self.num_clients, dtype=torch.float32,
                          device=self.device)
        for i in malicious_clients or []:
            mal[i] = 1.0
        self.malicious_mask = mal
        self.arrays = client_data.arrays
        self.mask = client_data.mask
        self.counts = client_data.counts.to(torch.float32)
        self._local_train = make_local_train_fn(model, spec,
                                                client_data.max_samples)

    def run_round(self, params: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global ``[D]`` buffer ``params``: returns the
        new global buffer and the round's metrics (device tensors)."""
        updates, client_losses = self._local_train(
            params, self.arrays, self.mask, generator)  # [C, D], [C]
        updates = self.attack.poison_updates(
            generator, updates, params, self.malicious_mask, self.num_clients)
        ctx = {"global": params, "generator": generator}
        agg, aux = self.defense.aggregate_with_aux(updates, self.counts, ctx)
        metrics = {
            "client_loss_mean": client_losses.mean(),
            "update_norm_mean": torch.linalg.vector_norm(
                updates - params, dim=1).mean(),
            **aux,
        }
        return agg, metrics

    def run_rounds(self, params, generator, num_rounds: int):
        raise _not_ported("run_rounds (a horizon as one program)", "554-609")

    def detect_malicious(self, params, generator):
        raise _not_ported("detect_malicious", "611-654")
