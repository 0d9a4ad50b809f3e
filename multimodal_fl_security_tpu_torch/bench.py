"""North-star benchmark of the port: FL rounds/min at 100 clients with Krum.

The same workload as the repo's ``bench.py`` (the JAX package's): 100
clients x 600 MNIST-shaped synthetic samples (padded to 608) x 2 local
epochs at batch 32 (38 SGD steps per client per round), SimpleCNN in bf16
compute, then Krum (f=20) over the stacked [100, 421,642] f32 update matrix.
The synthetic task is the JAX bench's recipe: 10 uniform class prototypes
plus 0.35 Gaussian noise, one channel, built on the device from a
``torch.Generator``. ``build_engine`` also takes another defense, an
in-round attack and a number of malicious clients, for the robust rounds
that ``chip_smoke.py`` drives at the same width.

Run on a CUDA card::

    python -m multimodal_fl_security_tpu_torch.bench

prints one JSON line in ``bench.py``'s schema, plus the card's name and
power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

NUM_CLIENTS = 100
SAMPLES_PER_CLIENT = 600
BATCH_SIZE = 32
LOCAL_EPOCHS = 2
NUM_MALICIOUS = 20
NUM_TEST = 1000
#: H100 SXM dense bf16 peak (NVIDIA data sheet, at a 700 W power limit):
#: the denominator of ``mfu_logical``.
PEAK_FLOPS = 989e12
#: the reference's ~30 s/round (BASELINE.md)
BASELINE_ROUNDS_PER_MIN = 2.0


def synthetic_images(labels: torch.Tensor, protos: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Prototype of each label plus 0.35 N(0, 1) noise, shaped
    ``labels.shape + (1, 28, 28)``."""
    noise = torch.randn(labels.shape + (28 * 28,), generator=generator,
                        device=labels.device)
    return (protos[labels] + 0.35 * noise).view(labels.shape + (1, 28, 28))


def build_engine(device, num_clients: int = NUM_CLIENTS,
                 samples_per_client: int = SAMPLES_PER_CLIENT,
                 defense: str = "krum",
                 defense_config: Optional[Dict[str, Any]] = None,
                 attack: str = "none",
                 attack_config: Optional[Dict[str, Any]] = None,
                 num_malicious_clients: int = 0):
    """Build ``(engine, params, test_set)`` for the north-star workload on
    ``device``. ``num_clients`` and ``samples_per_client`` shrink it for a
    CPU rehearsal; the bench runs the defaults.

    ``defense`` and ``attack`` are registry names with their configs;
    clients ``0 .. num_malicious_clients-1`` are malicious. The defaults
    build the north-star Krum round (f=20, k=1) with no attack."""
    from multimodal_fl_security_tpu_torch.attacks import get_attack
    from multimodal_fl_security_tpu_torch.data.stacking import ClientData
    from multimodal_fl_security_tpu_torch.defenses import get_defense
    from multimodal_fl_security_tpu_torch.models import create_model, init_model
    from multimodal_fl_security_tpu_torch.rounds.engine import (
        RoundEngine,
        TrainSpec,
    )

    device = torch.device(device)
    n_pad = -(-samples_per_client // BATCH_SIZE) * BATCH_SIZE
    protos = torch.rand((10, 28 * 28), device=device,
                        generator=torch.Generator(device).manual_seed(1000))
    gen = torch.Generator(device).manual_seed(0)
    labels = torch.randint(0, 10, (num_clients, n_pad), generator=gen,
                           device=device)
    images = synthetic_images(labels, protos, gen)
    mask = torch.zeros((num_clients, n_pad), device=device)
    mask[:, :samples_per_client] = 1.0  # real rows, then masked padding
    client_data = ClientData(
        arrays={"image": images, "label": labels},
        mask=mask,
        counts=torch.full((num_clients,), samples_per_client,
                          dtype=torch.int32, device=device),
        num_classes=10,
    )
    test_labels = torch.randint(0, 10, (NUM_TEST,), generator=gen,
                                device=device)
    test_set = {"image": synthetic_images(test_labels, protos, gen),
                "label": test_labels}

    # bf16 conv/dense compute; params, grads and Krum stay f32.
    model = create_model("simple_cnn", num_classes=10, dtype=torch.bfloat16)
    params = init_model(model, in_channels=1, seed=0, device=device)
    spec = TrainSpec(learning_rate=0.01, local_epochs=LOCAL_EPOCHS,
                     batch_size=BATCH_SIZE)
    if defense_config is None and defense == "krum":
        defense_config = {"num_malicious": NUM_MALICIOUS, "multi_k": 1}
    engine = RoundEngine(
        model, client_data, spec,
        attack=get_attack(attack, attack_config),
        defense=get_defense(defense, defense_config),
        malicious_clients=list(range(num_malicious_clients)),
    )
    return engine, params, test_set


def logical_flops_per_round(with_gram: bool = True) -> float:
    """Analytic FLOPs of one north-star round, as ``bench.py`` counts them:
    SimpleCNN's per-sample forward at 28x28x1, backward ~2x forward, plus
    (``with_gram``) Krum's Gram (2*C^2*D, D = 421,642). Padding rows are not
    counted."""
    conv1 = 2 * 3 * 3 * 1 * 32 * 28 * 28
    conv2 = 2 * 3 * 3 * 32 * 64 * 14 * 14
    fc1 = 2 * 3136 * 128
    fc2 = 2 * 128 * 10
    fwd = conv1 + conv2 + fc1 + fc2
    train = 3.0 * fwd * NUM_CLIENTS * LOCAL_EPOCHS * SAMPLES_PER_CLIENT
    return train + with_gram * 2.0 * NUM_CLIENTS * NUM_CLIENTS * 421_642


def time_rounds(engine, params: torch.Tensor, generator: torch.Generator,
                n_rounds: int) -> Tuple[torch.Tensor, float, List[Dict]]:
    """Run ``n_rounds`` rounds; returns (params, seconds, per-round metrics).
    The clock is read after ``torch.cuda.synchronize()``."""
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        params, m = engine.run_round(params, generator)
        metrics.append(m)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0, metrics


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def result_line(n_rounds: int, seconds: float,
                metric: str = "fl_rounds_per_min_100c_krum",
                with_gram: bool = True) -> Dict:
    """``bench.py``'s JSON schema, plus the card it ran on. ``with_gram``
    counts a Gram's FLOPs in ``mfu_logical`` (Krum and Bulyan have one)."""
    rounds_per_min = n_rounds / seconds * 60.0
    mfu = (logical_flops_per_round(with_gram) * (n_rounds / seconds)
           / PEAK_FLOPS)
    return {
        "metric": metric,
        "value": rounds_per_min,
        "unit": "rounds/min",
        "vs_baseline": rounds_per_min / BASELINE_ROUNDS_PER_MIN,
        "mfu_logical": mfu,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the port's bench needs a CUDA device")
    engine, params, _ = build_engine("cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    params, _ = engine.run_round(params, gen)  # warm-up
    n_rounds = 3
    params, seconds, metrics = time_rounds(engine, params, gen, n_rounds)
    final_loss = float(metrics[-1]["client_loss_mean"])
    if not math.isfinite(final_loss):
        raise RuntimeError(f"non-finite loss: {final_loss}")
    print(json.dumps(result_line(n_rounds, seconds)))


if __name__ == "__main__":
    main()
