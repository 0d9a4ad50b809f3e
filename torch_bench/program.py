"""The system under test, built through the port's public constructors.

The benchmark picks no trainer and no kernel: ``RoundEngine`` runs whatever
it runs by default for the model, attack and defense that the cell names.
The federation (data, initial parameters, the rounds' seed) comes from
``federation.py``; the program makes none of it.

Spans are recorded here, from the benchmark's side, around the calls into
each layer: the engine's ``attack`` and ``defense`` attributes are replaced
by recorders that wrap the instance's public ``poison_updates`` and
``aggregate_with_aux``. With ``sync`` the recorder waits for the device at
each boundary, so a span holds its layer's device work.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from torch_bench.federation import Federation, leaf_shapes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def apply_precision_flags(config: Dict[str, Any]) -> None:
    """The configuration's TF32 settings, stated explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32_matmul"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32_cudnn"])


def build_engine(config: Dict[str, Any], traffic: Dict[str, Any],
                 fed: Federation):
    """The port's ``RoundEngine`` for this configuration and traffic mix."""
    from multimodal_fl_security_tpu_torch.attacks import get_attack
    from multimodal_fl_security_tpu_torch.data.stacking import ClientData
    from multimodal_fl_security_tpu_torch.defenses import get_defense
    from multimodal_fl_security_tpu_torch.models import create_model
    from multimodal_fl_security_tpu_torch.rounds.engine import (
        RoundEngine,
        TrainSpec,
    )

    model = create_model(
        config["model"], num_classes=int(config["num_classes"]),
        hidden_dim=int(config["hidden_dim"]),
        image_size=tuple(config["image_size"]),
        dropout_rates=tuple(config["dropout_rates"]),
        dtype=DTYPES[config["compute_dtype"]])
    layout = [(name, tuple(shape)) for name, shape in
              model.layout(int(config["in_channels"])).entries]
    if layout != leaf_shapes(config):
        raise ValueError(f"the program lays out {layout}, the configuration "
                         f"states {leaf_shapes(config)}")
    data = ClientData(arrays={"image": fed.images, "label": fed.labels},
                      mask=fed.mask, counts=fed.counts,
                      num_classes=int(config["num_classes"]))
    spec = TrainSpec(
        learning_rate=float(traffic["learning_rate"]),
        momentum=float(traffic["momentum"]),
        weight_decay=float(traffic["weight_decay"]),
        clip_norm=float(traffic["clip_norm"]),
        local_epochs=int(traffic["local_epochs"]),
        batch_size=int(traffic["batch_size"]),
        label_smoothing=float(traffic["label_smoothing"]))
    return RoundEngine(
        model, data, spec,
        attack=get_attack(traffic["attack"]["name"],
                          traffic["attack"]["config"]),
        defense=get_defense(traffic["defense"]["name"],
                            traffic["defense"]["config"]),
        malicious_clients=fed.malicious)


class Spans:
    """Host-clock spans ``(name, start, end)`` kept in memory."""

    def __init__(self, sync: bool, device: torch.device):
        self.sync = sync and device.type == "cuda"
        self.records: List[Tuple[str, float, float]] = []

    def now(self) -> float:
        if self.sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def add(self, name: str, start: float, end: float) -> None:
        self.records.append((name, start, end))

    def of(self, name: str) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e in self.records if n == name]


class _Recorded:
    """Wraps ``layer.method``: a span around each call, and the profiler's
    label ``name`` over it."""

    def __init__(self, layer, method: str, name: str,
                 spans: Optional[Spans]):
        self._layer, self._method, self._name = layer, method, name
        self._spans = spans

    def __getattr__(self, attr):
        return getattr(self._layer, attr)

    def _call(self, *args, **kwargs):
        fn = getattr(self._layer, self._method)
        with torch.profiler.record_function(self._name):
            if self._spans is None:
                return fn(*args, **kwargs)
            start = self._spans.now()
            out = fn(*args, **kwargs)
            self._spans.add(self._name, start, self._spans.now())
            return out


class RecordedAttack(_Recorded):
    def poison_updates(self, *args, **kwargs):
        return self._call(*args, **kwargs)


class RecordedDefense(_Recorded):
    def aggregate_with_aux(self, *args, **kwargs):
        return self._call(*args, **kwargs)


def record_layers(engine, spans: Optional[Spans]):
    """Put recorders in place of ``engine.attack`` and ``engine.defense``;
    returns the originals, for :func:`restore_layers`."""
    originals = (engine.attack, engine.defense)
    engine.attack = RecordedAttack(originals[0], "poison_updates", "attack",
                                   spans)
    engine.defense = RecordedDefense(originals[1], "aggregate_with_aux",
                                     "aggregate", spans)
    return originals


def restore_layers(engine, originals) -> None:
    engine.attack, engine.defense = originals
