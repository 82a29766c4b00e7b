"""Experiment configs for the port.

The port's own copy of the fields and named configs of
``distributed_tensorflow_models_tpu/harness/config.py`` that the ResNet-50
training slice reads, with the same names and values.
``resnet50_synthetic_tiny`` is the port's: ResNet-50's depth at width 8 on
32x32 synthetic images, small enough to train on a CPU in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from distributed_tensorflow_models_tpu_torch.ops import optim


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"  # sgd | momentum
    learning_rate: float = 0.1
    # Exponential decay (staircase) as in the reference; None = constant.
    decay_steps: Optional[int] = None
    decay_rate: float = 0.94
    staircase: bool = True
    momentum: float = 0.9

    def schedule(self) -> optim.ScalarOrSchedule:
        if self.decay_steps is None:
            return self.learning_rate
        return optim.exponential_decay(self.learning_rate, self.decay_steps,
                                       self.decay_rate,
                                       staircase=self.staircase)

    def make(self) -> optim.GradientTransformation:
        lr = self.schedule()
        if self.name == "sgd":
            return optim.sgd(lr)
        if self.name == "momentum":
            return optim.tf_momentum(lr, self.momentum)
        raise ValueError(f"optimizer {self.name!r} is not ported yet")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    dataset: str = "imagenet_synthetic"
    image_size: int = 224
    global_batch_size: int = 256
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    weight_decay: float = 0.0
    train_steps: int = 1000
    log_every_steps: int = 100
    seed: int = 0

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_CONFIGS: dict[str, ExperimentConfig] = {}


def _add(cfg: ExperimentConfig) -> ExperimentConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- ImageNet ResNet-50 — the async-PS vs sync A/B model. ----------------
_add(
    ExperimentConfig(
        name="resnet50_imagenet",
        model="resnet50",
        dataset="imagenet",
        image_size=224,
        global_batch_size=256,
        optimizer=OptimizerConfig(
            name="momentum",
            learning_rate=0.1,
            momentum=0.9,
            decay_steps=150_000,  # ~30 epochs, staircase x0.1
            decay_rate=0.1,
        ),
        weight_decay=1e-4,
        train_steps=450_000,
    )
)

# --- Synthetic-input ResNet-50 (throughput benchmarking). ----------------
_add(
    ExperimentConfig(
        name="resnet50_synthetic",
        model="resnet50",
        dataset="imagenet_synthetic",
        image_size=224,
        global_batch_size=256,
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.1),
        weight_decay=1e-4,
        train_steps=100,
    )
)

_add(
    _CONFIGS["resnet50_synthetic"].replace(
        name="resnet50_synthetic_tiny",
        model_kwargs={"width": 8},
        image_size=32,
        global_batch_size=4,
        train_steps=2,
    )
)


def get_config(name: str, **overrides) -> ExperimentConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    cfg = _CONFIGS[name]
    return cfg.replace(**overrides) if overrides else cfg


def list_configs() -> list[str]:
    return sorted(_CONFIGS)
