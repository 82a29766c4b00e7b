"""Experiment configs for the port.

The port's own copy of the fields and named configs of
``distributed_tensorflow_models_tpu/harness/config.py`` that the ported
training slices read (ResNet-50, Inception-v3 and the transformer LMs),
with the same names and values.  ``resnet50_synthetic_tiny`` and ``transformer_lm_tiny``
are the port's, small enough to train on a CPU in tests: ResNet-50's depth
at width 8 on 32x32 images; 2 layers, 4 heads, d_model 64, d_ff 128,
vocab 256 at sequence 64 and batch 4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from distributed_tensorflow_models_tpu_torch.ops import optim


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"  # sgd | momentum | rmsprop | adam
    learning_rate: float = 0.1
    # Exponential decay (staircase) as in the reference; None = constant.
    decay_steps: Optional[int] = None
    decay_rate: float = 0.94
    staircase: bool = True
    momentum: float = 0.9
    rmsprop_decay: float = 0.9
    rmsprop_epsilon: float = 1.0
    # Global-norm gradient clipping before the optimizer; None = off.
    clip_global_norm: Optional[float] = None

    def schedule(self) -> optim.ScalarOrSchedule:
        if self.decay_steps is None:
            return self.learning_rate
        return optim.exponential_decay(self.learning_rate, self.decay_steps,
                                       self.decay_rate,
                                       staircase=self.staircase)

    def make(self) -> optim.GradientTransformation:
        lr = self.schedule()
        if self.name == "sgd":
            tx = optim.sgd(lr)
        elif self.name == "momentum":
            tx = optim.tf_momentum(lr, self.momentum)
        elif self.name == "rmsprop":
            tx = optim.tf_rmsprop(lr, decay=self.rmsprop_decay,
                                  momentum=self.momentum,
                                  epsilon=self.rmsprop_epsilon)
        elif self.name == "adam":
            tx = optim.adam(lr)
        else:
            raise ValueError(f"optimizer {self.name!r} is not ported yet")
        if self.clip_global_norm is not None:
            tx = optim.chain(optim.clip_by_global_norm(self.clip_global_norm),
                             tx)
        return tx


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str
    task: str = "classification"  # classification | lm
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # imagenet_synthetic | imagenet | ptb | mnist | cifar10
    dataset: str = "imagenet_synthetic"
    image_size: int = 224
    global_batch_size: int = 256
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    # Classification loss: smoothed targets and the weight of the auxiliary
    # head's loss (Inception-v3).
    label_smoothing: float = 0.0
    weight_decay: float = 0.0
    aux_loss_weight: float = 0.0
    # Decay of the EMA of the weights kept in the train state; None = none.
    ema_decay: Optional[float] = None
    # LM settings: sequence length per segment and the token vocabulary.
    num_steps: int = 35
    vocab_size: int = 10000
    train_steps: int = 1000
    log_every_steps: int = 100
    seed: int = 0
    # Host input pipeline: worker threads assembling batches behind
    # ordered reassembly (1 = one producer thread).  The batch stream is
    # the same for any value.
    data_workers: int = 1
    # Attention for attention models: auto (= blockwise) | reference |
    # blockwise | flash (kernels K2-K4 on the card; K2 and K5 with
    # DTM_FLASH_BWD=staged).
    attn_impl: str = "auto"
    # LM head: project and take the cross entropy chunked in bf16
    # (ops/losses.py::chunked_unembed_xent) instead of full f32 logits.
    fused_unembed: bool = False

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_CONFIGS: dict[str, ExperimentConfig] = {}


def _add(cfg: ExperimentConfig) -> ExperimentConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- ImageNet Inception-v3 (slim). -----------------------------------------
_add(
    ExperimentConfig(
        name="inception_v3_imagenet",
        model="inception_v3",
        dataset="imagenet",
        image_size=299,
        global_batch_size=256,
        optimizer=OptimizerConfig(
            name="rmsprop",
            learning_rate=0.045,
            rmsprop_decay=0.9,
            momentum=0.9,
            rmsprop_epsilon=1.0,
            # 0.94 decay every 2 epochs (epoch ~= 1.28M/256 = 5005 steps).
            decay_steps=10010,
            decay_rate=0.94,
        ),
        label_smoothing=0.1,
        aux_loss_weight=0.4,
        weight_decay=4e-5,
        ema_decay=0.9999,
        train_steps=500_000,
    )
)

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


# --- Transformer LM — the attention stack's flagship. ---------------------
_add(
    ExperimentConfig(
        name="transformer_lm",
        model="transformer_lm",
        task="lm",
        model_kwargs={
            "num_layers": 4,
            "num_heads": 8,
            "d_model": 256,
            "d_ff": 1024,
            "max_len": 512,
            "dropout_rate": 0.1,
        },
        dataset="ptb",
        global_batch_size=16,
        num_steps=256,  # sequence length per segment
        vocab_size=10000,
        optimizer=OptimizerConfig(
            name="adam", learning_rate=3e-4, clip_global_norm=1.0
        ),
        fused_unembed=True,
        train_steps=10_000,
    )
)

_add(
    _CONFIGS["transformer_lm"].replace(
        name="transformer_lm_tiny",
        model_kwargs={
            "num_layers": 2,
            "num_heads": 4,
            "d_model": 64,
            "d_ff": 128,
            "max_len": 64,
            "vocab_size": 256,
            "dropout_rate": 0.1,
        },
        global_batch_size=4,
        num_steps=64,
        vocab_size=256,
        train_steps=2,
    )
)


# Modern decoder recipe: rotary positions, grouped-query KV (2 of 8 heads),
# sliding-window attention.
_add(
    _CONFIGS["transformer_lm"].replace(
        name="transformer_lm_modern",
        model_kwargs={
            **_CONFIGS["transformer_lm"].model_kwargs,
            "pos_encoding": "rope",
            "num_kv_heads": 2,
            "attn_window": 256,
        },
    )
)


def get_config(name: str, **overrides) -> ExperimentConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    cfg = _CONFIGS[name]
    return cfg.replace(**overrides) if overrides else cfg


def list_configs() -> list[str]:
    return sorted(_CONFIGS)
