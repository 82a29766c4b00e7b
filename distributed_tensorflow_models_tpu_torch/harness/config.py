"""Experiment configs for the port.

The port's own copy of the fields and named configs of
``distributed_tensorflow_models_tpu/harness/config.py`` that the ported
training slices read (MNIST LeNet, CIFAR-10 ResNet-32, ResNet-50,
Inception-v3, the PTB LSTMs and the transformer LMs), with the same names
and values.  ``resnet50_synthetic_tiny`` and ``transformer_lm_tiny``
are the port's, small enough to train on a CPU in tests: ResNet-50's depth
at width 8 on 32x32 images; 2 layers, 4 heads, d_model 64, d_ff 128,
vocab 256 at sequence 64 and batch 4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from distributed_tensorflow_models_tpu_torch.ops import optim

# Steps between the multi-process preemption polls (the JAX package's).
PREEMPT_POLL_STEPS_DEFAULT = 20


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
    # Zaremba staged schedule (PTB): constant for ``hold_epochs`` epochs of
    # ``steps_per_epoch`` steps, then x ``decay_rate`` per epoch.  When set,
    # takes precedence over the exponential fields.
    steps_per_epoch: Optional[int] = None
    hold_epochs: Optional[int] = None

    def schedule(self) -> optim.ScalarOrSchedule:
        if self.steps_per_epoch is not None and self.hold_epochs is not None:
            return optim.zaremba_decay(self.learning_rate,
                                       self.steps_per_epoch,
                                       self.hold_epochs, self.decay_rate)
        if self.decay_steps is None:
            return self.learning_rate
        return optim.exponential_decay(self.learning_rate, self.decay_steps,
                                       self.decay_rate,
                                       staircase=self.staircase)

    def make(self, num_steps: Optional[int] = None
             ) -> optim.GradientTransformation:
        """The transformation; ``num_steps`` is the run's length, the
        counts its schedule is tabulated for on the device."""
        lr = self.schedule()
        if self.name == "sgd":
            tx = optim.sgd(lr, num_steps=num_steps)
        elif self.name == "momentum":
            tx = optim.tf_momentum(lr, self.momentum, num_steps=num_steps)
        elif self.name == "rmsprop":
            tx = optim.tf_rmsprop(lr, decay=self.rmsprop_decay,
                                  momentum=self.momentum,
                                  epsilon=self.rmsprop_epsilon,
                                  num_steps=num_steps)
        elif self.name == "adam":
            tx = optim.adam(lr, num_steps=num_steps)
        else:
            raise ValueError(f"unknown optimizer {self.name!r}")
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
    # Train steps per call of the K-step train call
    # (core/train_loop.py::MultiStep): one chunk of stacked batches, one
    # walk of the hooks that want a step in it, metrics left on the device
    # until a hook or the run's end reads them.  Chunks shrink to end at
    # log_every_steps boundaries, at train_steps and at the first step a
    # hook wants, so hooks fire at the same steps for any value, and the
    # trajectory is the same bit for bit.  On CUDA every step after the
    # first is a CUDA-graph replay whatever the value.
    steps_per_loop: int = 1
    seed: int = 0
    # Mesh axis sizes; -1 absorbs remaining devices (data axis).  The port
    # is data parallel only: any other axis above 1 raises.
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_seq: int = 1
    mesh_pipe: int = 1
    mesh_expert: int = 1
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
    # Named tensor-parallel rule set applied when mesh_model > 1 in the JAX
    # package; "" = fully replicated params, the only layout ported.
    param_rules: str = ""
    # Checkpoints under <workdir>/checkpoints (harness/checkpoint.py), only
    # when fit is given a workdir: every checkpoint_every_secs on the
    # chief's clock, every checkpoint_every_steps steps too when set (the
    # step cadence is deterministic, so it reproduces across restarts),
    # and at the end; the newest keep_checkpoints are kept.
    checkpoint_every_secs: Optional[float] = 600.0
    checkpoint_every_steps: Optional[int] = None
    keep_checkpoints: int = 5
    # Cold start (harness/startup.py), under the JAX package's names so a
    # config reads the same in both packages.  xla_cache_dir names the
    # kernel build cache here, where the JAX package kept its XLA
    # compilation cache: None keeps the process's build directory (the
    # default build/kernels/ of ops/_kernels.py unless an explicit
    # setting came first), a path is used as it is, and "" keeps no
    # persistent cache (kernels build into a fresh temporary directory).
    # aot_compile: while fit restores the checkpoint, a background thread
    # loads (or builds with nvcc) every kernel library the step will
    # launch and runs the FLOPs count; the result is the same bit for bit
    # with it on or off.
    xla_cache_dir: Optional[str] = None
    aot_compile: bool = True
    # Divergence policy.  "abort": a non-finite loss kills the run (the
    # reference's NanTensorHook).  "rollback": restore the newest finite
    # checkpoint in place, skip exactly the offending chunk's batches and
    # retry, at most rollback_budget times per run (needs a workdir).
    nan_policy: str = "abort"  # abort | rollback
    rollback_budget: int = 3
    # Step-progress watchdog (resilience/watchdog.py): an ERROR log when no
    # chunk completes within this many seconds (None = off); with
    # watchdog_abort the stall escalates to an interrupt of the main
    # thread from the second interval on.
    watchdog_timeout_s: Optional[float] = None
    watchdog_abort: bool = False
    # Multi-process preemption-notice poll cadence (steps): the SIGTERM flag
    # is gathered every this-many steps so every process enters the
    # emergency checkpoint together.  One process checks at every chunk
    # boundary and ignores this.
    preempt_poll_steps: int = PREEMPT_POLL_STEPS_DEFAULT
    # Deterministic fault injection (resilience/chaos.py): {key: int} of
    # faults, each fired once at its position; empty = off.  fit checks
    # the keys (unknown ones raise there, as in the JAX package).
    chaos: dict[str, Any] = dataclasses.field(default_factory=dict)
    # Event tracing (telemetry/trace.py).  trace_ring_events: the bounded
    # in-memory ring of span/instant events on the run's registry (0 turns
    # tracing off).  trace_export: write it as Chrome-trace JSON
    # (<workdir>/trace_p<i>.json) at every fit exit.  flight_recorder: dump
    # the ring and a registry snapshot to <workdir>/flight_recorder_p<i>.json
    # on abnormal exits (rollback, preemption, setup failure, crash, and a
    # SIGTERM's arrival).
    trace_ring_events: int = 4096
    trace_export: bool = False
    flight_recorder: bool = True
    # Batches an eval pass reads (harness/evaluate.py); None = one pass
    # over the split.
    eval_batches: Optional[int] = None

    def __post_init__(self):
        wide = {f: getattr(self, f) for f in ("mesh_model", "mesh_seq",
                                               "mesh_pipe", "mesh_expert")
                if getattr(self, f) != 1}
        if self.param_rules:
            wide["param_rules"] = self.param_rules
        if self.nan_policy not in ("abort", "rollback"):
            raise ValueError(f"nan_policy must be 'abort' or 'rollback', "
                             f"got {self.nan_policy!r}")
        if wide:
            raise NotImplementedError(
                f"{wide} not ported: the port is data parallel only "
                f"(tensor, sequence, pipeline and expert parallelism are "
                f"ROADMAP §1 item 6)")

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_CONFIGS: dict[str, ExperimentConfig] = {}


def _add(cfg: ExperimentConfig) -> ExperimentConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- MNIST LeNet, the single-worker reference config. --------------------
_add(
    ExperimentConfig(
        name="lenet_mnist",
        model="lenet",
        dataset="mnist",
        image_size=28,
        global_batch_size=64,
        optimizer=OptimizerConfig(name="sgd", learning_rate=0.1),
        train_steps=2000,
    )
)

# --- CIFAR-10 ResNet-32 sync-replica DP. -----------------------------------
_add(
    ExperimentConfig(
        name="resnet32_cifar10",
        model="resnet32_cifar",
        dataset="cifar10",
        image_size=32,
        global_batch_size=128,
        optimizer=OptimizerConfig(
            name="momentum",
            learning_rate=0.1,
            momentum=0.9,
            decay_steps=20000,
            decay_rate=0.1,
        ),
        weight_decay=2e-4,
        train_steps=64000,
    )
)

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


# --- PTB LSTM family: Zaremba staged-LR SGD with gradient clipping. ------
# Per size (lr decay, clip, hold epochs "max_epoch", total epochs
# "max_max_epoch", unroll) as the reference's small/medium/large configs;
# an epoch is the PTB train split's 929,589 tokens over batch x unroll.
for _size, _lr_decay, _clip, _hold, _total, _nsteps in (
    ("small", 0.5, 5.0, 4, 13, 20),
    ("medium", 0.8, 5.0, 6, 39, 35),
    ("large", 1 / 1.15, 10.0, 14, 55, 35),
):
    _spe = 929_589 // (20 * _nsteps)
    _add(
        ExperimentConfig(
            name=f"ptb_{_size}",
            model="ptb_lstm",
            task="lm",
            model_kwargs={"config": _size},
            dataset="ptb",
            global_batch_size=20,
            num_steps=_nsteps,
            optimizer=OptimizerConfig(
                name="sgd",
                learning_rate=1.0,
                decay_rate=_lr_decay,
                steps_per_epoch=_spe,
                hold_epochs=_hold,
                clip_global_norm=_clip,
            ),
            train_steps=_spe * _total,
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
