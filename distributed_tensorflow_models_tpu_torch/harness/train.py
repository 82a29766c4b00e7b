"""Training driver: build the dataset, state and step from a config and run
N steps.

PyTorch counterpart of the training path of
``distributed_tensorflow_models_tpu/harness/train.py`` on one device, for
classification (``task="classification"``) and language models
(``task="lm"``).  Batches reach the step through the input pipeline
(``data/pipeline.py``).  Checkpointing, resilience and the telemetry
reports are not ported yet; ``fit`` runs ``cfg.train_steps`` steps and
reports per-step metrics, step time and images/s or tokens/s.
"""

from __future__ import annotations

import dataclasses
import glob
import inspect
import json
import logging
import os
import time
from typing import Optional

import torch

from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import datasets as datalib
from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
from distributed_tensorflow_models_tpu_torch.harness.config import ExperimentConfig
from distributed_tensorflow_models_tpu_torch.models import builder_takes, get_model

log = logging.getLogger("dtm")


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is wanted and absent — never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    return dev


def build_dataset(cfg: ExperimentConfig, split: str = "train"):
    """The config's dataset, as the JAX package's ``build_dataset`` builds
    it for process 0 of 1: MNIST and CIFAR-10 (their loaders' synthetic
    sets where ``DATA_DIR`` holds no files), synthetic ImageNet, ImageNet
    from the TFRecord shards ``DATA_DIR/imagenet/train-*`` (``validation-*``
    for another split; the synthetic set only where no shard matches), and
    PTB."""
    if cfg.dataset == "mnist":
        return datalib.mnist_dataset(cfg.global_batch_size, split, cfg.seed)
    if cfg.dataset == "cifar10":
        return datalib.cifar10_dataset(cfg.global_batch_size, split, cfg.seed)
    if cfg.dataset == "imagenet_synthetic":
        return datalib.synthetic_imagenet_dataset(
            cfg.global_batch_size, cfg.image_size, cfg.seed)
    if cfg.dataset == "imagenet":
        pattern = os.path.join(
            datalib.DATA_DIR, "imagenet",
            "train-*" if split == "train" else "validation-*")
        paths = sorted(glob.glob(pattern))
        if not paths:
            log.warning("no ImageNet shards under %s; using synthetic data",
                        pattern)
            return datalib.synthetic_imagenet_dataset(
                cfg.global_batch_size, cfg.image_size, cfg.seed)
        return datalib.ImageNetTFRecordDataset(
            paths, cfg.global_batch_size, train=split == "train",
            image_size=cfg.image_size, seed=cfg.seed, label_offset=1)
    if cfg.dataset == "ptb":
        return datalib.ptb_dataset(cfg.global_batch_size, cfg.num_steps,
                                   split, cfg.vocab_size)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _model_kwargs(cfg: ExperimentConfig) -> dict:
    """The config's model kwargs plus, for the transformer, its attention
    implementation (the JAX harness's ``_mesh_model_kwargs``) and, for a
    model whose builder takes ``image_size`` (one whose first dense width
    follows from the input's size: flax infers it from the sample at init,
    the port fixes it at construction), ``cfg.image_size``; an explicit
    ``model_kwargs`` entry wins."""
    kwargs = {}
    if cfg.model == "transformer_lm":
        kwargs["attn_impl"] = cfg.attn_impl
    if builder_takes(cfg.model, "image_size"):
        kwargs["image_size"] = cfg.image_size
    return {**kwargs, **cfg.model_kwargs}


def build_model(cfg: ExperimentConfig, device: torch.device) -> torch.nn.Module:
    """The config's model, initialised from ``cfg.seed`` on the CPU (so the
    weights do not depend on the device) and moved to ``device``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.model, generator=gen, **_model_kwargs(cfg))
    return model.to(device)


def build_state(cfg: ExperimentConfig, device: torch.device) -> TrainState:
    """The model, optimizer and EMA of ``cfg`` on ``device``; an LM whose
    model has ``initial_carry`` (the PTB LSTM) starts from its zero f32
    carry at ``global_batch_size``, on the device."""
    model = build_model(cfg, device)
    carry = None
    if cfg.task == "lm" and hasattr(model, "initial_carry"):
        carry = model.initial_carry(cfg.global_batch_size, device)
    return TrainState.create(model, cfg.optimizer.make(),
                             ema_decay=cfg.ema_decay, carry=carry)


def build_loss(cfg: ExperimentConfig, state: TrainState):
    if cfg.task == "lm":
        forward = inspect.signature(state.model.forward).parameters
        if cfg.fused_unembed and "return_hidden" not in forward:
            raise ValueError("fused_unembed requires a model with a "
                             f"return_hidden path ({cfg.model!r} has none)")
        return train_loop.lm_loss_fn(state.model,
                                     fused_unembed=cfg.fused_unembed)
    return train_loop.classification_loss_fn(
        state.model, label_smoothing=cfg.label_smoothing,
        weight_decay=cfg.weight_decay, aux_loss_weight=cfg.aux_loss_weight)


def build_step(cfg: ExperimentConfig, state: TrainState):
    return train_loop.make_train_step(build_loss(cfg, state))


@dataclasses.dataclass
class FitResult:
    state: TrainState
    final_metrics: dict
    history: list[dict]
    device: str

    # The steady window is every step but the first, which pays kernel
    # builds and library warm-up; both numbers are None for a one-step run.

    @property
    def steady_step_time_s(self) -> Optional[float]:
        """Mean step time (batch handed over to metrics back) over the
        steady window; the wait for input is not in it."""
        times = [row["step_time_s"] for row in self.history[1:]]
        return sum(times) / len(times) if times else None

    def _steady_rate(self, key: str) -> Optional[float]:
        if len(self.history) < 2:
            return None
        total = sum(row[key] for row in self.history[1:])
        return total / (self.history[-1]["end_s"] - self.history[0]["end_s"])

    @property
    def images_per_sec(self) -> Optional[float]:
        """End-to-end throughput: the steady window's examples (images, or
        sequences of an LM) over its wall time, from the end of the first
        step to the end of the last, the wait for input included."""
        return self._steady_rate("batch_size")

    @property
    def tokens_per_sec(self) -> Optional[float]:
        """An LM's end-to-end throughput: the steady window's tokens over
        its wall time, as ``images_per_sec``; None for image models."""
        if not self.history or "tokens" not in self.history[0]:
            return None
        return self._steady_rate("tokens")


def _close_quietly(prefetcher, host) -> None:
    """Stop the prefetcher, then the host pipeline it pulls from, so no
    thread is left blocked on a full buffer.  Either may be None (the
    build failed before it); a stop that raises (a pending producer error)
    is logged, not raised, as the JAX package's teardown does."""
    try:
        if prefetcher is not None:
            prefetcher.stop()
    except Exception:
        log.exception("device prefetcher stop failed")
    finally:
        try:
            if host is not None:
                host.stop()
        except Exception:
            log.exception("host pipeline stop failed")


def fit(cfg: ExperimentConfig, workdir: Optional[str] = None,
        device: Optional[str | torch.device] = None) -> FitResult:
    """Train ``cfg.train_steps`` steps from a fresh state.

    Batches come through the stack the JAX package's ``fit`` builds:
    :class:`HostPipeline` (``prefetch=4``, ``max(1, cfg.data_workers)``
    workers) assembles them on host threads, then :class:`DevicePrefetcher`
    (``depth=2``) stages them in page-locked memory and copies them to the
    device on a stream of its own, while earlier steps run.

    Each row of the history holds the step's metrics, ``data_s`` (the time
    blocked in ``next`` on the prefetcher: the wait for input left on the
    step's path), ``step_time_s`` (from the batch handed over to the
    metrics read back, which waits for the device) and ``end_s`` (the time
    since the loop started at the step's end).  With a ``workdir`` the rows
    also go to ``<workdir>/metrics.jsonl``.  Both pipeline stages are
    stopped on the way out, however the loop ends."""
    dev = resolve_device(device)
    state = build_state(cfg, dev)
    step_fn = build_step(cfg, state)
    dataset = build_dataset(cfg)
    registry = telemetry.MetricsRegistry()
    history: list[dict] = []
    out = host = batches = None
    try:
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            out = open(os.path.join(workdir, "metrics.jsonl"), "w")
        host = pipelib.HostPipeline(
            dataset, prefetch=4, num_workers=max(1, int(cfg.data_workers)),
            registry=registry)
        batches = pipelib.DevicePrefetcher(host, dev, depth=2,
                                           registry=registry)
        start = time.perf_counter()
        for _ in range(cfg.train_steps):
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch, cfg.seed)
            row = {k: float(v) for k, v in metrics.items()}
            t2 = time.perf_counter()
            if cfg.task == "lm":
                shape = batch["inputs"].shape
                row.update(batch_size=int(shape[0]),
                           tokens=int(shape[0] * shape[1]))
            else:
                row.update(batch_size=int(batch["label"].shape[0]))
            row.update(step=state.step, data_s=t1 - t0, step_time_s=t2 - t1,
                       end_s=t2 - start)
            history.append(row)
            if out is not None:
                out.write(json.dumps(row) + "\n")
            if state.step % cfg.log_every_steps == 0 or state.step == 1:
                log.info("step %d loss %.4f, wait for input %.1f ms + step "
                         "%.1f ms", state.step, row["loss"],
                         1e3 * row["data_s"], 1e3 * row["step_time_s"])
    finally:
        _close_quietly(batches, host)
        if out is not None:
            out.close()
    final = history[-1] if history else {}
    return FitResult(state=state, final_metrics=final, history=history,
                     device=str(dev))
