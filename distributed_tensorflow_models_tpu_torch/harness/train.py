"""Training driver: build the dataset, state and step from a config and run
N steps.

PyTorch counterpart of the training path of
``distributed_tensorflow_models_tpu/harness/train.py`` on one device, for
classification (``task="classification"``) and language models
(``task="lm"``).  Checkpointing, resilience and telemetry are not ported
yet; ``fit`` runs ``cfg.train_steps`` steps and reports per-step metrics,
step time and images/s or tokens/s.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

import torch

from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import datasets as datalib
from distributed_tensorflow_models_tpu_torch.harness.config import ExperimentConfig
from distributed_tensorflow_models_tpu_torch.models import get_model

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


def build_dataset(cfg: ExperimentConfig) -> datalib.ArrayDataset:
    if cfg.dataset == "imagenet_synthetic":
        return datalib.synthetic_imagenet_dataset(
            cfg.global_batch_size, cfg.image_size, cfg.seed)
    if cfg.dataset == "imagenet":
        # ImageNet TFRecords are not ported yet: the JAX driver's own
        # no-shards fallback is the synthetic set of the same shapes.
        log.warning("ImageNet records are not read by the port; using "
                    "synthetic data")
        return datalib.synthetic_imagenet_dataset(
            cfg.global_batch_size, cfg.image_size, cfg.seed)
    if cfg.dataset == "ptb":
        return datalib.ptb_dataset(cfg.global_batch_size, cfg.num_steps,
                                   "train", cfg.vocab_size)
    raise ValueError(f"dataset {cfg.dataset!r} is not ported yet")


def _model_kwargs(cfg: ExperimentConfig) -> dict:
    """The config's model kwargs plus, for the transformer, its attention
    implementation (the JAX harness's ``_mesh_model_kwargs``); an explicit
    ``model_kwargs`` entry wins."""
    kwargs = {}
    if cfg.model == "transformer_lm":
        kwargs["attn_impl"] = cfg.attn_impl
    return {**kwargs, **cfg.model_kwargs}


def build_model(cfg: ExperimentConfig, device: torch.device) -> torch.nn.Module:
    """The config's model, initialised from ``cfg.seed`` on the CPU (so the
    weights do not depend on the device) and moved to ``device``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.model, generator=gen, **_model_kwargs(cfg))
    return model.to(device)


def build_state(cfg: ExperimentConfig, device: torch.device) -> TrainState:
    return TrainState.create(build_model(cfg, device), cfg.optimizer.make())


def build_loss(cfg: ExperimentConfig, state: TrainState):
    if cfg.task == "lm":
        if cfg.fused_unembed and cfg.model != "transformer_lm":
            raise ValueError("fused_unembed needs a model with a "
                             "return_hidden path (transformer_lm)")
        return train_loop.lm_loss_fn(state.model,
                                     fused_unembed=cfg.fused_unembed)
    return train_loop.classification_loss_fn(
        state.model, weight_decay=cfg.weight_decay)


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
        """Mean device step time (batch copy in, metrics back) over the
        steady window; host batch assembly is not in it."""
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
        step to the end of the last, host batch assembly included."""
        return self._steady_rate("batch_size")

    @property
    def tokens_per_sec(self) -> Optional[float]:
        """An LM's end-to-end throughput: the steady window's tokens over
        its wall time, as ``images_per_sec``; None for image models."""
        if not self.history or "tokens" not in self.history[0]:
            return None
        return self._steady_rate("tokens")


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def fit(cfg: ExperimentConfig, workdir: Optional[str] = None,
        device: Optional[str | torch.device] = None) -> FitResult:
    """Train ``cfg.train_steps`` steps from a fresh state.

    Each row of the history holds the step's metrics, the host's batch
    assembly time (``data_s``), the step time (``step_time_s``: from the
    batch's host-to-device copy to the metrics read back, which waits for
    the device) and the time since the loop started at the step's end
    (``end_s``).  Batches are assembled in series with the steps.  With a
    ``workdir`` the rows also go to ``<workdir>/metrics.jsonl``."""
    dev = resolve_device(device)
    state = build_state(cfg, dev)
    step_fn = build_step(cfg, state)
    batches = iter(build_dataset(cfg))
    history: list[dict] = []
    out = None
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        out = open(os.path.join(workdir, "metrics.jsonl"), "w")
    try:
        start = time.perf_counter()
        for _ in range(cfg.train_steps):
            t0 = time.perf_counter()
            host_batch = next(batches)
            t1 = time.perf_counter()
            batch = _to_device(host_batch, dev)
            state, metrics = step_fn(state, batch, cfg.seed)
            row = {k: float(v) for k, v in metrics.items()}
            t2 = time.perf_counter()
            if cfg.task == "lm":
                shape = host_batch["inputs"].shape
                row.update(batch_size=int(shape[0]),
                           tokens=int(shape[0] * shape[1]))
            else:
                row.update(batch_size=int(host_batch["label"].shape[0]))
            row.update(step=state.step, data_s=t1 - t0, step_time_s=t2 - t1,
                       end_s=t2 - start)
            history.append(row)
            if out is not None:
                out.write(json.dumps(row) + "\n")
            if state.step % cfg.log_every_steps == 0 or state.step == 1:
                log.info("step %d loss %.4f, batch %.1f ms + step %.1f ms",
                         state.step, row["loss"], 1e3 * row["data_s"],
                         1e3 * row["step_time_s"])
    finally:
        if out is not None:
            out.close()
    final = history[-1] if history else {}
    return FitResult(state=state, final_metrics=final, history=history,
                     device=str(dev))
