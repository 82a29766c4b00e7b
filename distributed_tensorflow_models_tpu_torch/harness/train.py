"""Training driver: build the dataset, state and step from a config and run
N steps.

PyTorch counterpart of the training path of
``distributed_tensorflow_models_tpu/harness/train.py``, for classification
(``task="classification"``) and language models (``task="lm"``), on one
device or as one process of a data-parallel world (``core/mesh.py``: one
device per process, the gradients all-reduced in the step).  Batches
reach the step through the input pipeline (``data/pipeline.py``) in chunks
of ``cfg.steps_per_loop``, each process reading its rows of the global
batch; on CUDA the step is captured once as a CUDA graph, collectives
included, and replayed.  Checkpointing, resilience and the telemetry
reports are not ported yet; ``fit`` runs ``cfg.train_steps`` steps and
reports per-step metrics, step time and images/s or tokens/s of the
global batch.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import inspect
import json
import logging
import os
import time
from typing import Optional, Sequence

import torch

from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.mesh import resolve_device
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import datasets as datalib
from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
from distributed_tensorflow_models_tpu_torch.harness.config import ExperimentConfig
from distributed_tensorflow_models_tpu_torch.models import builder_takes, get_model

log = logging.getLogger("dtm")


def build_dataset(cfg: ExperimentConfig, split: str = "train",
                  mesh: Optional[meshlib.Mesh] = None):
    """The config's dataset, as the JAX package's ``build_dataset`` builds
    it: MNIST and CIFAR-10 (their loaders' synthetic sets where
    ``DATA_DIR`` holds no files), synthetic ImageNet, ImageNet from the
    TFRecord shards ``DATA_DIR/imagenet/train-*`` (``validation-*`` for
    another split; the synthetic set only where no shard matches), and
    PTB.  Each process reads only its ``global_batch/process_count`` rows
    of every global batch, in process order: process ``mesh.rank`` of
    ``mesh.world_size`` (without a mesh, of the default process group's
    world, or 0 of 1 when there is none)."""
    if mesh is not None:
        proc = dict(process_index=mesh.rank, process_count=mesh.world_size)
    elif torch.distributed.is_initialized():
        proc = dict(process_index=torch.distributed.get_rank(),
                    process_count=torch.distributed.get_world_size())
    else:
        proc = dict(process_index=0, process_count=1)
    if cfg.dataset == "mnist":
        return datalib.mnist_dataset(cfg.global_batch_size, split, cfg.seed,
                                     **proc)
    if cfg.dataset == "cifar10":
        return datalib.cifar10_dataset(cfg.global_batch_size, split, cfg.seed,
                                       **proc)
    if cfg.dataset == "imagenet_synthetic":
        return datalib.synthetic_imagenet_dataset(
            cfg.global_batch_size, cfg.image_size, cfg.seed, **proc)
    if cfg.dataset == "imagenet":
        pattern = os.path.join(
            datalib.DATA_DIR, "imagenet",
            "train-*" if split == "train" else "validation-*")
        paths = sorted(glob.glob(pattern))
        if not paths:
            log.warning("no ImageNet shards under %s; using synthetic data",
                        pattern)
            return datalib.synthetic_imagenet_dataset(
                cfg.global_batch_size, cfg.image_size, cfg.seed, **proc)
        return datalib.ImageNetTFRecordDataset(
            paths, cfg.global_batch_size, train=split == "train",
            image_size=cfg.image_size, seed=cfg.seed, label_offset=1, **proc)
    if cfg.dataset == "ptb":
        return datalib.ptb_dataset(cfg.global_batch_size, cfg.num_steps,
                                   split, cfg.vocab_size, **proc)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def mesh_from_config(cfg: ExperimentConfig,
                     device: Optional[str | torch.device] = None
                     ) -> meshlib.Mesh:
    """The one place a config becomes a mesh: ``cfg.mesh_*`` over the
    default process group's world (a world of one without a group), on
    ``device`` (by default the group's; CUDA without a group)."""
    return meshlib.create_mesh(
        meshlib.MeshSpec(data=cfg.mesh_data, model=cfg.mesh_model,
                         seq=cfg.mesh_seq, pipe=cfg.mesh_pipe,
                         expert=cfg.mesh_expert),
        device)


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


def build_state(cfg: ExperimentConfig, device: torch.device,
                mesh: Optional[meshlib.Mesh] = None) -> TrainState:
    """The model, optimizer and EMA of ``cfg`` on ``device``; an LM whose
    model has ``initial_carry`` (the PTB LSTM) starts from its zero f32
    carry, on the device, at this process's rows of the global batch
    (``global_batch_size`` without a mesh): the carry is batch-sharded."""
    model = build_model(cfg, device)
    carry = None
    if cfg.task == "lm" and hasattr(model, "initial_carry"):
        rows = (cfg.global_batch_size if mesh is None else
                meshlib.local_batch_size(cfg.global_batch_size, mesh))
        carry = model.initial_carry(rows, device)
    return TrainState.create(model, cfg.optimizer.make(cfg.train_steps),
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
    """The eager single step (``TrainStep``) of ``cfg``."""
    return train_loop.make_train_step(build_loss(cfg, state))


def _chunk_len(step: int, cfg: ExperimentConfig,
               hooks: Sequence[hooklib.Hook] = ()) -> int:
    """Length of the next chunk starting after ``step``: up to
    ``cfg.steps_per_loop``, shrunk so the chunk ends exactly at (a) the
    next ``log_every_steps`` boundary, (b) ``train_steps``, and (c) the
    FIRST step any hook ``wants_step``: a chunk is one call, so the only
    way a hook sees the state of the step it fires at is for the chunk to
    end there.  Every hook therefore fires at the same steps, with the
    same state, for any ``steps_per_loop`` (the JAX package's rule)."""
    k = min(cfg.steps_per_loop, cfg.train_steps - step)
    if cfg.log_every_steps and cfg.log_every_steps > 0:
        k = min(k, cfg.log_every_steps - step % cfg.log_every_steps)
    k = max(k, 1)
    for i in range(1, k):
        if any(h.wants_step(step + i) for h in hooks):
            return i
    return k


# Chunks the host may have dispatched beyond the one the device runs: the
# host runs ahead of the device (metrics stay there), and this bounds how
# many batches and metric rows it holds for the device meanwhile.
RUN_AHEAD_CHUNKS = 2


@dataclasses.dataclass
class FitResult:
    """What ``fit`` returns.  ``history`` has a row per step: its metrics
    (averaged over the data axis), ``batch_size`` (and ``tokens`` for an
    LM) of the global batch, ``step``, ``data_s`` and
    ``step_time_s`` (its chunk's wait for input and host time after it,
    each divided by the chunk's steps) and ``end_s`` (its chunk's end
    since the loop started, on the host's clock).  The timed window runs
    from a device sync at the end of the first chunk (which pays kernel
    builds and the capture) to one at the run's end; ``window_s`` is its
    wall time, ``window_steps`` its steps and ``window_data_s`` the wait
    for input in it (``None``, 0 and 0 for a run of one chunk).
    ``captures``, ``capture_s`` and ``replayed_steps`` say how the steps
    ran: CUDA-graph captures, their seconds, and the steps run by replay
    (every step after the first on CUDA, none on the CPU).
    ``chunks_in_flight`` is the most chunks the device had still to run
    just after the host dispatched one (0 on the CPU): 2 or more means the
    host ran ahead of the device."""

    state: TrainState
    final_metrics: dict
    history: list[dict]
    device: str
    window_s: Optional[float] = None
    window_steps: int = 0
    window_data_s: float = 0.0
    captures: int = 0
    capture_s: float = 0.0
    replayed_steps: int = 0
    chunks_in_flight: int = 0
    registry: Optional[telemetry.MetricsRegistry] = None

    @property
    def steady_step_time_s(self) -> Optional[float]:
        """Mean step time over the timed window, the wait for input taken
        out: (window wall - its wait for input) / its steps."""
        if not self.window_steps:
            return None
        return (self.window_s - self.window_data_s) / self.window_steps

    def _steady_rate(self, key: str) -> Optional[float]:
        if not self.window_steps:
            return None
        total = sum(row[key] for row in self.history[-self.window_steps:])
        return total / self.window_s

    @property
    def images_per_sec(self) -> Optional[float]:
        """End-to-end throughput: the timed window's examples (images, or
        sequences of an LM) over its wall time, between two device syncs,
        the wait for input included."""
        return self._steady_rate("batch_size")

    @property
    def tokens_per_sec(self) -> Optional[float]:
        """An LM's end-to-end throughput: the timed window's tokens over
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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit(cfg: ExperimentConfig, workdir: Optional[str] = None,
        device: Optional[str | torch.device] = None,
        mesh: Optional[meshlib.Mesh] = None) -> FitResult:
    """Train ``cfg.train_steps`` steps from a fresh state, as this process's
    share of ``mesh`` (default :func:`mesh_from_config`: every process of
    the default process group on the data axis, or this process alone when
    there is none; ``meshlib.local_mesh`` runs alone whatever the world).

    Every process builds the same state from ``cfg.seed``; the state is
    placed without collectives and checked once to agree across the
    processes (``train_loop.place_state``).  Each process reads its rows
    of every global batch (:func:`build_dataset`), and the steps run under
    ``meshlib.data_parallel(mesh)``: the gradients and metrics are
    averaged over the processes, BatchNorm's moments are global and
    dropout draws the global batch's masks, so the trajectory is that of
    one process at the global batch.  Only process 0 counts steps, logs
    and writes ``metrics.jsonl``; every process stops at the same step
    and runs the NaN guard on the same (averaged) metrics.

    Batches come through the stack the JAX package's ``fit`` builds:
    :class:`HostPipeline` (``prefetch=4``, ``max(1, cfg.data_workers)``
    workers) assembles them on host threads, :class:`DevicePrefetcher`
    (``depth=2``) stages them in page-locked memory and copies them to the
    device on a stream of its own, and :class:`BatchStacker` stacks up to
    ``cfg.steps_per_loop`` of them into one chunk (:func:`_chunk_len`).
    The K-step call (``train_loop.MultiStep``) runs the chunk: on CUDA the
    first step eagerly and every later one by replaying the step captured
    as a CUDA graph, whatever ``steps_per_loop``; on the CPU eagerly.

    Metrics stay on the device: the hooks (stop, step counter, logging,
    NaN guard, and ``<workdir>/metrics.jsonl`` at ``log_every_steps`` with
    a ``workdir``) read them at their cadence, and
    the history is filled at return from one transfer of every step's
    metrics.  The host runs up to ``RUN_AHEAD_CHUNKS`` chunks ahead of the
    device.  Time blocked on the next chunk is recorded under
    ``train/data_wait``; each chunk's wall over its steps under
    ``train/step_time``, once per step.  Both pipeline stages are stopped
    on the way out, however the loop ends."""
    if mesh is None:
        mesh = mesh_from_config(cfg, device)
    elif device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"fit was asked for {device} on a mesh of "
                         f"{mesh.device}")
    dev = resolve_device(mesh.device)
    state = train_loop.place_state(build_state(cfg, dev, mesh), mesh)
    registry = telemetry.MetricsRegistry()
    multi = train_loop.MultiStep(build_step(cfg, state), name=cfg.model,
                                 registry=registry)
    dataset = build_dataset(cfg, mesh=mesh)
    chief = mesh.rank == 0
    hooks: list[hooklib.Hook] = [hooklib.StopAtStepHook(cfg.train_steps)]
    if chief:
        hooks += [
            hooklib.StepCounterHook(cfg.log_every_steps,
                                    cfg.global_batch_size),
            hooklib.LoggingHook(cfg.log_every_steps, keys=("loss",)),
        ]
    chunks: list[tuple] = []
    pending: collections.deque = collections.deque()
    host = batches = None
    window = None
    in_flight = 0
    try:
        if workdir and chief:
            hooks.append(hooklib.MetricWriterHook(workdir,
                                                  cfg.log_every_steps))
        hooks.append(hooklib.NanGuardHook(cfg.log_every_steps))
        host = pipelib.HostPipeline(
            dataset, prefetch=4, num_workers=max(1, int(cfg.data_workers)),
            registry=registry)
        batches = pipelib.DevicePrefetcher(host, dev, depth=2,
                                           registry=registry)
        stacker = pipelib.BatchStacker(batches)
        for h in hooks:
            h.begin(state)
        start = time.perf_counter()
        while state.step < cfg.train_steps:
            first = state.step
            t0 = time.perf_counter()
            with registry.span(telemetry.DATA_WAIT):
                chunk, k = stacker.next_chunk(_chunk_len(first, cfg, hooks))
            t1 = time.perf_counter()
            with meshlib.data_parallel(mesh):
                state, rows = multi(state, chunk, cfg.seed)
            if dev.type == "cuda":
                pending.append(torch.cuda.Event())
                pending[-1].record()
                in_flight = max(in_flight,
                                sum(not e.query() for e in pending))
                if len(pending) > RUN_AHEAD_CHUNKS:
                    pending.popleft().synchronize()
            if window is None:
                _sync(dev)
                window = [time.perf_counter(), 0, 0.0]
            else:
                window[1] += k
                window[2] += t1 - t0
            t2 = time.perf_counter()
            for _ in range(k):
                registry.timer(telemetry.STEP_TIME).record((t2 - t0) / k)
            chunks.append((rows, _sizes(cfg, chunk, mesh), k, t1 - t0,
                           t2 - t1, t2 - start))
            del chunk
            ok = hooklib.run_hooks_after_chunk(
                hooks, state, rows, first, k, registry=registry,
                final_row=hooklib.LazyMetricRow(rows, k - 1, first + 1))
            if not ok:
                break
        _sync(dev)
        window_s = (time.perf_counter() - window[0]) if window else None
        for h in hooks:
            h.end(state)
    except BaseException:
        for h in hooks:
            try:
                h.abort(state)
            except Exception:
                log.exception("hook abort failed")
        raise
    finally:
        _close_quietly(batches, host)
    history = _history(chunks)
    return FitResult(
        state=state, final_metrics=history[-1] if history else {},
        history=history, device=str(dev),
        window_s=window_s if window and window[1] else None,
        window_steps=window[1] if window else 0,
        window_data_s=window[2] if window else 0.0,
        captures=multi.captures, capture_s=multi.capture_s,
        replayed_steps=multi.replays, chunks_in_flight=in_flight,
        registry=registry)


def _sizes(cfg: ExperimentConfig, chunk: dict, mesh: meshlib.Mesh) -> dict:
    """A chunk's examples per step (and tokens, for an LM) over the whole
    data axis: this process's rows times the processes."""
    if cfg.task == "lm":
        _, b, t = chunk["inputs"].shape
        b *= mesh.data_size
        return {"batch_size": int(b), "tokens": int(b * t)}
    return {"batch_size": int(chunk["label"].shape[1] * mesh.data_size)}


def _history(chunks: list[tuple]) -> list[dict]:
    """One row per step from the chunks' stacked metrics, read back in one
    transfer, and their sizes and host times."""
    if not chunks:
        return []
    names = chunks[0][0].names
    values = torch.cat([rows.values for rows, *_ in chunks]).tolist()
    history, step = [], 0
    for rows, size, k, data_s, host_s, end_s in chunks:
        for _ in range(k):
            row = dict(zip(names, values[step]))
            step += 1
            row.update(size, step=step, data_s=data_s / k,
                       step_time_s=host_s / k, end_s=end_s)
            history.append(row)
    return history
