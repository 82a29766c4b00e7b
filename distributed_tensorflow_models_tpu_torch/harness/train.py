"""Training driver: build the dataset, state and step from a config and run
N steps.

PyTorch counterpart of the training path of
``distributed_tensorflow_models_tpu/harness/train.py``, for classification
(``task="classification"``) and language models (``task="lm"``), on one
device or as one process of a world laid out by ``cfg.mesh_*``
(``core/mesh.py``: one device per process; the data axis all-reduces the
gradients, the model axis splits the parameters of ``cfg.param_rules``,
the seq axis a language model's tokens under ``cfg.seq_impl``).  Batches
reach the step through the input pipeline (``data/pipeline.py``) in chunks
of ``cfg.steps_per_loop``, each process reading its rows of the global
batch; on CUDA the step is captured once as a CUDA graph, collectives
included, and replayed.  Given a workdir, ``fit`` resumes from
its newest valid checkpoint and saves on the config's cadence
(``harness/checkpoint.py``), answers a preemption notice with an
emergency checkpoint, can roll a divergence back to the last finite
checkpoint, runs under a progress watchdog, takes injected faults
(``cfg.chaos``) and heartbeats to a supervising launcher (``resilience/``);
:func:`recoverable_fit` restarts it on transient failures.  Every run
keeps a telemetry registry with an event tracer; given a workdir, ``fit``
writes ``metrics.jsonl`` (with the telemetry hook's keys), TensorBoard
events and, on either exit, ``telemetry.json`` (the goodput report with
the MFU), and a flight record on abnormal exits.  It returns per-step
metrics, step time and images/s or tokens/s of the global batch.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import inspect
import json
import logging
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch import resilience, telemetry
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.mesh import resolve_device
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import datasets as datalib
from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
from distributed_tensorflow_models_tpu_torch.harness import startup as startuplib
from distributed_tensorflow_models_tpu_torch.harness.config import ExperimentConfig
from distributed_tensorflow_models_tpu_torch.models import builder_takes, get_model
from distributed_tensorflow_models_tpu_torch.parallel import tensor as tensorlib
from distributed_tensorflow_models_tpu_torch.resilience import chaos as chaoslib
from distributed_tensorflow_models_tpu_torch.resilience import heartbeat

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
    ``mesh.world_size``, its index on the data axis (without a mesh, of
    the default process group's world, or 0 of 1 when there is none); a
    language model's batches keep this process's columns over a seq axis
    (``_SeqColumns``)."""
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
        ds = datalib.ptb_dataset(cfg.global_batch_size, cfg.num_steps,
                                 split, cfg.vocab_size, **proc)
        if mesh is not None and mesh.seq_size > 1:
            check_seq_len(cfg, mesh)
            ds = _SeqColumns(ds, mesh)
        return ds
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


class _SeqColumns:
    """A dataset whose batches keep this process's columns of the token
    axis over the seq axis (``sharding.seq_split`` on the host, before the
    copy to the device); transparent otherwise."""

    def __init__(self, dataset, mesh: meshlib.Mesh):
        self._dataset = dataset
        self._mesh = mesh

    def __getattr__(self, name):  # get_state/batches_per_epoch/...
        return getattr(self._dataset, name)

    def set_state(self, state) -> None:
        self._dataset.set_state(state)

    def _split(self, batch):
        return {k: np.ascontiguousarray(v) for k, v in
                shardlib.seq_split(self._mesh, batch, 1).items()}

    def assemble(self, work):
        return self._split(self._dataset.assemble(work))

    def __iter__(self):
        return (self._split(b) for b in self._dataset)


def check_seq_len(cfg: ExperimentConfig, mesh: meshlib.Mesh) -> None:
    """A language model's segment must split over the seq axis: the JAX
    package's ring raises on an indivisible one, and so does the port
    before any batch is read."""
    n = mesh.seq_size
    if cfg.task == "lm" and n > 1 and cfg.num_steps % n:
        raise ValueError(f"seq len {cfg.num_steps} not divisible by seq "
                         f"axis {n}")


def seq_dim(cfg: ExperimentConfig) -> Optional[int]:
    """The batch dim split over the seq axis: the token axis of a language
    model's ``[B, T]`` batches, none for images."""
    return 1 if cfg.task == "lm" else None


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


def seq_attention_fn(cfg: ExperimentConfig, mesh: Optional[meshlib.Mesh],
                     counting: bool = False):
    """The sequence-parallel ``attention_fn`` of ``cfg.seq_impl`` over
    ``mesh``'s seq axis (the JAX harness's closures), with the model's
    ``attn_window`` moved into it: the ring (``attn_impl`` auto takes its
    ``auto`` impl, the flash chunk kernels on the card in bf16; flash its
    ``flash`` impl, which never folds and on the card raises for a tensor
    the kernels do not take; reference or blockwise its fold) or Ulysses
    (local attention by ``attn_impl``).
    ``counting``: the plain forms (the fold, the reference) for the FLOPs
    count on the meta device."""
    from distributed_tensorflow_models_tpu_torch.parallel import ring as ringlib

    window = cfg.model_kwargs.get("attn_window")
    if cfg.seq_impl == "ring":
        impl = ("fold" if counting or cfg.attn_impl not in ("auto", "flash")
                else cfg.attn_impl)
        return lambda q, k, v, causal=True: ringlib.ring_attention(
            q, k, v, mesh, causal=causal, impl=impl, window=window)
    if cfg.seq_impl == "ulysses":
        impl = "reference" if counting else cfg.attn_impl
        return lambda q, k, v, causal=True: ringlib.ulysses_attention(
            q, k, v, mesh, causal=causal, impl=impl, window=window)
    raise ValueError(f"unknown seq_impl {cfg.seq_impl!r}")


def _model_kwargs(cfg: ExperimentConfig,
                  mesh: Optional[meshlib.Mesh] = None,
                  counting: bool = False) -> dict:
    """The config's model kwargs plus, for the transformer, its attention
    implementation and, with ``cfg.seq_impl``, the sequence-parallel
    ``attention_fn`` over ``mesh`` with the window moved into it (the JAX
    harness's ``_mesh_model_kwargs``/``_init_model_kwargs``), and
    ``pipelined=True`` where ``cfg.mesh_pipe`` is wider than one (the JAX
    model runs its pipelined stack whenever it is given a pipe mesh); for a
    model whose builder takes ``image_size`` (one whose first dense width
    follows from the input's size: flax infers it from the sample at init,
    the port fixes it at construction), ``cfg.image_size``; an explicit
    ``model_kwargs`` entry wins otherwise."""
    kwargs = {}
    if cfg.model == "transformer_lm":
        if cfg.mesh_pipe > 1 and cfg.seq_impl:
            raise ValueError(
                "mesh_pipe and seq_impl cannot combine: the pipelined block "
                "stack schedules whole blocks per stage and does not route "
                "through the sequence-parallel attention_fn")
        if cfg.mesh_pipe > 1 and cfg.mesh_model > 1:
            raise ValueError(
                "mesh_pipe and mesh_model cannot combine: the "
                "tensor-parallel rule sets target per-block parameter "
                "names, which the pipelined stacked layout does not use — "
                "TP would silently fall back to replication")
        kwargs["attn_impl"] = cfg.attn_impl
        if cfg.seq_impl:
            kwargs["attention_fn"] = seq_attention_fn(cfg, mesh, counting)
    if builder_takes(cfg.model, "image_size"):
        kwargs["image_size"] = cfg.image_size
    kwargs = {**kwargs, **cfg.model_kwargs}
    if cfg.model == "transformer_lm" and cfg.mesh_pipe > 1:
        kwargs["pipelined"] = True
    if cfg.seq_impl:
        # The window lives in the attention_fn's closure.
        kwargs.pop("attn_window", None)
    return kwargs


def _model_key(cfg: ExperimentConfig) -> str:
    """The model kwargs as a cache key (the closure left out)."""
    kwargs = {k: v for k, v in _model_kwargs(cfg).items()
              if k != "attention_fn"}
    return repr(sorted(kwargs.items()))


def build_model(cfg: ExperimentConfig, device: torch.device,
                mesh: Optional[meshlib.Mesh] = None) -> torch.nn.Module:
    """The config's model, initialised whole from ``cfg.seed`` on the CPU
    (so the weights do not depend on the device or the layout), cut to
    this process's slices over ``mesh`` (``parallel/tensor.py::
    shard_model``: ``cfg.param_rules`` over the model axis, the pipelined
    stack's layers over pipe, the MoE's experts over expert) and moved to
    ``device``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.model, generator=gen, **_model_kwargs(cfg, mesh))
    if mesh is not None:
        tensorlib.shard_model(model, tensorlib.get_rules(cfg.param_rules),
                              mesh)
    return model.to(device)


def build_state(cfg: ExperimentConfig, device: torch.device,
                mesh: Optional[meshlib.Mesh] = None,
                num_steps: Optional[int] = None) -> TrainState:
    """The model, optimizer and EMA of ``cfg`` on ``device``; an LM whose
    model has ``initial_carry`` (the PTB LSTM) starts from its zero f32
    carry, on the device, at this process's rows of the global batch
    (``global_batch_size`` without a mesh): the carry is batch-sharded.
    The optimizer's device tables cover ``num_steps`` steps
    (``cfg.train_steps`` by default); the schedules' values do not depend
    on it."""
    model = build_model(cfg, device, mesh)
    carry = None
    if cfg.task == "lm" and hasattr(model, "initial_carry"):
        rows = (cfg.global_batch_size if mesh is None else
                meshlib.local_batch_size(cfg.global_batch_size, mesh))
        carry = model.initial_carry(rows, device)
    return TrainState.create(model, cfg.optimizer.make(
        cfg.train_steps if num_steps is None else num_steps),
                             ema_decay=cfg.ema_decay, carry=carry)


def build_loss(cfg: ExperimentConfig, state: TrainState):
    return _loss_of(cfg, state.model)


def _loss_of(cfg: ExperimentConfig, model: torch.nn.Module):
    if cfg.task == "lm":
        forward = inspect.signature(model.forward).parameters
        if cfg.fused_unembed and "return_hidden" not in forward:
            raise ValueError("fused_unembed requires a model with a "
                             f"return_hidden path ({cfg.model!r} has none)")
        return train_loop.lm_loss_fn(model, fused_unembed=cfg.fused_unembed)
    return train_loop.classification_loss_fn(
        model, label_smoothing=cfg.label_smoothing,
        weight_decay=cfg.weight_decay, aux_loss_weight=cfg.aux_loss_weight)


# The counts taken in this process, by everything a count depends on (the
# model's and the loss's settings, the global batch's shapes): the fits of
# one configuration (arms in turns, a test's several runs) would otherwise
# each build and trace the model on the meta device again (~1.3 s for
# ResNet-50, ~2.8 s for Inception-v3).  The lock makes a second caller of
# a count in flight (fit's first step, while the startup thread of
# harness/startup.py counts) wait for it instead of counting again.
_STEP_FLOPS: dict[tuple, float] = {}
_STEP_FLOPS_LOCK = threading.Lock()


def step_flops_fn(cfg: ExperimentConfig, mesh: meshlib.Mesh):
    """``batch -> FLOPs`` of one step of ``cfg`` over the data axis (this
    process's rows times the data axis), for ``MultiStep``'s ``flops_of``:
    the config's model built anew on the meta device, cut to this
    process's slices over the model, pipe and expert axes, its
    sequence-parallel attention on this process's columns (the
    collectives keep only their shapes there), put on the plain
    formulation (``train_loop.library_route``) and counted by
    ``train_loop.step_flops``.  The count is the model's share that this
    process computes (its pipeline stage's layers on every microbatch, its
    expert chunk's routing and its experts on every source's slots), times
    the data axis, whatever route the run's convolutions and attention
    take; at model, seq, pipe and expert axes of one, the whole model's at
    the global batch, the same on every process."""
    sizes, coords = getattr(mesh, "sizes", None), getattr(mesh, "coords", None)
    split = any(n > 1 for n in (sizes or (1,))[1:])

    def count(batch) -> float:
        rows = next(iter(batch.values())).shape[0] * mesh.data_size
        key = (cfg.model, _model_key(cfg), cfg.task, cfg.seq_impl,
               cfg.param_rules, sizes, coords,
               cfg.fused_unembed, cfg.label_smoothing, cfg.weight_decay,
               cfg.aux_loss_weight, rows,
               tuple((k, tuple(v.shape[1:]), v.dtype)
                     for k, v in sorted(batch.items())))
        with _STEP_FLOPS_LOCK:
            if key not in _STEP_FLOPS:
                with torch.device("meta"):
                    model = get_model(cfg.model, **_model_kwargs(
                        cfg, mesh if cfg.seq_impl else None, counting=True))
                    if split:
                        tensorlib.shard_model(
                            model, tensorlib.get_rules(cfg.param_rules), mesh)
                    meta = {k: torch.empty((rows, *v.shape[1:]),
                                           dtype=v.dtype)
                            for k, v in batch.items()}
                    carry = (model.initial_carry(rows, torch.device("meta"))
                             if cfg.task == "lm"
                             and hasattr(model, "initial_carry") else None)
                train_loop.library_route(model)
                _STEP_FLOPS[key] = train_loop.step_flops(
                    _loss_of(cfg, model), model, meta, carry)
            return _STEP_FLOPS[key]

    return count


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
    host ran ahead of the device.

    Resilience: ``restored_from`` is the checkpoint step the run resumed
    from (None for a fresh start); ``preempted`` says the run stopped
    early at a chunk boundary on a preemption notice, after an emergency
    checkpoint — rerunning the same command resumes it, so callers treat
    it as resumable, not failed; ``rollbacks`` and ``skipped_batches`` are
    the ``nan_policy="rollback"`` activity (also the ``train/rollbacks``
    and ``train/skipped_batches`` counters).  After a rollback the history
    holds the steps of the timeline that survived.  ``saves`` has a row
    per checkpoint save of the run: its ``step``, ``snapshot_s`` (the
    device-to-host copies enqueued, on the host's clock), ``write_s`` (the
    writer thread's wait for them and its write) and ``bytes``."""

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
    preempted: bool = False
    restored_from: Optional[int] = None
    rollbacks: int = 0
    skipped_batches: int = 0
    saves: list[dict] = dataclasses.field(default_factory=list)

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


def _close_quietly(prefetcher, host, raise_pending: bool = True) -> None:
    """Stop the prefetcher, then the host pipeline it pulls from, so no
    thread is left blocked on a full buffer.  Either may be None (the
    build failed before it); a stop that raises (a pending producer error)
    is logged, not raised, as the JAX package's teardown does.
    ``raise_pending=False`` (the rollback, which abandons this stream
    position) keeps even the log quiet about a pending producer error."""
    try:
        if prefetcher is not None:
            prefetcher.stop()
    except Exception:
        log.exception("device prefetcher stop failed")
    finally:
        try:
            if host is not None:
                host.stop(raise_pending=raise_pending)
        except Exception:
            log.exception("host pipeline stop failed")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _PreemptPollHook(hooklib.Hook):
    """Ends chunks at the multi-process preemption-poll steps (the poll is
    a collective, so every process must stand at the same step)."""

    def __init__(self, every_steps: int):
        self._every = every_steps

    def wants_step(self, step):
        return step % self._every == 0


# Sentinel of "no divergence seen here" in the any-process agreement on a
# chunk's losses (min-reduced, so above any step, inside the int32 wire).
_NO_BAD_STEP = 2**31 - 1


def fit(cfg: ExperimentConfig, workdir: Optional[str] = None,
        device: Optional[str | torch.device] = None,
        mesh: Optional[meshlib.Mesh] = None, *,
        extra_hooks: Sequence[hooklib.Hook] = (),
        restarts: int = 0,
        listener: Optional[resilience.PreemptionListener] = None
        ) -> FitResult:
    """Train to ``cfg.train_steps`` as this process's share of ``mesh``
    (default :func:`mesh_from_config`: every process of the default
    process group on the data axis, or this process alone when there is
    none; ``meshlib.local_mesh`` runs alone whatever the world), resuming
    from ``workdir``'s newest valid checkpoint when there is one.

    Every process builds the same state from ``cfg.seed``; the state is
    placed without collectives and checked once to agree across the
    processes (``train_loop.place_state``).  With a ``workdir`` the
    checkpoint is then restored *into* the placed tensors
    (``checkpoint.restore_or_init``: newest valid and finite step, torn
    ones walked past) and the dataset cursor set to it before the input
    pipeline opens.  Each process reads its rows of every global batch
    (:func:`build_dataset`), and the steps run under
    ``meshlib.data_parallel(mesh)``: the gradients and metrics are
    averaged over the processes, BatchNorm's moments are global and
    dropout draws the global batch's masks, so the trajectory is that of
    one process at the global batch.  Only process 0 counts steps, logs
    and writes ``metrics.jsonl``; every process stops at the same step
    and runs the NaN guard on the same (averaged) metrics.

    Telemetry: the run owns a fresh registry, threaded through the
    pipeline, the step (``MultiStep``: captures under ``train/compile``,
    calls under ``train/dispatch``, the FLOPs of :func:`step_flops_fn`),
    the checkpoint manager and a ``TelemetryHook`` ahead of the writer
    hooks, with a ``Tracer`` of ``cfg.trace_ring_events`` events on it.
    With a workdir the chief writes ``metrics.jsonl`` and TensorBoard
    events at ``log_every_steps`` and, on exit, success *and* failure,
    ``<workdir>/telemetry.json``: the goodput report splitting the wall
    time into compute, data stall, checkpoint and capture, with the MFU
    against the card's peak (``telemetry/goodput.py``); every process
    writes ``flight_recorder_p<i>.json`` at a rollback, preemption, setup
    failure, crash or SIGTERM (``cfg.flight_recorder``) and, with
    ``cfg.trace_export``, ``trace_p<i>.json``.

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
    NaN guard, checkpoint, ``extra_hooks``, and ``<workdir>/metrics.jsonl``
    at ``log_every_steps`` with a ``workdir``) read them at their cadence,
    and the history is filled at return from one transfer of every step's
    metrics.  The host runs up to ``RUN_AHEAD_CHUNKS`` chunks ahead of the
    device.  Time blocked on the next chunk is recorded under
    ``train/data_wait``; each chunk's wall over its steps under
    ``train/step_time``, once per step.  Both pipeline stages are stopped
    on the way out, however the loop ends.

    Resilience, with a ``workdir`` (without one: no checkpoint, no resume,
    no signal handlers):

    - **Checkpoints** — ``CheckpointHook`` every
      ``cfg.checkpoint_every_secs`` on the chief's clock and every
      ``cfg.checkpoint_every_steps``, and at the end; each save snapshots
      the state right after its chunk, with the ``BatchStacker``'s
      position of that chunk, and writes in the background.
    - **Preemption grace** — SIGTERM (or a first SIGINT) sets a flag
      (``listener``, or one of the run's own) checked at chunk
      boundaries, gathered every ``cfg.preempt_poll_steps`` steps across
      processes; on it an emergency checkpoint is written and ``fit``
      returns with ``preempted=True``.
    - **Divergence rollback** — ``cfg.nan_policy="rollback"`` checks
      every chunk's losses (one device reduction and one read, paid only
      under rollback); a non-finite one stops both pipeline stages,
      restores the newest finite checkpoint in place (a captured step
      keeps replaying its graph), deletes the later steps, reopens the
      pipeline at the restored cursor and skips exactly the offending
      chunk's batches when the replay reaches them, at most
      ``cfg.rollback_budget`` times.  The default ``"abort"`` raises.
    - **Watchdog** — ``cfg.watchdog_timeout_s`` diagnoses a run in which
      no chunk completes (beaten once per chunk).
    - **Chaos** — ``cfg.chaos`` (off by default) injects deterministic
      faults at these seams (``resilience/chaos.py``): a failing batch
      assembly, a NaN written into the chunk before the step copies it
      in, a torn checkpoint, SIGTERM, SIGKILL, a hidden newest checkpoint
      and a straggler delay, each once; ``chaos/armed_unfired`` in
      ``telemetry.json`` counts the faults that never fired.
    - **Fleet** — under a supervising launcher (``launch.py``) the
      process heartbeats (``resilience/heartbeat.py``): its phase
      (``restore``, ``compile``, ``train``, ``save``) and its step at
      every chunk boundary; the chief exports the ``fleet/*`` gauges
      (``FleetHook``).

    Cold start (``harness/startup.py``): ``cfg.xla_cache_dir`` points the
    kernel builds at their cache, and with ``cfg.aot_compile`` threads
    started before the restore load (or build) the step's kernel libraries
    and count its FLOPs; the first chunk waits
    for what is left of that work (booked in its capture's
    ``train/compile`` record) and raises a failed build.  The run is the
    same bit for bit either way; ``startup/aot_compile_s`` is the threads'
    duration.

    ``restarts`` seeds the ``train/restarts`` counter
    (:func:`recoverable_fit` passes its attempt number)."""
    if cfg.nan_policy == "rollback" and not workdir:
        raise ValueError("nan_policy='rollback' restores checkpoints: fit "
                         "needs a workdir")
    t_run0 = time.perf_counter()
    if mesh is None:
        mesh = mesh_from_config(cfg, device)
    elif device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"fit was asked for {device} on a mesh of "
                         f"{mesh.device}")
    dev = resolve_device(mesh.device)
    registry = telemetry.MetricsRegistry()
    registry.counter(telemetry.RESTARTS).inc(restarts)
    registry.counter(telemetry.ROLLBACKS)
    registry.counter(telemetry.SKIPPED_BATCHES)
    # 0 unless the startup thread runs (cfg.aot_compile), which stamps its
    # real duration.
    registry.gauge(telemetry.STARTUP_AOT_COMPILE).set(0.0)
    startuplib.apply_compile_cache(cfg.xla_cache_dir)
    ring = int(cfg.trace_ring_events or 0)
    tracer = telemetry.Tracer(capacity=max(1, ring),
                              process_index=mesh.process_index,
                              enabled=ring > 0)
    registry.trace = tracer
    state: Optional[TrainState] = None

    def dump_flight(reason: str) -> None:
        """The ring and a registry snapshot to ``flight_recorder_p<i>.json``
        (best-effort: forensics must never be what fails training)."""
        if not workdir or not cfg.flight_recorder or not tracer.enabled:
            return
        try:
            os.makedirs(workdir, exist_ok=True)
            tracer.dump_flight_record(
                telemetry.flight_record_path(workdir, tracer.process_index),
                reason, registry,
                extra={"step": -1 if state is None else state.step})
        except Exception:  # noqa: BLE001
            log.exception("flight-record dump (%s) failed", reason)

    tracer.instant("fit/entry", {"config": cfg.name, "restarts": restarts})
    chaos = chaoslib.get_injector(cfg.chaos, seed=cfg.seed,
                                  scope=workdir or "")
    if chaos is not None:
        # (Re)wire the memoised injector to THIS run's forensics: fires
        # land on the timeline, and the kill fault dumps before SIGKILL.
        chaos.tracer = tracer
        chaos.flight_dump = dump_flight
    # Every fleet-visible decision (save skip/replace, restore pick,
    # restore-vs-init, preemption, divergence) is the chief's; with one
    # process (or a mesh of one) an exact no-op.
    consensus = mesh_consensus(mesh)
    manager = None
    restored = False
    aot: Optional[startuplib.AotTrainStep] = None
    try:
        flops_of = step_flops_fn(cfg, mesh)
        with tracer.span("fit/build_state"):
            state = train_loop.place_state(build_state(cfg, dev, mesh), mesh)
        # The kernel loads and the FLOPs count run under the restore.
        aot = _start_aot(cfg, state, mesh, dev, flops_of, registry)
        multi = train_loop.MultiStep(build_step(cfg, state), name=cfg.model,
                                     registry=registry, flops_of=flops_of)
        if workdir:
            manager = ckptlib.CheckpointManager(
                workdir, keep=cfg.keep_checkpoints,
                process_index=consensus.process_index,
                process_count=consensus.process_count, registry=registry,
                consensus=consensus,
                # The chaos visibility-skew simulation: the hidden step
                # vanishes from this process's listings, never from reads.
                step_filter=chaos.step_filter() if chaos is not None else None)
            heartbeat.set_phase("restore")
            t0 = time.perf_counter()
            with tracer.span("fit/restore"):
                state, data_state, restored = restore_or_init(
                    manager, state, mesh)
            registry.gauge(telemetry.STARTUP_RESTORE).set(
                time.perf_counter() - t0)
        restored_from = state.step if restored else None
        # "compile" until the first chunk completes: its eager first step
        # and the capture (kernel builds included) live there, and a
        # heartbeat frozen there says so.
        heartbeat.set_phase("compile")
        dataset = build_dataset(cfg, mesh=mesh)
        if restored and data_state.get("dataset") and hasattr(dataset,
                                                              "set_state"):
            dataset.set_state(data_state["dataset"])
        if chaos is not None:
            dataset = chaos.wrap_dataset(dataset)
    except BaseException:
        if aot is not None:
            aot.join(timeout=120.0)
        dump_flight("setup_failure")
        _unwire_chaos_forensics(chaos)
        raise
    chief = mesh.process_index == 0
    hooks: list[hooklib.Hook] = [
        hooklib.StopAtStepHook(cfg.train_steps),
        # Before the writer hooks, which record what it injects; on every
        # process (its multi-process gather is a collective).
        hooklib.TelemetryHook(registry, cfg.log_every_steps,
                              consensus.process_count, device=dev,
                              n_devices=mesh.data_size, consensus=consensus),
    ]
    hb_writer = heartbeat.active_writer()
    if chief and hb_writer is not None:
        # Fleet-health gauges from the launcher's heartbeat directory
        # (plain file reads), before the writer hooks that record them;
        # a supervised fleet of one exports them too (the JAX package
        # only above one process).
        hooks.append(hooklib.FleetHook(registry, hb_writer.directory,
                                       consensus.process_count,
                                       cfg.log_every_steps))
    if chief:
        hooks += [
            hooklib.StepCounterHook(cfg.log_every_steps,
                                    cfg.global_batch_size),
            hooklib.LoggingHook(cfg.log_every_steps, keys=("loss",)),
        ]
    chunks: list[tuple] = []
    pending: collections.deque = collections.deque()
    host = batches = stacker = None
    window = None
    in_flight = 0
    # False while a chunk runs (its steps update the state in place, so a
    # failure inside one leaves tensors no step number describes) and while
    # a rollback has no pipeline open (no cursor belongs to the state):
    # no crash-time save may write either.
    consistent = True

    def open_pipeline() -> None:
        nonlocal host, batches, stacker
        host = pipelib.HostPipeline(
            dataset, prefetch=4, num_workers=max(1, int(cfg.data_workers)),
            registry=registry)
        batches = pipelib.DevicePrefetcher(host, dev, depth=2,
                                           registry=registry)
        stacker = pipelib.BatchStacker(batches)

    def save_fn(s: TrainState, _step: Optional[int] = None, *,
                force: bool = False) -> None:
        # The cursor saved is the stacker's: the batches the state has
        # consumed, not the host pipeline's read-ahead.  ``force`` (the
        # chaos tear hook's) changes nothing: every call saves.
        if not consistent or stacker is None:
            log.warning("no checkpoint at step %d: the state is not that of "
                        "a step with a known input position (a chunk or a "
                        "rollback failed part way)", s.step)
            return
        prev_phase = heartbeat.set_phase("save")
        try:
            manager.save(tensorlib.whole_state(s, mesh),
                         {"dataset": stacker.get_state()})
            if chaos is not None and chaos.should_tear(s.step):
                # The torn-write drill damages only durable files.
                manager.wait()
                chaos.tear_checkpoint(manager.directory, s.step)
        finally:
            if prev_phase:
                heartbeat.set_phase(prev_phase)

    own_listener = listener is None and manager is not None
    if own_listener:
        listener = resilience.PreemptionListener()
    poll_steps = max(1, int(cfg.preempt_poll_steps))

    def preempt_due(step: int) -> bool:
        if listener is None:
            return False
        if not consensus.active:
            return listener.preempted
        if step % poll_steps:
            return False
        return consensus.any_flag(listener.preempted, label="preempt-poll")

    def check_chunk_finite(rows, start: int, k: int) -> None:
        """Under rollback every chunk's losses are checked (one device
        reduction and one read), so the divergence is pinned to its
        chunk: the skip is exact only if detection lands in the offending
        chunk.  With several processes the earliest bad step any process
        saw is agreed, so all roll back together."""
        loss = rows["loss"][:k]
        bad_step = _NO_BAD_STEP
        if not bool(torch.isfinite(loss).all()):
            i = int((~torch.isfinite(loss)).nonzero()[0, 0])
            bad_step = start + 1 + i
        if consensus.active:
            bad_step = min(consensus.allgather_int(bad_step,
                                                   label="chunk-finite"))
        if bad_step < _NO_BAD_STEP:
            registry.trace.instant("train/divergence", {"step": bad_step})
            raise FloatingPointError(f"loss is not finite at step "
                                     f"{bad_step}")

    preempted = False
    rollbacks = skipped = steps_run = 0
    # Rollback bookkeeping, the JAX package's: pending [step, n] discards
    # n batches when the replay reaches step; executed skips are
    # re-scheduled when a later rollback rewinds behind them.
    pending_skips: list[list[int]] = []
    executed_skips: list[tuple[int, int]] = []

    def discard_batches(n: int) -> int:
        with registry.span(telemetry.DATA_WAIT):
            try:
                _, done = stacker.next_chunk(n)
            except StopIteration:
                done = 0
        return done

    def rollback(offender_start: int, offender_len: int) -> bool:
        """Restore the newest finite checkpoint in place and schedule the
        exact skip of the offending chunk; False when there is no finite
        checkpoint to restore."""
        nonlocal state, host, batches, stacker, window, consistent
        consistent = False
        _close_quietly(batches, host, raise_pending=False)
        host = batches = stacker = None
        manager.wait()
        try:
            saved, restored_data = manager.restore_newest_valid(
                tensorlib.whole_state(state, mesh),
                accept=train_loop.state_is_finite,
                accept_name="non-finite parameters")
            state = tensorlib.scatter_state_(state, saved, mesh)
        except FileNotFoundError as e:  # NoValidCheckpointError included
            log.error("rollback: no finite checkpoint to restore (%s)", e)
            return False
        step = state.step
        for stale in manager.all_steps():
            if stale > step:
                log.warning("rollback: deleting post-divergence checkpoint "
                            "at step %d", stale)
                manager.delete(stale)
        if restored_data.get("dataset") and hasattr(dataset, "set_state"):
            dataset.set_state(restored_data["dataset"])
        open_pipeline()
        consistent = True
        chunks[:] = [c for c in chunks if c[0] + c[3] <= step]
        window = None
        wanted = {s: n for s, n in executed_skips if s >= step}
        for s, n in pending_skips:
            wanted[s] = max(wanted.get(s, 0), n)
        if offender_start >= step:
            wanted[offender_start] = max(wanted.get(offender_start, 0),
                                         offender_len)
        pending_skips[:] = sorted([s, n] for s, n in wanted.items())
        log.warning("rollback: restored step %d; will skip the offending "
                    "chunk (steps %d..%d) on replay", step,
                    offender_start + 1, offender_start + offender_len)
        registry.trace.instant("train/rollback", {
            "restored_step": step, "offender_start": offender_start,
            "offender_len": offender_len})
        return True

    watchdog = None
    listener_installed = False
    fwatch: Optional[telemetry.FlightWatcher] = None
    looping = False

    def final_dump(reason: str) -> None:
        # Stop the signal watcher first, so that its thinner at-arrival
        # record cannot overwrite this one later.
        if fwatch is not None:
            fwatch.stop()
        dump_flight(reason)

    try:
        if workdir and chief:
            hooks += [
                hooklib.MetricWriterHook(workdir, cfg.log_every_steps),
                hooklib.TensorBoardHook(workdir, cfg.log_every_steps,
                                        process_index=0),
            ]
        hooks.append(hooklib.NanGuardHook(cfg.log_every_steps))
        if manager is not None:
            hooks.append(hooklib.CheckpointHook(
                save_fn, every_secs=cfg.checkpoint_every_secs,
                every_steps=cfg.checkpoint_every_steps,
                poll_every_steps=poll_steps, consensus=consensus))
        if listener is not None:
            listener_installed = own_listener and listener.install()
        if chaos is not None:
            hooks += _chaos_hooks(
                chaos, save_fn if manager is not None else None,
                cfg.train_steps,
                listener is not None and (listener_installed
                                          or not own_listener))
        hooks += list(extra_hooks)
        if consensus.active and listener is not None:
            hooks.append(_PreemptPollHook(poll_steps))
        if (listener is not None and workdir and cfg.flight_recorder
                and tracer.enabled):
            # At-arrival forensics: a SIGTERM'd process wedged in a
            # collective never reaches its chunk-boundary poll; the watcher
            # dumps the moment the signal lands.
            fwatch = telemetry.FlightWatcher(dump_flight)
            if not fwatch.install():
                fwatch = None
        if cfg.watchdog_timeout_s:
            watchdog = resilience.ProgressWatchdog(
                cfg.watchdog_timeout_s, registry=registry,
                abort=cfg.watchdog_abort)
        open_pipeline()
        for h in hooks:
            h.begin(state)
        if cfg.nan_policy == "rollback" and not restored:
            # A restore anchor before the first scheduled save, durable
            # before training can diverge past it.
            save_fn(state)
            manager.wait()
        start = time.perf_counter()
        looping = True
        # The first beat carries the (possibly restored) entry step: the
        # supervisor and the peers see "looping, at step N" before the
        # first chunk, with its capture, completes.
        heartbeat.beat(state.step)
        while state.step < cfg.train_steps:
            first = state.step
            if preempt_due(first):
                log.warning("preemption: writing an emergency checkpoint at "
                            "step %d and exiting (resumable: rerun the same "
                            "command)", first)
                registry.trace.instant("train/preempted", {"step": first})
                if manager is not None:
                    save_fn(state)
                    manager.wait()
                preempted = True
                final_dump("preempted")
                break
            while pending_skips and pending_skips[0][0] <= first:
                skip_at, n = pending_skips.pop(0)
                if skip_at < first:
                    log.warning("rollback: scheduled skip at step %d "
                                "overshot (loop is at %d); dropping it",
                                skip_at, first)
                    continue
                done = discard_batches(n)
                skipped += done
                registry.counter(telemetry.SKIPPED_BATCHES).inc(done)
                registry.trace.instant("train/skip_batches",
                                       {"step": first, "n": done})
                executed_skips.append((first, done))
                log.warning("rollback: advanced the dataset cursor past %d "
                            "offending batch(es) at step %d", done, first)
                # Refresh the rollback's record with its last act.
                dump_flight("rollback")
            k_req = _chunk_len(first, cfg, hooks)
            if pending_skips:
                # A chunk is one call: a scheduled skip is exact only if
                # a chunk ends at its step.
                k_req = min(k_req, pending_skips[0][0] - first)
            t0 = time.perf_counter()
            with registry.span(telemetry.DATA_WAIT):
                chunk, k = stacker.next_chunk(k_req)
            if chaos is not None:
                # In place into the stacker's fresh stack, on this stream,
                # before the K-step call copies its rows into the step.
                chunk = chaos.poison_batch(chunk, first + 1, k)
            if aot is not None:
                # The first chunk waits for what is left of the startup
                # work, and its capture books that wait as compile.
                wait = aot.acquire(startuplib.signature(chunk))
                if wait is not None:
                    multi.pending_compile_s += wait
            t1 = time.perf_counter()
            consistent = False
            with meshlib.data_parallel(mesh, seq_dim(cfg)):
                state, rows = multi(state, chunk, cfg.seed)
            consistent = True
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
            steps_run += k
            for _ in range(k):
                registry.timer(telemetry.STEP_TIME).record((t2 - t0) / k)
            chunks.append((first, rows, _sizes(cfg, chunk, mesh), k, t1 - t0,
                           t2 - t1, t2 - start))
            del chunk
            try:
                if cfg.nan_policy == "rollback":
                    check_chunk_finite(rows, first, k)
                ok = hooklib.run_hooks_after_chunk(
                    hooks, state, rows, first, k, registry=registry,
                    final_row=hooklib.LazyMetricRow(rows, k - 1, first + 1))
            except FloatingPointError:
                if cfg.nan_policy != "rollback":
                    raise
                if rollbacks >= cfg.rollback_budget:
                    log.error("rollback budget (%d) exhausted; aborting",
                              cfg.rollback_budget)
                    raise
                # The verdict is agreed across processes, so every process
                # rolls back together.
                if not rollback(first, k):
                    raise
                rollbacks += 1
                registry.counter(telemetry.ROLLBACKS).inc()
                dump_flight("rollback")
                ok = True
            # One complete event per chunk (dispatch and hook walk).
            tracer.complete("train/chunk", time.perf_counter() - t0,
                            ts_mono=t0, args={"start": first, "k": k})
            first_step = registry.gauge(telemetry.STARTUP_FIRST_STEP)
            if first_step.value == 0.0:
                # Fit entry to the first completed chunk.
                first_step.set(time.perf_counter() - t_run0)
                heartbeat.set_phase("train")
            if watchdog is not None:
                watchdog.beat(state.step)
            heartbeat.beat(state.step)
            if not ok:
                break
        _sync(dev)
        window_s = (time.perf_counter() - window[0]) if window else None
    except BaseException as e:
        tracer.instant("fit/abort", {"step": state.step,
                                     "error": repr(e)[:200]})
        for h in hooks:
            try:
                h.abort(state)
            except Exception:
                log.exception("hook abort failed")
        if manager is not None:
            try:
                manager.wait()
            except Exception:
                log.exception("checkpoint write failed during error cleanup")
        # A goodput report from a crashed run is what its post-mortem
        # wants (with the armed-but-unfired chaos count); the trace gauges
        # land before the report's snapshot.
        if chaos is not None:
            chaos.export_unfired(registry)
        final_dump("crash" if looping else "setup_failure")
        _export_trace(workdir, registry, cfg)
        _write_telemetry_report(workdir, registry, t_run0, steps_run, dev,
                                mesh)
        raise
    finally:
        if aot is not None:
            aot.join(timeout=120.0)
        if watchdog is not None:
            watchdog.stop()
        if fwatch is not None:
            fwatch.stop()
        if listener_installed:
            listener.uninstall()
        _close_quietly(batches, host)
        # The memoised injector outlives the run: a stale fire must not
        # dump into a finished one.
        _unwire_chaos_forensics(chaos)
    # One hook's end() failing must not starve later hooks (the checkpoint
    # hook's final save among them); the first error still propagates
    # after the others ran and the last write is durable.
    end_error: Optional[BaseException] = None
    for h in hooks:
        try:
            h.end(state)
        except BaseException as e:
            log.exception("hook %r end() failed", h)
            end_error = end_error or e
    try:
        if manager is not None:
            manager.wait()
    finally:
        # After the last wait: the report's checkpoint share includes the
        # final save's wait until durable.  chaos/armed_unfired is set
        # first so that it lands in the report's registry snapshot.
        if chaos is not None:
            chaos.export_unfired(registry)
        tracer.instant("fit/end", {"steps_run": steps_run,
                                   "preempted": preempted})
        _export_trace(workdir, registry, cfg)
        _write_telemetry_report(workdir, registry, t_run0, steps_run, dev,
                                mesh)
    if chaos is not None and not preempted:
        # A drill whose fault never fired must not pass for one that did
        # (a preempted run legitimately leaves later faults unfired).
        chaos.warn_unfired()
    if end_error is not None:
        raise end_error
    if preempted:
        log.warning("run preempted at step %d after an emergency checkpoint; "
                    "resumable by rerunning the same command", state.step)
    history = _history(chunks)
    return FitResult(
        state=state, final_metrics=history[-1] if history else {},
        history=history, device=str(dev),
        window_s=window_s if window and window[1] else None,
        window_steps=window[1] if window else 0,
        window_data_s=window[2] if window else 0.0,
        captures=multi.captures, capture_s=multi.capture_s,
        replayed_steps=multi.replays, chunks_in_flight=in_flight,
        registry=registry, preempted=preempted, restored_from=restored_from,
        rollbacks=rollbacks, skipped_batches=skipped,
        saves=manager.save_log if manager is not None else [])


def mesh_consensus(mesh: meshlib.Mesh) -> resilience.Consensus:
    """The fleet's decisions over every process of the world (an exact
    no-op for a process alone)."""
    if mesh.group is None and mesh.dp_group is None and not mesh.axis_groups:
        return resilience.Consensus(0, 1)
    return resilience.Consensus(mesh.process_index, mesh.process_count)


def restore_or_init(manager: ckptlib.CheckpointManager, state: TrainState,
                    mesh: meshlib.Mesh):
    """``checkpoint.restore_or_init`` for a state whose parameters may be
    split over the model axis: the checkpoint holds whole tensors, so the
    restore reads into a whole-shaped template (the split tensors
    gathered, the others the live ones) and this process's slices are
    then copied into its live tensors."""
    whole = tensorlib.whole_state(state, mesh)
    restored, data, ok = ckptlib.restore_or_init(manager, whole)
    if not ok:
        return state, data, ok
    return tensorlib.scatter_state_(state, restored, mesh), data, ok


def _start_aot(cfg: ExperimentConfig, state: TrainState,
               mesh: meshlib.Mesh, dev: torch.device, flops_of,
               registry: telemetry.MetricsRegistry
               ) -> Optional[startuplib.AotTrainStep]:
    """Start the startup threads (``harness/startup.py``) for the dominant
    chunk of ``cfg`` and the kernels of ``state``'s model, or None when
    ``cfg.aot_compile`` is off or the dataset's batch structure is unknown
    (the step then does the work at its first call, as with them off)."""
    if not cfg.aot_compile:
        return None
    batch = startuplib.abstract_batch(cfg, mesh)
    if batch is None:
        log.info("aot_compile: the batch structure of dataset %r is "
                 "unknown; the first step loads its kernels itself",
                 cfg.dataset)
        return None
    k = startuplib.dominant_chunk_len(cfg, mesh.world_size)
    return startuplib.AotTrainStep(
        startuplib.stacked_batch(batch, k),
        loaders=startuplib.kernel_loaders(state.model, dev),
        flops_of=flops_of, registry=registry,
        label=f"{k}-step chunk").start()


def _chaos_hooks(chaos: chaoslib.ChaosInjector, save_fn, final_step: int,
                 listener_active: bool) -> list:
    """The injector's hooks, after the checkpoint hook: SIGTERM (only
    with an installed preemption listener: without its handler a raised
    SIGTERM is a hard kill, not the graceful drill), the forced save to
    tear (only with a checkpoint manager), the kill and the straggler
    delay."""
    out = []
    sigterm = chaos.sigterm_hook()
    if sigterm is not None:
        if listener_active:
            out.append(sigterm)
        else:
            log.warning("chaos sigterm_at_step disabled: no preemption "
                        "listener (fit without a workdir, or not on the "
                        "main thread)")
    if save_fn is not None:
        tear = chaos.tear_hook(save_fn, final_step=final_step)
        if tear is not None:
            out.append(tear)
    elif chaos.config.torn_checkpoint_at_step is not None:
        log.warning("chaos torn_checkpoint_at_step disabled: fit has no "
                    "workdir to checkpoint into")
    return out + [h for h in (chaos.kill_hook(), chaos.straggler_hook())
                  if h is not None]


def _unwire_chaos_forensics(chaos: Optional[chaoslib.ChaosInjector]) -> None:
    """Detach a (memoised, process-lifetime) injector from a finished
    run's tracer and flight-dump closure; ``fit`` rewires them at every
    entry."""
    if chaos is not None:
        chaos.tracer = None
        chaos.flight_dump = None


def _export_trace(workdir: Optional[str],
                  registry: telemetry.MetricsRegistry,
                  cfg: ExperimentConfig) -> None:
    """Per process, best-effort: stamp the ``trace/*`` gauges (how far the
    ring reached, how much it dropped) and, under ``cfg.trace_export``,
    write the Chrome trace ``<workdir>/trace_p<i>.json``.  Runs on both
    exit paths, before the telemetry report snapshots the registry."""
    tracer = registry.trace
    if not tracer.enabled:
        return
    try:
        registry.gauge(telemetry.TRACE_EVENTS).set(float(tracer.emitted))
        registry.gauge(telemetry.TRACE_DROPPED).set(float(tracer.dropped))
        if cfg.trace_export and workdir:
            os.makedirs(workdir, exist_ok=True)
            tracer.dump_chrome(
                telemetry.chrome_trace_path(workdir, tracer.process_index))
    except Exception:  # noqa: BLE001 — reporting must never mask training
        log.exception("trace export failed")


def _write_telemetry_report(workdir: Optional[str],
                            registry: telemetry.MetricsRegistry,
                            t_run0: float, steps_run: int,
                            dev: torch.device, mesh: meshlib.Mesh) -> None:
    """Chief-only, best-effort ``<workdir>/telemetry.json`` goodput report:
    the run's device (a CPU has no peak, so its MFU is 0) and the data
    axis's devices, over which the counted FLOPs of the global batch ran."""
    if not workdir or mesh.process_index != 0:
        return
    try:
        report = telemetry.goodput_report(
            registry, total_s=time.perf_counter() - t_run0, steps=steps_run,
            kind=telemetry.device_kind(dev) or dev.type,
            n_devices=mesh.data_size)
        telemetry.write_report(os.path.join(workdir, "telemetry.json"),
                               report)
        frac = report["fractions"]
        log.info(
            "goodput: compute %.1f%%, data stall %.1f%%, checkpoint %.1f%%, "
            "compile %.1f%% over %.1fs (%d compile events, mfu %.4f)",
            100 * frac["compute"], 100 * frac["data_stall"],
            100 * frac["checkpoint"], 100 * frac["compile"],
            report["total_s"], report["compile_events"], report["mfu"])
    except Exception:  # noqa: BLE001 — reporting must never mask training
        log.exception("failed to write telemetry.json")


def default_recoverable_errors() -> tuple[type[BaseException], ...]:
    """Failure classes worth restarting on — *transient* ones only: a
    ``torch.distributed`` backend failure (a peer lost, a collective
    timed out: the analogue of the AbortedError/UnavailableError set
    ``_RecoverableSession`` retries on, TF monitored_session.py:
    1261-1274) and connection/timeout failures to peers or storage.
    Deliberately NOT blanket ``OSError`` or ``RuntimeError``: a bad
    workdir, or a CUDA error, is deterministic or fatal to the process.
    :func:`recoverable_fit` also filters the set by message with
    :func:`is_transient_error`."""
    import torch.distributed as dist

    return (dist.DistBackendError, ConnectionError, TimeoutError)


# Errors that poison the process's CUDA context: every later CUDA call of
# the process fails too, so no in-process restart can recover (a new
# process can).  Matched in the message, since a collective's backend
# error can carry one.
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "uncorrectable ecc",
)


def is_transient_error(e: BaseException) -> bool:
    """True if ``e`` is worth a restore-and-retry in this process.  A
    sticky CUDA error (an illegal memory access, a device-side assert:
    the context is poisoned) and ``torch.cuda.OutOfMemoryError`` (the
    same program needs the same memory) are not, whatever class carries
    them; any other error of the recoverable set is."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    msg = str(e).lower()
    return not any(marker in msg for marker in _STICKY_CUDA_MARKERS)


# The restart schedule lives in resilience/backoff.py (the JAX package's
# split); recoverable_fit's callers reach it here too.
restart_backoff = resilience.restart_backoff


# recoverable_fit's bound on restarts, and the cap of its backoff.
MAX_RESTARTS = 3
BACKOFF_MAX_S = 60.0


def recoverable_fit(cfg: ExperimentConfig, workdir: str, *,
                    backoff_base_s: float = 1.0, **fit_kwargs) -> FitResult:
    """``fit`` wrapped in the reference's session-recovery loop.

    ``_RecoverableSession`` catches preemption-class errors, recreates the
    session and resumes from the last checkpoint (TF monitored_session.py:
    1238,1261-1274).  Here that is calling ``fit`` again: it restores the
    newest checkpoint — parameters, optimizer state, EMA, step, carry and
    the input position — so no progress is lost beyond the last save.
    Bounded by ``MAX_RESTARTS`` and spaced by :func:`restart_backoff`
    (``backoff_base_s``, capped at ``BACKOFF_MAX_S``).  Only an error of
    :func:`default_recoverable_errors` that :func:`is_transient_error`
    passes is retried; any other propagates at once.  One preemption
    listener spans every attempt and the backoff sleeps, so a notice
    received in one is honoured by the next; a ``preempted`` result returns
    as it is."""
    recover_on = default_recoverable_errors()
    listener = resilience.PreemptionListener()
    listener.install()
    attempt = 0
    try:
        while True:
            try:
                return fit(cfg, workdir, restarts=attempt, listener=listener,
                           **fit_kwargs)
            except recover_on as e:
                if not is_transient_error(e):
                    raise
                attempt += 1
                if attempt > MAX_RESTARTS:
                    raise
                delay = restart_backoff(attempt, base_s=backoff_base_s,
                                        max_s=BACKOFF_MAX_S, seed=cfg.seed)
                log.warning("fit failed (%s: %s); restart %d/%d from the "
                            "newest checkpoint in %.2fs", type(e).__name__,
                            e, attempt, MAX_RESTARTS, delay)
                if delay > 0 and not listener.preempted:
                    listener.wait(delay)
    finally:
        listener.uninstall()


def _sizes(cfg: ExperimentConfig, chunk: dict, mesh: meshlib.Mesh) -> dict:
    """A chunk's examples per step (and tokens, for an LM) over the whole
    data axis: this process's rows times the data axis (its columns times
    the seq axis)."""
    if cfg.task == "lm":
        _, b, t = chunk["inputs"].shape
        b *= mesh.data_size
        return {"batch_size": int(b), "tokens": int(b * t * mesh.seq_size)}
    return {"batch_size": int(chunk["label"].shape[1] * mesh.data_size)}


def _history(chunks: list[tuple]) -> list[dict]:
    """One row per step from the chunks' stacked metrics, read back in one
    transfer, and their sizes and host times."""
    if not chunks:
        return []
    names = chunks[0][1].names
    values = torch.cat([c[1].values for c in chunks]).tolist()
    history, i = [], 0
    for first, rows, size, k, data_s, host_s, end_s in chunks:
        for j in range(k):
            row = dict(zip(names, values[i]))
            i += 1
            row.update(size, step=first + j + 1, data_s=data_s / k,
                       step_time_s=host_s / k, end_s=end_s)
            history.append(row)
    return history
