"""The synchronous train step and its builders.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/train_loop.py``.
:class:`TrainStep` is the eager step: forward, loss, ``autograd.grad``
over the parameter dict, the gradients averaged over the data-parallel
mesh, one optimizer update applied in place (then the EMA shadows, when
kept), and the metrics as 0-d tensors averaged over the mesh (the caller
decides when to read them back).  :class:`MultiStep` runs the steps of a
chunk of stacked batches; on CUDA it captures the step once as a CUDA
graph, collectives included, and replays it, the counterpart of the JAX
package's ``make_multi_step``.  :class:`GradApply` runs the step's
gradient part and its apply as two such programs, for the async-PS and
backup emulators of ``parallel/``.  :func:`place_state` lays the replicated
state out without collectives and checks once that every process holds
the same one.  :func:`step_flops` counts a step's FLOPs for the MFU, the
counterpart of the JAX package's XLA cost analysis.
"""

from __future__ import annotations

import inspect
import logging
import math
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.ops import _kernels
from distributed_tensorflow_models_tpu_torch.ops import ema as emalib
from distributed_tensorflow_models_tpu_torch.ops import losses as losslib
from distributed_tensorflow_models_tpu_torch.ops import metrics as metriclib
from distributed_tensorflow_models_tpu_torch.ops import optim
from distributed_tensorflow_models_tpu_torch.ops import remat as rematlib
from distributed_tensorflow_models_tpu_torch.ops.conv import Conv2D
from distributed_tensorflow_models_tpu_torch.parallel import tensor as tensorlib

log = logging.getLogger("dtm")

Batch = Mapping[str, torch.Tensor]
# loss_fn(params, state, batch, rngs) -> (loss, aux); aux may carry
# 'metrics' (dict of scalars), 'batch_stats' (updated BN state) and
# 'carry' (updated recurrent state).
LossFn = Callable[
    [Mapping[str, torch.Tensor], TrainState, Batch,
     Mapping[str, torch.Generator]],
    tuple[torch.Tensor, dict],
]


def classification_loss_fn(model: torch.nn.Module, *,
                           label_smoothing: float = 0.0,
                           weight_decay: float = 0.0,
                           aux_loss_weight: float = 0.0) -> LossFn:
    """Forward + loss for image classification: softmax cross entropy with
    optional label smoothing, slim-style L2 on kernels, and Inception-v3's
    weighted auxiliary-logits loss.  The model returns ``logits`` or, in
    training with an auxiliary head, ``(logits, aux_logits)``.  Its BN
    layers update their running statistics in place."""

    def loss_fn(params, state, batch, rngs):
        outputs = model(batch["image"], train=True, rngs=rngs)
        if isinstance(outputs, (tuple, list)):
            logits, aux_logits = outputs
        else:
            logits, aux_logits = outputs, None
        labels = batch["label"]
        xent = losslib.mean_softmax_cross_entropy(logits, labels,
                                                  label_smoothing)
        loss = xent
        if aux_logits is not None and aux_loss_weight:
            loss = loss + aux_loss_weight * losslib.mean_softmax_cross_entropy(
                aux_logits, labels, label_smoothing)
        if weight_decay:
            loss = loss + losslib.l2_weight_decay(params, weight_decay)
        metrics = {
            "loss": loss.detach(),
            "xent": xent.detach(),
            "accuracy": metriclib.accuracy(logits.detach(), labels),
        }
        return loss, {"metrics": metrics, "batch_stats": state.batch_stats}

    return loss_fn


def lm_loss_fn(model: torch.nn.Module, fused_unembed: bool = False) -> LossFn:
    """Forward + loss for language models: mean per-token NLL of
    ``targets`` (``inputs`` shifted by one) given ``inputs``, both
    ``[B, T]`` int.

    ``fused_unembed=True`` stops the model at the post-``ln_f`` hidden
    states (``return_hidden=True``) and runs the head projection and the
    cross entropy chunked in bf16 (:func:`...ops.losses.chunked_unembed_xent`)
    on the model's own ``head`` parameters; otherwise the model's f32 head
    gives full logits.  The carry is read from ``state.carry`` and the
    updated value returned through aux.

    A model whose forward takes ``losses`` (the transformer) is given a
    fresh dict, the JAX package's mutable ``losses`` collection: what it
    sows there (the MoE blocks' weighted aux losses) is summed, leaf by
    leaf in the flax tree's key order, into the objective and kept out of
    ``nll``.  Metrics: ``loss`` (nll + the sown sum), ``nll`` (perplexity
    = exp(nll)) and, when anything was sown, ``aux_loss``.

    Under a seq axis the batch is this process's columns, and the mean is
    over its tokens: the step's average over data x seq
    (``sharding.all_reduce_mean_``) makes it the mean over the global
    tokens, the blocks being of one size.  Under ``transformer_tp`` with
    ``fused_unembed`` the head's kernel and bias, split over the
    vocabulary, are all-gathered whole each step (two gathers forward, no
    collective in their backward) and the chunked head runs on them
    unchanged: no ``[B*T, V]`` f32 logits are made."""
    sows = "losses" in inspect.signature(model.forward).parameters

    def loss_fn(params, state, batch, rngs):
        sown: dict = {}
        kw = {"losses": sown} if sows else {}
        if fused_unembed:
            hidden, new_carry = model(batch["inputs"], carry=state.carry,
                                      train=True, return_hidden=True,
                                      rngs=rngs, **kw)
            # A head split over the vocabulary is gathered whole for the
            # chunked head, differentiably (its backward slices).
            split = getattr(model.head, "tp", None)
            nll = torch.mean(losslib.chunked_unembed_xent(
                hidden, tensorlib.whole(params["head.kernel"], split),
                tensorlib.whole(params.get("head.bias"), split),
                batch["targets"]))
        else:
            logits, new_carry = model(batch["inputs"], carry=state.carry,
                                      train=True, rngs=rngs, **kw)
            nll = torch.mean(losslib.softmax_cross_entropy(
                logits, batch["targets"]))
        loss = nll
        metrics = {"nll": nll.detach()}
        if sown:
            aux = sum(sown[k] for k in sorted(sown))
            loss = nll + aux
            metrics["aux_loss"] = aux.detach()
        metrics = {"loss": loss.detach(), **metrics}
        return loss, {"metrics": metrics, "carry": new_carry}

    return loss_fn


def step_seed(seed: int, step: int, index: int) -> int:
    """The seed of the ``index``-th named generator at ``step``."""
    return int(np.random.SeedSequence([seed, step, index])
               .generate_state(1)[0])


class StepRngs:
    """A step's named generators on one device, one per name, re-seeded
    before every step from ``(seed, step, index of the name)``
    (:func:`step_seed`), so a step's randomness depends only on the base
    seed and the step, as the JAX package's ``fold_in(rng, state.step)``.
    The generators live as long as the run: a captured step registers them
    with its graph, whose replays read the seed and offset set here, so
    step ``s`` draws the same bits eagerly and by replay."""

    def __init__(self, names: Sequence[str], device: torch.device):
        self.generators = {name: torch.Generator(device=device)
                           for name in names}

    def reseed(self, seed: int, step: int) -> dict[str, torch.Generator]:
        for i, gen in enumerate(self.generators.values()):
            gen.manual_seed(step_seed(seed, step, i))
        return self.generators


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _detached(tree):
    """``tree`` (tensors in nested tuples, lists and dicts) with every
    tensor cut from its autograd graph."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, Mapping):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detached(v) for v in tree)
    return tree


@torch.no_grad()
def _store_carry(old, new):
    """The step's new carry, detached, written into the old carry's tensors
    in place (a captured step keeps its state at fixed addresses); stored
    as given, detached, where there is no old carry of the same shapes to
    write into."""
    if old is None or new is None:
        return _detached(new)
    olds, news = list(_leaves(old)), list(_leaves(new))
    if (len(olds) != len(news)
            or any(o.shape != n.shape or o.dtype != n.dtype
                   for o, n in zip(olds, news))):
        return _detached(new)
    for o, n in zip(olds, news):
        if o is not n:
            o.copy_(n)
    return old


def apply_gradients(state: TrainState, grads: Mapping[str, torch.Tensor],
                    aux: dict, norm: Optional[torch.Tensor] = None
                    ) -> TrainState:
    """Optimizer update, EMA update and state advance from one gradient
    computation, every tensor of the state updated in place; ``norm``,
    where given, is the gradients' global norm, which a clip reads.  The new
    carry is stored detached: the JAX package never differentiates through
    ``state.carry``, and a carry that kept its graph would tie each step's
    backward to the last one's (freed) graph and hold its memory."""
    updates, new_opt_state = state.tx.update(grads, state.opt_state, norm)
    optim.apply_updates(state.params, updates)
    if state.ema_params is not None:
        # The shadows follow the updated parameters, the decay damped by
        # the step count before this step (TF's num_updates).
        emalib.update_ema(state.ema_params, state.params, state.ema_decay,
                          num_updates=state.device_step)
    state.device_step.add_(1)
    return state.replace(
        step=state.step + 1,
        batch_stats=aux.get("batch_stats", state.batch_stats),
        opt_state=new_opt_state,
        carry=_store_carry(state.carry, aux.get("carry", state.carry)),
    )


def _device_of(state: TrainState) -> torch.device:
    return next(iter(state.params.values())).device


def _check_steps(state: TrainState, k: int) -> None:
    """Raise, on the host, when the next ``k`` steps run past the steps the
    optimizer's device tables were made for (``GradientTransformation.
    num_steps``): on the device that read would be out of range."""
    limit = state.tx.num_steps
    if limit is not None and state.step + k > limit:
        raise ValueError(
            f"step {state.step + k - 1} is past the {limit} steps the "
            f"optimizer's schedule tables cover (num_steps={limit})")


class TrainStep:
    """The eager step, ``(state, batch, seed) -> (state, metrics)``:
    forward, loss, ``autograd.grad`` over the parameter dict, one
    optimizer update applied in place (then the EMA shadows, when kept),
    and the metrics as 0-d tensors on the device.  :meth:`body` is the
    step without the host's part (re-seeding the generators), which is
    what :class:`MultiStep` captures.

    Under a data-parallel mesh (``core/mesh.py::data_parallel``; each
    process's ``batch`` its rows of the global batch) the gradients are
    averaged over the mesh (``sharding.all_reduce_mean_``) before anything
    reads them, so the gradient norm, clipping, the optimizer and the EMA
    all see the global batch's gradient, as in the JAX package; the
    metrics are averaged in one more collective.  Without a process group
    neither is issued.  The gradient norm is taken once, for the
    ``grad_norm`` metric and the clip alike.  Where parameters are split
    over the model, pipe or expert axis it is the whole arrays': the split
    gradients' sums of squares are summed over their axes
    (``sharding.square_sum``), as optax's norm runs over the JAX package's
    sharded arrays."""

    def __init__(self, loss_fn: LossFn,
                 rng_names: Sequence[str] = ("dropout",)):
        self.loss_fn = loss_fn
        self.rng_names = tuple(rng_names)
        self._rngs: dict[torch.device, StepRngs] = {}

    def rngs(self, device: torch.device) -> StepRngs:
        rngs = self._rngs.get(device)
        if rngs is None:
            rngs = self._rngs[device] = StepRngs(self.rng_names, device)
        return rngs

    def __call__(self, state: TrainState, batch: Batch, seed: int):
        _check_steps(state, 1)
        gens = self.rngs(_device_of(state)).reseed(seed, state.step)
        return self.body(state, batch, gens)

    def body(self, state: TrainState, batch: Batch,
             rngs: Mapping[str, torch.Generator]):
        grads, aux, norm, metrics = self.gradients(state.params, state,
                                                   batch, rngs)
        return apply_gradients(state, grads, aux, norm), metrics

    def gradients(self, params: Mapping[str, torch.Tensor],
                  state: TrainState, batch: Batch,
                  rngs: Mapping[str, torch.Generator]):
        """The step's gradient part, ``(grads, aux, norm, metrics)``: the
        loss at ``params``, ``autograd.grad`` over them, the gradients
        averaged over the data x seq processes, their whole-array norm
        (the clip's and the ``grad_norm`` metric's) and the metrics
        averaged.  :meth:`body` is this followed by :func:`apply_gradients`;
        the emulators of ``parallel/async_ps.py`` and ``parallel/backup.py``
        put their own bookkeeping between the two.

        ``params`` must be the tensors the model computes with
        (``state.params``, its own parameters): the loss runs the model,
        which reads its parameters, not the dict it is handed.  A caller
        that wants the gradient at other values (a stale snapshot) writes
        them into those tensors first."""
        if len(params) != len(state.params) or any(
                params.get(k) is not v for k, v in state.params.items()):
            raise ValueError("gradients are taken at the model's own "
                             "parameters (state.params); write other "
                             "values into them first")
        mesh = meshlib.current_mesh()
        loss, aux = self.loss_fn(params, state, batch, rngs)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        shardlib.all_reduce_mean_(grads.values(), mesh)
        metrics = dict(aux.get("metrics", {}))
        norm = grad_norm(state.model, grads)
        metrics["grad_norm"] = norm
        metrics = shardlib.all_reduce_metrics(metrics, mesh)
        return grads, aux, norm, metrics


def grad_norm(model: torch.nn.Module, grads: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """The global norm of ``grads`` as whole arrays: where ``model``'s
    parameters are split over processes (``parallel/tensor.py::
    split_axes``), ``sharding.square_sum`` over the mesh it was cut on;
    else this process's tensors'."""
    axes = tensorlib.split_axes(model)
    if not axes:
        return optim.global_norm(grads)
    return torch.sqrt(shardlib.square_sum(grads, model.split_mesh, axes))


def make_train_step(loss_fn: LossFn,
                    rng_names: Sequence[str] = ("dropout",)) -> TrainStep:
    """The eager single step a driver (or a test) calls; :func:`make_multi_step`
    is K of them in one call, captured on CUDA."""
    return TrainStep(loss_fn, rng_names)


class StackedMetrics(Mapping):
    """A chunk's metrics: row ``i`` of ``values`` (``[K, len(names)]``,
    f32, on the device) holds step ``i``'s; ``m[name]`` is that name's
    ``[K]`` column."""

    def __init__(self, names: Sequence[str], values: torch.Tensor):
        self.names = tuple(names)
        self.values = values
        self._col = {n: i for i, n in enumerate(self.names)}

    def __getitem__(self, key):
        return self.values[:, self._col[key]]

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)


def _row_vector(metrics: Mapping[str, torch.Tensor],
                names: Sequence[str]) -> torch.Tensor:
    return torch.stack([metrics[n].float() for n in names])


class _Captured:
    __slots__ = ("graph", "batch", "metrics", "names", "launches",
                 "collectives", "twins")

    def __init__(self, graph, batch, metrics, names, launches, collectives,
                 twins):
        self.graph, self.batch, self.metrics = graph, batch, metrics
        self.names, self.launches = names, launches
        self.collectives = collectives
        self.twins = twins


class MultiStep:
    """The steps of a chunk in one call: ``(state, chunk, seed) -> (state,
    StackedMetrics)``, ``chunk`` holding each batch key stacked on a new
    leading axis ``[K, ...]`` (``data/pipeline.py::BatchStacker``).

    On the CPU the step runs K times eagerly.  On CUDA the first step at
    each batch signature (keys, row shapes, dtypes) runs eagerly, on the
    stream the step is then captured on, so that kernel builds, TMA
    descriptors and cuBLAS handles and workspaces all exist before
    capture.  The step's :meth:`TrainStep.body` is then captured once as a
    CUDA graph, and every later step of that signature replays it: the
    batch row copied into the graph's static batch buffer, the generators
    re-seeded for the step, the graph launched, its metrics copied out.  A
    shorter tail chunk replays the same graph.  No step runs twice or is
    thrown away, so the trajectory is the eager one.

    Under a data-parallel mesh the step's collectives (the gradient
    bucket, BatchNorm's moments and their cotangents, the metric vector)
    are captured with it and replayed inside the graph; the eager first
    step has created the process group's communicator by then.

    Under remat (``ops/remat.py``) the eager step records the Philox
    offset at which each checkpointed block starts drawing from the step's
    generators; the capture registers a twin generator for each, and the
    host seeds the twins before every replay, so a block's recompute
    draws its forward's dropout bits.

    The state must stay where the capture found it: every tensor of it is
    updated in place (checked after the capture).  A capture that fails
    raises, naming the model: nothing falls back to eager steps, or to
    eager collectives around a replay.  Each capture adds one record (its
    seconds) to ``registry``'s ``train/compile`` timer; the kernels'
    launch counters (``ops/_kernels.py``) and the collective counters
    (``core/sharding.py``) count what each replay launches, and each call
    adds the collectives its steps issued, and their bytes, to
    ``registry``'s ``train/collectives`` and ``train/collective_bytes``.
    A call that captures nothing is timed on the host into
    ``train/dispatch`` (one record a call: on CUDA the replays' enqueue,
    on the CPU the eager steps themselves).

    ``flops_of(batch)`` (a batch of the chunk's row shapes, on the device)
    prices one step: it is called once per batch signature, before the
    signature's first step, and sets ``train/flops_per_step``; every step
    run, eager or replayed, then adds that count to ``train/flops_total``
    on the host, as the launch counters count replays.  A failing count is
    logged and counts 0.

    ``pending_compile_s`` is time the caller waited, before the first
    capture, for work done for the step elsewhere (``fit``'s startup
    thread, ``harness/startup.py``): the next capture adds it to its
    ``train/compile`` record (not to ``capture_s``) and resets it.  The
    FLOPs count, the eager first step and each capture are traced on
    ``registry.trace`` (``train/flops_count``; ``train/eager_step``, its
    host time to the capture's device sync; ``train/capture``)."""

    def __init__(self, step: Callable, name: str = "the model",
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 flops_of: Optional[Callable[[Batch], float]] = None):
        self.step = step
        self.name = name
        self.registry = registry
        self.flops_of = flops_of
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.pending_compile_s = 0.0
        self._captured: dict[tuple, _Captured] = {}
        self._flops: dict[tuple, float] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        if registry is not None:
            # Zero is a reading (no capture on the CPU), absence is not.
            registry.timer(telemetry.COMPILE)
            registry.timer(telemetry.DISPATCH)

    def __call__(self, state: TrainState, chunk: Batch, seed: int):
        before = shardlib.collective_counts()
        if self.registry is not None and self.flops_of is not None:
            k = next(iter(chunk.values())).shape[0]
            self.registry.counter(telemetry.FLOPS_TOTAL).inc(
                k * self._step_flops(chunk))
        captures = self.captures
        t0 = time.perf_counter()
        state, rows = self._run(state, chunk, seed)
        if self.registry is not None:
            if self.captures == captures:
                self.registry.timer(telemetry.DISPATCH).record(
                    time.perf_counter() - t0)
            issued = shardlib.counts_since(before).values()
            self.registry.counter(telemetry.COLLECTIVES).inc(
                sum(n for n, _ in issued))
            self.registry.counter(telemetry.COLLECTIVE_BYTES).inc(
                sum(b for _, b in issued))
        return state, rows

    def _step_flops(self, chunk: Batch) -> float:
        sig = _signature(chunk)
        flops = self._flops.get(sig)
        if flops is None:
            t0 = time.perf_counter()
            try:
                flops = max(float(self.flops_of(
                    {key: v[0] for key, v in chunk.items()})), 0.0)
            except Exception:  # noqa: BLE001 — telemetry must not fail a step
                log.warning("the FLOPs of a step of %s could not be counted; "
                            "MFU counts them as 0", self.name, exc_info=True)
                flops = 0.0
            self.registry.trace.complete(
                "train/flops_count", time.perf_counter() - t0, ts_mono=t0)
            self._flops[sig] = flops
            if flops > 0:
                self.registry.gauge(telemetry.FLOPS_PER_STEP).set(flops)
        return flops

    def _run(self, state: TrainState, chunk: Batch, seed: int):
        k = next(iter(chunk.values())).shape[0]
        _check_steps(state, k)
        if _device_of(state).type != "cuda":
            rows = []
            for i in range(k):
                state, metrics = self.step(
                    state, {key: v[i] for key, v in chunk.items()}, seed)
                rows.append(metrics)
            names = list(rows[0])
            return state, StackedMetrics(names, torch.stack(
                [_row_vector(m, names) for m in rows]))
        if not isinstance(self.step, TrainStep):
            raise TypeError(f"a captured step needs a TrainStep, got "
                            f"{type(self.step).__name__}")
        sig = _signature(chunk)
        cap = self._captured.get(sig)
        first = 0
        if cap is None:
            t_eager = time.perf_counter()
            state, row0, names = self._eager_step(state, chunk, seed)
            cap = self._capture(sig, state, chunk, names, t_eager)
            first = 1
        values = torch.empty(k, len(cap.names), device=cap.metrics.device)
        if first:
            values[0].copy_(row0)
        gens = self.step.rngs(_device_of(state))
        for i in range(first, k):
            for key, buf in cap.batch.items():
                buf.copy_(chunk[key][i])
            gens.reseed(seed, state.step)
            rematlib.seed_twins(cap.twins)
            cap.graph.replay()
            _kernels.add_launches(cap.launches)
            shardlib.add_collectives(cap.collectives)
            values[i].copy_(cap.metrics)
            state = state.replace(step=state.step + 1)
            self.replays += 1
        return state, StackedMetrics(cap.names, values)

    def _side_stream(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _eager_step(self, state, chunk, seed):
        """Row 0 of ``chunk`` eagerly, on the capture stream; returns the
        new state, the step's metric vector (usable on the caller's
        stream) and the metrics' names."""
        device = _device_of(state)
        cur = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        side.wait_stream(cur)
        gens = self.step.rngs(device).generators
        with torch.cuda.stream(side), rematlib.recording(gens.values()):
            state, metrics = self.step(
                state, {key: v[0] for key, v in chunk.items()}, seed)
            names = list(metrics)
            row = _row_vector(metrics, names)
        cur.wait_stream(side)
        row.record_stream(cur)
        return state, row, names

    def _capture(self, sig, state, chunk, names,
                 t_eager: Optional[float] = None) -> _Captured:
        device = _device_of(state)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if self.registry is not None and t_eager is not None:
            self.registry.trace.complete("train/eager_step", t0 - t_eager,
                                         ts_mono=t_eager)
        batch = {key: torch.empty_like(v[0]) for key, v in chunk.items()}
        gens = self.step.rngs(device).generators

        def step():
            new_state, metrics = self.step.body(state, batch, gens)
            return new_state, _row_vector(metrics, names)

        graph, (_, row), launches, collectives, twins = capture_call(
            step, state, gens, self._side_stream(device),
            f"the train step of {self.name}")
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += seconds
        if self.registry is not None:
            self.registry.trace.complete("train/capture", seconds, ts_mono=t0)
            self.registry.timer(telemetry.COMPILE).record(
                seconds + self.pending_compile_s)
        self.pending_compile_s = 0.0
        cap = self._captured[sig] = _Captured(graph, batch, row, names,
                                              launches, collectives, twins)
        return cap


class _GradGraph:
    __slots__ = ("graph", "batch", "out", "launches", "collectives", "twins")

    def __init__(self, graph, batch, out, launches, collectives, twins):
        self.graph, self.batch, self.out = graph, batch, out
        self.launches, self.collectives = launches, collectives
        self.twins = twins


class _ApplyGraph:
    __slots__ = ("graph", "inputs", "launches", "collectives")

    def __init__(self, graph, inputs, launches, collectives):
        self.graph, self.inputs = graph, inputs
        self.launches, self.collectives = launches, collectives


class GradApply:
    """A train step's gradient part (:meth:`TrainStep.gradients`) and its
    apply (``apply_fn``, :func:`apply_gradients` by default) as two
    programs, for callers that put work of their own between them: the
    async-PS and backup-replica emulators (``parallel/async_ps.py``,
    ``parallel/backup.py``).

    On the CPU, and with ``capture=False``, both run eagerly.  On CUDA each
    runs eagerly the first time, on the stream it is then captured on (so
    that kernel builds, cuBLAS handles and the communicator exist before
    the capture, as in :class:`MultiStep`), is captured right after as a
    CUDA graph, and is replayed from then on:

    - :meth:`grads` copies the batch into the graph's static batch buffers,
      re-seeds the step's generators for ``(seed, salt)`` (and the remat
      twins) and replays.  It returns the graph's static outputs ``(grads,
      aux, norm, metrics)`` (the first call copies its eager outputs into
      them), which the next call overwrites: a caller keeps what it needs
      before then.
    - :meth:`apply` takes its gradients at fixed addresses (the grad
      graph's outputs, or the caller's own buffers) and replays; every
      state tensor is updated in place.

    The state must stay where the first calls found it, and a later batch
    must have the first one's shapes.  A capture that fails raises, naming
    the model: nothing falls back to eager work.  The replays add their
    launches and collectives to the counters; ``captures`` and
    ``capture_s`` count the captures and their seconds."""

    def __init__(self, step: TrainStep, name: str = "the model",
                 capture: bool = True,
                 apply_fn: Optional[Callable] = None):
        self.step = step
        self.name = name
        self.capture = capture
        self.apply_fn = apply_fn or apply_gradients
        self.captures = 0
        self.capture_s = 0.0
        self._stream: Optional[torch.cuda.Stream] = None
        self._grad: Optional[_GradGraph] = None
        self._apply: Optional[_ApplyGraph] = None

    def _captured(self, state: TrainState) -> bool:
        return self.capture and _device_of(state).type == "cuda"

    def _side(self, device) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
        """(the capture stream, made to wait for the current one; the
        current stream)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        self._stream.wait_stream(cur)
        return self._stream, cur

    def _captured_now(self, t0: float) -> None:
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def grads(self, state: TrainState, batch: Batch, seed: int, salt: int):
        """``TrainStep.gradients`` at the model's parameters on ``batch``,
        the generators seeded from ``(seed, salt)``."""
        device = _device_of(state)
        gens = self.step.rngs(device).reseed(seed, salt)
        if not self._captured(state):
            return self.step.gradients(state.params, state, batch, gens)
        g = self._grad
        if g is None:
            return self._first_grads(state, batch, gens)
        for key, buf in g.batch.items():
            v = batch[key]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(
                    f"the gradient program of {self.name} was captured on "
                    f"{key} {tuple(buf.shape)} {buf.dtype}, given "
                    f"{tuple(v.shape)} {v.dtype}")
            buf.copy_(v)
        rematlib.seed_twins(g.twins)
        g.graph.replay()
        _kernels.add_launches(g.launches)
        shardlib.add_collectives(g.collectives)
        return g.out

    def _first_grads(self, state, batch, gens):
        device = _device_of(state)
        side, cur = self._side(device)
        with torch.cuda.stream(side), rematlib.recording(gens.values()):
            eager = self.step.gradients(state.params, state, batch, gens)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        static = {key: torch.empty_like(v) for key, v in batch.items()}
        graph, out, launches, collectives, twins = capture_call(
            lambda: self.step.gradients(state.params, state, static, gens),
            state, gens, side, f"the gradient program of {self.name}")
        outs, eagers = list(_leaves(out)), list(_leaves(eager))
        if len(outs) != len(eagers):
            raise RuntimeError(f"the gradient program of {self.name} "
                               f"returned another structure when captured")
        with torch.no_grad(), torch.cuda.stream(side):
            for a, b in zip(outs, eagers):
                if a is not b:
                    a.copy_(b)
        cur.wait_stream(side)
        self._grad = _GradGraph(graph, static, out, launches, collectives,
                                twins)
        self._captured_now(t0)
        return out

    def apply(self, state: TrainState, grads: Mapping[str, torch.Tensor],
              aux: dict, norm: Optional[torch.Tensor]) -> TrainState:
        """``apply_fn(state, grads, aux, norm)``: the state one step on."""
        _check_steps(state, 1)
        if not self._captured(state):
            return self.apply_fn(state, grads, aux, norm)
        inputs = [id(t) for t in _leaves((grads, aux.get("carry"), norm))]
        a = self._apply
        if a is None:
            return self._first_apply(state, grads, aux, norm, inputs)
        if inputs != a.inputs:
            raise RuntimeError(
                f"the apply program of {self.name} was captured on other "
                f"gradient tensors; pass the same ones to every call")
        a.graph.replay()
        _kernels.add_launches(a.launches)
        shardlib.add_collectives(a.collectives)
        return state.replace(step=state.step + 1)

    def _first_apply(self, state, grads, aux, norm, inputs):
        device = _device_of(state)
        side, cur = self._side(device)
        with torch.cuda.stream(side):
            new_state = self.apply_fn(state, grads, aux, norm)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        graph, _, launches, collectives, _ = capture_call(
            lambda: self.apply_fn(new_state, grads, aux, norm), new_state,
            {}, side, f"the apply program of {self.name}")
        cur.wait_stream(side)
        self._apply = _ApplyGraph(graph, inputs, launches, collectives)
        self._captured_now(t0)
        return new_state


def copy_state(state: TrainState) -> list[torch.Tensor]:
    """A copy of every tensor of ``state`` (parameters, BN statistics,
    optimizer slots, EMA shadows, carry, device step), for
    :func:`restore_state_`."""
    with torch.no_grad():
        return [t.detach().clone() for t in _state_leaves(state)]


def restore_state_(state: TrainState, copies: Sequence[torch.Tensor]
                   ) -> None:
    """Write :func:`copy_state`'s copies back into ``state``'s tensors, in
    place (a captured program keeps reading them where they are)."""
    leaves = _state_leaves(state)
    if len(leaves) != len(copies):
        raise ValueError(f"{len(copies)} copies for a state of "
                         f"{len(leaves)} tensors")
    with torch.no_grad():
        for t, c in zip(leaves, copies):
            t.copy_(c)


def capture_call(fn: Callable, state: TrainState,
                 gens: Mapping[str, torch.Generator],
                 stream: torch.cuda.Stream, what: str) -> tuple:
    """``fn()`` captured once as a CUDA graph on ``stream``, the step's
    generators ``gens`` and the remat twins of the eager call recorded
    just before it (``ops/remat.py``) registered with the graph:
    ``(graph, fn's output, launches per replay, collectives per replay,
    twins)``.  Nothing runs: the kernels' launch counters and the
    collective counters are put back, and a replay adds what the capture
    recorded.  ``state`` must keep every tensor where it is (checked when
    ``fn`` returns a state first, or nothing).  A capture that fails
    raises, naming ``what``: nothing falls back to eager work."""
    before = _kernels.launch_counts()
    issued = shardlib.collective_counts()
    held = [id(t) for t in _state_leaves(state)]
    twins = rematlib.make_twins(gens)
    try:
        graph = torch.cuda.CUDAGraph()
        for gen in gens.values():
            graph.register_generator_state(gen)
        for _, twin, _ in twins:
            graph.register_generator_state(twin)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"), \
                rematlib.capturing(twins):
            out = fn()
    except Exception as e:
        raise RuntimeError(
            f"capturing {what} as a CUDA graph failed: {e}") from e
    launches = {key: n - before[key]
                for key, n in _kernels.launch_counts().items()
                if n != before[key]}
    collectives = shardlib.counts_since(issued)
    # The capture launched nothing: what it counted is per replay.
    _kernels.add_launches(launches, -1)
    shardlib.add_collectives(collectives, -1)
    new_state = out[0] if isinstance(out, tuple) and out else out
    if (isinstance(new_state, TrainState)
            and [id(t) for t in _state_leaves(new_state)] != held):
        raise RuntimeError(
            f"{what} rebinds state tensors; a captured step must update "
            f"its state in place")
    return graph, out, launches, collectives, twins


def _signature(chunk: Batch) -> tuple:
    """A chunk's batch signature: its keys, row shapes and dtypes."""
    return tuple((key, tuple(v.shape[1:]), v.dtype)
                 for key, v in sorted(chunk.items()))


def _state_leaves(state: TrainState) -> list[torch.Tensor]:
    return list(_leaves((state.params, state.batch_stats, state.opt_state,
                         state.ema_params, state.carry, state.device_step)))


def library_route(model: torch.nn.Module) -> torch.nn.Module:
    """Point every lowering knob of ``model`` at the plain formulation, in
    place: each conv at ``F.conv2d`` (``Conv2D.impl``; the pools'
    ``conv_impl``), each attention at the reference softmax attention
    (``attn_impl``).  What :func:`step_flops` counts on, so the count is
    of the model's work and not of the route the run takes (K1, K6, the
    patches matmul, ``DTM_CONV_IMPL``, flash or blockwise attention)."""
    for module in model.modules():
        if isinstance(module, Conv2D):
            module.impl = "xla"
        if hasattr(module, "conv_impl"):
            module.conv_impl = "xla"
        if hasattr(module, "attn_impl"):
            module.attn_impl = "reference"
    return model


def step_flops(loss_fn: LossFn, model: torch.nn.Module, batch: Batch,
               carry=None, rng_names: Sequence[str] = ("dropout",)) -> float:
    """FLOPs of one train step's forward and backward: ``loss_fn`` (over
    ``model``) and ``autograd.grad`` over every parameter, under
    ``torch.utils.flop_counter.FlopCounterMode``.

    Meant for a copy of the model on the meta device (nothing is computed
    or allocated) put on the plain formulation (:func:`library_route`):
    the counter sees only ATen operators, so a hand-written kernel behind
    ``ctypes`` counts 0, and a replayed CUDA graph runs no operator at
    all.  It counts the matrix products and convolutions (every tap of a
    padded convolution, as ``F.conv2d`` computes it); elementwise work,
    normalisation, reductions, the optimizer's update and the EMA count
    0.  It runs outside any data-parallel mesh, on ``batch`` as given."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    state = TrainState(
        step=0, params=params, batch_stats=dict(model.named_buffers()),
        opt_state={}, model=model, tx=None, carry=carry,
        device_step=torch.zeros((), dtype=torch.int64, device=device))
    rngs = {name: torch.Generator() for name in rng_names}
    # Outside any data axis: ``batch`` is the whole batch counted, and no
    # collective may be issued for it.
    with meshlib.data_parallel(None), FlopCounterMode(
            display=False) as counter:
        loss, _ = loss_fn(params, state, batch, rngs)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(counter.get_total_flops())


def make_multi_step(loss_fn: LossFn, rng_names: Sequence[str] = ("dropout",),
                    name: str = "the model",
                    registry: Optional[telemetry.MetricsRegistry] = None
                    ) -> MultiStep:
    """The K-step train call, ``(state, chunk, seed) -> (state,
    StackedMetrics)``: every metric a ``[K]`` column on the device.  The
    JAX package's ``make_multi_step`` scans the step in one compiled
    program; here it is :class:`MultiStep`, the step captured once as a
    CUDA graph and replayed per row (K eager steps on the CPU)."""
    return MultiStep(TrainStep(loss_fn, rng_names), name=name,
                     registry=registry)


def _named_leaves(tree, prefix: str):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")


def _replicated_leaves(state: TrainState) -> list[tuple[str, torch.Tensor]]:
    """Every tensor of the state that each process holds whole: all but
    the carry, which holds each process's own rows."""
    return list(_named_leaves({
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": state.opt_state, "ema_params": state.ema_params,
        "device_step": state.device_step}, "state"))


@torch.no_grad()
def check_replicas_agree(state: TrainState, mesh: meshlib.Mesh) -> None:
    """Raise unless every process of ``mesh``'s data x seq group (the
    processes that hold the same slices) holds the same state: a checksum
    per tensor (its f64 sum and sum of squares), reduced by MIN and by MAX
    over the group, must come back unchanged.  Two collectives, once,
    outside the step; nothing without a group."""
    if mesh.dp_group is None:
        return
    leaves = _replicated_leaves(state)
    sums = torch.stack([torch.stack([t.double().sum(),
                                     t.double().square().sum()])
                        for _, t in leaves]).to(mesh.device)
    lo, hi = sums.clone(), sums.clone()
    for t, op in ((lo, torch.distributed.ReduceOp.MIN),
                  (hi, torch.distributed.ReduceOp.MAX)):
        torch.distributed.all_reduce(t, op=op, group=mesh.dp_group)
        shardlib.add_collectives(
            {"replica_check": (1, t.numel() * t.element_size())})
    differ = (lo != hi).any(dim=1).nonzero().flatten().tolist()
    if differ:
        names = [leaves[i][0] for i in differ]
        raise RuntimeError(
            f"the {mesh.dp_size} processes do not hold the same initial "
            f"state: {len(names)} tensors differ, first {names[:5]}; every "
            f"process must build it from the same seed")


def place_state(state: TrainState, mesh: meshlib.Mesh) -> TrainState:
    """Lay the train state out on the mesh, without collectives, as the
    JAX package's ``place_state`` does: every process built the same
    initial state from the config's seed and kept its slices of the
    parameters a rule set splits over the model axis (``harness/train.py::
    build_model``), so each holds its own copy of the rest, the BN
    statistics, the optimizer slots and EMA shadows of its slices, and
    the carry holds this process's rows of the batch (built at the local
    batch).  Then :func:`check_replicas_agree`, the one startup check."""
    check_replicas_agree(state, mesh)
    return state


def state_is_finite(state: TrainState) -> bool:
    """True when every float tensor of the trajectory-carrying state —
    parameters, BN statistics, carry, optimizer slots, EMA shadows — is
    finite (the JAX package's ``state_is_finite``).  One fused multi-tensor
    reduction (``torch._foreach_norm`` at order inf: each tensor's largest
    magnitude, inf or NaN when the tensor holds one), one finiteness test
    per dtype over those norms, and one read back."""
    leaves = [leaf for leaf in _leaves((state.params, state.batch_stats,
                                        state.carry, state.opt_state,
                                        state.ema_params))
              if leaf.is_floating_point()]
    if not leaves:
        return True
    norms = torch._foreach_norm(leaves, ord=math.inf)
    by_dtype: dict = {}
    for norm in norms:
        by_dtype.setdefault(norm.dtype, []).append(norm)
    flags = [torch.stack(group).isfinite().all()
             for group in by_dtype.values()]
    return bool(torch.stack(flags).all())


def make_eval_step(model: torch.nn.Module, use_ema: bool = True
                   ) -> Callable[[TrainState, Batch], dict]:
    """Eval step returning top-1/top-5 counts summed over the batch; rows
    with a negative label are padding and are not counted.  With
    ``use_ema`` the model runs on ``state.eval_params`` (the EMA shadows
    when kept), else on ``state.params``."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Batch):
        params = state.eval_params if use_ema else state.params
        outputs = torch.func.functional_call(
            model, {**params, **state.batch_stats}, (batch["image"],),
            {"train": False})
        logits = (outputs[0] if isinstance(outputs, (tuple, list))
                  else outputs)
        labels = batch["label"]
        valid = (labels >= 0).to(torch.float32)
        return {
            "top1_count": torch.sum(
                metriclib.top_k_correct(logits, labels, 1) * valid),
            "top5_count": torch.sum(
                metriclib.top_k_correct(logits, labels, 5) * valid),
            "count": torch.sum(valid),
            "xent_sum": torch.sum(
                losslib.softmax_cross_entropy(logits, labels.clamp(min=0))
                * valid),
        }

    return eval_fn
