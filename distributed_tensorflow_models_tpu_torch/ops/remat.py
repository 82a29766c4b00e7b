"""Rematerialisation: a block's activations dropped after its forward and
recomputed in the backward, the port's ``flax.linen.remat``.

:func:`checkpoint` runs a block under ``torch.utils.checkpoint`` (the
non-reentrant form), so that its recompute is one more forward inside the
backward, captured with the rest of a CUDA-graph step.  Three things a
recompute must not change, and how each is kept:

- **Dropout masks.**  The port's dropout draws from explicit generators
  (``rngs``), which ``torch.utils.checkpoint`` does not restore.  The
  recompute gets generators that start where the block's forward started:
  eagerly, a fresh generator set to the state the forward began from;
  inside a CUDA-graph capture (where a generator's state cannot be read),
  a *twin* generator registered with the graph, which the host seeds
  before every replay to the step's seed and to the Philox offset at which
  the block's forward began.  That offset is the one the step's eager run
  found there (:func:`recording`): the eager step and its capture make the
  same draws in the same order.  ``MultiStep`` makes the twins
  (:func:`make_twins`), registers them, and seeds them
  (:func:`seed_twins`).  The masks then equal the forward's, and the
  no-remat run's, bit for bit.
- **BatchNorm's running statistics.**  The recompute runs with
  :func:`recomputing` true, and ``BatchNorm`` leaves its buffers alone
  then: one update a step, as one forward makes.
- **The data axis.**  The recompute may run on the autograd engine's
  device thread, which does not see the caller's
  ``core/mesh.py::data_parallel`` block; it re-enters the mesh (and the
  seq dim) the forward saw, so BatchNorm's moments and dropout's global
  draw are the forward's.

Outside autograd (``torch.no_grad``, eval, decode) the block just runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterable, Iterator, Mapping, Optional

import torch
import torch.utils.checkpoint

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib

_local = threading.local()
# Offsets recorded by the step the host runs eagerly before a capture:
# per CUDA generator (by id), the Philox offset at each block's start;
# while recording, and once it ended until the twins are made.
_recording: dict[int, list[int]] = {}
_recorded: dict[int, list[int]] = {}
# The twins of the capture in flight, per generator id, and how many of
# each the capture has handed out.
_capture_twins: dict[int, list[torch.Generator]] = {}
_capture_next: dict[int, int] = {}
_lock = threading.Lock()


def recomputing() -> bool:
    """True while a checkpointed block runs again in the backward."""
    return getattr(_local, "recomputing", False)


@contextlib.contextmanager
def _recompute():
    prev = recomputing()
    _local.recomputing = True
    try:
        yield
    finally:
        _local.recomputing = prev


def _capturing(gen: torch.Generator) -> bool:
    return (gen.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _replay_source(rngs: Optional[Mapping[str, torch.Generator]]
                   ) -> Callable[[], Optional[dict]]:
    """At a block's start: a function giving the recompute its generators,
    each positioned where the block's forward starts drawing."""
    if not rngs:
        return lambda: rngs
    sources = {}
    for name, gen in rngs.items():
        key = id(gen)
        if _capturing(gen):
            with _lock:
                twins = _capture_twins.get(key)
                i = _capture_next.get(key, 0)
                if twins is None or i >= len(twins):
                    raise RuntimeError(
                        "a rematerialised block draws from a generator the "
                        "capture has no twin for: capture the step after "
                        "an eager run of it under remat.recording")
                _capture_next[key] = i + 1
            twin = twins[i]
            sources[name] = lambda twin=twin: twin
        else:
            state = gen.get_state()
            with _lock:
                if key in _recording:
                    _recording[key].append(gen.get_offset())

            def fresh(gen=gen, state=state):
                g = torch.Generator(device=gen.device)
                g.set_state(state)
                return g

            sources[name] = fresh
    return lambda: {name: src() for name, src in sources.items()}


def checkpoint(fn: Callable, *args,
               rngs: Optional[Mapping[str, torch.Generator]] = None):
    """``fn(*args)`` (``fn(*args, rngs=rngs)`` when ``rngs`` is given)
    with its activations recomputed in the backward instead of kept
    (module docstring).  Tensors it returns carry their gradients, and
    whatever a block returns beside its output (the MoE block's aux loss)
    comes out of the checkpoint once, with its gradient."""
    def call(a, r):
        return fn(*a) if r is None else fn(*a, rngs=r)

    if not torch.is_grad_enabled():
        return call(args, rngs)
    replay = _replay_source(rngs)
    layout = meshlib.current_layout()
    runs = 0

    def run(*a):
        nonlocal runs
        runs += 1
        if runs == 1:
            return call(a, rngs)
        with _recompute(), meshlib.data_parallel(*layout):
            return call(a, replay())

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


@contextlib.contextmanager
def recording(generators: Iterable[torch.Generator]) -> Iterator[None]:
    """Record, for each CUDA generator of ``generators``, the Philox
    offset at which every checkpointed block starts drawing while the
    block runs (the eager step before a capture)."""
    keys = [id(g) for g in generators if g.device.type == "cuda"]
    with _lock:
        for key in keys:
            _recording[key] = []
    try:
        yield
    finally:
        with _lock:
            for key in keys:
                _recorded[key] = _recording.pop(key)


def make_twins(generators: Mapping[str, torch.Generator]
               ) -> list[tuple[torch.Generator, torch.Generator, int]]:
    """One twin per block start :func:`recording` saw, for each CUDA
    generator: ``(generator, twin, offset)``, the twin a fresh generator
    on the same device to register with the graph before the capture."""
    out = []
    with _lock:
        for gen in generators.values():
            for offset in _recorded.pop(id(gen), []):
                out.append((gen, torch.Generator(device=gen.device), offset))
    return out


def seed_twins(twins: Iterable[tuple[torch.Generator, torch.Generator, int]]
               ) -> None:
    """Before a replay, after the step's generators were seeded: each twin
    at its generator's seed and its block's offset."""
    for gen, twin, offset in twins:
        twin.manual_seed(gen.initial_seed())
        twin.set_offset(offset)


@contextlib.contextmanager
def capturing(twins: Iterable[tuple[torch.Generator, torch.Generator, int]]
              ) -> Iterator[None]:
    """Hand ``twins`` out, in order per generator, to the blocks of the
    capture in flight."""
    by_gen: dict[int, list[torch.Generator]] = {}
    for gen, twin, _ in twins:
        by_gen.setdefault(id(gen), []).append(twin)
    with _lock:
        _capture_twins.clear()
        _capture_twins.update(by_gen)
        _capture_next.clear()
    try:
        yield
    finally:
        with _lock:
            _capture_twins.clear()
            _capture_next.clear()
