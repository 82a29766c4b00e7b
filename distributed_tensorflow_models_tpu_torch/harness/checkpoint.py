"""Checkpoint save/restore: the Saver/SessionManager replacement.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/harness/
checkpoint.py``, with its semantics: keep-last-k steps, each written
atomically; a save at a step that exists is a no-op and a torn one is
replaced; restore walks back past torn or unrestorable steps (and, on the
training resume path, past non-finite ones); the input-pipeline position
is saved with the state; every fleet-visible decision is the chief's
(``resilience/consensus.py``); and a resume onto another process count
re-splits the dataset cursor (``data/resplit.py``).  Checkpoints are
``torch.save`` files read back with ``torch.load(..., weights_only=True)``
and JSON; neither orbax nor safetensors is needed (numpy has no bf16, so
``.npy`` would not round-trip the bf16 tensors).

Layout under ``<workdir>/checkpoints`` (``resilience/fsck.py`` checks it
by structure)::

    <step>/state.pt        {name: tensor} of every tensor of the state, on
                           the CPU in its own dtype (the chief's)
    <step>/data.json       the chief's dataset state, with the topology
                           stamp under ``"__fleet__"``
    <step>/manifest.json   step, process count, plain (non-tensor) leaves,
                           each file's bytes, each tensor's shape, dtype
                           and bytes
    <step>/COMMITTED       written last
    dataset_states/<step>/p<pid>.json       each process's dataset state
    dataset_states/<step>/p<pid>.carry.pt   each process's carry rows

The sidecars are written only with more than one process.  A step is
written whole under ``<step>.tmp-*``, each file fsynced, then renamed.

**What is saved.** Every tensor leaf of the :class:`TrainState` under a
stable name: ``params/<name>``, ``batch_stats/<name>``,
``opt_state/...`` (the optimizers' slots and their step counts),
``ema_params/<name>``, ``carry/...`` (the LSTM's state) and
``device_step``; ``step``, the host's count, in the manifest.  A leaf of
``opt_state`` that is neither a tensor nor plain JSON data (a bool, int,
float, str or None) raises: nothing is dropped silently.  ``model`` and
``tx`` are rebuilt from the config, and so are the schedules' device
tables (``ops/optim.py``'s ``_CountTable`` and ``_Divisor``): they are
functions of the config, indexed by the saved counts, not state.  The
carry holds each process's rows of the batch: with more than one process
each writes its own rows to its sidecar directory; a resume onto another
process count joins the saved rows in process order and takes its own.

**Restore is in place.** A captured train step
(``core/train_loop.py::MultiStep``) replays a CUDA graph that reads and
writes the state at the addresses the capture found, so :meth:`restore`
loads a step on the CPU, checks every name, shape and dtype against the
live state (:class:`CheckpointMismatchError` on any difference — never
walked past: every older step of the same run would differ the same
way), applies the caller's acceptance test to the loaded tensors, and
only then ``copy_``\\ s each into the live tensor of the same name.  No
tensor is rebound, so a rollback inside a running ``fit`` keeps replaying
the graph it has.

**Saves are asynchronous, and correct under run-ahead.** ``fit`` runs up
to ``RUN_AHEAD_CHUNKS`` chunks ahead of the device, so a host read of the
live tensors would save a later chunk's state.  :meth:`save` instead
enqueues, on the current stream right after the chunk whose state it
saves, ``non_blocking`` copies into page-locked host buffers (kept across
saves) and an event; a writer thread waits on the event, then writes.
:meth:`fence` waits for the previous write before the buffers are
reused.  The snapshot is timed under ``checkpoint/save``, the wait for a
previous write under ``checkpoint/fence`` and the explicit waits under
``checkpoint/wait``; :attr:`save_log` keeps each save's snapshot and
write seconds and bytes.  No collective runs on the writer thread: every
consensus decision is made on the caller's thread, in the same order on
every process.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import uuid
from collections.abc import Mapping
from typing import Any, Callable, Optional, Sequence

import torch

from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import resplit as resplitlib
from distributed_tensorflow_models_tpu_torch.resilience import consensus as conslib
from distributed_tensorflow_models_tpu_torch.resilience import fsck as fscklib

log = logging.getLogger("dtm")

# Chief-broadcast save decision codes (ints — broadcastable).
_SAVE_PROCEED = 0
_SAVE_SKIP_INFLIGHT = 1
_SAVE_SKIP_EXISTS = 2
_SAVE_REPLACE = 3

# Reserved key stamped into data.json at save time so a restore knows the
# writing fleet's topology (single-process runs write no sidecars).
# Stripped on restore: the train harness never sees it.
_FLEET_META_KEY = "__fleet__"

# The re-split audit the chief writes next to the crossing step's
# sidecars (CheckpointManager._write_resize_ledger).
RESIZE_LEDGER = "resize_ledger.json"

_PLAIN = (bool, int, float, str, type(None))
_FIELDS = ("params", "batch_stats", "opt_state", "ema_params", "carry")


class NoValidCheckpointError(FileNotFoundError):
    """Checkpoints exist but every candidate is torn/unrestorable.
    Distinct from the bare ``FileNotFoundError`` ("no checkpoint found")
    so ``restore_or_init`` can fall back to a fresh init with a loud
    warning instead of crashing the job at recovery time."""


class CheckpointMismatchError(ValueError):
    """A checkpoint's tensors do not fit the live state: a name missing on
    either side, or a shape or dtype that differs."""


def _flatten(tree, prefix: str, tensors: dict, plain: dict) -> None:
    if isinstance(tree, torch.Tensor):
        tensors[prefix] = tree
    elif isinstance(tree, Mapping):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}", tensors, plain)
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}/{i}", tensors, plain)
    elif isinstance(tree, _PLAIN):
        plain[prefix] = tree
    else:
        raise TypeError(
            f"{prefix} holds a {type(tree).__name__}, which is neither a "
            f"tensor nor plain JSON data: a checkpoint cannot hold it")


def flatten_state(state: TrainState) -> tuple[dict, dict]:
    """``({name: tensor}, {name: plain value})`` over every leaf of the
    state that a checkpoint carries, under stable names."""
    tensors: dict[str, torch.Tensor] = {}
    plain: dict[str, Any] = {}
    for field in _FIELDS:
        _flatten(getattr(state, field), field, tensors, plain)
    tensors["device_step"] = state.device_step
    return tensors, plain


def _rebuild(tree, prefix: str, tensors: Mapping, plain: Mapping):
    """``tree``'s structure with each leaf replaced by the value of its
    name in ``tensors`` or ``plain``."""
    if isinstance(tree, torch.Tensor):
        return tensors[prefix]
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, f"{prefix}/{k}", tensors, plain)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, f"{prefix}/{i}", tensors, plain)
                          for i, v in enumerate(tree))
    return plain[prefix]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_bytes(path: str, data: bytes) -> int:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return len(data)


def _save_tensors(path: str, tensors: dict) -> int:
    with open(path, "wb") as f:
        torch.save(tensors, f)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


def _atomic_json(path: str, payload) -> None:
    tmp = f"{path}.tmp"
    _write_bytes(tmp, json.dumps(payload).encode())
    os.replace(tmp, path)


class _PinnedSnapshot:
    """Host buffers a save copies the live tensors into, kept across saves
    (page-locked for CUDA tensors) so a save allocates nothing after the
    first."""

    def __init__(self):
        self._bufs: dict[str, torch.Tensor] = {}

    def take(self, tensors: Mapping[str, torch.Tensor]):
        """Enqueue the copies on each tensor's current stream; returns the
        buffers and the event recorded after them (None on the CPU, where
        the copies are done on return)."""
        out: dict[str, torch.Tensor] = {}
        device = None
        with torch.no_grad():
            for name, t in tensors.items():
                buf = self._bufs.get(name)
                if (buf is None or buf.shape != t.shape
                        or buf.dtype != t.dtype):
                    buf = self._bufs[name] = torch.empty(
                        t.shape, dtype=t.dtype, device="cpu",
                        pin_memory=t.is_cuda)
                buf.copy_(t.detach(), non_blocking=t.is_cuda)
                if t.is_cuda:
                    device = t.device
                out[name] = buf
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return out, event


class CheckpointManager:
    """keep-last-k, asynchronous, atomic checkpoints under
    ``workdir/checkpoints``.

    ``process_index``/``process_count`` default to the live
    ``torch.distributed`` facts (0 of 1 without a process group); the
    consensus defaults to them too, so a manager made for one process of
    a larger world (``fit`` on ``meshlib.local_mesh``) decides alone.
    Only the chief (process 0) writes ``state.pt``; with more than one
    process every process writes its own dataset sidecar (and carry)."""

    def __init__(
        self,
        workdir: str,
        keep: int = 5,
        *,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        registry: Optional[telemetry.MetricsRegistry] = None,
        consensus: Optional[conslib.Consensus] = None,
        step_filter: Optional[Callable[[Sequence[int]], Sequence[int]]] = None,
    ):
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._dir = os.path.abspath(os.path.join(workdir, "checkpoints"))
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep
        live = conslib.Consensus()
        self._pid = live.process_index if process_index is None else (
            process_index)
        self._nproc = live.process_count if process_count is None else (
            process_count)
        # The consensus defaults to the LIVE process facts, not the
        # injected ones: those exist so that sidecar paths are testable in
        # one process, which must not be handed real collectives.
        self._consensus = live if consensus is None else consensus
        # View filter (the chaos visibility-skew simulation,
        # ``hide_newest_ckpt``): applied to every *listing* this manager
        # reasons from — all_steps, latest_step, the save decision and the
        # restore walk's candidates — never to reads or to the retention
        # sweep, which is the real shape of object-store metadata lag.
        self._step_filter = step_filter
        # Zero-vs-missing: both record only on warning paths, and zero is
        # the healthy reading; the fence records only when a save waited.
        self._registry.timer(telemetry.CKPT_FENCE)
        self._registry.counter(telemetry.CKPT_SIDECAR_FALLBACKS)
        self._registry.counter(telemetry.CKPT_RESIZE_RESTORES)
        self._pending_resize: Optional[dict] = None
        self._last_resize: Optional[dict] = None
        self._snapshot = _PinnedSnapshot()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._inflight_step: Optional[int] = None
        # One entry per save: {"step", "snapshot_s", "write_s", "bytes"}
        # (write_s and bytes filled in by the writer thread).
        self.save_log: list[dict] = []

    @property
    def consensus(self) -> conslib.Consensus:
        return self._consensus

    @property
    def last_resize(self) -> Optional[dict]:
        """Details of the cross-topology re-split the most recent restore
        performed (``{"step", "from_nproc", "to_nproc", "source_pid"}``),
        or None when the restore was same-shape."""
        return self._last_resize

    @property
    def is_chief(self) -> bool:
        return self._pid == 0

    @property
    def directory(self) -> str:
        """The checkpoint root (``<workdir>/checkpoints``, absolute)."""
        return self._dir

    def all_steps(self) -> list[int]:
        """Ascending retained steps (rollback and restore candidates), as
        this process sees them (``step_filter`` applied)."""
        steps = fscklib.list_steps(self._dir)
        if self._step_filter is not None:
            steps = sorted(self._step_filter(steps))
        return steps

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _sidecar_dir(self, step: int) -> str:
        return os.path.join(self._dir, fscklib.SIDECARS, str(step))

    def _sidecar(self, step: int, pid: Optional[int] = None) -> str:
        pid = self._pid if pid is None else pid
        return os.path.join(self._sidecar_dir(step), f"p{pid}.json")

    # -- save -------------------------------------------------------------

    def _local_save_decision(self, step: int) -> int:
        """This process's view of what ``save(step)`` should do.  The
        acting decision is the chief's (broadcast in :meth:`save`)."""
        if step == self._inflight_step and self.is_saving():
            # This very state is being written (training is deterministic
            # in step): deleting or rewriting it would corrupt the write.
            return _SAVE_SKIP_INFLIGHT
        if step not in self.all_steps():
            return _SAVE_PROCEED
        if not fscklib.validate_step_dir(self._step_dir(step)):
            # A valid checkpoint of this step IS this state: idempotent,
            # so a preemption's emergency save at the step a cadence save
            # just wrote is a no-op, not a crash.
            return _SAVE_SKIP_EXISTS
        # A renamed dir that fails validation is damage, not a
        # checkpoint: treating it as one would suppress a real save.
        return _SAVE_REPLACE

    def _agree_int(self, value: int, label: str) -> int:
        """Chief-decides broadcast with the skew audit: a follower whose
        local decision is overridden bumps ``fleet/consensus_overrides``
        and the override lands on the trace timeline."""
        agreed = self._consensus.broadcast_int(value, label=label)
        if agreed != value:
            self._registry.counter(telemetry.CONSENSUS_OVERRIDES).inc()
            self._registry.trace.instant(
                "fleet/consensus_override",
                {"label": label, "local": value, "agreed": agreed},
            )
        return agreed

    def save(self, state: TrainState,
             dataset_state: Optional[dict] = None) -> bool:
        """Save ``state`` (and ``dataset_state``, the input position that
        goes with it) at ``state.step``, asynchronously; returns False
        when the step is skipped (already written, or being written)."""
        step = int(state.step)
        decision = self._local_save_decision(step)
        if self._consensus.active:
            decision = self._agree_int(decision, f"save-decision@{step}")
        if decision == _SAVE_SKIP_INFLIGHT:
            log.info("checkpoint at step %d is still being written; "
                     "skipping duplicate save", step)
            return False
        if decision == _SAVE_SKIP_EXISTS:
            log.info("checkpoint at step %d already exists; skipping save",
                     step)
            return False
        if decision == _SAVE_REPLACE:
            log.warning("existing checkpoint at step %d is torn; replacing "
                        "it", step)
            self._registry.trace.instant("checkpoint/replace_torn",
                                         {"step": step})
        # The buffers of the previous save are reused: its write must be
        # done (and a failed write raises here, before anything else).
        self.fence()
        if decision == _SAVE_REPLACE and self.is_chief:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        tensors, plain = flatten_state(state)
        carry = {}
        if self._nproc > 1:
            carry = {k: tensors.pop(k) for k in list(tensors)
                     if k.startswith("carry/")}
        t0 = time.perf_counter()
        with self._registry.span(telemetry.CKPT_SAVE):
            snap, event = self._snapshot.take(
                {**(tensors if self.is_chief else {}), **carry})
        entry = {"step": step, "snapshot_s": time.perf_counter() - t0,
                 "write_s": None, "bytes": None}
        self.save_log.append(entry)
        # Frozen now: the caller's dict moves on with the pipeline.
        data = json.loads(json.dumps(dataset_state or {}))
        job = dict(step=step, snap=snap, event=event, plain=plain,
                   names=list(tensors), carry=list(carry), data=data,
                   entry=entry)
        self._inflight_step = step
        self._write_error = None
        self._writer = threading.Thread(target=self._write, args=(job,),
                                        name="checkpoint-writer",
                                        daemon=True)
        self._writer.start()
        log.info("saving checkpoint at step %d", step)
        return True

    def _write(self, job: dict) -> None:
        try:
            t0 = time.perf_counter()
            if job["event"] is not None:
                job["event"].synchronize()
            nbytes = 0
            if self.is_chief:
                nbytes += self._write_step(job)
            if self._nproc > 1:
                nbytes += self._write_sidecar(job)
            job["entry"]["write_s"] = time.perf_counter() - t0
            job["entry"]["bytes"] = nbytes
        except Exception as e:  # raised by the next fence()/wait()
            log.error("checkpoint write at step %d failed: %r", job["step"],
                      e)
            self._write_error = e

    def _write_step(self, job: dict) -> int:
        step, snap = job["step"], job["snap"]
        tensors = {k: snap[k] for k in job["names"]}
        tmp = os.path.join(
            self._dir, f"{step}.tmp-{self._pid}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        files = {fscklib.STATE_FILE: _save_tensors(
            os.path.join(tmp, fscklib.STATE_FILE), tensors)}
        data = dict(job["data"])
        data[_FLEET_META_KEY] = {"nproc": self._nproc}
        files[fscklib.DATA_FILE] = _write_bytes(
            os.path.join(tmp, fscklib.DATA_FILE), json.dumps(data).encode())
        manifest = {
            "step": step,
            "nproc": self._nproc,
            "carry": "per_process" if job["carry"] else None,
            "plain": job["plain"],
            "files": files,
            "tensors": {k: {"shape": list(t.shape),
                            "dtype": _dtype_name(t.dtype),
                            "bytes": t.numel() * t.element_size()}
                        for k, t in tensors.items()},
        }
        _write_bytes(os.path.join(tmp, fscklib.MANIFEST),
                     json.dumps(manifest, indent=1).encode())
        _write_bytes(os.path.join(tmp, fscklib.COMMITTED), b"")
        _fsync_dir(tmp)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self._dir)
        self._collect(step)
        return sum(files.values())

    def _write_sidecar(self, job: dict) -> int:
        """This process's dataset position, stamped with the process
        count, and its carry rows; the JSON last, each atomic by rename."""
        step = job["step"]
        base = self._sidecar_dir(step)
        os.makedirs(base, exist_ok=True)
        wrapped: dict = {"nproc": self._nproc, "state": job["data"]}
        nbytes = 0
        if job["carry"]:
            name = f"p{self._pid}.carry.pt"
            tmp = os.path.join(base, f"{name}.tmp")
            nbytes = _save_tensors(tmp, {k: job["snap"][k]
                                         for k in job["carry"]})
            os.replace(tmp, os.path.join(base, name))
            wrapped["carry"] = {"file": name, "bytes": nbytes}
        _atomic_json(self._sidecar(step), wrapped)
        return nbytes

    def _collect(self, newest: int) -> None:
        """Keep the newest ``keep`` steps (chief only): older step
        directories go with their sidecars, and so do sidecar directories
        older than every kept step (a newer one may belong to a step
        still being written)."""
        steps = fscklib.list_steps(self._dir)
        for step in steps[:-self._keep]:
            self.delete(step)
        kept = steps[-self._keep:] or [newest]
        base = os.path.join(self._dir, fscklib.SIDECARS)
        if os.path.isdir(base):
            for name in os.listdir(base):
                if name.isdigit() and int(name) < min(kept):
                    shutil.rmtree(os.path.join(base, name),
                                  ignore_errors=True)

    def delete(self, step: int) -> None:
        """Remove one retained step and its sidecars (chief only; a no-op
        elsewhere).  The rollback path deletes the abandoned timeline's
        checkpoints after rewinding: they hold post-divergence state that
        must never be restored."""
        if not self.is_chief:
            return
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        shutil.rmtree(self._sidecar_dir(step), ignore_errors=True)

    def is_saving(self) -> bool:
        """True while a save's write is still running."""
        return self._writer is not None and self._writer.is_alive()

    def _raise_write_error(self) -> None:
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise RuntimeError(f"writing the checkpoint at step "
                               f"{self._inflight_step} failed: {e!r}") from e

    def fence(self) -> None:
        """Wait for the previous save's write before the next one reuses
        its buffers, recorded under ``checkpoint/fence`` only when it had
        to wait: the timer's count is how often the save cadence outran
        the writer, its total what that cost."""
        if self.is_saving():
            with self._registry.span(telemetry.CKPT_FENCE):
                self._writer.join()
        self._raise_write_error()

    def wait(self) -> None:
        """Block until the pending write is durable (the explicit fence of
        the emergency-save, rollback and teardown paths; always recorded,
        under ``checkpoint/wait``).  A failed write raises."""
        with self._registry.span(telemetry.CKPT_WAIT):
            if self._writer is not None:
                self._writer.join()
        self._raise_write_error()

    # -- restore ----------------------------------------------------------

    def restore(self, template: TrainState) -> tuple[TrainState, dict]:
        """Restore the newest valid step into ``template``'s tensors, in
        place (see the module docstring); :meth:`restore_newest_valid`
        without a finiteness gate (the training resume path adds it in
        :func:`restore_or_init`).  Returns the state with ``step`` set and
        the dataset state dict."""
        return self.restore_newest_valid(template)

    def restore_newest_valid(
        self,
        template: TrainState,
        accept: Optional[Callable[[TrainState], bool]] = None,
        accept_name: str = "",
    ) -> tuple[TrainState, dict]:
        """Walk candidate steps newest-first, skipping torn (structural
        validation), unloadable and — when ``accept(candidate)`` is given
        — rejected ones, then restore the survivor in place.  ``accept``
        sees the candidate loaded on the CPU, before it touches the live
        state.  Raises :class:`NoValidCheckpointError` when nothing
        survives.  With several processes the walk is chief-decided, as in
        the JAX package: process 0 names each candidate, and restore
        failures and rejections are agreed with any-host reductions."""
        if self._consensus.active:
            return self._restore_newest_valid_fleet(template, accept,
                                                    accept_name)
        return self._restore_newest_valid_local(template, accept,
                                                accept_name)

    def _restore_newest_valid_local(self, template, accept, accept_name):
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError("no checkpoint found")
        last_error: Optional[BaseException] = None
        for i, step in enumerate(candidates):
            issues = fscklib.validate_step_dir(self._step_dir(step))
            if issues:
                log.warning(
                    "checkpoint step %d fails validation (%s); walking back "
                    "to an earlier step (python -m "
                    "distributed_tensorflow_models_tpu_torch.resilience.fsck "
                    "reports and can --repair)", step, "; ".join(issues))
                self._trace_walk_back(step, "torn")
                continue
            try:
                candidate, data = self._restore_step(template, step)
            except CheckpointMismatchError:
                raise
            except Exception as e:  # damage fsck can't see
                last_error = e
                log.warning("checkpoint step %d passed validation but failed "
                            "to load (%s); walking back", step, e)
                self._trace_walk_back(step, "unrestorable")
                continue
            if accept is not None and not accept(candidate):
                log.warning("checkpoint step %d rejected (%s); walking back",
                            step, accept_name or "accept predicate")
                self._trace_walk_back(step, accept_name or "rejected")
                continue
            if i > 0:
                log.warning("restored step %d instead of the newest step %d "
                            "(newer candidates torn/unrestorable/rejected)",
                            step, candidates[0])
            return self._finalize(template, candidate, data)
        raise NoValidCheckpointError(
            f"no valid checkpoint among steps {candidates} under "
            f"{self._dir}") from last_error

    def _trace_walk_back(self, step: int, why: str) -> None:
        self._registry.trace.instant("checkpoint/walk_back",
                                     {"step": step, "why": why})

    def _walk_order(self) -> list[int]:
        """Candidate order for the fleet walk, from THIS process's view:
        newest-first within two tiers — steps whose sidecar set is
        complete (for the live process count, or for its stamped one),
        then structurally valid steps.  Only the chief's order decides."""
        structural = [
            s for s in sorted(self.all_steps(), reverse=True)
            if not fscklib.validate_step_dir(self._step_dir(s))
        ]
        complete = [
            s for s in structural
            if fscklib.fleet_sidecars_complete(self._dir, s, self._nproc)
            or fscklib.stamped_topology(self._dir, s) is not None
        ]
        done = set(complete)
        return complete + [s for s in structural if s not in done]

    def _restore_newest_valid_fleet(self, template, accept, accept_name):
        queue = self._walk_order()
        newest = queue[0] if queue else None
        tried: set[int] = set()
        last_error: Optional[BaseException] = None
        while True:
            # -1: the walk exhausted the candidates; -2: the chief saw no
            # checkpoint.  The agreed code picks the exception, so every
            # process raises the same class.
            if any(s not in tried for s in queue):
                local_pick = next(s for s in queue if s not in tried)
            else:
                local_pick = -2 if not queue else -1
            step = self._agree_int(local_pick, "restore-pick")
            if step == -2:
                raise FileNotFoundError("no checkpoint found")
            if step < 0:
                raise NoValidCheckpointError(
                    f"no valid checkpoint among steps {sorted(tried)} under "
                    f"{self._dir} (chief-decided walk exhausted)"
                ) from last_error
            tried.add(step)
            failed = False
            out = None
            try:
                out = self._restore_step(template, step)
            except CheckpointMismatchError:
                raise
            except Exception as e:
                last_error = e
                failed = True
                log.warning("chief-decided step %d failed to load here (%s)",
                            step, e)
            if self._consensus.any_flag(failed, label="restore-failed"):
                self._trace_walk_back(
                    step, "unrestorable" if failed else "peer-unrestorable")
                continue
            rejected = accept is not None and not accept(out[0])
            if self._consensus.any_flag(rejected, label="restore-rejected"):
                log.warning("checkpoint step %d rejected by the fleet (%s); "
                            "walking back", step,
                            accept_name or "accept predicate")
                self._trace_walk_back(step, accept_name or "fleet-rejected")
                continue
            if newest is not None and step != newest:
                log.warning("restored step %d instead of the newest step %d",
                            step, newest)
            return self._finalize(template, out[0], out[1])

    def _load_carry(self, template: TrainState, step: int, manifest: dict,
                    flat: dict, saved_nproc: int) -> dict:
        """This process's carry rows at ``step``: its own saved rows when
        the process count is the one that wrote them, else the saved rows
        joined in process order and cut to this process's share."""
        live, _ = flatten_state(template)
        names = [k for k in live if k.startswith("carry/")]
        if not names:
            return {}
        if manifest.get("carry") == "per_process":
            pids = ([self._pid] if saved_nproc == self._nproc
                    else range(saved_nproc))
            parts = []
            for pid in pids:
                path = os.path.join(self._sidecar_dir(step),
                                    f"p{pid}.carry.pt")
                parts.append(torch.load(path, map_location="cpu",
                                        weights_only=True))
            if saved_nproc == self._nproc:
                return parts[0]
            rows = {k: torch.cat([p[k] for p in parts]) for k in names}
        else:
            rows = {k: flat.pop(k) for k in names if k in flat}
            if self._nproc == 1 or len(rows) != len(names):
                return rows
        out = {}
        for k in names:
            n = live[k].shape[0]
            if rows[k].shape[0] != n * self._nproc:
                raise CheckpointMismatchError(
                    f"{k}: {rows[k].shape[0]} saved rows do not split into "
                    f"{self._nproc} processes of {n}")
            out[k] = rows[k][self._pid * n:(self._pid + 1) * n]
        return out

    def _restore_step(self, template: TrainState,
                      step: int) -> tuple[TrainState, dict]:
        """Load ``step`` on the CPU as a candidate: ``template`` with each
        tensor replaced by the saved one (names, shapes and dtypes checked)
        and ``step`` set; nothing live is touched.  Returns it and the
        dataset state."""
        # A previous walk candidate may have staged a re-split and then
        # been discarded: never let it leak into this one.
        self._pending_resize = None
        step_dir = self._step_dir(step)
        with self._registry.span(telemetry.CKPT_RESTORE):
            manifest = fscklib.read_manifest(step_dir)
            if manifest is None:
                raise FileNotFoundError(f"no readable manifest in {step_dir}")
            flat = torch.load(os.path.join(step_dir, fscklib.STATE_FILE),
                              map_location="cpu", weights_only=True)
            with open(os.path.join(step_dir, fscklib.DATA_FILE)) as f:
                data = json.load(f)
            meta = data.pop(_FLEET_META_KEY, None)
            try:
                saved_nproc = int(meta["nproc"])
            except (KeyError, TypeError, ValueError):
                saved_nproc = int(manifest.get("nproc", 1))
            flat.update(self._load_carry(template, step, manifest, flat,
                                         saved_nproc))
            candidate = self._candidate(template, flat,
                                        manifest.get("plain", {}),
                                        int(manifest["step"]))
        if saved_nproc != self._nproc:
            data = self._prepare_resize(step, saved_nproc, data)
        elif self._nproc > 1:
            data = self._own_sidecar(step, data)
        return candidate, data

    def _candidate(self, template: TrainState, flat: dict, plain: dict,
                   step: int) -> TrainState:
        live, live_plain = flatten_state(template)
        missing = sorted(set(live) - set(flat))
        extra = sorted(set(flat) - set(live))
        if missing or extra:
            raise CheckpointMismatchError(
                f"the checkpoint does not hold the live state's tensors: "
                f"missing {missing[:5]}, not in the live state {extra[:5]}")
        for name, t in live.items():
            saved = flat[name]
            if tuple(saved.shape) != tuple(t.shape) or saved.dtype != t.dtype:
                raise CheckpointMismatchError(
                    f"{name}: saved {tuple(saved.shape)} {saved.dtype}, live "
                    f"{tuple(t.shape)} {t.dtype}")
        if set(plain) != set(live_plain):
            raise CheckpointMismatchError(
                f"plain leaves differ: saved {sorted(plain)}, live "
                f"{sorted(live_plain)}")
        fields = {f: _rebuild(getattr(template, f), f, flat, plain)
                  for f in _FIELDS}
        return template.replace(step=step, device_step=flat["device_step"],
                                **fields)

    def _finalize(self, template: TrainState, candidate: TrainState,
                  data: dict) -> tuple[TrainState, dict]:
        """Copy the accepted candidate into the live tensors and resolve a
        staged re-split."""
        live, live_plain = flatten_state(template)
        saved, plain = flatten_state(candidate)
        with torch.no_grad():
            for name, t in live.items():
                t.copy_(saved[name])
        state = template.replace(step=candidate.step)
        if plain != live_plain:
            # Same tensors (copied into above), the saved plain leaves.
            state = state.replace(opt_state=_rebuild(
                template.opt_state, "opt_state", live, plain))
        return self._finalize_resize((state, data))

    def _own_sidecar(self, step: int, primary: dict) -> dict:
        """This process's own dataset state at ``step``; the primary's
        (approximate resume, counted) when it is missing, unreadable or
        stamped with another process count."""
        path = self._sidecar(step)
        wrapped = None
        why = "no per-process dataset sidecar"
        if os.path.exists(path):
            try:
                with open(path) as f:
                    wrapped = json.load(f)
            except (OSError, ValueError) as e:
                why = f"dataset sidecar is unreadable ({e})"
        if isinstance(wrapped, dict) and wrapped.get("nproc") == self._nproc:
            return wrapped.get("state") or {}
        if isinstance(wrapped, dict):
            why = (f"dataset sidecar is from a {wrapped.get('nproc')}-process "
                   f"run, not {self._nproc}")
        log.warning("%s at %s; using the primary's position (approximate "
                    "resume)", why, path)
        self._registry.counter(telemetry.CKPT_SIDECAR_FALLBACKS).inc()
        return primary

    def _read_sidecar_state(self, step: int, pid: int) -> Optional[dict]:
        try:
            with open(self._sidecar(step, pid)) as f:
                wrapped = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(wrapped, dict):
            return None
        state = wrapped.get("state")
        return state if isinstance(state, dict) else None

    def _prepare_resize(self, step: int, saved_nproc: int,
                        primary: dict) -> dict:
        """Stage the cross-topology dataset re-split for this candidate
        (local and deterministic; agreed in :meth:`_finalize_resize`,
        after the walk has settled on the candidate)."""
        states: dict = {}
        for pid in range(saved_nproc):
            state = self._read_sidecar_state(step, pid)
            if state is not None:
                states[pid] = state
        local_pick = resplitlib.pick_source(states)
        self._pending_resize = {
            "step": step,
            "from_nproc": saved_nproc,
            "states": states,
            "local_pick": local_pick,
            "primary": primary,
        }
        return primary if local_pick < 0 else states[local_pick]

    def _finalize_resize(
        self, out: tuple[TrainState, dict]
    ) -> tuple[TrainState, dict]:
        """Resolve a staged cross-topology re-split on the accepted
        candidate: agree the source pid (the chief's), adopt that
        sidecar's cursor everywhere, count and trace the crossing, and
        have the chief write the audit ledger.  Identity for same-shape
        restores."""
        pend, self._pending_resize = self._pending_resize, None
        self._last_resize = None
        if pend is None:
            return out
        step = pend["step"]
        pick = pend["local_pick"]
        if self._consensus.active:
            pick = self._agree_int(pick, f"resize-pick@{step}")
        self._registry.counter(telemetry.CKPT_RESIZE_RESTORES).inc()
        self._registry.trace.instant("checkpoint/resize_restore", {
            "step": step, "from_nproc": pend["from_nproc"],
            "to_nproc": self._nproc, "source_pid": pick})
        state = pend["states"].get(pick) if pick >= 0 else None
        if state is None and pick >= 0:
            state = self._read_sidecar_state(step, pick)
        if state is None:
            log.warning(
                "cross-topology restore at step %d (%d -> %d processes): no "
                "usable dataset cursor among the saved sidecars; using the "
                "primary's position (approximate resume)",
                step, pend["from_nproc"], self._nproc)
            self._registry.counter(telemetry.CKPT_SIDECAR_FALLBACKS).inc()
            data = pend["primary"]
        else:
            log.warning(
                "CROSS-TOPOLOGY RESTORE at step %d: checkpoint written by %d "
                "process(es), restoring onto %d; dataset cursor re-split to "
                "the fleet-minimum position (source sidecar p%d)",
                step, pend["from_nproc"], self._nproc, pick)
            data = state
        self._last_resize = {"step": step, "from_nproc": pend["from_nproc"],
                             "to_nproc": self._nproc, "source_pid": pick}
        if self.is_chief:
            self._write_resize_ledger(pend, pick)
        return out[0], data

    def _write_resize_ledger(self, pend: dict, pick: int) -> None:
        """The crossing's audit (chief only, atomic, best-effort): every
        saved pid's cursor position, the agreed source and the adopted
        position."""
        step = pend["step"]
        adopted = resplitlib.cursor_position(pend["states"].get(pick))
        ledger = dict(resplitlib.describe_positions(pend["states"]))
        ledger.update({
            "step": step,
            "from_nproc": pend["from_nproc"],
            "to_nproc": self._nproc,
            "source_pid": pick,
            "adopted_position": (list(adopted) if adopted is not None
                                 else None),
        })
        base = self._sidecar_dir(step)
        try:
            os.makedirs(base, exist_ok=True)
            _atomic_json(os.path.join(base, RESIZE_LEDGER), ledger)
        except OSError as e:  # the audit trail is advisory
            log.warning("could not write resize ledger at %s (%s)", base, e)


def restore_or_init(
    manager: CheckpointManager, template: TrainState
) -> tuple[TrainState, dict, bool]:
    """``SessionManager.prepare_session`` semantics (TF
    session_manager.py:259): restore the latest checkpoint into
    ``template``'s tensors when one exists, otherwise return ``template``
    as it is.  Returns ``(state, dataset_state, restored)``.

    When checkpoints exist but every candidate is torn or non-finite,
    training starts fresh with a loud error log.  Candidates are gated on
    finiteness (``train_loop.state_is_finite``, on the loaded tensors
    before they reach the live ones): a crash-time save after a NaN trip
    is structurally valid but poisoned.  With several processes,
    restore-vs-init is the chief's decision."""
    cons = manager.consensus
    has_checkpoint = manager.latest_step() is not None
    if cons.active:
        has_checkpoint = bool(cons.broadcast_int(int(has_checkpoint),
                                                 label="restore-or-init"))
    if not has_checkpoint:
        return template, {}, False
    from distributed_tensorflow_models_tpu_torch.core.train_loop import (
        state_is_finite,
    )

    try:
        state, data = manager.restore_newest_valid(
            template, accept=state_is_finite,
            accept_name="non-finite state (post-divergence save)")
    except NoValidCheckpointError as e:
        log.error(
            "checkpoints exist but none are restorable (%s); initializing "
            "fresh — run python -m "
            "distributed_tensorflow_models_tpu_torch.resilience.fsck "
            "--repair to clear the torn steps", e)
        return template, {}, False
    resize = manager.last_resize
    if resize is not None:
        log.warning(
            "RESUMING ACROSS A FLEET RESIZE: checkpoint at step %d was "
            "written by %d process(es), this fleet has %d; the dataset "
            "cursor was re-split (source sidecar p%d; see %s).  The "
            "trajectory after the resize is equivalent, not bit-identical.",
            resize["step"], resize["from_nproc"], resize["to_nproc"],
            resize["source_pid"], RESIZE_LEDGER)
    log.info("restored checkpoint at step %d", int(state.step))
    return state, data, True
