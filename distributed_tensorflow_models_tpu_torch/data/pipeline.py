"""Host prefetch pipeline: the QueueRunner/Coordinator replacement.

The reference overlaps input with compute via graph-resident queues driven
by *many* Python ``QueueRunner`` threads per queue under a ``Coordinator``
(SURVEY.md §2.2 F10/F11; TF queue_runner_impl.py:34, coordinator.py:28).
The split here: :class:`HostPipeline` produces numpy batches into a
bounded buffer — one background producer thread by default, or an
N-worker pool (``num_workers > 1``) that restores the reference's
producer parallelism for decode/augment-bound inputs — and
:class:`DevicePrefetcher` keeps a couple of batches resident on the
device, copied from page-locked memory on a stream of their own, so the
next step's input is on the card before the step asks for it.

The worker pool keeps the Coordinator semantics AND, unlike the
reference's free-running queue runners, stays deterministic: a serial
dispatcher advances the dataset's cheap cursor (``next_work()``,
datasets.py) and enqueues indexed work items; workers execute the pure
``assemble(work)`` in parallel; an ordered-reassembly stage releases
batches strictly in dispatch-index order.  The emitted stream is
therefore bit-identical for any worker count, a producer error surfaces
at exactly the position it occurred (after every earlier good batch has
drained), and the resume contract below is unchanged.

Unlike the reference's queues, the pipeline is *checkpointable*: each batch
carries the producer state that follows it, so `state` after consuming
batch k resumes at batch k+1 exactly (SURVEY.md §5.4 gap).

Telemetry: all stages record into an injectable
:class:`...telemetry.MetricsRegistry` (default: the process-global one) —
``pipeline/host_queue_depth`` + ``pipeline/producer_wait`` from the host
producer, ``pipeline/worker_busy/<i>`` per-worker utilization +
``pipeline/reassembly_wait`` from the pool, ``pipeline/prefetch_fill`` +
``pipeline/prefetch_depth`` from the device stage.  High producer wait =
consumer-bound (healthy); high prefetch-fill p95 = the host stream is the
bottleneck — then worker_busy vs reassembly_wait splits "pool too small /
decode-bound" from "serial cursor-bound".

The port's own copy of ``distributed_tensorflow_models_tpu/data/
pipeline.py``: :class:`HostPipeline` is the same code on the port's
registry; :class:`DevicePrefetcher` is written for CUDA (a pinned staging
ring and a copy stream in place of the mesh placement) and keeps the
reference's contract.  ``BatchStacker`` (K-step fusion) is not ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch import telemetry

PyTree = Any

log = logging.getLogger("dtm")

# Pipeline stage waits below this duration are not traced (they still
# land in the timers): the tracer's ring exists to hold *stalls* for the
# flight recorder / fleet timeline, and a healthy pipeline's thousands of
# sub-millisecond waits would evict exactly the events a post-mortem
# needs.
_TRACE_STALL_MIN_S = 1e-3


def _trace_stall(reg, name: str, dur_s: float, t0_mono: float) -> None:
    tr = reg.trace
    if tr.enabled and dur_s >= _TRACE_STALL_MIN_S:
        tr.complete(name, dur_s, ts_mono=t0_mono)


class _Stop:
    pass


_STOP = _Stop()


class _Failure:
    """A producer-side error travelling the queues as a payload, so the
    ordered-release stage surfaces it at the position it occurred."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class HostPipeline:
    """Batch producer with bounded buffering: one background thread, or an
    ordered worker pool.

    ``dataset`` must be iterable (yielding numpy pytrees) and may expose
    ``get_state()/set_state()`` for resume.  With ``num_workers > 1`` it
    must additionally expose the worker-pool split (``next_work()`` +
    pure ``assemble(work)`` — every dataset in ``datasets.py`` does);
    datasets without it fall back to the serial producer with a warning.

    Pool topology (all threads daemon, all loops cooperative on the stop
    event): ``host-pipeline`` (dispatcher) advances the cursor serially
    and enqueues ``(index, work, state-after)``; ``data-worker-<i>``
    threads run ``assemble`` in parallel; ``host-pipeline-reassembly``
    releases results strictly in index order into the bounded consumer
    buffer.  Because release is ordered and state was captured at
    dispatch, the checkpointable state follows the last *released* batch
    exactly as in the serial path, and in-flight work is naturally
    bounded by the dispatch queue depth + pool width (the reassembly
    hold-back set can never exceed it).
    """

    def __init__(
        self,
        dataset,
        *,
        prefetch: int = 4,
        num_workers: int = 1,
        registry: Optional[telemetry.MetricsRegistry] = None,
    ):
        self._dataset = dataset
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._buffer: queue.Queue = queue.Queue(maxsize=prefetch)
        self._error: Optional[BaseException] = None
        self._error_raised = False
        self._stop_event = threading.Event()
        self._state: Optional[dict] = (
            dataset.get_state() if hasattr(dataset, "get_state") else None
        )
        # Pool wind-down, distinct from the consumer-facing stop event:
        # set by reassembly when it exits early (producer error) so the
        # dispatcher and workers stop feeding the unbounded results queue
        # while the consumer is still draining buffered good batches —
        # the STOP sentinel (gated on _stop_event only) still goes out.
        self._pool_stop = threading.Event()
        pooled = num_workers > 1
        if pooled and not (
            hasattr(dataset, "next_work") and hasattr(dataset, "assemble")
        ):
            log.warning(
                "num_workers=%d requested but %s does not expose the "
                "next_work/assemble worker-pool split; using the serial "
                "producer",
                num_workers,
                type(dataset).__name__,
            )
            pooled = False
        if pooled:
            self._num_workers = num_workers
            # Dispatch depth = pool width + prefetch: enough queued work
            # to keep every worker fed while the consumer drains, small
            # enough that dispatch (and so checkpoint state) never runs
            # far ahead of release.
            self._work_q: queue.Queue = queue.Queue(
                maxsize=num_workers + prefetch
            )
            # Unbounded on purpose: in-flight items are bounded by
            # work_q depth + num_workers, and a bounded results queue
            # could deadlock reassembly waiting for an index a blocked
            # worker holds.
            self._results_q: queue.Queue = queue.Queue()
            self._dispatched = 0
            self._dispatch_done = False
            # Reassembly's hold-back set, an attribute so stop() can
            # sweep it (with the results queue) for a failure that never
            # reached the release point.
            self._pending: dict[int, tuple] = {}
            self._threads = [
                threading.Thread(
                    target=self._dispatch, name="host-pipeline", daemon=True
                ),
                *(
                    threading.Thread(
                        target=self._worker,
                        args=(i,),
                        name=f"data-worker-{i}",
                        daemon=True,
                    )
                    for i in range(num_workers)
                ),
                threading.Thread(
                    target=self._reassemble,
                    name="host-pipeline-reassembly",
                    daemon=True,
                ),
            ]
        else:
            self._threads = [
                threading.Thread(
                    target=self._run, name="host-pipeline", daemon=True
                )
            ]
        for t in self._threads:
            t.start()

    # -- queue helpers (every blocking op must observe the stop event) ----

    def _put_stop_aware(self, q: queue.Queue, item) -> bool:
        """Put, polling the stop event; False if stop was requested."""
        while not self._stop_event.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pool_halted(self) -> bool:
        return self._stop_event.is_set() or self._pool_stop.is_set()

    def _put_pool_aware(self, q: queue.Queue, item) -> bool:
        """Put, polling stop AND pool wind-down; False if either fired."""
        while not self._pool_halted():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- serial producer (num_workers == 1 or no pool protocol) -----------

    def _run(self) -> None:
        reg = self._registry
        try:
            for batch in self._dataset:
                state = (
                    self._dataset.get_state()
                    if hasattr(self._dataset, "get_state")
                    else None
                )
                # Time blocked on a full buffer: high producer wait means
                # the consumer is the bottleneck — the healthy state.
                t0 = time.perf_counter()
                delivered = self._put_stop_aware(
                    self._buffer, (batch, state)
                )
                dt = time.perf_counter() - t0
                reg.timer(telemetry.PRODUCER_WAIT).record(dt)
                _trace_stall(reg, telemetry.PRODUCER_WAIT, dt, t0)
                reg.gauge(telemetry.HOST_QUEUE_DEPTH).set(
                    self._buffer.qsize()
                )
                if not delivered:
                    return
        except BaseException as e:  # propagate like Coordinator.join
            self._error = e
        finally:
            # The STOP sentinel must not be dropped: without it a consumer
            # blocks forever after draining the buffer (and a stored error
            # would never surface).  Retry until delivered or stop requested.
            self._put_stop_aware(self._buffer, (_STOP, None))

    # -- worker pool -------------------------------------------------------

    def _dispatch(self) -> None:
        """Serial cursor walk: the only thread that touches the dataset's
        mutable state.  State is captured immediately after ``next_work``
        so it names the position *after* the dispatched batch — the
        resume-exact value released alongside that batch downstream."""
        idx = 0
        try:
            while not self._pool_halted():
                try:
                    work = self._dataset.next_work()
                except StopIteration:
                    break
                state = (
                    self._dataset.get_state()
                    if hasattr(self._dataset, "get_state")
                    else None
                )
                if not self._put_pool_aware(
                    self._work_q, (idx, work, state)
                ):
                    return
                idx += 1
        except BaseException as e:
            # A cursor error holds position idx: reassembly releases
            # 0..idx-1 first, then surfaces it — straight to results, no
            # worker involved.
            self._results_q.put((idx, _Failure(e), None))
            idx += 1
        finally:
            self._dispatched = idx
            self._dispatch_done = True
            for _ in range(self._num_workers):
                if not self._put_pool_aware(self._work_q, _STOP):
                    break

    def _worker(self, wid: int) -> None:
        reg = self._registry
        busy_gauge = reg.gauge(f"{telemetry.WORKER_BUSY}/{wid}")
        t_start = time.perf_counter()
        busy = 0.0
        while not self._pool_halted():
            try:
                item = self._work_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if isinstance(item, _Stop):
                return
            idx, work, state = item
            t0 = time.perf_counter()
            try:
                payload = self._dataset.assemble(work)
            except BaseException as e:
                payload = _Failure(e)
            now = time.perf_counter()
            busy += now - t0
            busy_gauge.set(busy / max(now - t_start, 1e-9))
            self._results_q.put((idx, payload, state))

    def _reassemble(self) -> None:
        """Ordered release: batches leave in dispatch-index order no
        matter which worker finished first, so the stream (and the state
        riding with each batch) is identical to the serial producer's."""
        reg = self._registry
        pending = self._pending
        next_idx = 0
        try:
            while not self._stop_event.is_set():
                # Wait for the *next in-order* index.  This timer is the
                # pool's stall signal: fat p95 with workers near 1.0 busy
                # = pool too small (decode-bound); fat p95 with workers
                # idle = the serial cursor is the bottleneck.
                t0 = time.perf_counter()
                while next_idx not in pending:
                    if self._stop_event.is_set():
                        return
                    if (
                        self._dispatch_done
                        and next_idx >= self._dispatched
                    ):
                        return
                    try:
                        idx, payload, state = self._results_q.get(
                            timeout=0.1
                        )
                    except queue.Empty:
                        continue
                    pending[idx] = (payload, state)
                dt = time.perf_counter() - t0
                reg.timer(telemetry.REASSEMBLY_WAIT).record(dt)
                _trace_stall(reg, telemetry.REASSEMBLY_WAIT, dt, t0)
                payload, state = pending.pop(next_idx)
                next_idx += 1
                if isinstance(payload, _Failure):
                    # Surfaces after every earlier good batch has drained
                    # — the position-exact Coordinator contract.
                    self._error = payload.error
                    return
                # Blocked on a full buffer = consumer-bound (healthy) —
                # the same signal the serial producer records.
                t0 = time.perf_counter()
                delivered = self._put_stop_aware(
                    self._buffer, (payload, state)
                )
                dt = time.perf_counter() - t0
                reg.timer(telemetry.PRODUCER_WAIT).record(dt)
                _trace_stall(reg, telemetry.PRODUCER_WAIT, dt, t0)
                reg.gauge(telemetry.HOST_QUEUE_DEPTH).set(
                    self._buffer.qsize()
                )
                if not delivered:
                    return
        finally:
            # Wind the pool down on EVERY exit — on the error path the
            # dispatcher and workers would otherwise free-run an
            # infinite dataset into the unbounded results queue while
            # the consumer drains buffered batches toward the error.
            self._pool_stop.set()
            self._put_stop_aware(self._buffer, (_STOP, None))

    # -- consumer side -----------------------------------------------------

    def __iter__(self) -> Iterator[PyTree]:
        return self

    def __next__(self) -> PyTree:
        # Buffered good batches drain before a producer error surfaces —
        # the error is raised at the position it occurred, not earlier.
        item, state = self._buffer.get()
        # Sample depth on the consumer side too: a drained queue must
        # read 0, not the last depth the producer happened to publish.
        self._registry.gauge(telemetry.HOST_QUEUE_DEPTH).set(
            self._buffer.qsize()
        )
        if isinstance(item, _Stop):
            if self._error is not None:
                self._error_raised = True
                raise self._error
            raise StopIteration
        self._state = state
        return item

    def get_state(self) -> Optional[dict]:
        """Producer state as of the last *consumed* batch (resume-exact)."""
        return self._state

    def stop(self, raise_pending: bool = True) -> None:
        """Cooperative stop — ``Coordinator.request_stop`` + ``join``
        (TF coordinator.py:181,318).  Like ``Coordinator.join``, a stored
        producer error that never reached the consumer is re-raised here
        (after the threads are down) rather than silently dropped, and a
        thread that outlives the join timeout is reported.

        ``raise_pending=False`` downgrades that re-raise to a warning —
        for callers tearing the pipeline down because they are about to
        *abandon this stream position anyway* (the divergence-rollback
        path rebuilds the pipeline at the restored cursor), where an
        in-flight producer error from the doomed lookahead must not mask
        the recovery in progress."""
        self._stop_event.set()
        while True:  # drain so the producer unblocks
            try:
                self._buffer.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=5.0)
            if t.is_alive():
                log.warning(
                    "pipeline thread %s still alive after 5s join timeout",
                    t.name,
                )
        if self._error is None and hasattr(self, "_results_q"):
            # A pooled failure may still be in flight — produced by a
            # worker but not yet walked past by reassembly when stop cut
            # it short.  Sweep the results queue and the hold-back set
            # (threads are joined; no writers remain) and surface the
            # earliest-index failure, matching the serial path where the
            # error is stored the moment it is raised.
            while True:
                try:
                    idx, payload, state = self._results_q.get_nowait()
                except queue.Empty:
                    break
                self._pending[idx] = (payload, state)
            failures = [
                (idx, payload)
                for idx, (payload, _) in self._pending.items()
                if isinstance(payload, _Failure)
            ]
            if failures:
                self._error = min(failures, key=lambda f: f[0])[1].error
        if self._error is not None and not self._error_raised:
            self._error_raised = True
            if not raise_pending:
                log.warning(
                    "host pipeline stopped with pending producer error "
                    "(suppressed by caller): %r",
                    self._error,
                )
                return
            log.error(
                "host pipeline stopped with pending producer error: %r",
                self._error,
            )
            raise self._error



# How long DevicePrefetcher.stop waits for its fill thread, which may be
# in a pull that ends only when the upstream delivers one more batch.
_FILL_JOIN_TIMEOUT_S = 60.0


class _Slot:
    __slots__ = ("buffers", "event")

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None


class _PinnedRing:
    """Page-locked staging buffers for the host-to-device copies, used in
    turn.  A slot is refilled only after the copy that last read it has
    completed (its event), so a copy in flight never reads a buffer being
    overwritten.  A buffer is reallocated when a batch's shape or dtype
    changes (a ragged final batch)."""

    def __init__(self, slots: int):
        self._slots = [_Slot() for _ in range(slots)]
        self._next = 0

    @property
    def nbytes(self) -> int:
        # list() snapshots each dict: the fill thread may add a buffer.
        return sum(buf.nbytes for slot in self._slots
                   for buf in list(slot.buffers.values()))

    def stage(self, batch: dict) -> tuple[dict[str, torch.Tensor], _Slot]:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()
        staged = {}
        for key, value in batch.items():
            value = np.asarray(value)
            dtype = torch.from_numpy(np.empty(0, value.dtype)).dtype
            buf = slot.buffers.get(key)
            if buf is None or buf.shape != value.shape or buf.dtype != dtype:
                buf = torch.empty(value.shape, dtype=dtype, pin_memory=True)
                slot.buffers[key] = buf
            np.copyto(buf.numpy(), value, casting="no")
            staged[key] = buf
        return staged, slot


class DevicePrefetcher:
    """Keep ``depth`` batches ahead on ``device``.

    A fill thread pulls each host batch (a dict of numpy arrays) from the
    upstream iterator and puts it on the device, so neither the pull nor
    the copy runs on the thread that dispatches the step.  On CUDA it
    copies the batch into a page-locked staging slot (a ring of
    ``depth + 1``; a slot is reused only once its last copy has
    completed) and from there to the device on a dedicated
    ``torch.cuda.Stream``, recording an event.  :meth:`__next__` makes the
    caller's current stream wait on that event and records the batch's
    tensors on it (``record_stream``), so the caching allocator does not
    hand a batch's memory to a later copy while the step still reads it.
    On the CPU (which the caller must ask for) batches pass through as
    tensors sharing the numpy arrays' memory.  ``depth`` batches wait in
    the buffer; one more may be in its copy.

    Each buffered batch carries the producer state captured when it was
    pulled, and :meth:`get_state` returns the state of the last batch
    *handed to the consumer* — so a checkpoint taken mid-training resumes
    at exactly the next unconsumed batch, never skipping the batches
    sitting in this buffer.  An upstream error is deferred until the
    buffered good batches have drained, then raised at the pull that needs
    the failed position; ``KeyboardInterrupt`` and ``SystemExit`` are
    raised at the next pull, ahead of any buffered batch.

    Call :meth:`stop` before stopping the upstream: the fill thread may be
    blocked in a pull that only the upstream can answer.
    """

    def __init__(self, iterator, device, *, depth: int = 2,
                 registry: Optional[telemetry.MetricsRegistry] = None):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DevicePrefetcher on a CUDA device, but no CUDA device "
                    "is available")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        elif device.type != "cpu":
            raise ValueError(f"DevicePrefetcher runs on cuda or cpu, not "
                             f"{device}")
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self._device = device
        self._it = iter(iterator)
        self._source = iterator
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._state: Optional[dict] = (
            iterator.get_state() if hasattr(iterator, "get_state") else None
        )
        self._buffer: queue.Queue = queue.Queue(maxsize=depth)
        self._stop_event = threading.Event()
        # KeyboardInterrupt/SystemExit from the upstream: raised at the
        # next pull, never deferred behind buffered batches.
        self._abort: Optional[BaseException] = None
        self._ended = False
        if device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device)
            self._pinned: Optional[_PinnedRing] = _PinnedRing(depth + 1)
        else:
            self._copy_stream = None
            self._pinned = None
        self._thread = threading.Thread(
            target=self._fill, name="device-prefetch", daemon=True
        )
        self._thread.start()

    @property
    def pinned_bytes(self) -> int:
        """Bytes of page-locked staging memory held (0 on the CPU)."""
        return self._pinned.nbytes if self._pinned is not None else 0

    def _put_stop_aware(self, item) -> bool:
        while not self._stop_event.is_set():
            try:
                self._buffer.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch: dict):
        if self._pinned is None:
            return {k: torch.from_numpy(np.asarray(v))
                    for k, v in batch.items()}, None
        staged, slot = self._pinned.stage(batch)
        with torch.cuda.stream(self._copy_stream):
            out = {k: buf.to(self._device, non_blocking=True)
                   for k, buf in staged.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        slot.event = event
        return out, event

    def _fill(self) -> None:
        reg = self._registry
        end: Any = _STOP
        try:
            if self._copy_stream is not None:
                torch.cuda.set_device(self._device)
            while not self._stop_event.is_set():
                # Fill stall: time blocked on the upstream (host) stream.
                # A fat p95 here is the data-stall smoking gun — the host
                # pipeline cannot keep the prefetch buffer full.
                t0 = time.perf_counter()
                try:
                    batch = next(self._it)
                except StopIteration:
                    return
                dt = time.perf_counter() - t0
                reg.timer(telemetry.PREFETCH_FILL).record(dt)
                _trace_stall(reg, telemetry.PREFETCH_FILL, dt, t0)
                if self._stop_event.is_set():
                    return
                state = (
                    self._source.get_state()
                    if hasattr(self._source, "get_state")
                    else None
                )
                if not self._put_stop_aware((self._to_device(batch), state)):
                    return
                reg.gauge(telemetry.PREFETCH_DEPTH).set(self._buffer.qsize())
        except (KeyboardInterrupt, SystemExit) as e:
            # Hard aborts (second ctrl-C, watchdog escalation) must act
            # NOW — deferring one would train through buffered batches
            # first, or drop it entirely if the run ends.
            self._abort = e
        except BaseException as e:  # surfaces after the buffer drains
            # Loud at deferral time: if the run ends before draining to
            # the failed position, this line is the error's only trace.
            log.error(
                "upstream pipeline error deferred until buffered "
                "batches drain: %r", e,
            )
            end = _Failure(e)
        finally:
            # One terminal item, after every good batch; it also wakes a
            # consumer blocked on the empty buffer after an abort.
            self._put_stop_aware(end)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._ended:
            raise StopIteration
        item = None
        if self._abort is None:
            item = self._buffer.get()
            self._registry.gauge(telemetry.PREFETCH_DEPTH).set(
                self._buffer.qsize()
            )
        if self._abort is not None:
            self._ended = True
            raise self._abort
        if isinstance(item, _Stop):
            self._ended = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._ended = True
            raise item.error
        (batch, event), state = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for tensor in batch.values():
                tensor.record_stream(stream)
        self._state = state
        return batch

    def get_state(self) -> Optional[dict]:
        """Producer state as of the last batch the consumer received."""
        return self._state

    def stop(self) -> None:
        """Stop the fill thread and join it.  It exits at its next pull or
        put; a pull blocked on a live upstream ends when the upstream
        delivers its next batch (hence the long join timeout: one batch's
        assembly), so stop the upstream after this, not before."""
        self._stop_event.set()
        while True:  # drain so a blocked put returns
            try:
                self._buffer.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=_FILL_JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            log.warning(
                "device prefetch thread still alive after %.0f s join "
                "timeout", _FILL_JOIN_TIMEOUT_S,
            )
