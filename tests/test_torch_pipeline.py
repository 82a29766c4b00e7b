"""The port's input pipeline against the JAX package's, and under ``fit``.

- ``HostPipeline``: the batch stream and the state after each batch equal
  the JAX pipeline's, byte for byte, with 1 and 3 workers, over plain
  arrays, a per-sample transform (CIFAR), process shards, PTB, decoded
  ImageNet records and a ``set_state`` resume; an error surfaces at the
  position it occurred, after the good batches before it; ``stop``
  re-raises an error the consumer never reached and leaves no thread; a
  stalled consumer holds the worker pool back.
- ``DevicePrefetcher`` on the CPU: ``get_state`` after batch k, the
  deferred upstream error and exhaustion equal the JAX prefetcher's (on
  the test mesh); an abort is raised ahead of buffered batches; a CUDA
  prefetcher raises where there is no card.
- ``fit``: its losses through the pipeline equal, bit for bit, a serial
  loop's over the same dataset, at 1 and 3 workers, and it stops both
  stages however the loop ends.

The CUDA copy path (pinned staging, the copy stream, ``wait_event`` and
``record_stream``) is held on the card in ``tests/test_torch_gpu.py``.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.data import datasets as jdata
from distributed_tensorflow_models_tpu.data import pipeline as jpipe
from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.data import augment as taug
from distributed_tensorflow_models_tpu_torch.data import datasets as tdata
from distributed_tensorflow_models_tpu_torch.data import example_proto
from distributed_tensorflow_models_tpu_torch.data import pipeline as tpipe
from distributed_tensorflow_models_tpu_torch.data import tfrecord
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

PIPELINE_THREADS = ("host-pipeline", "data-worker", "device-prefetch")


@pytest.fixture
def pipeline_threads():
    """A function listing the pipeline threads started during the test
    that are still alive (threads of earlier tests in the process are
    left out)."""
    before = set(threading.enumerate())

    def alive():
        return [t for t in threading.enumerate()
                if t not in before and t.name.startswith(PIPELINE_THREADS)
                and t.is_alive()]
    return alive


def _assert_batches_equal(got, want, msg=""):
    assert sorted(got) == sorted(want), msg
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{msg} {k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} {k}")


def _records(tmp_path, n_shards=2, per_shard=6):
    rs = np.random.RandomState(0)
    paths = []
    for s in range(n_shards):
        recs = [example_proto.build_example({
            "image/encoded": [taug.encode_jpeg(
                (rs.rand(30, 40, 3) * 255).astype(np.uint8))],
            "image/class/label": [1 + i]}) for i in range(per_shard)]
        p = str(tmp_path / f"train-{s:05d}")
        tfrecord.write_records(p, recs)
        paths.append(p)
    return paths


def _resumed(mod):
    ds = mod.synthetic_imagenet_dataset(8, 8, 1)
    ds.set_state({"epoch": 3, "batch_idx": 30})
    return ds


DATASETS = {
    "arrays": lambda mod, _: mod.synthetic_imagenet_dataset(8, 8, 2),
    "cifar_transform": lambda mod, _: mod.cifar10_dataset(8, "train", 3),
    "process_shard": lambda mod, _: mod.cifar10_dataset(
        8, "train", 3, process_index=1, process_count=2),
    "ptb": lambda mod, _: mod.ptb_dataset(4, 16, "train", 300),
    "imagenet_records": lambda mod, paths: mod.ImageNetTFRecordDataset(
        paths, 4, image_size=16, seed=1, label_offset=1, native=False),
    "resumed": lambda mod, _: _resumed(mod),
}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_host_pipeline_stream_equals_jax(tmp_path, name, workers,
                                         pipeline_threads):
    """Each stack pulls 7 batches; the JAX one runs one producer thread,
    the port's ``workers`` (the stream is the same for any count)."""
    build = DATASETS[name]
    paths = _records(tmp_path) if name == "imagenet_records" else None
    tp = tpipe.HostPipeline(build(tdata, paths), prefetch=2,
                            num_workers=workers,
                            registry=telemetry.MetricsRegistry())
    jp = jpipe.HostPipeline(build(jdata, paths), prefetch=2)
    try:
        assert tp.get_state() == jp.get_state()
        for i in range(7):
            _assert_batches_equal(next(tp), next(jp), f"batch {i}")
            assert tp.get_state() == jp.get_state(), i
    finally:
        tp.stop()
        jp.stop()
    assert not pipeline_threads()


class _Exploding:
    """Batch i is ``{"x": [i, i]}``; assembling batch ``boom_at`` (or,
    with ``in_cursor``, advancing the cursor to it) raises."""

    def __init__(self, boom_at, in_cursor=False, n=None):
        self._i, self._boom, self._in_cursor, self._n = 0, boom_at, in_cursor, n

    def next_work(self):
        if self._n is not None and self._i >= self._n:
            raise StopIteration
        if self._in_cursor and self._i == self._boom:
            raise RuntimeError(f"cursor boom at {self._i}")
        self._i += 1
        return self._i - 1

    def assemble(self, i):
        if not self._in_cursor and i == self._boom:
            raise RuntimeError(f"boom at {i}")
        return {"x": np.full((2,), i, np.float32)}

    def get_state(self):
        return {"i": self._i}

    def __iter__(self):
        return tdata.iterate_via_work(self)


@pytest.mark.parametrize("in_cursor", [False, True], ids=["assemble",
                                                          "cursor"])
@pytest.mark.parametrize("workers", [1, 3])
def test_host_pipeline_error_surfaces_at_its_position_like_jax(
        workers, in_cursor, pipeline_threads):
    got = {}
    for name, mod in (("port", tpipe), ("jax", jpipe)):
        pipe = mod.HostPipeline(_Exploding(3, in_cursor), prefetch=4,
                                num_workers=workers)
        seen, states = [], []
        with pytest.raises(RuntimeError, match="boom at 3") as err:
            for _ in range(10):
                seen.append(float(next(pipe)["x"][0]))
                states.append(pipe.get_state())
        pipe.stop()  # the error was raised: stop does not raise it again
        got[name] = (seen, states, str(err.value))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [0.0, 1.0, 2.0]
    assert not pipeline_threads()


@pytest.mark.parametrize("workers", [1, 2])
def test_host_pipeline_stop_raises_a_pending_error(workers,
                                                   pipeline_threads):
    pipe = tpipe.HostPipeline(_Exploding(2), prefetch=4, num_workers=workers)
    assert float(next(pipe)["x"][0]) == 0.0
    deadline = time.monotonic() + 10
    while pipe._error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="boom at 2"):
        pipe.stop()
    assert not pipeline_threads()


@pytest.mark.parametrize("workers", [1, 3])
def test_host_pipeline_stop_joins_every_thread_and_ends_finite(
        workers, pipeline_threads):
    reg = telemetry.MetricsRegistry()
    pipe = tpipe.HostPipeline(_Exploding(-1, n=5), prefetch=2,
                              num_workers=workers, registry=reg)
    assert [float(b["x"][0]) for b in pipe] == [0.0, 1.0, 2.0, 3.0, 4.0]
    pipe.stop()
    assert not pipeline_threads()
    snap = reg.snapshot()
    assert snap[telemetry.HOST_QUEUE_DEPTH] == 0.0
    assert snap[f"{telemetry.PRODUCER_WAIT}/count"] == 5
    if workers > 1:
        assert f"{telemetry.WORKER_BUSY}/{workers - 1}" in snap
        assert snap[f"{telemetry.REASSEMBLY_WAIT}/count"] >= 5
    # A stopped pipeline that never started consuming also joins.
    idle = tpipe.HostPipeline(_Exploding(-1), prefetch=1, num_workers=workers)
    idle.stop()
    assert not pipeline_threads()


@pytest.mark.parametrize("workers,prefetch", [(3, 2), (4, 4)])
def test_host_pipeline_pool_holds_back_while_the_consumer_stalls(
        workers, prefetch, pipeline_threads):
    """With the consumer stalled, the pool keeps at most workers +
    prefetch batches between dispatch and release (the dataset's cursor
    stops there too), beside the prefetch buffer; the stream that follows
    is unchanged.  The JAX package's pool bounds only its dispatch queue,
    so there the results queue grows for as long as the consumer stalls."""
    dataset = _Exploding(-1, n=200)
    pipe = tpipe.HostPipeline(dataset, prefetch=prefetch,
                              num_workers=workers)
    time.sleep(0.5)
    in_flight = (pipe._results_q.qsize() + len(pipe._pending)
                 + pipe._work_q.qsize())
    assert in_flight <= workers + prefetch
    assert dataset.get_state()["i"] <= 2 * (workers + prefetch) + 1
    assert [float(b["x"][0]) for b in pipe] == [float(i) for i in range(200)]
    pipe.stop()
    assert not pipeline_threads()


class _Upstream:
    """``n`` batches ``{"x": [i]*8}``, then an error (``boom``) or the end;
    its state after batch i is ``{"i": i + 1}``."""

    def __init__(self, n, boom=None):
        self._i, self._n, self._boom = 0, n, boom

    def __iter__(self):
        return self

    def __next__(self):
        if self._i == self._n:
            if self._boom is not None:
                raise self._boom
            raise StopIteration
        self._i += 1
        return {"x": np.full((8,), self._i - 1, np.float32),
                "y": np.arange(8, dtype=np.int32) + self._i}

    def get_state(self):
        return {"i": self._i}


def _drain(prefetcher):
    seen = []
    try:
        while True:
            batch = next(prefetcher)
            seen.append((np.asarray(batch["x"]).tolist(),
                         np.asarray(batch["y"]).tolist(),
                         prefetcher.get_state()))
    except StopIteration:
        return seen, None
    except RuntimeError as e:
        return seen, str(e)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("boom", [None, "upstream exploded"],
                         ids=["exhausted", "error"])
def test_cpu_prefetcher_state_error_and_end_equal_jax(mesh8, depth, boom,
                                                      pipeline_threads):
    """Batch for batch, the state after each, then the deferred error (or
    the end) at the same position as the JAX prefetcher; a second pull
    after either ends the stream."""
    err = (lambda: RuntimeError(boom)) if boom else (lambda: None)
    port = tpipe.DevicePrefetcher(_Upstream(5, err()), "cpu", depth=depth,
                                  registry=telemetry.MetricsRegistry())
    ref = jpipe.DevicePrefetcher(_Upstream(5, err()), mesh8, depth=depth)
    assert port.get_state() == ref.get_state() == {"i": 0}
    got, want = _drain(port), _drain(ref)
    assert got == want
    assert len(got[0]) == 5 and got[0][-1][2] == {"i": 5}
    assert got[1] == boom
    for pf in (port, ref):
        with pytest.raises(StopIteration):
            next(pf)
    port.stop()
    assert not pipeline_threads()


def test_cpu_prefetcher_over_host_pipeline_resumes_exactly(pipeline_threads):
    """The state after batch k, read through both stages, resumes a fresh
    stack at batch k + 1, although more batches sat in the buffers."""
    def stack(ds):
        host = tpipe.HostPipeline(ds, prefetch=4, num_workers=3)
        return host, tpipe.DevicePrefetcher(host, "cpu", depth=2)

    host, pf = stack(tdata.cifar10_dataset(8, "train", 3))
    first = [next(pf) for _ in range(4)]
    state = pf.get_state()
    assert state == {"epoch": 0, "batch_idx": 4}
    pf.stop()
    host.stop()
    ds = tdata.cifar10_dataset(8, "train", 3)
    ds.set_state(state)
    host, pf = stack(ds)
    resumed = next(pf)
    pf.stop()
    host.stop()
    ref = list(itertools.islice(iter(tdata.cifar10_dataset(8, "train", 3)),
                                5))
    for got, want in zip(first + [resumed], ref):
        assert isinstance(got["image"], torch.Tensor)
        _assert_batches_equal({k: v.numpy() for k, v in got.items()}, want)
    assert not pipeline_threads()


@pytest.mark.parametrize("abort", [KeyboardInterrupt, SystemExit])
def test_cpu_prefetcher_raises_an_abort_ahead_of_buffered_batches(
        abort, pipeline_threads):
    pf = tpipe.DevicePrefetcher(_Upstream(2, abort()), "cpu", depth=2)
    deadline = time.monotonic() + 10
    while pf._abort is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._buffer.qsize() == 2  # both good batches wait in the buffer
    with pytest.raises(abort):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    assert pf.get_state() == {"i": 0}
    pf.stop()
    assert not pipeline_threads()


def test_cpu_prefetcher_records_its_telemetry():
    reg = telemetry.MetricsRegistry()
    pf = tpipe.DevicePrefetcher(_Upstream(4), "cpu", depth=2, registry=reg)
    assert len(_drain(pf)[0]) == 4
    pf.stop()
    snap = reg.snapshot()
    assert snap[f"{telemetry.PREFETCH_FILL}/count"] == 4
    assert snap[telemetry.PREFETCH_DEPTH] == 0.0
    assert pf.pinned_bytes == 0


def test_prefetcher_refuses_a_missing_card_and_other_devices(
        monkeypatch, pipeline_threads):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.DevicePrefetcher(_Upstream(1), "cuda")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpipe.DevicePrefetcher(_Upstream(1), "meta")
    with pytest.raises(ValueError, match="depth"):
        tpipe.DevicePrefetcher(_Upstream(1), "cpu", depth=0)
    assert not pipeline_threads()


def _serial_losses(cfg):
    """The loop ``fit`` ran before the pipeline: one batch at a time from
    the dataset's own iterator, in series with the steps."""
    dev = torch.device("cpu")
    state = trainlib.build_state(cfg, dev)
    step_fn = trainlib.build_step(cfg, state)
    losses = []
    for batch in itertools.islice(iter(trainlib.build_dataset(cfg)),
                                  cfg.train_steps):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, metrics = step_fn(state, batch, cfg.seed)
        losses.append(float(metrics["loss"]))
    return losses


FIT_CASES = {
    "resnet": ("resnet50_synthetic_tiny", {}),
    "resnet_cifar_transform": ("resnet50_synthetic_tiny",
                               {"dataset": "cifar10"}),
    "lm": ("transformer_lm_tiny", {}),
}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_losses_equal_a_serial_loop(case, workers, pipeline_threads):
    name, over = FIT_CASES[case]
    cfg = tconfig.get_config(name, train_steps=3, data_workers=workers,
                             **over)
    result = trainlib.fit(cfg, device="cpu")
    assert [row["loss"] for row in result.history] == _serial_losses(cfg)
    for row in result.history:
        assert row["data_s"] >= 0 and row["step_time_s"] > 0
    assert not pipeline_threads()


def test_fit_stops_the_pipeline_when_a_step_raises(monkeypatch,
                                                   pipeline_threads):
    cfg = tconfig.get_config("resnet50_synthetic_tiny", train_steps=4,
                             data_workers=3)
    real = trainlib.build_step

    def failing_step(cfg, state):
        step = real(cfg, state)

        def run(state, batch, seed):
            if state.step == 2:
                raise RuntimeError("step failed")
            return step(state, batch, seed)
        return run

    monkeypatch.setattr(trainlib, "build_step", failing_step)
    with pytest.raises(RuntimeError, match="step failed"):
        trainlib.fit(cfg, device="cpu")
    assert not pipeline_threads()


def test_cli_data_workers_reach_fit(tmp_path, capsys, monkeypatch):
    seen = []
    real = trainlib.fit

    def spy(cfg, *a, **kw):
        seen.append(cfg.data_workers)
        return real(cfg, *a, **kw)

    monkeypatch.setattr(trainlib, "fit", spy)
    assert cli.main(["train", "--config", "resnet50_synthetic_tiny",
                     "--workdir", str(tmp_path), "--train-steps", "2",
                     "--data-workers", "3", "--device", "cpu"]) == 0
    assert seen == [3]
    assert tconfig.get_config("resnet50_synthetic").data_workers == 1
