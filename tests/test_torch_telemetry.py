"""A run's telemetry in the port, on the CPU, against the JAX package.

- ``harness/summary.py``: the event bytes and a whole event file equal the
  JAX writer's for the same scalars, step and wall time (exact).
- ``telemetry/goodput.py``: the report of the same registry sequence
  equals the JAX report (exact), over-attribution clamping and the device
  count's scaling of the MFU included; ``peak_flops`` maps the H100's name
  and ``DTM_PEAK_FLOPS``.
- ``TelemetryHook`` fed the same registry sequence on the same clock
  injects the same keys and values as the JAX hook, at its cadence only,
  and the per-process aggregation (the JAX package's
  ``tests/test_telemetry.py`` hook tests, side by side).
- A cut LeNet ``fit`` (8 steps, ``log_every_steps`` 4) leaves
  ``telemetry.json`` (fractions summing to 1), ``metrics.jsonl`` rows at
  steps 4 and 8 with the telemetry keys, TensorBoard events whose records
  and checksums read back, and, after a ``FaultInjectionHook`` crash, a
  flight record and ``telemetry.json``.  All pass the repo's schema lint
  ``scripts/check_metrics_schema.py`` unedited.
- The step's FLOPs (``train_loop.step_flops``): the same on every CPU conv
  route, and within 15 % of the JAX step's XLA ``cost_analysis()`` on
  LeNet at batch 32 and ResNet-32 at batch 16.  The port counts every tap
  of a SAME-padded convolution (as ``F.conv2d`` computes it); XLA counts
  only the taps inside the input (held on LeNet's first conv), and adds
  elementwise work: the port counts 1.129x on LeNet and 1.083x on
  ResNet-32.
"""

import json
import os
import struct
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu import telemetry as jtelemetry
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import hooks as jhooks
from distributed_tensorflow_models_tpu.harness import summary as jsummary
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.data import tfrecord
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
from distributed_tensorflow_models_tpu_torch.harness import summary
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
from distributed_tensorflow_models_tpu_torch.resilience import consensus

jax.config.update("jax_platforms", "cpu")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCHEMA_LINT = os.path.join(REPO, "scripts", "check_metrics_schema.py")
REGISTRY_PY = os.path.join(REPO, "distributed_tensorflow_models_tpu_torch",
                           "telemetry", "registry.py")
# Declared keys this CPU run does not emit, each for a reason of the run,
# not of the code: chaos (fault injection) and the fleet gauges
# (heartbeats, a supervisor) are not ported; serve/ is the serving stack's
# (not ported); a fresh run restores nothing (checkpoint/restore); one
# input worker has no pool (pipeline/reassembly_wait, worker_busy); no
# watchdog is configured (train/watchdog_last_progress_s).
ALLOW_MISSING = ("chaos/", "fleet/", "serve/", "checkpoint/restore",
                 "pipeline/reassembly_wait", "pipeline/worker_busy",
                 "train/watchdog_last_progress_s")
H100 = "NVIDIA H100 80GB HBM3"


def _lint(*args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, SCHEMA_LINT, *map(str, args)],
                          capture_output=True, text=True)


# --------------------------------------------------------------------------
# The event writer
# --------------------------------------------------------------------------

SCALARS = {"loss": 2.25, "mfu": 0.03125, "big": 1e39, "neg": -1e39,
           "steps_per_sec": 7.0}


def test_encode_event_bytes_equal_the_jax_writer():
    for kw in (dict(file_version="brain.Event:2"),
               dict(scalars={"loss": 2.25, "lr": 0.1}),
               dict(scalars={"x/y": -3.5}, file_version="v")):
        for step in (None, 0, 7, 2**40):
            assert summary.encode_event(1792.5, step, **kw) == (
                jsummary.encode_event(1792.5, step, **kw))


def test_event_file_bytes_equal_the_jax_writer(tmp_path, monkeypatch):
    """Both writers on one frozen clock: the same records, checksums and
    clamps of out-of-f32 values, byte for byte; the port's reads back."""
    monkeypatch.setattr(time, "time", lambda: 1792287583.25)
    paths = []
    for mod, name in ((summary, "port"), (jsummary, "jax")):
        with mod.SummaryWriter(tmp_path / name) as w:
            w.scalars(4, SCALARS)
            w.scalar("only", 1.5, 8)
            w.scalars(9, {"text": "not a number"})
            paths.append(w.path)
    port, jax_ = (open(p, "rb").read() for p in paths)
    assert port == jax_
    records = list(tfrecord.read_records(paths[0]))
    assert len(records) == 3  # version record + two scalar events
    assert records[1] == jsummary.encode_event(
        1792287583.25, 4, scalars={**SCALARS, "big": float("inf"),
                                   "neg": float("-inf")})


# --------------------------------------------------------------------------
# The goodput report
# --------------------------------------------------------------------------


def _fill(reg, mod, data_wait=0.2, compile_s=0.3, flops=0.0):
    reg.timer(mod.DATA_WAIT).record(data_wait)
    reg.timer(mod.CKPT_SAVE).record(0.05)
    reg.timer(mod.CKPT_WAIT).record(0.05)
    reg.timer(mod.CKPT_FENCE).record(0.01)
    reg.timer(mod.COMPILE).record(compile_s)
    reg.gauge(mod.STARTUP_RESTORE).set(0.5)
    reg.gauge(mod.STARTUP_FIRST_STEP).set(2.5)
    if flops:
        reg.gauge(mod.FLOPS_PER_STEP).set(flops / 10)
        reg.counter(mod.FLOPS_TOTAL).inc(flops)
    return reg


@pytest.mark.parametrize("case", ["split", "clamped", "mfu_1", "mfu_4",
                                  "gauge_fallback"])
def test_goodput_report_equals_the_jax_report(case, monkeypatch):
    """The same registry sequence through both packages' registries and
    reports, every field of the payload equal (the snapshot's timer
    statistics included).  ``clamped``: attributed time above the total
    raises the total; ``mfu_*``: one device-second of peak work over 1
    and 4 devices; ``gauge_fallback``: FLOPs per step x steps without the
    retired counter."""
    monkeypatch.setenv("DTM_PEAK_FLOPS", "2e12")
    kw = dict(total_s=1.0, steps=10, kind="cpu", n_devices=1)
    fill = {}
    if case == "clamped":
        fill = dict(data_wait=2.0)
    elif case.startswith("mfu"):
        fill = dict(flops=2e12)
        kw["n_devices"] = int(case[-1])
    reports = []
    for mod in (telemetry, jtelemetry):
        reg = _fill(mod.MetricsRegistry(), mod, **fill)
        if case == "gauge_fallback":
            reg.gauge(mod.FLOPS_PER_STEP).set(1e11)
        reports.append(mod.goodput_report(reg, **kw))
    port, ref = reports
    assert port == ref
    assert sum(port["fractions"].values()) == pytest.approx(1.0)
    assert min(port["fractions"].values()) >= 0.0
    if case == "clamped":
        assert port["fractions"]["compute"] == 0.0
        assert port["total_s"] > 1.0
    if case.startswith("mfu"):
        assert port["mfu"] == pytest.approx(1.0 / kw["n_devices"])
    if case == "gauge_fallback":
        assert port["flops_total"] == 1e12 and port["mfu"] == 0.5


def test_report_of_a_cpu_has_no_peak(tmp_path, monkeypatch):
    monkeypatch.delenv("DTM_PEAK_FLOPS", raising=False)
    rep = telemetry.goodput_report(
        _fill(telemetry.MetricsRegistry(), telemetry, flops=1e12),
        total_s=1.0, steps=10, kind="cpu", n_devices=1)
    assert rep["peak_bf16_flops"] is None and rep["mfu"] == 0.0
    path = str(tmp_path / "telemetry.json")
    telemetry.write_report(path, rep)
    assert json.load(open(path))["fractions"] == rep["fractions"]


def test_peak_flops_maps_the_h100(monkeypatch):
    monkeypatch.delenv("DTM_PEAK_FLOPS", raising=False)
    assert telemetry.peak_flops(H100) == 989.4e12
    for unknown in ("NVIDIA A100-SXM4-80GB", "cpu", "TPU v5e", "", None):
        assert telemetry.peak_flops(unknown) is None
    monkeypatch.setenv("DTM_PEAK_FLOPS", "1e12")
    assert telemetry.peak_flops("anything") == 1e12
    assert telemetry.peak_flops(None) == 1e12


def test_device_kind_and_count_without_a_card_or_group():
    assert telemetry.device_kind("cpu") is None
    assert telemetry.device_count() == 1


# --------------------------------------------------------------------------
# TelemetryHook against the JAX hook
# --------------------------------------------------------------------------


class _State:
    step = 0


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _hook_pair(monkeypatch, every, nproc=None, peak=None):
    """The JAX hook and the port's over their own registries, on one fake
    clock (both read ``time.perf_counter``)."""
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    if peak:
        monkeypatch.setenv("DTM_PEAK_FLOPS", str(peak))
    else:
        monkeypatch.delenv("DTM_PEAK_FLOPS", raising=False)
    jreg, treg = jtelemetry.MetricsRegistry(), telemetry.MetricsRegistry()
    jkw, tkw = {}, dict(device="cpu", n_devices=len(jax.devices()))
    if nproc:
        jkw["process_count"] = nproc
        tkw["consensus"] = consensus.Consensus(0, nproc,
                                               backend=_TimesThree())
    jh = jhooks.TelemetryHook(jreg, every_steps=every, **jkw)
    th = hooklib.TelemetryHook(treg, every_steps=every, **tkw)
    for h in (jh, th):
        h.begin(_State())
    return clock, (jreg, jh), (treg, th)


def _feed(pair, mod, i):
    reg = pair[0]
    reg.timer(mod.STEP_TIME).record(0.02 * (i + 1))
    reg.timer(mod.DATA_WAIT).record(0.01 * (i + 1))
    reg.timer(mod.DISPATCH).record(0.001)
    reg.counter(mod.FLOPS_TOTAL).inc(3e11 * (i + 1))
    reg.gauge(mod.HOST_QUEUE_DEPTH).set(i)


@pytest.mark.parametrize("every,peak", [(2, None), (1, 5e12), (3, 1e13)])
def test_telemetry_hook_injects_what_the_jax_hook_does(monkeypatch, every,
                                                       peak):
    """Six steps: off cadence nothing is injected; at cadence both hooks
    inject the same keys and values (interval means and deltas, the MFU
    against the same whole-world peak)."""
    clock, jax_side, port_side = _hook_pair(monkeypatch, every, peak=peak)
    for i in range(6):
        step = i + 1
        clock.t += 0.25 * (i + 1)
        rows = []
        for (reg, h), mod in ((jax_side, jtelemetry), (port_side, telemetry)):
            _feed((reg, h), mod, i)
            metrics = {"loss": 1.0}
            h.after_step(_State(), metrics, step)
            rows.append(metrics)
        assert rows[1] == pytest.approx(rows[0], rel=1e-12)
        assert set(rows[1]) == set(rows[0])
        if step % every:
            assert rows[1] == {"loss": 1.0}
        else:
            assert "data_wait_s" in rows[1] and "mfu" in rows[1]
            if peak:
                assert rows[1]["mfu"] > 0


class _TimesThree:
    """A two-process gather whose other process runs 3x this one."""

    def allgather_floats(self, values):
        return [list(values), [3.0 * v for v in values]]


def test_telemetry_hook_aggregates_processes_as_the_jax_hook(monkeypatch):
    from jax.experimental import multihost_utils

    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda arr: np.stack([arr, arr * 3.0]))
    clock, (jreg, jh), (treg, th) = _hook_pair(monkeypatch, 1, nproc=2)
    clock.t += 0.5
    out = []
    for reg, h, mod in ((jreg, jh, jtelemetry), (treg, th, telemetry)):
        reg.timer(mod.DATA_WAIT).record(0.001)
        metrics = {}
        h.after_step(_State(), metrics, 1)
        out.append(metrics)
    assert out[1] == pytest.approx(out[0], rel=1e-6)  # f32 in JAX's gather
    assert out[1]["hosts/steps_per_sec_mean"] == pytest.approx(
        2.0 * out[1]["hosts/steps_per_sec_min"])
    assert out[1]["hosts/stall_fraction_max"] == pytest.approx(
        3.0 * out[1]["stall_fraction"])


def test_telemetry_hook_writes_into_a_lazy_row():
    """In the chunked loop the hook's keys land in the row's overlay,
    where the writer hooks after it read them."""
    reg = telemetry.MetricsRegistry()
    h = hooklib.TelemetryHook(reg, every_steps=2, device="cpu")
    h.begin(_State())
    reg.timer(telemetry.STEP_TIME).record(0.5)
    row = hooklib.LazyMetricRow({"loss": torch.tensor([3.0, 2.0])}, 1, 1)
    h.after_step(_State(), row, 2)
    assert row["step_time_s"] == 0.5 and float(row["loss"]) == 2.0
    assert "mfu" in set(row)


# --------------------------------------------------------------------------
# A run's artifacts
# --------------------------------------------------------------------------

RUN = dict(train_steps=8, global_batch_size=8, log_every_steps=4,
           steps_per_loop=4, checkpoint_every_secs=10_000.0,
           trace_export=True)


def _events(path) -> list[bytes]:
    """An event file's records; ``read_records`` checks every CRC."""
    return list(tfrecord.read_records(path))


def test_fit_writes_the_runs_telemetry(tmp_path):
    cfg = tconfig.get_config("lenet_mnist", **RUN)
    result = trainlib.fit(cfg, str(tmp_path), device="cpu")
    assert result.state.step == 8

    report = json.load(open(tmp_path / "telemetry.json"))
    frac = report["fractions"]
    assert set(frac) == {"compute", "data_stall", "checkpoint", "compile"}
    assert sum(frac.values()) == pytest.approx(1.0, abs=1e-9)
    assert min(frac.values()) >= 0.0
    assert report["steps"] == 8 and report["compile_events"] == 0  # no capture
    assert report["seconds"]["checkpoint"] > 0  # the final save's wait
    assert report["device_kind"] == "cpu" and report["mfu"] == 0.0
    assert report["n_devices"] == 1
    flops = trainlib.step_flops_fn(cfg, meshlib.local_mesh("cpu"))(
        {"image": torch.empty(8, 28, 28, 1),
         "label": torch.empty(8, dtype=torch.int32)})
    assert report["flops_per_step"] == flops > 0
    assert report["flops_total"] == 8 * flops
    snap = report["metrics"]
    assert snap["train/dispatch/count"] == 2  # one record a chunk
    assert snap["trace/events"] > 0 and snap["trace/dropped"] == 0
    assert snap["startup/time_to_first_step_s"] > 0

    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [4, 8]
    for r in rows:
        for key in ("loss", "data_wait_s", "step_time_s", "dispatch_s",
                    "steps_per_sec", "stall_fraction", "mfu",
                    "compile_count", "checkpoint_s", "startup/restore_s",
                    "restarts", "rollbacks", "skipped_batches"):
            assert key in r, key
        assert r["step_time_s"] > 0

    (events,) = os.listdir(tmp_path / "tensorboard")
    records = _events(tmp_path / "tensorboard" / events)
    assert len(records) == 3  # version + steps 4 and 8
    assert b"brain.Event:2" in records[0]
    for rec, row in zip(records[1:], rows):
        assert b"loss" in rec and b"mfu" in rec and b"step_time_s" in rec
        assert struct.pack("<f", row["loss"]) in rec

    trace = json.load(open(tmp_path / "trace_p0.json"))
    names = {e["name"] for e in trace["traceEvents"]}
    for expected in ("fit/entry", "fit/end", "train/chunk",
                     "checkpoint/save"):
        assert expected in names, expected
    assert not os.path.exists(tmp_path / "flight_recorder_p0.json")

    proc = _lint(tmp_path / "metrics.jsonl", "--require-telemetry")
    assert proc.returncode == 0, proc.stderr
    allow = [a for p in ALLOW_MISSING for a in ("--allow-missing", p)]
    proc = _lint(tmp_path / "telemetry.json", "--declared-coverage",
                 REGISTRY_PY, *allow)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_a_crash_leaves_a_flight_record_and_the_report(tmp_path):
    cfg = tconfig.get_config("lenet_mnist", **RUN)
    with pytest.raises(RuntimeError, match="injected"):
        trainlib.fit(cfg, str(tmp_path), device="cpu",
                     extra_hooks=[hooklib.FaultInjectionHook(6)])
    record = json.load(open(tmp_path / "flight_recorder_p0.json"))
    assert record["reason"] == "crash" and record["step"] == 6
    names = [e["name"] for e in record["events"]]
    assert names.count("train/chunk") == 1  # steps 1-4; 5-6 raised
    assert names[-1] == "checkpoint/wait" and "fit/abort" in names
    report = json.load(open(tmp_path / "telemetry.json"))
    assert report["steps"] == 6
    assert sum(report["fractions"].values()) == pytest.approx(1.0)
    proc = _lint(tmp_path / "flight_recorder_p0.json", "--flight-recorder")
    assert proc.returncode == 0, proc.stderr


def test_tracing_off_leaves_no_trace_gauges(tmp_path):
    cfg = tconfig.get_config("lenet_mnist", **{**RUN, "train_steps": 4},
                             trace_ring_events=0)
    trainlib.fit(cfg, str(tmp_path), device="cpu")
    report = json.load(open(tmp_path / "telemetry.json"))
    assert "trace/events" not in report["metrics"]
    assert not os.path.exists(tmp_path / "trace_p0.json")


def test_profiler_hook_exports_a_chrome_trace(tmp_path):
    cfg = tconfig.get_config("lenet_mnist", **{**RUN, "train_steps": 4})
    hook = hooklib.ProfilerHook(str(tmp_path), 1, 3)
    trainlib.fit(cfg, device="cpu", extra_hooks=[hook])
    assert hook.path == str(tmp_path / "profile" / "trace_1_3.json")
    trace = json.load(open(hook.path))
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


# --------------------------------------------------------------------------
# The step's FLOPs
# --------------------------------------------------------------------------


def _image_batch(cfg, channels):
    n, s = cfg.global_batch_size, cfg.image_size
    return {"image": np.zeros((n, s, s, channels), np.float32),
            "label": np.zeros((n,), np.int32)}


def _jax_flops(name, batch_size, channels) -> float:
    """The JAX step's XLA cost analysis, as its ``InstrumentedStep``
    takes it: a trace-only lowering (here of an abstract state)."""
    jcfg = jconfig.get_config(name, global_batch_size=batch_size)
    mesh = jtrain.mesh_from_config(jcfg)
    state = jax.eval_shape(lambda: jtrain.build_state(jcfg, mesh))
    step = jtrain.build_step(jcfg, state)
    cost = step.lower(state, _image_batch(jcfg, channels),
                      jax.random.key(1)).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


@pytest.mark.parametrize("name,batch_size,channels,ratio", [
    ("lenet_mnist", 32, 1, 1.12904), ("resnet32_cifar10", 16, 3, 1.08350)])
def test_step_flops_near_the_jax_cost_analysis(name, batch_size, channels,
                                               ratio):
    cfg = tconfig.get_config(name, global_batch_size=batch_size)
    batch = {k: torch.from_numpy(v)
             for k, v in _image_batch(cfg, channels).items()}
    port = trainlib.step_flops_fn(cfg, meshlib.local_mesh("cpu"))(batch)
    jax_ = _jax_flops(name, batch_size, channels)
    assert port / jax_ == pytest.approx(ratio, abs=1e-5)
    assert abs(port / jax_ - 1) <= 0.15


def test_xla_counts_only_the_in_bounds_taps_of_a_same_conv():
    """Why the port's count exceeds XLA's: LeNet's first conv (5x5 SAME,
    28x28x1 -> 32).  ``FlopCounterMode`` counts every tap of the padded
    input, 2*28*28*25*32 = 1,254,400; XLA's cost analysis only the taps
    inside it, 2*32*134*134 = 1,149,184 (134 = 3+4+22*5+4+3 taps along
    each axis)."""
    from torch.utils.flop_counter import FlopCounterMode

    x, k = np.zeros((1, 28, 28, 1), np.float32), np.zeros((5, 5, 1, 32),
                                                          np.float32)
    cost = jax.jit(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ).lower(x, k).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    assert cost["flops"] == 2 * 32 * 134 * 134
    with FlopCounterMode(display=False) as counter:
        convlib.conv2d_xla(torch.from_numpy(x), torch.from_numpy(k))
    assert counter.get_total_flops() == 2 * 28 * 28 * 25 * 32


def test_step_flops_is_the_models_not_the_routes(monkeypatch):
    """LeNet on each CPU conv route (``DTM_CONV_IMPL``'s library, patches,
    the mxu wrapper's plain version) and with the route fixed in the
    model's kwargs: one count.  ResNet-32 at batch 2 in a data axis of 4
    counts the global batch of 8."""
    batch = {"image": torch.empty(8, 28, 28, 1),
             "label": torch.empty(8, dtype=torch.int32)}
    mesh = meshlib.local_mesh("cpu")
    counts = set()
    for impl in ("xla", "patches", "mxu"):
        monkeypatch.setattr(convlib, "_default_impl", impl)
        for kw in ({}, {"model_kwargs": {"conv_impl": impl}}):
            cfg = tconfig.get_config("lenet_mnist", global_batch_size=8,
                                     **kw)
            counts.add(trainlib.step_flops_fn(cfg, mesh)(batch))
    assert len(counts) == 1 and counts.pop() > 0

    cfg = tconfig.get_config("resnet32_cifar10", global_batch_size=8,
                             model_kwargs={"blocks_per_stage": 1})
    rows = lambda n: {"image": torch.empty(n, 32, 32, 3),  # noqa: E731
                      "label": torch.empty(n, dtype=torch.int32)}

    class _Axis4:
        data_size = 4

    assert trainlib.step_flops_fn(cfg, _Axis4())(rows(2)) == (
        trainlib.step_flops_fn(cfg, mesh)(rows(8)))
