"""The port's SLO monitor and time-series writer (``telemetry/slo.py``,
``telemetry/timeseries.py``) against the JAX package's, and the port
server's observability artifacts against the JAX package's reader.

Each scenario runs on both packages' modules with the same inputs and
clock stamps; the verdicts, margins, episode counts, percentiles and the
time-series rows (all but the wall-clock stamp) must be identical, and
each also carries the JAX suite's own assertions (``tests/
test_serving_obs.py``).  Exact throughout: these are host computations on
the same floats.  The served-traffic case runs the port's ``LMServer`` on
the CPU and reads its artifacts with ``scripts/serving_report.py`` and
``scripts/check_metrics_schema.py``.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch  # noqa: F401
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)
import torch_serving_run as runlib

from distributed_tensorflow_models_tpu.telemetry import registry as jreg
from distributed_tensorflow_models_tpu.telemetry import slo as jslo
from distributed_tensorflow_models_tpu.telemetry import timeseries as jts
from distributed_tensorflow_models_tpu_torch.serving.server import LMServer
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib
from distributed_tensorflow_models_tpu_torch.telemetry import slo as slolib
from distributed_tensorflow_models_tpu_torch.telemetry import (
    timeseries as tslib,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO_ROOT, "scripts")
SCHEMA_LINT = os.path.join(SCRIPTS, "check_metrics_schema.py")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import serving_report  # noqa: E402

PORT = (slolib, reglib, tslib)
JAX = (jslo, jreg, jts)

SPECS = [
    "serve/ttft_s:p99<0.25@30s",
    "gold=serve/tpot_s:p50<0.01@5",
    "serve/ttft_s:p99.9<1e-1@2.5s",
    "q=serve/queue_depth:p95<12@60s",
]
BAD_SPECS = [
    "serve/ttft_s",
    "serve/ttft_s:p99<0.25",
    "serve/ttft_s:p0<0.25@30s",
    "serve/ttft_s:p99<-1@30s",
    "serve/ttft_s:p99<0.25@0s",
    "a/b=serve/ttft_s:p99<0.25@30s",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_spec_equals_the_jax_parser(spec):
    got, want = slolib.parse_slo_spec(spec), jslo.parse_slo_spec(spec)
    assert (got.name, got.key, got.percentile, got.threshold,
            got.window_s) == (want.name, want.key, want.percentile,
                              want.threshold, want.window_s)


def test_parse_slo_spec_forms():
    fine = slolib.parse_slo_spec("serve/ttft_s:p99.9<1e-1@2.5s")
    assert fine.name == "ttft_s_p99_9" and fine.percentile == pytest.approx(
        0.999)
    assert slolib.parse_slo_spec(SPECS[0]).name == "ttft_s_p99"


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_slo_spec_rejects(bad):
    for lib in (slolib, jslo):
        with pytest.raises(ValueError):
            lib.parse_slo_spec(bad)


# -- rolling window --------------------------------------------------------


def _window_trace(lib):
    win = lib.RollingWindow(window_s=1e9)
    vals = [((7 * i + 3) % 101) / 10.0 for i in range(257)]
    out = []
    for i, v in enumerate(vals):
        win.observe(v, t=float(i))
        out.append([win.percentile(q, now=float(i))
                    for q in (0.5, 0.9, 0.95, 0.99)])
    return out


def test_rolling_window_equals_the_jax_window():
    got = _window_trace(slolib)
    assert got == _window_trace(jslo)
    ordered = sorted(((7 * i + 3) % 101) / 10.0 for i in range(257))
    assert got[-1][0] == ordered[min(256, int(0.5 * 257))]


def _prune_trace(lib):
    win = lib.RollingWindow(window_s=10.0, max_samples=4)
    for t in range(8):
        win.observe(float(t), t=float(t))
    return [win.percentile(0.5, now=7.0), win.percentile(0.99, now=16.5),
            win.percentile(0.5, now=100.0)]


def test_rolling_window_prunes_by_time_and_caps_samples():
    got = _prune_trace(slolib)
    assert got == _prune_trace(jslo)
    assert got[1] == 7.0 and got[2] is None


# -- monitor hysteresis ----------------------------------------------------


def _run(libs, spec, kw, script):
    """``script``: (op, args) steps on one monitor; every evaluation's
    transitions, the breached set, and the registry snapshot after each
    step."""
    slo, reg_mod, _ = libs
    reg = reg_mod.MetricsRegistry()
    mon = slo.SLOMonitor([spec], reg, **{"eval_interval_s": 0.0, **kw})
    out = [reg.snapshot()]
    for op, *args in script:
        if op == "obs":
            mon.observe(*args[:2], t=args[2])
            out.append(None)
        else:
            out.append(mon.evaluate(now=args[0], force=args[1]))
        out.append((mon.breached(), mon.margins(), reg.snapshot()))
    return out


HYSTERESIS = [("obs", "serve/ttft_s", 0.5, 0.0), ("ev", 0.0, True),
              ("ev", 0.1, True), ("ev", 0.2, True), ("ev", 20.0, True),
              ("ev", 20.1, True), ("obs", "serve/ttft_s", 0.9, 21.0),
              ("ev", 21.0, True), ("ev", 21.1, True)]
SPIKE = [("obs", "serve/ttft_s", 5.0, 0.0), ("ev", 0.0, True),
         ("ev", 0.1, True), ("ev", 11.0, True)]
WARMUP = [("obs", "serve/ttft_s", 9.0, 0.0), ("obs", "serve/ttft_s", 9.0, 1.0),
          ("obs", "serve/ttft_s", 9.0, 2.0), ("ev", 3.0, True),
          ("obs", "serve/ttft_s", 0.01, 4.0), ("ev", 4.0, True),
          ("obs", "serve/ttft_s", 2.0, 5.0), ("ev", 5.0, True)]
RATE = [("obs", "serve/unwatched", 99.0, 0.0), ("obs", "serve/ttft_s", 5.0, 0.0),
        ("ev", 0.0, False), ("obs", "serve/ttft_s", 5.0, 1.0),
        ("ev", 1.0, False), ("ev", 200.0, False)]
SCENARIOS = {
    "hysteresis": (dict(breach_after=2, recover_after=2), HYSTERESIS),
    "single_spike": (dict(breach_after=3, recover_after=3), SPIKE),
    "warmup": (dict(breach_after=1, warmup_samples=3), WARMUP),
    "rate_limit": (dict(eval_interval_s=100.0, breach_after=1), RATE),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_monitor_scenario_equals_the_jax_monitor(name):
    kw, script = SCENARIOS[name]
    got = _run(PORT, "serve/ttft_s:p99<0.1@10s", kw, script)
    assert got == _run(JAX, "serve/ttft_s:p99<0.1@10s", kw, script)


def test_breach_recovery_hysteresis_counts_episodes():
    """The JAX suite's episode count on the port: two stalls, two
    episodes; the margin negative exactly while out of SLO."""
    out = _run(PORT, "serve/ttft_s:p99<0.1@10s",
               SCENARIOS["hysteresis"][0], HYSTERESIS)
    breach = f"{reglib.SERVE_SLO_BREACH}/ttft_s_p99"
    margin = f"{reglib.SERVE_SLO_MARGIN}/ttft_s_p99"
    assert out[0][breach] == 0.0 and out[0][margin] == pytest.approx(0.1)
    transitions = [t for t in out[1::2] if t]
    assert [t[0]["event"] for t in transitions] == [
        "breach", "recovery", "breach"]
    assert out[-1][2][breach] == 2.0
    assert out[4][2][margin] == pytest.approx(-0.4)


# -- time-series writer ----------------------------------------------------


def _timeseries_rows(libs, path):
    _, reg_mod, ts = libs
    reg = reg_mod.MetricsRegistry()
    reg.counter(reg_mod.SERVE_REQUESTS)
    reg.counter(reg_mod.SERVE_COMPLETED)
    reg.timer(reg_mod.SERVE_TTFT).record(0.01)
    w = ts.TimeseriesWriter(str(path), reg, interval_s=0.5, max_rows=10)
    for i in range(25):
        reg.counter(reg_mod.SERVE_REQUESTS).inc(2)
        reg.counter(reg_mod.SERVE_COMPLETED).inc()
        w.write_row(now=float(i))
    rows = [json.loads(line) for line in open(path).read().splitlines()]
    for r in rows:
        r.pop("ts_wall")
    return rows


def test_timeseries_rows_equal_the_jax_writer(tmp_path):
    got = _timeseries_rows(PORT, tmp_path / "timeseries_p0.jsonl")
    assert got == _timeseries_rows(JAX, tmp_path / "timeseries_p1.jsonl")
    assert len(got) <= 10
    assert got[-1]["offered"] == 50.0 and got[-1]["served"] == 25.0
    proc = subprocess.run([sys.executable, SCHEMA_LINT,
                           str(tmp_path / "timeseries_p0.jsonl"),
                           "--timeseries"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_timeseries_maybe_write_rate_limits(tmp_path):
    for i, (_, reg_mod, ts) in enumerate((PORT, JAX)):
        path = str(tmp_path / f"timeseries_p{i}.jsonl")
        w = ts.TimeseriesWriter(path, reg_mod.MetricsRegistry(),
                                interval_s=10.0)
        assert [w.maybe_write(now=t) for t in (0.0, 5.0, 10.5)] == [
            True, False, True]
        assert len(open(path).read().splitlines()) == 2


# -- the port server's artifacts -------------------------------------------


def test_served_artifacts_read_by_the_jax_report(tmp_path):
    """A port ``LMServer`` with an SLO and the time-series writer: every
    request's waterfall reconciles with its TTFT in
    ``serving_report.py`` (queue + prefill == TTFT), the SLO passes, and
    the artifacts pass the schema lint."""
    srv = LMServer(
        runlib.drill_factory(), workdir=str(tmp_path), process_index=0,
        slo_specs=["ttft=serve/ttft_s:p99<30@60s"],
        timeseries_interval_s=0.01)
    srv.start()
    handles = [srv.submit([1 + i, 2, 3], 5, temperature=0.7 * (i % 2),
                          seed=i) for i in range(4)]
    for h in handles:
        assert len(h.result(timeout=120).tokens) == 5
    srv.drain()
    report = serving_report.build_report(str(tmp_path))
    assert report["attribution"]["requests"] == 4
    assert report["attribution"]["attributed"] == 4
    assert report["attribution"]["sum_bad"] == 0
    assert {r["slo"]: r["verdict"] for r in report["slo"]} == {
        "ttft": "PASS"}
    rows = [json.loads(line) for line in
            (tmp_path / "timeseries_p0.jsonl").read_text().splitlines()]
    assert rows[-1]["offered"] == rows[-1]["served"] == 4.0
    for name, flag in (("serving_stats_p0.json", "--serving-report"),
                       ("timeseries_p0.jsonl", "--timeseries"),
                       ("flight_recorder_p0.json", "--flight-recorder")):
        proc = subprocess.run([sys.executable, SCHEMA_LINT,
                               str(tmp_path / name), flag],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr + proc.stdout


def test_request_ids_unique_under_concurrent_submission():
    release = threading.Event()

    def factory():
        release.wait(30.0)
        raise RuntimeError("stub engine: drill over")

    srv = LMServer(factory)
    srv.start()
    ids: list = []
    lock = threading.Lock()

    def pump():
        mine = [srv.submit([1, 2, 3], 2).request_id for _ in range(50)]
        with lock:
            ids.extend(mine)

    threads = [threading.Thread(target=pump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ids) == 400 and len(set(ids)) == 400
    release.set()
    with pytest.raises(RuntimeError, match="stub engine"):
        srv.drain()
