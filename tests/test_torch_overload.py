"""The port's overload tier against the JAX package's: admission,
backpressure and autoscale decisions (``serving/admission.py``), replay
traces and arrival processes (``serving/replay.py``), the file-queue
protocol and the fleet-size watcher (``serving/server.py``), and the
closed-loop ``launch.FleetAutoscaler``; and the scheduler's shed and
backpressure paths driven by those real objects, against the JAX
scheduler on bridged weights.

Each scenario is run by both packages on the same inputs; the decisions,
traces, arrivals, registry snapshots, journals and fleet files must be
identical (exact: host logic on the same values), and each carries the
JAX suite's own assertions (``tests/test_overload.py``).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu import launch as jlaunch
from distributed_tensorflow_models_tpu.serving import admission as jadm
from distributed_tensorflow_models_tpu.serving import replay as jreplay
from distributed_tensorflow_models_tpu.serving import server as jserver
from distributed_tensorflow_models_tpu.telemetry import registry as jreg
from distributed_tensorflow_models_tpu_torch import launch
from distributed_tensorflow_models_tpu_torch.serving import admission as admlib
from distributed_tensorflow_models_tpu_torch.serving import replay as replaylib
from distributed_tensorflow_models_tpu_torch.serving import server as srvlib
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

# -- AdmissionPolicy -------------------------------------------------------


def _admission_trace(adm):
    out = []
    for classes, kw in ((("batch", "standard", "interactive"), {}),
                        (("a", "b", "c", "d"), {}), (("only",), {}),
                        (("a", "b"), {"default": "a"}),
                        (("lo", "hi"), {"shed_on_slo": ("qdepth",),
                                        "max_shed_per_step": 3})):
        pol = adm.AdmissionPolicy(classes, **kw)
        out.append((pol.default, [pol.rank(c) for c in classes],
                    pol.resolve(None), pol.resolve(""),
                    [pol.shed_quota(b) for b in ([], ["ttft"],
                                                 ["ttft", "qdepth"])]))
    pol = adm.AdmissionPolicy()
    out.append([pol.overdue(t0, d, now) for t0, d, now in (
        (10.0, None, 1e9), (10.0, 2.0, 12.0), (10.0, 2.0, 12.001),
        (10.0, 2.0, 11.0))])
    return out


def test_admission_decisions_equal_the_jax_policy():
    got = _admission_trace(admlib)
    assert got == _admission_trace(jadm)
    assert got[0][0] == "standard" and got[1][0] == "b"
    assert got[-1] == [False, False, True, False]
    assert got[4][4] == [0, 0, 3]


@pytest.mark.parametrize("kwargs", [
    {"classes": ()},
    {"classes": ("a", "a")},
    {"classes": ("a", "")},
    {"classes": ("a", "b/c")},
    {"classes": ("a",), "default": "b"},
    {"classes": ("a",), "max_shed_per_step": 0},
])
def test_admission_ctor_rejects(kwargs):
    kwargs = dict(kwargs)
    classes = kwargs.pop("classes")
    for adm in (admlib, jadm):
        with pytest.raises(ValueError):
            adm.AdmissionPolicy(classes, **kwargs)


def test_admission_resolve_validates():
    pol = admlib.AdmissionPolicy(("lo", "hi"))
    with pytest.raises(ValueError, match="unknown priority class"):
        pol.resolve("vip")
    with pytest.raises(ValueError, match="unknown priority class"):
        pol.rank("vip")


# -- BackpressureGate ------------------------------------------------------

GATES = {
    "queue": (dict(engage_queue_depth=3, release_queue_depth=1),
              [(99, 2), (99, 3), (99, 2), (99, 1), (99, 5)]),
    "blocks": (dict(engage_blocks_free=2, release_blocks_free=5,
                    engage_queue_depth=10, release_queue_depth=4),
               [(2, 0), (6, 5), (6, 4), (1, 0), (5, 0), (6, 0)]),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_backpressure_decisions_equal_the_jax_gate(name):
    kw, script = GATES[name]
    traces = []
    for adm in (admlib, jadm):
        gate = adm.BackpressureGate(**kw)
        traces.append(([gate.update(blocks_free=b, queue_depth=q)
                        for b, q in script], gate.episodes, gate.engaged))
    assert traces[0] == traces[1]
    if name == "queue":
        assert traces[0] == ([False, True, True, False, True], 2, True)


@pytest.mark.parametrize("kwargs", [
    {},
    {"engage_blocks_free": 2},
    {"engage_queue_depth": 3},
    {"engage_blocks_free": 2, "release_blocks_free": 2},
    {"engage_queue_depth": 3, "release_queue_depth": 3},
    {"engage_queue_depth": 3, "release_queue_depth": 4},
])
def test_backpressure_ctor_rejects(kwargs):
    for adm in (admlib, jadm):
        with pytest.raises(ValueError):
            adm.BackpressureGate(**kwargs)


# -- AutoscalePolicy -------------------------------------------------------

BASE = dict(min_replicas=1, max_replicas=4, up_backlog=4.0,
            down_backlog=1.0, up_after=2, down_after=3, cooldown=2)
AUTOSCALE = {
    "up_streak": (dict(cooldown=0), [(1, 10.0), (1, 2.0), (1, 10.0),
                                     (1, 10.0)]),
    "down_and_floor": (dict(cooldown=0), [(2, 0.0)] * 3 + [(1, 0.0)] * 6),
    "cooldown": ({}, [(1, 10.0), (1, 10.0)] + [(2, 30.0)] * 4),
    "band": (dict(cooldown=0), [(1, 10.0), (1, 2.0), (1, 10.0), (2, 0.0),
                                (2, 0.0), (2, 3.0), (2, 0.0)]),
    "slo": (dict(cooldown=0), [(1, 0.0, True), (1, 0.0, True)]),
    "max_clamp": (dict(max_replicas=2, cooldown=0), [(2, 100.0)] * 10),
}


@pytest.mark.parametrize("name", sorted(AUTOSCALE))
def test_autoscale_decisions_equal_the_jax_policy(name):
    kw, script = AUTOSCALE[name]
    traces = []
    for adm in (admlib, jadm):
        pol = adm.AutoscalePolicy(**{**BASE, **kw})
        traces.append([pol.observe(replicas=s[0], backlog=s[1],
                                   slo_breached=bool(s[2:] and s[2]))
                       for s in script])
    assert traces[0] == traces[1]
    want = {"up_streak": [0, 0, 0, 1], "slo": [0, 1],
            "max_clamp": [0] * 10,
            "down_and_floor": [0, 0, -1] + [0] * 6,
            "cooldown": [0, 1, 0, 0, 0, 1]}
    if name in want:
        assert traces[0] == want[name]


@pytest.mark.parametrize("kwargs", [
    {"min_replicas": 0},
    {"min_replicas": 3, "max_replicas": 2},
    {"up_backlog": 1.0, "down_backlog": 1.0},
    {"up_after": 0},
    {"down_after": 0},
    {"cooldown": -1},
])
def test_autoscale_ctor_rejects(kwargs):
    for adm in (admlib, jadm):
        with pytest.raises(ValueError):
            adm.AutoscalePolicy(**kwargs)
    with pytest.raises(ValueError):
        admlib.AutoscalePolicy(**BASE).observe(replicas=0, backlog=1.0)


# -- replay presets and arrival processes ----------------------------------


def _specs(reqs):
    return [(r.spec(), r.arrival_s) for r in reqs]


@pytest.mark.parametrize("preset,n", [("uniform", 6), ("interference", 5),
                                      ("shared_prefix", None),
                                      ("long_context", None)])
@pytest.mark.parametrize("seed", [1, 7])
def test_preset_trace_equals_the_jax_trace(preset, n, seed):
    for smoke in (False, True):
        got = replaylib.preset_trace(preset, n, seed=seed, smoke=smoke,
                                     first_id=3)
        want = jreplay.preset_trace(preset, n, seed=seed, smoke=smoke,
                                    first_id=3)
        assert _specs(got) == _specs(want) and got
        assert replaylib.preset_params(preset, smoke=smoke) == (
            jreplay.preset_params(preset, smoke=smoke))


@pytest.mark.parametrize("mix,kw", [
    ("uniform_mix", {}), ("mixed_mix", {"sample_every": 3}),
    ("shared_prefix_mix", {"tail_len": 9}),
])
def test_request_mixes_equal_the_jax_mixes(mix, kw):
    got = getattr(replaylib, mix)(7, seed=5, **kw)
    want = getattr(jreplay, mix)(7, seed=5, **kw)
    assert _specs(got) == _specs(want)


ARRIVALS = {
    "open_loop": lambda lib, s: lib.open_loop_arrivals(32, seed=s,
                                                       mean_gap_s=0.01),
    "bursty": lambda lib, s: lib.bursty_arrivals(
        32, seed=s, lull_gap_s=0.1, spike_gap_s=0.001, lull_s=0.2,
        spike_s=0.3),
    "diurnal": lambda lib, s: lib.diurnal_arrivals(
        32, seed=s, mean_gap_s=0.01, period_s=1.0),
    "assign": lambda lib, s: [r.arrival_s for r in lib.assign_arrivals(
        lib.uniform_mix(8, seed=s), seed=s, mean_gap_s=0.05)],
}


@pytest.mark.parametrize("name", sorted(ARRIVALS))
def test_arrivals_equal_the_jax_processes(name):
    make = ARRIVALS[name]
    a = make(replaylib, 5)
    assert a == make(jreplay, 5)
    assert a == make(replaylib, 5) and a != make(replaylib, 6)
    assert all(x < y for x, y in zip(a, a[1:]))


def test_bursty_arrivals_spike_is_denser_than_lull():
    offs = replaylib.bursty_arrivals(400, seed=3, lull_gap_s=0.5,
                                     spike_gap_s=0.005, lull_s=1.0,
                                     spike_s=1.0)
    lull = sum(1 for t in offs if (t % 2.0) < 1.0)
    assert len(offs) - lull > 10 * lull


@pytest.mark.parametrize("call,match", [
    (lambda lib: lib.bursty_arrivals(4, seed=1, lull_gap_s=0.1,
                                     spike_gap_s=0.1, lull_s=1.0,
                                     spike_s=1.0), "below lull_gap_s"),
    (lambda lib: lib.bursty_arrivals(4, seed=1, lull_gap_s=0.2,
                                     spike_gap_s=0.1, lull_s=0.0,
                                     spike_s=1.0), "phase lengths"),
    (lambda lib: lib.diurnal_arrivals(4, seed=1, mean_gap_s=0.1,
                                      period_s=1.0, peak_to_trough=0.5),
     "peak_to_trough"),
    (lambda lib: lib.diurnal_arrivals(4, seed=1, mean_gap_s=0.1,
                                      period_s=0.0), "period_s"),
    (lambda lib: lib.preset_trace("uniform", seed=1), "explicit n"),
    (lambda lib: lib.preset_params("nope"), "unknown trace preset"),
])
def test_replay_rejects_as_the_jax_module(call, match):
    for lib in (replaylib, jreplay):
        with pytest.raises(ValueError, match=match):
            call(lib)


def test_spec_carries_priority_and_deadline_only_when_set():
    plain = replaylib.ReplayRequest(request_id=1, prompt=[1],
                                    max_new_tokens=2)
    assert "priority" not in plain.spec()
    tagged = replaylib.ReplayRequest(request_id=2, prompt=[1],
                                     max_new_tokens=2, priority="interactive",
                                     deadline_s=0.5)
    assert tagged.spec() == jreplay.ReplayRequest(
        request_id=2, prompt=[1], max_new_tokens=2, priority="interactive",
        deadline_s=0.5).spec()


def test_replay_report_offered_vs_achieved_accounting(tmp_path):
    reqs = replaylib.stamp_arrivals(replaylib.uniform_mix(5, seed=1),
                                    [0.0] * 5)
    seen = []
    rep = replaylib.replay(reqs, seen.append)
    assert rep.emitted == 5 and seen == reqs
    assert rep.offered_duration_s == 0.0 and rep.pacing_error == 0.0
    slow = replaylib.ReplayReport(emitted=10, offered_duration_s=1.0,
                                  achieved_duration_s=1.5, max_lag_s=0.5,
                                  mean_lag_s=0.1)
    assert slow.offered_qps == pytest.approx(10.0)
    assert slow.pacing_error == pytest.approx(0.5)
    # write_request files: the JAX writer's bytes.
    for lib, d in ((replaylib, "a"), (jreplay, "b")):
        os.makedirs(tmp_path / d)
        lib.write_request(str(tmp_path / d), reqs[0])
    (name,) = os.listdir(tmp_path / "a")
    assert (tmp_path / "a" / name).read_bytes() == (
        tmp_path / "b" / name).read_bytes()


# -- exactly-once across a scripted scale-down -----------------------------


def _queue(tmp_path, n):
    queue_dir = str(tmp_path / "queue")
    claimed = os.path.join(queue_dir, "claimed")
    resp = os.path.join(queue_dir, "resp")
    os.makedirs(claimed)
    os.makedirs(resp)
    for req in replaylib.preset_trace("uniform", n, seed=11):
        replaylib.write_request(queue_dir, req)
    return queue_dir, claimed, resp


def test_exactly_once_across_scripted_scale_down(tmp_path):
    """The port's claim/unclaim/respond helpers, replayed by hand: the
    victim (replica 1) answers one of its four claims and hands three
    back; the survivor, the JAX package's helpers, serves the rest."""
    queue_dir, claimed, resp = _queue(tmp_path, 8)
    victim = [srvlib._claim_one(queue_dir, claimed, replica=1)
              for _ in range(4)]
    name, spec = victim[0]
    srvlib._write_response(resp, spec["request_id"], {
        "request_id": spec["request_id"], "tokens": [1], "replica": 1})
    os.remove(os.path.join(claimed, f"{name}.p1"))
    for name, _ in victim[1:]:
        srvlib._unclaim(queue_dir, claimed, name, replica=1)
    served = 0
    while True:
        got = jserver._claim_one(queue_dir, claimed, replica=0)
        if got is None:
            break
        name, spec = got
        jserver._write_response(resp, spec["request_id"], {
            "request_id": spec["request_id"], "tokens": [0], "replica": 0})
        os.remove(os.path.join(claimed, f"{name}.p0"))
        served += 1
    assert served == 7
    assert sorted(int(f.split("-")[1].split(".")[0])
                  for f in os.listdir(resp)) == list(range(8))
    assert os.listdir(claimed) == []
    assert not [f for f in os.listdir(queue_dir) if f.startswith("req-")]


def test_claim_race_loser_skips_without_error(tmp_path):
    queue_dir, claimed, _ = _queue(tmp_path, 1)
    assert srvlib._claim_one(queue_dir, claimed, replica=0) is not None
    assert srvlib._claim_one(queue_dir, claimed, replica=1) is None


# -- FleetSizeWatcher ------------------------------------------------------


def _watch(srv, reg_mod, path, script):
    reg = reg_mod.MetricsRegistry()
    w = srv.FleetSizeWatcher(path, reg)
    out = []
    for size in script:
        if size == "torn":
            with open(path, "w") as f:
                f.write("{torn")
        elif size is not None:
            with open(path, "w") as f:
                json.dump({"size": size, "ts_wall": 0.0}, f)
        out.append((w.poll(), reg.snapshot()))
    os.remove(path)
    return out


@pytest.mark.parametrize("script", [
    [None, 2], [1, 3, 3, 2], [2, "torn"], [4, 1, 1, 5],
])
def test_fleet_watcher_equals_the_jax_watcher(tmp_path, script):
    path = str(tmp_path / "fleet_size.json")
    got = _watch(srvlib, reglib, path, script)
    assert got == _watch(jserver, jreg, path, script)
    if script == [1, 3, 3, 2]:
        snap = got[-1][1]
        assert (snap[reglib.SERVE_FLEET_SIZE], snap[reglib.SERVE_SCALE_UP],
                snap[reglib.SERVE_SCALE_DOWN]) == (2.0, 2.0, 1.0)
    if script == [None, 2]:
        assert got[0][0] is None and got[1][1][reglib.SERVE_SCALE_UP] == 0.0


# -- FleetAutoscaler -------------------------------------------------------


def _ts_row(workdir, replica, **fields):
    with open(os.path.join(workdir, f"timeseries_p{replica}.jsonl"),
              "a") as f:
        f.write(json.dumps({"ts_wall": 0.0, "t_rel_s": 0.0, **fields}) + "\n")


def _controller(tmp_path, lib, adm, **policy_kw):
    workdir = str(tmp_path / "wd")
    queue_dir = str(tmp_path / "queue")
    os.makedirs(workdir)
    os.makedirs(queue_dir)
    ctl = lib.FleetAutoscaler(workdir, queue_dir=queue_dir,
                              poll_interval_s=0.0,
                              policy=adm.AutoscalePolicy(**policy_kw))
    return ctl, workdir, queue_dir


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "ts_wall"} for r in rows]


def _autoscale_run(tmp_path, lib, adm):
    """Signals over two replicas' artifacts and a queue, a spike that
    scales up, a lull that scales down, and the trail it leaves."""
    ctl, workdir, queue_dir = _controller(
        tmp_path, lib, adm, min_replicas=1, max_replicas=4, up_backlog=2.0,
        down_backlog=0.5, up_after=2, down_after=2, cooldown=0)
    _ts_row(workdir, 0, offered=10.0, served=6.0,
            **{"serve/blocks_free": 3.0, "serve/slo_margin/ttft": -0.5})
    _ts_row(workdir, 1, offered=4.0, served=4.0,
            **{"serve/blocks_free": 9.0})
    for req in jreplay.preset_trace("uniform", 2, seed=1, first_id=50):
        jreplay.write_request(queue_dir, req)
    out = [ctl.signals([0, 1])]
    out += [ctl.decide([0, 1]) for _ in range(3)]
    for name in os.listdir(queue_dir):
        os.remove(os.path.join(queue_dir, name))
    _ts_row(workdir, 0, offered=10.0, served=10.0)
    _ts_row(workdir, 1, offered=4.0, served=4.0)
    _ts_row(workdir, 2, offered=0.0, served=0.0)
    out += [ctl.decide([0, 1, 2]) for _ in range(2)]
    with open(os.path.join(workdir, "scale_events.jsonl")) as f:
        out.append(_strip(json.loads(line) for line in f))
    with open(os.path.join(workdir, "fleet_size.json")) as f:
        out.append(json.load(f)["size"])
    dumps = sorted(n for n in os.listdir(workdir)
                   if n.startswith("flight_autoscale_"))
    out.append([(n, json.load(open(os.path.join(workdir, n)))["reason"])
                for n in dumps])
    out.append(ctl.events)
    return out


def test_autoscaler_equals_the_jax_controller(tmp_path):
    got = _autoscale_run(tmp_path / "port", launch, admlib)
    want = _autoscale_run(tmp_path / "jax", jlaunch, jadm)
    assert got == want
    sig = got[0]
    assert sig["unclaimed"] == 2 and sig["backlog"] == pytest.approx(6.0)
    assert sig["blocks_free"] == 3.0 and sig["slo_breached"] == ["ttft"]
    events = got[-4]
    assert [e["event"] for e in events] == ["scale_up", "scale_down"]
    assert got[-3] == 2 and got[-1] == 2
    assert got[-2] == [("flight_autoscale_0.json", "autoscale_scale_up"),
                       ("flight_autoscale_1.json", "autoscale_scale_down")]


def test_autoscaler_fleet_file_tracks_decisions_not_liveness(tmp_path):
    ctl, workdir, _ = _controller(
        tmp_path, launch, admlib, min_replicas=1, max_replicas=4,
        up_backlog=4.0, down_backlog=1.0, up_after=2, down_after=2,
        cooldown=0)
    fleet_file = os.path.join(workdir, "fleet_size.json")
    assert ctl.decide([0, 1]) == 0
    assert json.load(open(fleet_file))["size"] == 2
    assert ctl.decide([0, 1]) == -1
    committed = json.load(open(fleet_file))
    assert committed["size"] == 1
    for _ in range(4):
        ctl.decide([0, 1])
    assert json.load(open(fleet_file)) == committed


def test_autoscaler_rate_limit_skips_between_polls(tmp_path):
    workdir = str(tmp_path / "wd")
    os.makedirs(workdir)
    ctl = launch.FleetAutoscaler(
        workdir, poll_interval_s=3600.0,
        policy=admlib.AutoscalePolicy(up_backlog=0.5, down_backlog=0.1,
                                      up_after=1, cooldown=0))
    _ts_row(workdir, 0, offered=50.0, served=0.0)
    assert [ctl.decide([0]) for _ in range(3)] == [1, 0, 0]


def test_launch_local_recruits_and_drains_under_the_controller(tmp_path):
    """``launch_local(scale_controller=)`` with a scripted controller:
    +1 spawns process 2 at a fresh index (its environment says a fleet
    of 3), -1 SIGTERMs the newest live child, which exits 0; the code
    list covers every child ever spawned."""
    import sys

    marks = tmp_path / "marks"
    marks.mkdir()
    child = (
        "import os, signal, sys, time\n"
        "i = os.environ['DTM_PROCESS_ID']\n"
        "n = os.environ['DTM_NUM_PROCESSES']\n"
        f"open(os.path.join({str(marks)!r}, i), 'w').write(n)\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
        "time.sleep({'0': 0.5, '1': 3}.get(i, 30))\n")

    class Scripted:
        def __init__(self):
            self.calls = []

        def decide(self, live):
            self.calls.append(list(live))
            if len(self.calls) == 1:
                return 1
            if 2 in live and os.path.exists(marks / "2"):
                return -1
            return 0

    ctl = Scripted()
    codes = launch.launch_local(2, [sys.executable, "-c", child],
                                scale_controller=ctl, timeout=60)
    assert codes == [0, 0, 0]
    assert sorted(os.listdir(marks)) == ["0", "1", "2"]
    assert (marks / "2").read_text() == "3"
    assert max(len(c) for c in ctl.calls) == 3


# -- the scheduler's shed and backpressure paths, real objects -------------


def _overload_run(sched_mod, adm, slo, reg_mod, engine):
    """Eight greedy requests on a 2-slot engine through the scheduler with
    a real AdmissionPolicy (three classes, SLO shedding one a step), a
    BackpressureGate on queue depth and an SLOMonitor on queue depth that
    breaches at once; two requests carry a zero TTFT deadline.  Returns
    each step's completions, the gate and breach state, and the
    overload counters."""
    reg = engine.registry
    monitor = slo.SLOMonitor(["q=serve/queue_depth:p50<0.5@60s"], reg,
                             eval_interval_s=0.0, breach_after=1,
                             recover_after=1)
    sched = sched_mod.ContinuousBatchingScheduler(
        engine, registry=reg, slo_monitor=monitor,
        admission=adm.AdmissionPolicy(("batch", "standard", "interactive"),
                                      shed_on_slo=("q",),
                                      max_shed_per_step=1),
        backpressure=adm.BackpressureGate(engage_queue_depth=3,
                                          release_queue_depth=1))
    classes = ("batch", "standard", "interactive")
    for i in range(8):
        sched.submit(sched_mod.Request(
            i, np.asarray([1 + i, 2, 3, 4 + i], np.int32), 4,
            priority=classes[i % 3],
            deadline_s=0.0 if i in (2, 5) else None))
    trace = []
    while sched.has_work:
        done = sched.step()
        trace.append((sorted((c.request_id, c.finish_reason, list(c.tokens))
                             for c in done), sched.intake_paused,
                      monitor.breached()))
    keys = ("serve/submitted", "serve/shed", "serve/backpressure",
            "serve/slo_breach", "serve/requests", "serve/completed")
    return trace, {k: v for k, v in reg.snapshot().items()
                   if k.startswith(keys)}


def test_scheduler_sheds_and_gates_as_the_jax_scheduler():
    """The port's scheduler with the port's real admission objects, and
    the JAX scheduler with the JAX package's, over bridged weights: the
    same sheds (deadline, then SLO-driven from the lowest class), the same
    completions token for token, the gate and breach states, and the
    per-class counters, step by step (exact)."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_models_tpu.models import get_model
    from distributed_tensorflow_models_tpu.serving import engine as jengine
    from distributed_tensorflow_models_tpu.serving import scheduler as jsched
    from distributed_tensorflow_models_tpu.telemetry import slo as jslo
    from distributed_tensorflow_models_tpu_torch import interop
    from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
        TransformerLM,
    )
    from distributed_tensorflow_models_tpu_torch.serving import (
        scheduler as schedlib,
    )
    from distributed_tensorflow_models_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_models_tpu_torch.telemetry import slo as slolib

    small = dict(vocab_size=50, num_layers=2, num_heads=2, d_model=32,
                 d_ff=64, max_len=64, dropout_rate=0.0)
    jm = get_model("transformer_lm", **small, dtype=jnp.float32,
                   attn_impl="reference")
    params = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]))
    tm = TransformerLM(**small, dtype=torch.float32, attn_impl="reference")
    interop.load_flax_variables(tm, {"params": params})
    kw = dict(max_slots=2, prefill_chunk=8)
    got = _overload_run(schedlib, admlib, slolib, reglib, InferenceEngine(
        tm, device="cpu", registry=reglib.MetricsRegistry(), **kw))
    want = _overload_run(jsched, jadm, jslo, jreg, jengine.InferenceEngine(
        jm, params, registry=jreg.MetricsRegistry(), **kw))
    assert got == want
    trace, counters = got
    reasons = {rid: why for step in trace for rid, why, _ in step[0]}
    assert reasons[2] == reasons[5] == "shed"  # the zero deadlines
    assert "shed" in {reasons[i] for i in (0, 3, 6)}  # the batch class
    assert counters["serve/backpressure_engaged"] >= 1
    assert counters["serve/slo_breach/q"] >= 1
    assert counters["serve/shed/batch"] >= 1
    assert sum(v for k, v in counters.items()
               if k.startswith("serve/submitted/")) == 8
