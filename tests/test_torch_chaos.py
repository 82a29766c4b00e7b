"""The port's fault injection (``resilience/chaos.py``) and fleet heartbeats
(``resilience/heartbeat.py``, ``FleetHook``), on the CPU.

Against the JAX package, exactly: ``parse_chaos_spec`` and
``ChaosConfig.from_dict`` give the same dicts and the same errors on the
same input; ``poison_batch`` poisons the same rows of the same batch
(NaN where JAX's is NaN, the rest bit for bit); the ``chaos/armed_unfired``
count; the heartbeat files, ``read_fleet`` and ``fleet_summary`` on one
directory; ``FleetHook``'s gauges and warnings.  The rest holds the
contracts of the JAX package's ``tests/test_resilience.py`` and
``tests/test_fleet.py`` on the port: memoisation per scope and fire-once,
the durable kill marker, the hidden newest checkpoint and the straggler
delay on the target process only, and through ``fit`` on LeNet:
``nan_at_step`` rolls back and skips exactly the offending chunk (one
batch at ``steps_per_loop`` 1, the chunk of 4 at 4), ``torn_checkpoint_at
_step`` walks back, ``sigterm_at_step`` exits 75 through the CLI, and
``pipeline_fail_at_batch`` recovers under ``recoverable_fit``, each ending
bit for bit at the straight run's state (or, for the rollback, at a
straight run over the stream without the skipped batches); a fault that
never fires warns.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.harness import hooks as jhooks
from distributed_tensorflow_models_tpu.resilience import chaos as jchaos
from distributed_tensorflow_models_tpu.resilience import heartbeat as jheartbeat
from distributed_tensorflow_models_tpu_torch import launch, telemetry
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.resilience import chaos
from distributed_tensorflow_models_tpu_torch.resilience import fsck
from distributed_tensorflow_models_tpu_torch.resilience import heartbeat

STEPS = 8


def _cfg(**kw):
    base = dict(train_steps=STEPS, global_batch_size=8, log_every_steps=4,
                checkpoint_every_secs=10_000.0, steps_per_loop=4)
    base.update(kw)
    return tconfig.get_config("lenet_mnist", **base)


@pytest.fixture(scope="module")
def straight():
    return trainlib.fit(_cfg(), device="cpu")


def _same_state(a, b) -> bool:
    ta, pa = ckptlib.flatten_state(a)
    tb, pb = ckptlib.flatten_state(b)
    return (a.step == b.step and pa == pb and sorted(ta) == sorted(tb)
            and all(torch.equal(ta[k], tb[k]) for k in ta))


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


# -- host logic against the JAX package ---------------------------------


@pytest.mark.parametrize("text", [
    "nan_at_step=5, sigterm_at_step=9",
    "",
    "kill_at_step=3,hide_newest_ckpt=1,straggler_delay_ms=40,chaos_host=1",
    "pipeline_fail_at_batch=2,torn_checkpoint_at_step=4,",
    "explode_at=3",
    "nan_at_step",
    "nan_at_step=soon",
])
def test_parse_chaos_spec_matches_jax(text):
    assert (_outcome(chaos.parse_chaos_spec, text)
            == _outcome(jchaos.parse_chaos_spec, text))


@pytest.mark.parametrize("spec", [
    {"kill_at_step": 3, "chaos_host": 1},
    {"nan_at_step": "7", "straggler_delay_ms": 20},
    {"explode_at_step": 1},
])
def test_chaos_config_from_dict_matches_jax(spec):
    def fields(mod):
        try:
            cfg = mod.ChaosConfig.from_dict(spec, seed=3)
        except ValueError as e:
            return str(e)
        return {f: getattr(cfg, f) for f in (*mod._FIELDS, "seed")}

    assert fields(chaos) == fields(jchaos)


def test_injector_memoised_per_scope_and_fires_once(tmp_path):
    spec = {"pipeline_fail_at_batch": 1}
    a = chaos.get_injector(spec, seed=0, scope=str(tmp_path / "a"))
    assert a is chaos.get_injector(spec, seed=0, scope=str(tmp_path / "a"))
    assert a is not chaos.get_injector(spec, seed=0, scope=str(tmp_path / "b"))
    assert chaos.get_injector({}, seed=0, scope="x") is None

    class TwoBatch:
        def __init__(self):
            self.i = 0

        def next_work(self):
            self.i += 1
            return self.i - 1

        def assemble(self, work):
            return {"x": np.zeros(1)}

        def get_state(self):
            return {"i": self.i}

        def set_state(self, s):
            self.i = s["i"]

    ds = a.wrap_dataset(TwoBatch())
    assert ds.assemble(ds.next_work()) is not None
    with pytest.raises(chaos.ChaosPipelineError):
        ds.assemble(ds.next_work())
    assert ds.assemble(ds.next_work()) is not None  # exactly once
    armed = chaos.ChaosInjector(chaos.ChaosConfig(pipeline_fail_at_batch=5))
    rewound = armed.wrap_dataset(TwoBatch())
    rewound.assemble(rewound.next_work())
    with pytest.raises(ValueError, match="next_work"):
        armed.wrap_dataset([{"x": 1}])
    assert isinstance(chaos.ChaosPipelineError("x"), ConnectionError)


def _poison_pair(cfg_kw, batch, first_step, k, host=0):
    out = []
    for mod in (chaos, jchaos):
        inj = mod.ChaosInjector(mod.ChaosConfig(**cfg_kw))
        inj._process_index = host
        out.append(inj)
    port = out[0].poison_batch({key: torch.from_numpy(v.copy())
                                for key, v in batch.items()}, first_step, k)
    ref = out[1].poison_batch(dict(batch), first_step, k)
    return out, port, {key: np.asarray(v) for key, v in ref.items()}


@pytest.mark.parametrize("first_step,k", [(5, 4), (6, 1), (1, 4), (7, 2)])
def test_poison_batch_matches_jax(first_step, k):
    """The same rows of the same chunk become NaN (row ``nan_at_step -
    first_step`` of a stacked chunk, the whole batch at ``k == 1``, nothing
    outside the window); integer tensors are left alone."""
    rng = np.random.default_rng(0)
    lead = (k,) if k > 1 else ()
    batch = {"image": rng.standard_normal((*lead, 2, 3, 3, 1),
                                          dtype=np.float32),
             "label": rng.integers(0, 9, (*lead, 2), dtype=np.int32)}
    (tinj, jinj), port, ref = _poison_pair({"nan_at_step": 6}, batch,
                                           first_step, k)
    for key in batch:
        got = port[key].numpy()
        assert got.dtype == ref[key].dtype, key
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref[key]))
        np.testing.assert_array_equal(got[~np.isnan(got)],
                                      ref[key][~np.isnan(ref[key])])
    fired = first_step <= 6 < first_step + k
    assert tinj._nan_fired == jinj._nan_fired == fired
    assert np.isnan(port["image"].numpy()).any() == fired
    assert tinj.unfired() == jinj.unfired()


def test_poison_batch_writes_the_stacked_chunk_in_place(caplog):
    """A stacked chunk is poisoned in place (``fit`` hands over the
    stacker's fresh stack); only on the target process; an integer-only
    batch warns and is left as it was."""
    chunk = {"image": torch.zeros(4, 2, 3), "label": torch.zeros(4, 2)}
    inj = chaos.ChaosInjector(chaos.ChaosConfig(nan_at_step=6))
    inj._process_index = 0
    out = inj.poison_batch(chunk, 5, 4)
    assert out["image"] is chunk["image"]
    assert torch.isnan(chunk["image"][1]).all()
    assert not torch.isnan(chunk["image"][[0, 2, 3]]).any()
    other = chaos.ChaosInjector(chaos.ChaosConfig(nan_at_step=6,
                                                  chaos_host=1))
    other._process_index = 0
    fresh = {"image": torch.zeros(4, 2)}
    assert other.poison_batch(fresh, 5, 4) is fresh
    assert not torch.isnan(fresh["image"]).any()
    assert other.unfired() == []  # not the target: no audit
    ints = chaos.ChaosInjector(chaos.ChaosConfig(nan_at_step=1))
    ints._process_index = 0
    tokens = {"inputs": torch.ones(1, 2, 3, dtype=torch.int32)}
    with caplog.at_level(logging.WARNING, logger="dtm"):
        assert torch.equal(ints.poison_batch(tokens, 1, 1)["inputs"],
                           tokens["inputs"])
    assert "found no float leaves" in caplog.text


def test_export_unfired_matches_jax():
    kw = dict(nan_at_step=10_000, hide_newest_ckpt=1, straggler_delay_ms=0,
              sigterm_at_step=3, chaos_host=0)
    counts = []
    for mod, tel in ((chaos, telemetry), (jchaos, None)):
        inj = mod.ChaosInjector(mod.ChaosConfig(**kw))
        inj._process_index = 0
        counts.append(inj.unfired())
    assert counts[0] == counts[1] == [
        "nan_at_step=10000", "sigterm_at_step=3", "hide_newest_ckpt=1"]
    registry = telemetry.MetricsRegistry()
    inj = chaos.ChaosInjector(chaos.ChaosConfig(**kw))
    inj._process_index = 0
    inj.export_unfired(registry)
    assert registry.snapshot()[telemetry.CHAOS_ARMED_UNFIRED] == 3.0


def test_kill_marker_is_durable(tmp_path):
    a = chaos.ChaosInjector(chaos.ChaosConfig(kill_at_step=3),
                            scope=str(tmp_path))
    a._process_index = 0
    assert a.kill_hook().wants_step(3)
    a._mark_kill_fired()
    assert (tmp_path / ".chaos_fired" / "kill_at_step").read_text() == "3"
    b = chaos.ChaosInjector(chaos.ChaosConfig(kill_at_step=3),
                            scope=str(tmp_path))  # "the restarted process"
    b._process_index = 0
    assert b._kill_fired() and not b.kill_hook().wants_step(3)
    assert b.unfired() == []


def test_hidden_newest_checkpoint_on_the_target_only(tmp_path):
    """The filter hides the newest step from the target process's
    listings (``all_steps``, ``latest_step``, the restore walk) and no
    other's; the files stay readable."""
    state = trainlib.build_state(_cfg(), torch.device("cpu"))
    plain = ckptlib.CheckpointManager(str(tmp_path))
    for step in (2, 4):
        plain.save(state.replace(step=step), {"pos": step})
        plain.wait()
    seen = {}
    for host in (0, 1):
        inj = chaos.ChaosInjector(chaos.ChaosConfig(hide_newest_ckpt=1,
                                                    chaos_host=1))
        inj._process_index = host
        jinj = jchaos.ChaosInjector(jchaos.ChaosConfig(hide_newest_ckpt=1,
                                                       chaos_host=1))
        jinj._process_index = host
        assert inj.step_filter()([2, 4, 9]) == jinj.step_filter()([2, 4, 9])
        mgr = ckptlib.CheckpointManager(str(tmp_path),
                                        step_filter=inj.step_filter())
        restored, data = mgr.restore(trainlib.build_state(
            _cfg(), torch.device("cpu")))
        seen[host] = (mgr.all_steps(), mgr.latest_step(), restored.step,
                      data["pos"], inj.unfired())
    assert seen[0] == ([2, 4], 4, 4, 4, [])
    assert seen[1] == ([2], 2, 2, 2, [])
    assert chaos.ChaosInjector(chaos.ChaosConfig()).step_filter() is None


def test_straggler_delay_on_the_target_only():
    inj = chaos.ChaosInjector(chaos.ChaosConfig(straggler_delay_ms=30))
    inj._process_index = 0
    hook = inj.straggler_hook()
    assert hook.wants_step(1) and hook.wants_step(2)
    t0 = time.perf_counter()
    hook.after_step(None, {}, 1)
    assert time.perf_counter() - t0 >= 0.025 and inj._straggler_fired
    bystander = chaos.ChaosInjector(chaos.ChaosConfig(straggler_delay_ms=500,
                                                      chaos_host=3))
    bystander._process_index = 0
    t0 = time.perf_counter()
    bystander.straggler_hook().after_step(None, {}, 1)
    assert time.perf_counter() - t0 < 0.2 and bystander.unfired() == []


def test_tear_removes_what_fsck_reports_torn(tmp_path):
    state = trainlib.build_state(_cfg(), torch.device("cpu"))
    mgr = ckptlib.CheckpointManager(str(tmp_path))
    mgr.save(state.replace(step=3))
    mgr.wait()
    assert fsck.validate_step_dir(os.path.join(mgr.directory, "3")) == []
    inj = chaos.ChaosInjector(chaos.ChaosConfig(torn_checkpoint_at_step=3))
    assert inj.should_tear(3) and not inj.should_tear(2)
    inj.tear_checkpoint(mgr.directory, 3)
    issues = fsck.validate_step_dir(os.path.join(mgr.directory, "3"))
    assert any(fsck.COMMITTED in i for i in issues)
    assert any(fsck.MANIFEST in i for i in issues)
    assert not inj.should_tear(3) and inj.unfired() == []


# -- heartbeats and FleetHook against the JAX package ---------------------


def test_heartbeat_files_read_as_jax_reads_them(tmp_path):
    """A port writer's file, and hand-written ones with a stale peer and a
    missing one, read the same through both packages."""
    w = heartbeat.HeartbeatWriter(str(tmp_path), 0, interval_s=0.05).start()
    try:
        w.beat(12)
        assert w.set_phase("train") == "init"
        deadline = time.time() + 5
        while time.time() < deadline:
            view = heartbeat.read_fleet(str(tmp_path), 1)[0]
            if view is not None and view["step"] == 12:
                break
            time.sleep(0.02)
    finally:
        w.stop()
    now = time.time()
    with open(tmp_path / "p2.json", "w") as f:
        json.dump({"pid": 7, "time": now - 100.0, "step": 4}, f)
    for n in (1, 4):
        views = heartbeat.read_fleet(str(tmp_path), n, now=now)
        assert views == jheartbeat.read_fleet(str(tmp_path), n, now=now)
    assert views[0]["step"] == 12 and views[0]["phase"] == "train"
    assert views[1] is None and views[3] is None
    for stale in (10.0, 1000.0):
        got = heartbeat.fleet_summary(str(tmp_path), 4, stale_after_s=stale,
                                      now=now)
        assert got == jheartbeat.fleet_summary(str(tmp_path), 4,
                                               stale_after_s=stale, now=now)
    assert got["peers_alive"] == 2 and got["step_lag"] == 8


def test_fleet_hook_gauges_and_warnings_match_jax(tmp_path, caplog):
    from distributed_tensorflow_models_tpu import telemetry as jtelemetry

    now = time.time()
    with open(tmp_path / "p0.json", "w") as f:
        json.dump({"pid": 1, "time": now, "step": 10}, f)
    with open(tmp_path / "p2.json", "w") as f:
        json.dump({"pid": 3, "time": now - 60.0, "step": 6}, f)
    got = []
    for hooks, tel in ((hooklib, telemetry), (jhooks, jtelemetry)):
        registry = tel.MetricsRegistry()
        hook = hooks.FleetHook(registry, str(tmp_path), 3, every_steps=2,
                               stale_after_s=30)
        caplog.clear()
        metrics = {}
        with caplog.at_level(logging.WARNING, logger="dtm"):
            assert hook.wants_step(2) and not hook.wants_step(3)
            hook.after_step(None, metrics, 3)
            assert metrics == {}
            hook.after_step(None, metrics, 2)
            hook.after_step(None, {}, 4)  # warned once per peer
        snap = registry.snapshot()
        got.append((metrics[tel.FLEET_PEERS_ALIVE],
                    metrics[tel.FLEET_STEP_LAG],
                    round(metrics[tel.FLEET_HEARTBEAT_AGE]),
                    snap[tel.FLEET_PEERS_ALIVE],
                    [r.getMessage().split(" (")[0] for r in caplog.records]))
    assert got[0] == got[1]
    assert got[0][:3] == (1.0, 0.0, 60)
    assert got[0][4] == ["fleet: process 1 heartbeat is missing",
                         "fleet: process 2 heartbeat is 60.0s stale"]


@pytest.mark.parametrize("codes", [
    [0, 0], [0, 75], [75, 3], [75, 75], [-9, 75, 0], [2, 7], [], [0, -15]])
def test_aggregate_exit_codes_matches_jax(codes):
    from distributed_tensorflow_models_tpu import launch as jlaunch

    assert (launch.aggregate_exit_codes(codes)
            == jlaunch.aggregate_exit_codes(codes))


# -- the faults through fit ---------------------------------------------


class _Drop:
    """The dataset without the batches at some positions (those after
    which its cursor reads one of ``after``): what a rollback skips."""

    def __init__(self, ds, after):
        self._ds, self._after = ds, after

    def __iter__(self):
        for batch in self._ds:
            if self._ds.get_state() not in self._after:
                yield batch

    def get_state(self):
        return self._ds.get_state()

    def set_state(self, state):
        self._ds.set_state(state)


@pytest.mark.parametrize("k,skipped", [(1, [6]), (4, [5, 6, 7, 8])])
def test_nan_rolls_back_and_skips_the_offending_chunk(tmp_path, monkeypatch,
                                                      k, skipped):
    """NaN written into the batch of step 6 (the second row of the chunk
    5-8 at ``steps_per_loop`` 4): one rollback to the step-4 checkpoint,
    exactly the offending chunk's batches skipped, and every state tensor
    and loss equal to a straight run over the stream without them; the
    fire is on the flight record's timeline and nothing stays armed."""
    cfg = _cfg(steps_per_loop=k, checkpoint_every_steps=4)
    rolled = trainlib.fit(cfg.replace(nan_policy="rollback",
                                      chaos={"nan_at_step": 6}),
                          str(tmp_path), device="cpu")
    assert (rolled.rollbacks, rolled.skipped_batches) == (1, len(skipped))
    assert [h["step"] for h in rolled.history] == list(range(1, STEPS + 1))
    snap = rolled.registry.snapshot()
    assert snap[telemetry.CHAOS_ARMED_UNFIRED] == 0.0
    record = json.loads((tmp_path / "flight_recorder_p0.json").read_text())
    names = [e["name"] for e in record["events"]]
    assert record["reason"] == "rollback"
    assert {"chaos/nan_at_step", "train/divergence",
            "train/rollback"} <= set(names)

    probe = trainlib.build_dataset(cfg)
    it = iter(probe)
    after = []
    for _ in range(max(skipped)):
        next(it)
        after.append(probe.get_state())
    drop = [after[i - 1] for i in skipped]
    build = trainlib.build_dataset
    monkeypatch.setattr(trainlib, "build_dataset",
                        lambda c, split="train", mesh=None: _Drop(
                            build(c, split, mesh), drop))
    without = trainlib.fit(cfg, device="cpu")
    assert _same_state(rolled.state, without.state)
    assert ([h["loss"] for h in rolled.history]
            == [h["loss"] for h in without.history])


def test_torn_newest_walks_back_bit_identical(straight, tmp_path):
    """The run's final save (step 5) torn after it was durable: fsck
    reports the walk-back, the resume restores step 4 and ends at the
    straight run's state; a tear with no save cadence at its step forces
    one (step 3) and leaves the final checkpoint intact."""
    chaos_spec = {"torn_checkpoint_at_step": 5}
    first = trainlib.fit(_cfg(train_steps=5, checkpoint_every_steps=2,
                              chaos=chaos_spec), str(tmp_path / "a"),
                         device="cpu")
    assert first.registry.snapshot()[telemetry.CHAOS_ARMED_UNFIRED] == 0.0
    report = fsck.fsck_checkpoints(str(tmp_path / "a" / "checkpoints"))
    assert (report["latest_step"], report["newest_valid_step"]) == (5, 4)
    resumed = trainlib.fit(_cfg(checkpoint_every_steps=2, chaos=chaos_spec),
                           str(tmp_path / "a"), device="cpu")
    assert resumed.restored_from == 4
    assert _same_state(resumed.state, straight.state)

    mid = trainlib.fit(_cfg(chaos={"torn_checkpoint_at_step": 3}),
                       str(tmp_path / "b"), device="cpu")
    assert _same_state(mid.state, straight.state)
    report = fsck.fsck_checkpoints(str(tmp_path / "b" / "checkpoints"))
    valid = {s["step"]: s["valid"] for s in report["steps"]}
    assert valid[3] is False and report["newest_valid_step"] == STEPS


def test_cli_sigterm_exits_75_then_resumes(straight, tmp_path, capsys):
    """``--chaos sigterm_at_step=3``: the CLI's ``train`` takes the
    emergency checkpoint, prints ``preempted`` and returns 75, leaving a
    flight record with the fire; the same command again (a new process
    would re-arm; this one's injector has fired) resumes at 3 and ends at
    the straight run's final loss."""
    argv = ["train", "--config", "lenet_mnist", "--workdir", str(tmp_path),
            "--train-steps", str(STEPS), "--batch-size", "8",
            "--steps-per-loop", "4", "--device", "cpu",
            "--chaos", "sigterm_at_step=3"]
    assert cli.main(argv) == launch.RESUMABLE_EXIT_CODE == 75
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["preempted"] and out["steps"] == 3
    record = json.loads((tmp_path / "flight_recorder_p0.json").read_text())
    assert record["reason"] == "preempted" and record["step"] == 3
    assert "chaos/sigterm_at_step" in [e["name"] for e in record["events"]]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["restored_from"], out["steps"]) == (3, STEPS)
    assert out["final_metrics"]["loss"] == straight.history[-1]["loss"]


def test_pipeline_fault_recovers_bit_identical(straight, tmp_path):
    """``assemble`` raises in a pipeline worker at batch 3: the crash-time
    save holds the consumed position, ``recoverable_fit`` restarts once,
    the fault does not fire again, and the run ends at the straight
    state."""
    res = trainlib.recoverable_fit(
        _cfg(chaos={"pipeline_fail_at_batch": 3}, data_workers=2),
        str(tmp_path), device="cpu", backoff_base_s=0.0)
    assert res.registry.counter(telemetry.RESTARTS).value == 1
    assert _same_state(res.state, straight.state)


def test_unfired_fault_warns(straight, tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="dtm"):
        res = trainlib.fit(_cfg(chaos={"nan_at_step": 10_000}),
                           str(tmp_path), device="cpu")
    assert _same_state(res.state, straight.state)
    assert "never fired" in caplog.text and "nan_at_step=10000" in caplog.text
    report = json.loads((tmp_path / "telemetry.json").read_text())
    assert report["metrics"][telemetry.CHAOS_ARMED_UNFIRED] == 1.0
