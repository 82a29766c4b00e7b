"""The port's resilience stack (``resilience/``) and what ``fit``, the
CLI and ``recoverable_fit`` do with it, on the CPU.

Against the JAX package: ``restart_backoff`` gives the same delays, and
``Consensus`` over the same scripted ``Backend`` makes the same decisions
(and, one process, touches no backend at all).  Port-internal: a
self-sent SIGTERM preempts ``fit`` at the next chunk boundary with an
emergency checkpoint, the resume is bit-identical, and the CLI exits 75;
``recoverable_fit`` restarts on a transient error and ends at the
straight run's state; a sticky CUDA error or an out-of-memory error is
never retried; the listener gives back the previous SIGTERM handler; the
watchdog diagnoses a stall and its abort stays off the main thread's
work; a checkpoint manager obeys the chief's decisions; a chaos config
builds (the fault drills are ``tests/test_torch_chaos.py``).
"""

import json
import logging
import signal
import threading
import time

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.resilience import backoff as jbackoff
from distributed_tensorflow_models_tpu.resilience import consensus as jconsensus
from distributed_tensorflow_models_tpu_torch import launch, resilience, telemetry
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.resilience import consensus


def _cfg(**kw):
    base = dict(train_steps=8, global_batch_size=32, log_every_steps=2,
                checkpoint_every_secs=10_000.0, steps_per_loop=4)
    base.update(kw)
    return tconfig.get_config("lenet_mnist", **base)


@pytest.fixture(scope="module")
def straight():
    return trainlib.fit(_cfg(), device="cpu")


def _same_state(a, b) -> bool:
    ta, _ = ckptlib.flatten_state(a)
    tb, _ = ckptlib.flatten_state(b)
    return a.step == b.step and all(torch.equal(ta[k], tb[k]) for k in ta)


class _SigtermAt(hooklib.Hook):
    """Sends this process SIGTERM after ``step`` (a preemption notice)."""

    def __init__(self, step):
        self._step = step

    def wants_step(self, step):
        return step == self._step

    def after_step(self, state, metrics, step):
        if step == self._step:
            signal.raise_signal(signal.SIGTERM)


def test_listener_sets_the_flag_and_gives_back_the_previous_handler():
    def previous(signum, frame):
        pass

    old = signal.signal(signal.SIGTERM, previous)
    try:
        listener = resilience.PreemptionListener()
        assert listener.install()
        signal.raise_signal(signal.SIGTERM)
        assert listener.preempted
        signal.raise_signal(signal.SIGINT)  # the first ctrl-C: graceful
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)  # the second: escalates
        listener.uninstall()
        assert signal.getsignal(signal.SIGTERM) is previous
    finally:
        signal.signal(signal.SIGTERM, old)


def test_sigterm_preempts_and_the_resume_is_bit_identical(straight, tmp_path):
    """SIGTERM after step 3 of chunks of 4 (the chunk ends there: the hook
    wants step 3): ``fit`` writes an emergency checkpoint at 3 and returns
    ``preempted`` through ``recoverable_fit`` without a restart; the rerun
    resumes at 3 and ends at the straight run's state."""
    first = trainlib.recoverable_fit(_cfg(), str(tmp_path), device="cpu",
                                     backoff_base_s=0.0,
                                     extra_hooks=[_SigtermAt(3)])
    assert first.preempted and first.state.step == 3
    assert first.registry.counter(telemetry.RESTARTS).value == 0
    assert (tmp_path / "checkpoints" / "3" / "COMMITTED").exists()
    again = trainlib.fit(_cfg(), str(tmp_path), device="cpu")
    assert again.restored_from == 3 and not again.preempted
    assert _same_state(again.state, straight.state)


def test_cli_exits_75_when_preempted_then_resumes(straight, tmp_path,
                                                  monkeypatch, capsys):
    """The CLI's ``train`` returns ``launch.RESUMABLE_EXIT_CODE`` (75) on a
    preemption and prints ``preempted``; the same command again resumes and
    ends at the straight run's final loss."""
    real = trainlib.recoverable_fit
    hooks = [[_SigtermAt(3)], []]
    monkeypatch.setattr(trainlib, "recoverable_fit",
                        lambda cfg, workdir, **kw: real(
                            cfg.replace(log_every_steps=2,
                                        checkpoint_every_secs=10_000.0),
                            workdir, extra_hooks=hooks.pop(0), **kw))
    argv = ["train", "--config", "lenet_mnist", "--workdir", str(tmp_path),
            "--train-steps", "8", "--batch-size", "32", "--steps-per-loop",
            "4", "--device", "cpu"]
    assert cli.main(argv) == launch.RESUMABLE_EXIT_CODE == 75
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["preempted"] and out["steps"] == 3
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["restored_from"], out["steps"]) == (3, 8)
    assert out["final_metrics"]["loss"] == straight.history[-1]["loss"]


def test_recoverable_fit_restarts_on_a_transient_error(straight, tmp_path):
    """A ``ConnectionError`` at step 5: the crash-time checkpoint is
    written, the next attempt resumes from it and ends at the straight
    run's state; the attempt count lands in ``train/restarts``."""
    fault = hooklib.FaultInjectionHook(5, lambda: ConnectionError("peer"))
    result = trainlib.recoverable_fit(_cfg(), str(tmp_path), device="cpu",
                                      backoff_base_s=0.0,
                                      extra_hooks=[fault])
    assert result.restored_from == 5
    assert result.registry.counter(telemetry.RESTARTS).value == 1
    assert _same_state(result.state, straight.state)


@pytest.mark.parametrize("error,transient", [
    (ConnectionError("connection reset by peer"), True),
    (TimeoutError("store get timed out"), True),
    (torch.distributed.DistBackendError("NCCL watchdog: collective timed "
                                        "out"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (torch.distributed.DistBackendError(
        "NCCL error: CUDA error: device-side assert triggered"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     False),
])
def test_is_transient_error(error, transient):
    assert trainlib.is_transient_error(error) is transient


def test_a_sticky_cuda_error_is_not_retried(tmp_path):
    """In the recoverable set by class (a backend error), but it poisoned
    the context: it propagates from the first attempt."""
    fault = hooklib.FaultInjectionHook(2, lambda: (
        torch.distributed.DistBackendError(
            "CUDA error: an illegal memory access was encountered")))
    with pytest.raises(torch.distributed.DistBackendError):
        trainlib.recoverable_fit(_cfg(train_steps=2), str(tmp_path),
                                 device="cpu", backoff_base_s=0.0,
                                 extra_hooks=[fault])
    assert trainlib.default_recoverable_errors() == (
        torch.distributed.DistBackendError, ConnectionError, TimeoutError)


def test_restart_backoff_matches_jax():
    for kw in ({}, {"base_s": 0.5, "max_s": 3.0, "seed": 7},
               {"base_s": 0.0}):
        got = [resilience.restart_backoff(a, **kw) for a in range(1, 9)]
        want = [jbackoff.restart_backoff(a, **kw) for a in range(1, 9)]
        assert got == want
    assert trainlib.restart_backoff is resilience.restart_backoff


class _Scripted:
    """A backend that answers each allgather with the next scripted vector
    and records what it was given."""

    def __init__(self, script):
        self.script = list(script)
        self.sent = []

    def allgather(self, value):
        self.sent.append(value)
        return self.script.pop(0)


def _decisions(mod, pid, script):
    bus = _Scripted(script)
    c = mod.Consensus(process_index=pid, process_count=3, backend=bus)
    out = [c.broadcast_int(5, label="save"), c.allgather_int(9),
           c.any_flag(False), c.any_flag(True), c.broadcast_int(-1),
           c.is_chief, c.active]
    return out, bus.sent


@pytest.mark.parametrize("pid", [0, 2])
def test_consensus_decides_as_jax_over_a_scripted_backend(pid):
    script = [[7, 5, 5], [9, 3, 1], [0, 0, 1], [0, 0, 0], [4, -1, -1]]
    assert (_decisions(consensus, pid, script)
            == _decisions(jconsensus, pid, script))
    alone = consensus.Consensus(process_index=0, process_count=1,
                                backend=_Scripted([]))
    assert (alone.broadcast_int(3), alone.allgather_int(4),
            alone.any_flag(True)) == (3, [4], True)
    assert not alone.active and alone._backend.sent == []


def test_checkpoint_manager_obeys_the_chief(tmp_path):
    """A follower whose own view says "save" is told by the chief that the
    step exists: it skips, and the override is counted."""
    registry = telemetry.MetricsRegistry()
    bus = _Scripted([[ckptlib._SAVE_SKIP_EXISTS, ckptlib._SAVE_PROCEED]])
    mgr = ckptlib.CheckpointManager(
        str(tmp_path), process_index=1, process_count=2, registry=registry,
        consensus=consensus.Consensus(1, 2, backend=bus))
    state = trainlib.build_state(_cfg(), torch.device("cpu"))
    assert not mgr.save(state.replace(step=4))
    assert bus.sent == [ckptlib._SAVE_PROCEED]
    assert registry.counter(telemetry.CONSENSUS_OVERRIDES).value == 1


def test_watchdog_diagnoses_a_stall_and_aborts_after_a_beat(caplog):
    fired = threading.Event()
    registry = telemetry.MetricsRegistry()
    with caplog.at_level(logging.ERROR, logger="dtm"):
        dog = resilience.ProgressWatchdog(0.05, registry=registry,
                                          abort=True, abort_fn=fired.set,
                                          poll_s=0.01)
        try:
            time.sleep(0.2)
            assert not fired.is_set()  # no beat yet: never abort
            dog.beat(1)
            assert fired.wait(2.0)
        finally:
            dog.stop()
    assert "no training progress" in caplog.text
    assert registry.gauge(telemetry.WATCHDOG_LAST_PROGRESS).value > 0


def test_watchdog_abort_disabled_off_the_main_thread(caplog):
    made = []
    with caplog.at_level(logging.WARNING, logger="dtm"):
        t = threading.Thread(target=lambda: made.append(
            resilience.ProgressWatchdog(60.0, abort=True)))
        t.start()
        t.join()
    made[0].stop()
    assert not made[0]._abort
    assert "watchdog abort disabled" in caplog.text


def test_fit_runs_under_the_watchdog(straight):
    result = trainlib.fit(_cfg(watchdog_timeout_s=300.0), device="cpu")
    assert _same_state(result.state, straight.state)


def test_chaos_is_not_ported():
    """Chaos is ported now (``tests/test_torch_chaos.py``): a config with
    a fault builds, and so does one with a pipe axis (ported since
    pipeline parallelism); the rest of the fleet (the serving autoscaler,
    ported with the server) asks for its workdir like the JAX one."""
    from distributed_tensorflow_models_tpu_torch import launch

    cfg = tconfig.get_config("lenet_mnist", chaos={"nan_at_step": 3})
    assert cfg.chaos == {"nan_at_step": 3}
    assert tconfig.get_config("lenet_mnist", mesh_pipe=2).mesh_pipe == 2
    with pytest.raises(TypeError, match="workdir"):
        launch.FleetAutoscaler()
