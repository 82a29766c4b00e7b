"""The port's launcher (``launch.py``): ``launch_local``, ``supervise_local``
and the CLI, on the CPU.

The contracts of the JAX package's ``tests/test_fleet.py`` launcher and
heartbeat cases, held on the port's launcher with children that are
plain ``sys.executable`` scripts importing no torch: a child's death or a
stale heartbeat tears the fleet down, attributed to its index; the
restart loop relaunches with attribution, gives up after
``max_restarts``, returns 75 without a restart and relaunches at
``resize_to`` (or one fewer with ``auto_resize``); the port's
``initialize_from_env`` beats before it imports torch; what the port does
not have raises.

One ``two_proc`` case runs the port's own training CLI under
``supervise_local(2, ...)`` on gloo with ``--chaos kill_at_step=2,
chaos_host=1``: process 1 SIGKILLs itself once, the fleet is torn down
and relaunched, resumes from its checkpoint and ends, bit for bit, at the
state of the unkilled two-process LeNet run of the session's
data-parallel cluster (``tests/test_torch_data_parallel.py``).
"""

import json
import os
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu_torch import launch
from distributed_tensorflow_models_tpu_torch.resilience import heartbeat
from test_torch_data_parallel import _free_port, cluster  # noqa: F401
import torch_data_parallel_worker as worker  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _child(tmp_path, body: str) -> list[str]:
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(body))
    return [sys.executable, str(script)]


def test_launch_local_tears_the_fleet_down_on_a_death(tmp_path, capfd):
    """Child 1 exits 3: the survivor is SIGTERM'd at once (its handler
    exits resumable) instead of the launcher waiting on it; every child
    sees its index as ``LOCAL_RANK``."""
    argv = _child(tmp_path, f"""
        import os, signal, sys, time
        pid = os.environ["DTM_PROCESS_ID"]
        assert os.environ["LOCAL_RANK"] == pid
        assert os.environ["DTM_NUM_PROCESSES"] == "2"
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
        open({str(tmp_path)!r} + "/up-" + pid, "w").close()
        if pid == "1":
            while not os.path.exists({str(tmp_path)!r} + "/up-0"):
                time.sleep(0.05)  # dies only once its peer listens
            sys.exit(3)
        time.sleep(120)
        """)
    t0 = time.monotonic()
    codes = launch.launch_local(2, argv, port=_free_port(), term_grace_s=5)
    assert time.monotonic() - t0 < 30
    assert codes == [75, 3]
    assert launch.aggregate_exit_codes(codes) == 3
    assert (tmp_path / "up-0").exists() and (tmp_path / "up-1").exists()
    err = capfd.readouterr().err
    assert "process 1 exited 3; terminating the rest of the fleet" in err


def test_launch_local_detects_a_stalled_child_by_heartbeat(tmp_path, capfd):
    """Process 1 beats once and freezes: the supervisor attributes the
    stall to it (last step and phase) and tears the fleet down."""
    argv = _child(tmp_path, """
        import json, os, signal, sys, time
        pid = os.environ["DTM_PROCESS_ID"]
        hb = os.environ["DTM_HEARTBEAT_DIR"]
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))

        def beat(step):
            path = os.path.join(hb, f"p{pid}.json")
            json.dump({"pid": os.getpid(), "time": time.time(),
                       "step": step, "phase": "train"},
                      open(path + ".tmp", "w"))
            os.replace(path + ".tmp", path)

        beat(1)
        if pid == "1":
            time.sleep(120)  # wedged: never beats again
        for step in range(2, 1000):
            beat(step)
            time.sleep(0.2)
        """)
    t0 = time.monotonic()
    codes = launch.launch_local(2, argv, port=_free_port(),
                                heartbeat_timeout=2.0, term_grace_s=3)
    assert time.monotonic() - t0 < 30
    assert codes[0] == 75 and codes[1] != 0
    err = capfd.readouterr().err
    assert "process 1 heartbeat stale" in err
    assert "last step 1, phase train" in err


def test_supervise_local_restarts_with_attribution(tmp_path, capfd):
    marker = tmp_path / "attempted"
    argv = _child(tmp_path, f"""
        import os, sys
        if os.environ["DTM_PROCESS_ID"] == "1":
            if not os.path.exists({str(marker)!r}):
                open({str(marker)!r}, "w").close()
                sys.exit(9)
        sys.exit(0)
        """)
    rc = launch.supervise_local(2, argv, max_restarts=2, backoff_base_s=0.0,
                                port=_free_port(), term_grace_s=3)
    assert rc == 0
    err = capfd.readouterr().err
    assert "process(es) [1] failed" in err
    assert "relaunching the whole fleet" in err


@pytest.mark.parametrize("code,restarts,want", [
    (7, 1, 7),  # gives up after max_restarts
    (75, 3, launch.RESUMABLE_EXIT_CODE),  # preempted: no restart
])
def test_supervise_local_gives_up_or_returns_preempted(tmp_path, capfd, code,
                                                       restarts, want):
    runs = tmp_path / "runs"
    argv = _child(tmp_path, f"""
        import os, sys
        open({str(runs)!r} + os.environ["DTM_COORDINATOR_ADDRESS"][-5:]
             + os.environ["DTM_PROCESS_ID"], "w").close()
        sys.exit({code})
        """)
    rc = launch.supervise_local(2, argv, max_restarts=restarts,
                                backoff_base_s=0.0, port=_free_port(),
                                term_grace_s=2)
    assert rc == want
    err = capfd.readouterr().err
    if code == 75:  # one launch, both children ran to their exit
        assert len(list(tmp_path.glob("runs*"))) == 2
        assert "relaunching" not in err
    else:  # a child torn down by its peer's failure may not have started
        assert err.count("relaunching the whole fleet") == restarts
        assert f"giving up after {restarts} restart(s)" in err


@pytest.mark.parametrize("kw", [{"resize_to": 1}, {"auto_resize": True}])
def test_supervise_local_relaunches_resized(tmp_path, capfd, kw):
    marker = tmp_path / "attempted"
    argv = _child(tmp_path, f"""
        import os, sys
        n = os.environ["DTM_NUM_PROCESSES"]
        pid = os.environ["DTM_PROCESS_ID"]
        open({str(tmp_path)!r} + f"/seen-{{n}}-{{pid}}", "w").close()
        if not os.path.exists({str(marker)!r}):
            if pid == "1":
                open({str(marker)!r}, "w").close()
            sys.exit(9 if pid == "1" else 0)
        sys.exit(0)
        """)
    rc = launch.supervise_local(2, argv, max_restarts=2, backoff_base_s=0.0,
                                port=_free_port(), term_grace_s=3, **kw)
    assert rc == 0
    assert "RESIZING 2 -> 1" in capfd.readouterr().err
    assert (tmp_path / "seen-2-1").exists()
    assert (tmp_path / "seen-1-0").exists()
    assert not (tmp_path / "seen-1-1").exists()


def test_what_the_port_does_not_have_raises(tmp_path):
    argv = [sys.executable, "-c", "pass"]
    with pytest.raises(ValueError, match="resize_to"):
        launch.supervise_local(2, argv, max_restarts=1, resize_to=0)
    with pytest.raises(ValueError, match="cpu_devices_per_process"):
        launch.launch_local(2, argv, cpu_devices_per_process=2)
    with pytest.raises(ValueError, match="cpu_devices_per_process"):
        launch.supervise_local(2, argv, cpu_devices_per_process=2)
    # The serving autoscaler is ported: it builds, and its first tick
    # commits the live fleet's size.
    ctl = launch.FleetAutoscaler(str(tmp_path), poll_interval_s=0.0)
    assert ctl.decide([0]) == 0
    assert json.load(open(tmp_path / "fleet_size.json"))["size"] == 1


def test_initialize_from_env_beats_before_torch(tmp_path):
    """A child that calls the port's ``initialize_from_env`` (no cluster
    facts: heartbeat only) beats within a second of its spawn, with torch
    still unimported; ``startup_stats`` stamps its first beat, its loop
    entry and, from the beat its writer leaves at exit, its first
    step."""
    argv = _child(tmp_path, f"""
        import os, sys, time
        sys.path.insert(0, {str(REPO)!r})
        del os.environ["DTM_COORDINATOR_ADDRESS"]
        from distributed_tensorflow_models_tpu_torch import launch
        assert launch.initialize_from_env() is False
        assert "torch" not in sys.modules
        from distributed_tensorflow_models_tpu_torch.resilience import (
            heartbeat)
        heartbeat.beat(0)
        time.sleep(1.2)  # one write of the 1 s writer carries step 0
        heartbeat.beat(1)  # the writer's last beat at exit carries it
        """)
    stats: dict = {}
    codes = launch.launch_local(1, argv, port=_free_port(),
                                startup_stats=stats)
    assert codes == [0]
    assert stats[0]["first_beat_s"] < 1.5
    assert stats[0]["loop_entry_s"] >= stats[0]["first_beat_s"]
    assert stats[0]["first_step_s"] > stats[0]["loop_entry_s"]
    assert heartbeat.ENV_HEARTBEAT_DIR == "DTM_HEARTBEAT_DIR"


def test_launch_cli(tmp_path):
    """``python -m distributed_tensorflow_models_tpu_torch.launch``: its
    aggregate exit code, and its usage errors."""
    argv = ["--num-processes", "2", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--term-grace", "2", "--",
            *_child(tmp_path, """
                import os, sys
                sys.exit(75 if os.environ["DTM_PROCESS_ID"] == "1" else 0)
                """)]
    assert launch.main(argv) == launch.RESUMABLE_EXIT_CODE
    with pytest.raises(SystemExit):
        launch.main(["--num-processes", "2"])
    with pytest.raises(SystemExit):
        launch.main(["--num-processes", "2", "--resize-to", "1", "--",
                     sys.executable, "-c", "pass"])


@pytest.mark.two_proc
def test_killed_fleet_resumes_to_the_unkilled_state(cluster, tmp_path,
                                                    capfd):
    """The port's training CLI as a two-process gloo fleet under the
    port's ``supervise_local``, checkpointing every step, with ``--chaos
    kill_at_step=2,chaos_host=1``: process 1 SIGKILLs itself once (the
    durable marker disarms the relaunch), the supervisor attributes the
    death to it, tears the fleet down and relaunches it; the fleet
    resumes and its final checkpoint equals, bit for bit, the unkilled
    run's state (the cluster's ``lenet_mnist`` case: same config, global
    batch, steps and thread count)."""
    case = worker.CASES["lenet_mnist"]
    wd = tmp_path / "wd"
    argv = [sys.executable, "-m",
            "distributed_tensorflow_models_tpu_torch.harness.cli", "train",
            "--config", "lenet_mnist", "--workdir", str(wd),
            "--batch-size", str(case.global_batch_size),
            "--train-steps", str(case.train_steps), "--device", "cpu",
            "--checkpoint-every-steps", "1", "--preempt-poll-steps", "1",
            "--chaos", "kill_at_step=2,chaos_host=1"]
    env = {"OMP_NUM_THREADS": "2", "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    rc = launch.supervise_local(2, argv, max_restarts=1, backoff_base_s=0.0,
                                port=_free_port(), term_grace_s=3,
                                extra_env=env, timeout=240)
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    assert "process 1 died on SIGKILL" in err
    assert "relaunch 1" in err  # the relaunch's startup milestones
    assert (wd / ".chaos_fired" / "kill_at_step").read_text() == "2"
    got = torch.load(wd / "checkpoints" / str(case.train_steps) / "state.pt",
                     weights_only=True)
    want = np.load(cluster / "lenet_mnist.npz")
    names = sorted(k for k in want.files
                   if k not in ("loss", "grad_norm", "batch_size"))
    assert sorted(f"state/{k}" for k in got) == names
    for k in names:
        np.testing.assert_array_equal(
            got[k[len("state/"):]].float().numpy(), want[k], err_msg=k)
    report = json.loads((wd / "telemetry.json").read_text())
    assert report["metrics"]["chaos/armed_unfired"] == 0.0
