"""The port's cold start (``harness/startup.py`` and ``fit``'s use of it)
against the JAX package's contracts, on the CPU.

- ``dominant_chunk_len`` equals JAX's over a table of configs, exactly.
- ``abstract_batch`` gives the shapes and dtypes of the chunks ``fit``'s
  pipeline produces, and the FLOPs count the startup thread takes on it is
  the one the step takes on the live batch.
- The kernel build cache resolves ``xla_cache_dir`` as documented; the
  CLI's ``--xla-cache-dir`` and ``--aot-compile/--no-aot-compile`` reach
  the config.
- ``fit`` with the startup thread equals ``fit`` without it bit for bit,
  fresh and resumed, and stamps its real duration.
- The heartbeat stays fresh, in phase ``restore``, through a slow restore.
- An error of the thread (a kernel that fails to build) reaches ``fit``'s
  caller; a failing FLOPs count does not fail the run.

Off CUDA no kernel library loads (every wrapper takes its plain version),
so here the thread runs the FLOPs count; ``tests/test_torch_gpu.py`` holds
the kernel loads under the restore on the card.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import startup as jstartup
from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import startup
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.ops import _kernels
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops import conv_mxu
from distributed_tensorflow_models_tpu_torch.resilience import heartbeat

# (steps_per_loop, train_steps, log_every_steps, checkpoint_every_steps,
#  preempt_poll_steps, processes)
CHUNK_TABLE = [
    (16, 1000, 8, None, 20, 1), (16, 1000, 8, 2, 20, 1),
    (16, 1000, 8, None, 4, 2), (16, 1000, 8, None, 4, 1),
    (16, 1000, 0, None, 20, 1), (16, 3, 8, None, 20, 1),
    (1, 1000, 100, None, 20, 1), (4, 11, 100, 4, 20, 1),
    (8, 64, 5, 3, 2, 4), (32, 100, -1, 7, 20, 2), (5, 5, 5, 5, 5, 8),
]


@pytest.mark.parametrize("spl,steps,log,ckpt,poll,nproc", CHUNK_TABLE)
def test_dominant_chunk_len_equals_jax(spl, steps, log, ckpt, poll, nproc):
    over = dict(steps_per_loop=spl, train_steps=steps, log_every_steps=log,
                checkpoint_every_steps=ckpt, preempt_poll_steps=poll)
    for name in ("lenet_mnist", "transformer_lm"):
        want = jstartup.dominant_chunk_len(
            jconfig.get_config(name, **over), nproc)
        assert startup.dominant_chunk_len(
            tconfig.get_config(name, **over), nproc) == want, name


def test_dominant_chunk_len_is_fits_first_chunk():
    """Without a step-cadence checkpoint or a multi-process poll, fit's
    first chunk has the dominant length."""
    for spl, steps, log in ((16, 1000, 8), (4, 3, 100), (8, 64, 5)):
        cfg = tconfig.get_config("lenet_mnist", steps_per_loop=spl,
                                 train_steps=steps, log_every_steps=log)
        assert trainlib._chunk_len(0, cfg) == startup.dominant_chunk_len(cfg)


@pytest.mark.parametrize("name,over", [
    ("lenet_mnist", dict(global_batch_size=8)),
    ("resnet32_cifar10", dict(global_batch_size=4)),
    ("resnet50_synthetic_tiny", {}),
    ("transformer_lm_tiny", {}),
    ("ptb_small", dict(global_batch_size=4)),
])
def test_abstract_batch_matches_the_live_chunk(name, over):
    """The chunk fit's pipeline stacks (HostPipeline, the prefetcher,
    BatchStacker) against ``stacked_batch(abstract_batch)``: keys, shapes
    and dtypes; and the FLOPs of one step on its meta row equal the count
    on the live row."""
    cfg = tconfig.get_config(name, steps_per_loop=2, **over)
    mesh = meshlib.local_mesh("cpu")
    host = pipelib.HostPipeline(trainlib.build_dataset(cfg, mesh=mesh),
                                prefetch=2)
    batches = pipelib.DevicePrefetcher(host, torch.device("cpu"), depth=1)
    try:
        chunk, k = pipelib.BatchStacker(batches).next_chunk(2)
    finally:
        batches.stop()
        host.stop()
    spec = startup.stacked_batch(startup.abstract_batch(cfg, mesh), k)
    assert {key: (tuple(v.shape), v.dtype) for key, v in spec.items()} == {
        key: (tuple(v.shape), v.dtype) for key, v in chunk.items()}
    assert startup.signature(spec) == startup.signature(chunk)
    assert all(v.device.type == "meta" for v in spec.values())
    if name != "resnet32_cifar10":
        count = trainlib.step_flops_fn(cfg, mesh)
        trainlib._STEP_FLOPS.clear()
        meta = count({key: v[0] for key, v in spec.items()})
        trainlib._STEP_FLOPS.clear()
        assert count({key: v[0] for key, v in chunk.items()}) == meta > 0


def test_abstract_batch_unknown_dataset_is_none():
    cfg = tconfig.get_config("lenet_mnist").replace(dataset="exotic")
    assert startup.abstract_batch(cfg) is None
    lm = tconfig.get_config("transformer_lm_tiny").replace(dataset="wiki")
    assert startup.abstract_batch(lm) is None


@pytest.fixture
def build_dir():
    """Leave the process's kernel build directory as it was."""
    before, persistent = _kernels.BUILD_DIR, startup._persistent
    yield
    _kernels.set_build_dir(before)
    startup._persistent = persistent


def test_apply_compile_cache_resolution(tmp_path, build_dir):
    _kernels.set_build_dir(_kernels.DEFAULT_BUILD_DIR)
    assert startup.apply_compile_cache(None) == str(
        _kernels.DEFAULT_BUILD_DIR)
    explicit = str(tmp_path / "cache-x")
    assert startup.apply_compile_cache(explicit) == explicit
    assert _kernels.BUILD_DIR == tmp_path / "cache-x"
    # An explicit setting stays in force for a later None.
    assert startup.apply_compile_cache(None) == explicit
    # "" keeps no persistent cache: a fresh temporary directory.
    assert startup.apply_compile_cache("") is None
    assert startup.configured_cache_dir() is None
    tmp = _kernels.BUILD_DIR
    assert tmp.is_dir() and tmp != tmp_path / "cache-x"
    assert not list(tmp.iterdir())
    # None after "" returns to the default.
    assert startup.apply_compile_cache(None) == str(
        _kernels.DEFAULT_BUILD_DIR)


def test_cache_entry_count(tmp_path):
    assert startup.cache_entry_count(None) == 0
    assert startup.cache_entry_count(str(tmp_path / "missing")) == 0
    (tmp_path / "a_0123.so").write_bytes(b"")
    (tmp_path / "a_0123.1.tmp").write_bytes(b"")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b_4567.so").write_bytes(b"")
    assert startup.cache_entry_count(str(tmp_path)) == 2


def test_kernel_loaders_follow_the_models_routes():
    with torch.device("meta"):
        r50 = get_model("resnet50", conv_impl="mxu")
        r50_xla = get_model("resnet50", conv_impl="xla")
        lenet = get_model("lenet", conv_impl="mxu")
        flash = get_model("transformer_lm", attn_impl="flash", num_layers=1)
        auto = get_model("transformer_lm", num_layers=1)
    assert startup.kernel_loaders(r50, "cuda") == {
        "conv_implicit_gemm.cu": conv_mxu._load}
    assert startup.kernel_loaders(r50, "cpu") == {}
    assert startup.kernel_loaders(r50_xla, "cuda") == {}
    # LeNet's convs have one and six input channels: patches, no K1.
    assert startup.kernel_loaders(lenet, "cuda") == {}
    assert startup.kernel_loaders(flash, "cuda") == {
        "flash_attention.cu": attnlib._load}
    assert startup.kernel_loaders(auto, torch.device("cuda:0")) == {}


def _chunk():
    return startup.stacked_batch(
        {"image": torch.empty(2, 4, device="meta")}, 3)


def test_aot_train_step_acquire_contract():
    done = []

    def slow():
        time.sleep(0.3)
        done.append(True)

    reg = telemetry.MetricsRegistry()
    reg.trace = telemetry.Tracer(capacity=64)
    aot = startup.AotTrainStep(_chunk(), loaders={"slow.cu": slow},
                               flops_of=lambda row: 7.0, registry=reg).start()
    wrong = startup.signature(startup.stacked_batch(
        {"image": torch.empty(2, 5, device="meta")}, 3))
    t0 = time.perf_counter()
    assert aot.acquire(wrong) is None
    assert time.perf_counter() - t0 < 0.2 and not done
    wait = aot.acquire(startup.signature(_chunk()))
    assert done and wait > 0.0
    assert aot.acquire(startup.signature(_chunk())) is None
    assert reg.snapshot()["startup/aot_compile_s"] >= wait
    assert {e["name"] for e in reg.trace.events()} >= {
        "startup/kernel_load", "startup/flops_count", "startup/aot_join",
        "startup/aot_compile"}
    aot.join()
    off = startup.AotTrainStep(_chunk(), loaders={}).start()
    off.disable()
    assert off.acquire(startup.signature(_chunk())) is None
    off.join(timeout=5.0)


def test_aot_train_step_raises_a_failed_build():
    def broken():
        raise RuntimeError("nvcc failed for broken.cu (2)")

    aot = startup.AotTrainStep(_chunk(), loaders={
        "fine.cu": lambda: None, "broken.cu": broken}).start()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        aot.acquire(startup.signature(_chunk()))
    aot.join()


def test_cli_startup_knob_overrides(tmp_path, build_dir, capsys):
    out = cli._overrides(SimpleNamespace(xla_cache_dir="/tmp/c",
                                         aot_compile=False, batch_size=None))
    assert out == {"xla_cache_dir": "/tmp/c", "aot_compile": False}
    assert cli._overrides(SimpleNamespace(aot_compile=True)) == {
        "aot_compile": True}
    cache = str(tmp_path / "kernels")
    for flag, want in (("--no-aot-compile", 0.0), ("--aot-compile", None)):
        wd = tmp_path / flag
        assert cli.main(["train", "--config", "lenet_mnist", "--workdir",
                         str(wd), "--train-steps", "2", "--batch-size", "8",
                         "--device", "cpu", flag, "--xla-cache-dir",
                         cache]) == 0
        assert str(_kernels.BUILD_DIR) == cache
        got = json.load(open(wd / "telemetry.json"))["startup"]
        if want is None:
            assert got["aot_compile_s"] > 0.0
        else:
            assert got["aot_compile_s"] == want
    capsys.readouterr()


def _state_equal(a, b):
    for coll in ("params", "batch_stats", "opt_state"):
        x, y = dict(getattr(a, coll)), dict(getattr(b, coll))
        assert sorted(x) == sorted(y), coll
        for key in x:
            xv, yv = x[key], y[key]
            if isinstance(xv, torch.Tensor):
                assert torch.equal(xv, yv), (coll, key)


def test_fit_aot_on_equals_off_bit_for_bit(tmp_path):
    """LeNet 4 steps in chunks of 2 with a checkpoint every 2, then resumed
    to 6 from step 4's checkpoint (the thread runs under a real restore):
    on and off end equal, losses and state; the thread's duration is
    stamped with it on, 0 with it off; no capture on the CPU, so no
    compile event."""
    cfg = tconfig.get_config("lenet_mnist", train_steps=4,
                             global_batch_size=8, log_every_steps=2,
                             steps_per_loop=2, checkpoint_every_steps=2,
                             checkpoint_every_secs=10_000.0)
    runs = {}
    for on in (True, False):
        wd = str(tmp_path / str(on))
        c = cfg.replace(aot_compile=on)
        first = trainlib.fit(c, wd, device="cpu")
        resumed = trainlib.fit(c.replace(train_steps=6), wd, device="cpu")
        assert resumed.restored_from == 4
        rep = json.load(open(f"{wd}/telemetry.json"))
        runs[on] = (first, resumed, rep)
    (f_on, r_on, rep_on), (f_off, r_off, rep_off) = runs[True], runs[False]
    assert [h["loss"] for h in f_on.history] == [
        h["loss"] for h in f_off.history]
    assert [h["loss"] for h in r_on.history] == [
        h["loss"] for h in r_off.history]
    _state_equal(r_on.state, r_off.state)
    assert rep_on["startup"]["aot_compile_s"] > 0.0
    assert rep_off["startup"]["aot_compile_s"] == 0.0
    assert rep_on["compile_events"] == rep_off["compile_events"] == 0
    assert rep_on["flops_per_step"] == rep_off["flops_per_step"] > 0
    names = {e["name"] for e in r_on.registry.trace.events()}
    assert {"startup/aot_compile", "startup/flops_count", "startup/aot_join",
            "fit/restore", "fit/build_state"} <= names
    assert "startup/aot_compile" not in {
        e["name"] for e in r_off.registry.trace.events()}


def test_heartbeat_stays_fresh_through_a_slow_restore(tmp_path, monkeypatch):
    """A 0.6 s restore (12 beats of the writer's 0.05 s) under fit with
    the startup thread running: the heartbeat file is at most 0.25 s old
    throughout, in phase ``restore`` (after the writer's first interval),
    not looping yet (step -1); after the run it is in phase ``train`` at
    the last step."""
    hb_dir = str(tmp_path / "hb")
    writer = heartbeat.HeartbeatWriter(hb_dir, 0, interval_s=0.05).start()
    monkeypatch.setattr(heartbeat, "_writer", writer)
    seen = []
    restore = ckptlib.restore_or_init

    def slow_restore(manager, state):
        t0 = time.monotonic()
        while time.monotonic() < t0 + 0.6:
            view = heartbeat.read_fleet(hb_dir, 1)[0]
            if view is not None:
                seen.append((time.monotonic() - t0, view["age_s"],
                             view["phase"], view["step"]))
            time.sleep(0.05)
        return restore(manager, state)

    monkeypatch.setattr(trainlib.ckptlib, "restore_or_init", slow_restore)
    try:
        cfg = tconfig.get_config("lenet_mnist", train_steps=2,
                                 global_batch_size=8, log_every_steps=2,
                                 steps_per_loop=2)
        trainlib.fit(cfg, str(tmp_path / "wd"), device="cpu")
        time.sleep(0.15)
        final = heartbeat.read_fleet(hb_dir, 1)[0]
    finally:
        writer.stop()
    assert len(seen) >= 8
    assert max(age for _, age, _, _ in seen) <= 0.25
    # The file shows the phase the writer last persisted: "restore" from
    # one write interval after the restore began.
    assert {phase for t, _, phase, _ in seen if t >= 0.15} == {"restore"}
    assert {step for _, _, _, step in seen} == {-1}
    assert (final["phase"], final["step"]) == ("train", 2)


def test_a_failed_kernel_build_in_the_thread_reaches_fits_caller(
        tmp_path, monkeypatch):
    """The thread's build error is raised by fit (never a fall back to the
    plain versions), and the thread is reaped."""
    def broken():
        raise RuntimeError("nvcc failed for flash_attention.cu (1): "
                           "injected")

    monkeypatch.setattr(startup, "kernel_loaders",
                        lambda model, device: {"flash_attention.cu": broken})
    cfg = tconfig.get_config("lenet_mnist", train_steps=2,
                             global_batch_size=8, steps_per_loop=2)
    with pytest.raises(RuntimeError, match="injected"):
        trainlib.fit(cfg, str(tmp_path), device="cpu")
    # Off, the same config trains (nothing of the thread runs).
    result = trainlib.fit(cfg.replace(aot_compile=False), device="cpu")
    assert result.state.step == 2


def test_a_failed_flops_count_in_the_thread_does_not_fail_fit(monkeypatch):
    """The FLOPs count is telemetry: failing on the thread it is logged and
    the step counts again (and counts 0 if that fails too), as without the
    thread."""
    def broken(cfg, mesh):
        def count(batch):
            raise RuntimeError("injected count failure")
        return count

    monkeypatch.setattr(trainlib, "step_flops_fn", broken)
    cfg = tconfig.get_config("lenet_mnist", train_steps=2,
                             global_batch_size=8, steps_per_loop=2)
    result = trainlib.fit(cfg, device="cpu")
    assert result.state.step == 2
    assert np.isfinite(result.final_metrics["loss"])
