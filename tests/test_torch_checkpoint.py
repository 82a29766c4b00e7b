"""The port's checkpoint/resume (``harness/checkpoint.py``), its fsck
(``resilience/fsck.py``) and ``fit``'s divergence rollback, on the CPU.

Against the JAX package, exactly: the dataset state a checkpoint saves
after N steps equals the JAX dataset's ``get_state()`` after the same N
batches (LeNet's MNIST stream, the PTB stream).  Port-internal, bit for
bit over every state tensor, ``device_step`` and ``step``: a run killed
at a chunk boundary and resumed ends where the straight run ends, on
LeNet (batch 32, 8 steps, the JAX package's ``tests/test_resilience.py``
run), ResNet-32 cut to one block a stage (BatchNorm statistics) and
``ptb_medium`` cut to hidden 16 (the carry, dropout), at
``steps_per_loop`` 1 and 4; walk-back past torn and non-finite steps,
fresh init when every step is torn, keep-k, idempotent and replacing
saves, sidecar fallback, a resume across a fleet resize (cursor and
carry re-split), restore in place and its refusals, rollback.  The
straight runs are made once per module.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.data import datasets as jdata
from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.resilience import fsck

STEPS = 8
CUTS = {
    "lenet_mnist": dict(global_batch_size=32),
    "resnet32_cifar10": dict(global_batch_size=8,
                             model_kwargs={"blocks_per_stage": 1}),
    "ptb_medium": dict(global_batch_size=4, num_steps=5, vocab_size=64,
                       model_kwargs={"config": "medium", "vocab_size": 64,
                                     "hidden_size": 16}),
}


def _cfg(name="lenet_mnist", **kw):
    base = dict(train_steps=STEPS, log_every_steps=2,
                checkpoint_every_secs=10_000.0, **CUTS[name])
    base.update(kw)
    return tconfig.get_config(name, **base)


@pytest.fixture(scope="module")
def straight():
    """The fault-free run of each model (``steps_per_loop`` 4; the
    trajectory is the same at any value), made on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = trainlib.fit(_cfg(name, steps_per_loop=4),
                                      device="cpu")
        return runs[name]

    return get


def assert_same_state(a, b):
    ta, pa = ckptlib.flatten_state(a)
    tb, pb = ckptlib.flatten_state(b)
    assert sorted(ta) == sorted(tb) and pa == pb
    for name in ta:
        assert ta[name].dtype == tb[name].dtype, name
        assert torch.equal(ta[name], tb[name]), name
    assert a.step == b.step == int(a.device_step) == int(b.device_step)


@pytest.mark.parametrize("spl", [1, 4])
@pytest.mark.parametrize("name", sorted(CUTS))
def test_killed_run_resumes_bit_identical(straight, tmp_path, name, spl):
    """Killed at step 4 (``FaultInjectionHook``; its crash-time save), then
    resumed: every state tensor, ``device_step``, ``step`` and the losses
    of steps 5-8 equal the straight run's."""
    cfg = _cfg(name, steps_per_loop=spl)
    with pytest.raises(RuntimeError, match="injected"):
        trainlib.fit(cfg, str(tmp_path), device="cpu",
                     extra_hooks=[hooklib.FaultInjectionHook(4)])
    resumed = trainlib.fit(cfg, str(tmp_path), device="cpu")
    want = straight(name)
    assert resumed.restored_from == 4
    assert [h["step"] for h in resumed.history] == [5, 6, 7, 8]
    assert [h["loss"] for h in resumed.history] == [
        h["loss"] for h in want.history[4:]]
    assert_same_state(resumed.state, want.state)


def test_kill_mid_chunk_resumes_at_the_next_batch(straight, tmp_path):
    """A fault at step 5 of chunks of 4 ends its chunk there; the resume
    reads batch 6 next (the saved cursor says 5 batches were consumed)."""
    cfg = _cfg(steps_per_loop=4, log_every_steps=100)
    with pytest.raises(RuntimeError, match="injected"):
        trainlib.fit(cfg, str(tmp_path), device="cpu",
                     extra_hooks=[hooklib.FaultInjectionHook(5)])
    data = json.loads((tmp_path / "checkpoints" / "5" / "data.json")
                      .read_text())
    assert data["dataset"] == {"epoch": 0, "batch_idx": 5}
    resumed = trainlib.fit(cfg, str(tmp_path), device="cpu")
    assert resumed.restored_from == 5
    assert [h["loss"] for h in resumed.history] == [
        h["loss"] for h in straight("lenet_mnist").history[5:]]
    assert_same_state(resumed.state, straight("lenet_mnist").state)


@pytest.mark.parametrize("name", ["lenet_mnist", "ptb_medium"])
def test_saved_dataset_state_equals_jax_after_the_same_batches(tmp_path,
                                                               name):
    cfg = _cfg(name, train_steps=4, steps_per_loop=4)
    trainlib.fit(cfg, str(tmp_path), device="cpu")
    saved = json.loads((tmp_path / "checkpoints" / "4" / "data.json")
                       .read_text())
    if name == "lenet_mnist":
        jds = jdata.mnist_dataset(cfg.global_batch_size, "train", cfg.seed)
    else:
        jds = jdata.ptb_dataset(cfg.global_batch_size, cfg.num_steps,
                                "train", cfg.vocab_size)
    it = iter(jds)
    for _ in range(4):
        next(it)
    assert saved == {"dataset": jds.get_state(), "__fleet__": {"nproc": 1}}


def _run_with_checkpoints(tmp_path, **kw):
    cfg = _cfg(steps_per_loop=4, checkpoint_every_steps=2, **kw)
    trainlib.fit(cfg, str(tmp_path), device="cpu")
    return cfg


def _rewrite_state(step_dir, edit):
    """Load a step's state.pt, edit it, write it back and fix the
    manifest's byte count, so that the step stays structurally valid."""
    path = step_dir / "state.pt"
    flat = torch.load(path, weights_only=True)
    edit(flat)
    torch.save(flat, path)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    manifest["files"]["state.pt"] = path.stat().st_size
    (step_dir / "manifest.json").write_text(json.dumps(manifest))


@pytest.mark.parametrize("damage", ["torn", "non-finite"])
def test_resume_walks_back_past_a_bad_newest_step(straight, tmp_path,
                                                  damage):
    """The newest step (8) truncated, or holding a NaN (a crash-time save
    after a divergence): the resume restores step 6, trains 7 and 8 and
    ends bit-identical; the final save replaces the torn step."""
    cfg = _run_with_checkpoints(tmp_path)
    step8 = tmp_path / "checkpoints" / "8"
    if damage == "torn":
        with open(step8 / "state.pt", "r+b") as f:
            f.truncate(1000)
        assert fsck.validate_step_dir(str(step8))
    else:
        _rewrite_state(step8, lambda flat: flat["params/Dense_0.kernel"]
                       .view(-1)[3].fill_(float("nan")))
        assert not fsck.validate_step_dir(str(step8))
    resumed = trainlib.fit(cfg, str(tmp_path), device="cpu")
    assert resumed.restored_from == 6
    assert_same_state(resumed.state, straight("lenet_mnist").state)
    assert fsck.fsck_checkpoints(str(tmp_path / "checkpoints"))[
        "newest_valid_step"] == 8


def test_fresh_init_when_every_step_is_torn(straight, tmp_path, caplog):
    cfg = _run_with_checkpoints(tmp_path)
    for step in fsck.list_steps(str(tmp_path / "checkpoints")):
        (tmp_path / "checkpoints" / str(step) / "COMMITTED").unlink()
    with caplog.at_level("ERROR", logger="dtm"):
        again = trainlib.fit(cfg, str(tmp_path), device="cpu")
    assert again.restored_from is None
    assert "none are restorable" in caplog.text
    assert_same_state(again.state, straight("lenet_mnist").state)


def _state(cfg=None):
    cfg = cfg or _cfg()
    return trainlib.build_state(cfg, torch.device("cpu"))


def _manager(tmp_path, **kw):
    return ckptlib.CheckpointManager(str(tmp_path), registry=kw.pop(
        "registry", telemetry.MetricsRegistry()), **kw)


def test_restore_is_in_place(tmp_path):
    """Restore copies into the live tensors: each keeps its storage
    (``data_ptr``) and takes the saved values; ``step`` is set."""
    saved = _state()
    with torch.no_grad():
        for t in saved.params.values():
            t.add_(1.0)
        saved.device_step.fill_(3)
    mgr = _manager(tmp_path)
    assert mgr.save(saved.replace(step=3), {"dataset": {"epoch": 0,
                                                         "batch_idx": 3}})
    mgr.wait()
    live = _state()
    before = {k: t.data_ptr() for k, t in
              ckptlib.flatten_state(live)[0].items()}
    state, data = mgr.restore(live)
    assert state.step == 3 and data == {"dataset": {"epoch": 0,
                                                    "batch_idx": 3}}
    after = ckptlib.flatten_state(state)[0]
    assert {k: t.data_ptr() for k, t in after.items()} == before
    assert all(state.params[k] is live.params[k] for k in live.params)
    assert_same_state(state, saved.replace(step=3))


@pytest.mark.parametrize("change", ["shape", "dtype", "name"])
def test_restore_refuses_a_mismatch(tmp_path, change):
    mgr = _manager(tmp_path)
    mgr.save(_state())
    mgr.wait()
    live = _state()
    key = "Dense_0.kernel"
    t = live.params[key]
    if change == "shape":
        live.params[key] = torch.zeros(t.shape[0] + 1, *t.shape[1:])
    elif change == "dtype":
        live.params[key] = t.detach().double()
    else:
        live.params["extra"] = torch.zeros(2)
    with pytest.raises(ckptlib.CheckpointMismatchError):
        mgr.restore(live)
    # The walk does not step past a mismatch: every step would differ.
    with pytest.raises(ckptlib.CheckpointMismatchError):
        ckptlib.restore_or_init(mgr, live)


def test_opt_state_leaf_that_is_not_data_raises(tmp_path):
    state = _state()
    state = state.replace(opt_state={**state.opt_state, "fn": print})
    with pytest.raises(TypeError, match="opt_state/fn"):
        _manager(tmp_path).save(state)


def test_save_at_an_existing_step_is_idempotent_and_a_torn_one_replaced(
        tmp_path):
    mgr = _manager(tmp_path)
    state = _state()
    assert mgr.save(state)
    assert not mgr.save(state)  # being written, or written: skipped
    mgr.wait()
    assert not mgr.save(state)
    step0 = tmp_path / "checkpoints" / "0"
    (step0 / "manifest.json").unlink()
    assert mgr.save(state)
    mgr.wait()
    assert not fsck.validate_step_dir(str(step0))
    assert mgr.all_steps() == [0]


def test_keeps_the_newest_k(tmp_path):
    mgr = _manager(tmp_path, keep=2)
    state = _state()
    for step in range(1, 6):
        mgr.save(state.replace(step=step))
        mgr.wait()
    assert mgr.all_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["4", "5"]
    assert [e["step"] for e in mgr.save_log] == [1, 2, 3, 4, 5]
    assert all(e["bytes"] > 0 and e["write_s"] >= 0 for e in mgr.save_log)


def test_corrupt_sidecar_falls_back_to_the_primary_and_is_counted(tmp_path):
    """Two processes' managers in one process (no collectives: the
    consensus is the live one, a world of one): process 1 writes its
    sidecar, the chief the step and its own; process 1 restores its own
    position, and with its sidecar torn, the primary's, counting the
    fallback."""
    state = _state()
    registry = telemetry.MetricsRegistry()
    peer = _manager(tmp_path, process_index=1, process_count=2,
                    registry=registry)
    chief = _manager(tmp_path, process_index=0, process_count=2)
    # Process 1 first: it finds no step 2 (the decision a fleet agrees on
    # before anyone writes), then the chief writes the step.
    for mgr, position in ((peer, 7), (chief, 2)):
        assert mgr.save(state.replace(step=2),
                        {"dataset": {"epoch": 0, "batch_idx": position}})
        mgr.wait()
    side = tmp_path / "checkpoints" / "dataset_states" / "2"
    assert sorted(os.listdir(side)) == ["p0.json", "p1.json"]
    assert fsck.fleet_sidecars_complete(str(tmp_path / "checkpoints"), 2, 2)
    _, data = peer.restore(_state())
    assert data == {"dataset": {"epoch": 0, "batch_idx": 7}}
    (side / "p1.json").write_text("{torn")
    _, data = peer.restore(_state())
    assert data == {"dataset": {"epoch": 0, "batch_idx": 2}}
    assert registry.counter(telemetry.CKPT_SIDECAR_FALLBACKS).value == 1


def test_fsck_reports_and_repairs(tmp_path, capsys):
    _run_with_checkpoints(tmp_path)
    assert fsck.main([str(tmp_path)]) == 0
    assert "restore target: step 8" in capsys.readouterr().out
    with open(tmp_path / "checkpoints" / "8" / "state.pt", "r+b") as f:
        f.truncate(10)
    assert fsck.main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "TORN" in out and "WALK BACK" in out and "newest valid is 6" in out
    assert fsck.main([str(tmp_path), "--repair", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["repaired_steps"] == [8]
    assert report["newest_valid_step"] == report["latest_step"] == 6


class _PoisonAt:
    """The dataset's batches, with the image of the batch after which the
    cursor reads ``after`` set to NaN (by position, so a replay poisons
    the same batch)."""

    def __init__(self, ds, after):
        self._ds, self._after = ds, after

    def __iter__(self):
        for batch in self._ds:
            if self._ds.get_state() == self._after:
                batch = dict(batch)
                batch["image"] = np.full_like(batch["image"], np.nan)
            yield batch

    def get_state(self):
        return self._ds.get_state()

    def set_state(self, state):
        self._ds.set_state(state)


class _DropAt(_PoisonAt):
    """The dataset without the batches after which the cursor reads one of
    ``after``: the batches a rollback skips."""

    def __iter__(self):
        for batch in self._ds:
            if self._ds.get_state() not in self._after:
                yield batch


@pytest.fixture
def poison_batch_6(monkeypatch):
    """Poisons batch 6 of ``fit``'s dataset; gives the unpatched
    ``build_dataset``."""
    build = trainlib.build_dataset
    monkeypatch.setattr(
        trainlib, "build_dataset",
        lambda cfg, split="train", mesh=None: _PoisonAt(
            build(cfg, split, mesh), {"epoch": 0, "batch_idx": 6}))
    return build


def test_rollback_skips_exactly_the_offending_chunk(tmp_path, monkeypatch,
                                                    poison_batch_6):
    """Batch 6 poisoned, chunks of 2 (the log cadence): the chunk of steps
    5-6 diverges, the run restores step 4 in place, discards exactly that
    chunk's two batches on replay and ends at step 8, the state finite and
    equal bit for bit, with every loss, to a straight run over the dataset
    without batches 5 and 6."""
    cfg = _cfg(steps_per_loop=4, checkpoint_every_steps=2,
               nan_policy="rollback")
    result = trainlib.fit(cfg, str(tmp_path), device="cpu")
    build = poison_batch_6
    monkeypatch.setattr(
        trainlib, "build_dataset",
        lambda cfg, split="train", mesh=None: _DropAt(
            build(cfg, split, mesh), [{"epoch": 0, "batch_idx": i}
                                      for i in (5, 6)]))
    without = trainlib.fit(cfg.replace(nan_policy="abort"), device="cpu")
    assert_same_state(result.state, without.state)
    assert ([h["loss"] for h in result.history]
            == [h["loss"] for h in without.history])
    assert (result.rollbacks, result.skipped_batches) == (1, 2)
    snap = result.registry.snapshot()
    assert snap[telemetry.ROLLBACKS] == 1
    assert snap[telemetry.SKIPPED_BATCHES] == 2
    assert [h["step"] for h in result.history] == list(range(1, 9))
    assert all(np.isfinite(h["loss"]) for h in result.history)
    assert result.state.step == 8 and train_loop.state_is_finite(
        result.state)
    data = json.loads((tmp_path / "checkpoints" / "8" / "data.json")
                      .read_text())
    assert data["dataset"] == {"epoch": 0, "batch_idx": 10}


def test_a_failed_rollback_saves_no_checkpoint(tmp_path, monkeypatch,
                                              poison_batch_6):
    """A rollback that fails after it closed the pipeline (here its restore
    raises) leaves no cursor that belongs to the state: the crash-time
    save writes nothing, so no step 6 pairs the diverged state with the
    producer's read-ahead."""
    def refuse(self, *args, **kwargs):
        raise ckptlib.CheckpointMismatchError("refused")

    monkeypatch.setattr(ckptlib.CheckpointManager, "restore_newest_valid",
                        refuse)
    cfg = _cfg(steps_per_loop=4, checkpoint_every_steps=2,
               nan_policy="rollback")
    with pytest.raises(ckptlib.CheckpointMismatchError):
        trainlib.fit(cfg, str(tmp_path), device="cpu")
    manager = ckptlib.CheckpointManager(str(tmp_path))
    assert manager.all_steps() == [0, 2, 4]


def test_rollback_budget_exhausts(tmp_path, monkeypatch):
    """Every batch from the 5th on poisoned: each rollback meets a new
    divergence, and the run raises once its budget of 1 is spent."""
    build = trainlib.build_dataset

    class _Always(_PoisonAt):
        def __iter__(self):
            for batch in self._ds:
                if self._ds.get_state()["batch_idx"] >= 5:
                    batch = dict(batch, image=np.full_like(batch["image"],
                                                           np.nan))
                yield batch

    monkeypatch.setattr(trainlib, "build_dataset",
                        lambda cfg, split="train", mesh=None: _Always(
                            build(cfg, split, mesh), None))
    cfg = _cfg(steps_per_loop=4, checkpoint_every_steps=2,
               nan_policy="rollback", rollback_budget=1)
    with pytest.raises(FloatingPointError):
        trainlib.fit(cfg, str(tmp_path), device="cpu")


def test_abort_is_the_default_nan_policy(tmp_path, poison_batch_6):
    cfg = _cfg(steps_per_loop=4, checkpoint_every_steps=2)
    assert cfg.nan_policy == "abort"
    with pytest.raises(FloatingPointError, match="step 6"):
        trainlib.fit(cfg, str(tmp_path), device="cpu")


def test_rollback_needs_a_workdir():
    with pytest.raises(ValueError, match="workdir"):
        trainlib.fit(_cfg(nan_policy="rollback"), device="cpu")


def test_state_is_finite():
    """Every float tensor of the state counts: a parameter, a BatchNorm
    statistic or an optimizer slot (ResNet-32: momentum) holding an inf or
    a NaN makes it non-finite."""
    state = _state(_cfg("resnet32_cifar10"))
    assert train_loop.state_is_finite(state)
    leaves = [next(iter(state.params.values())),
              next(iter(state.batch_stats.values())),
              next(t for t in train_loop._leaves(state.opt_state)
                   if t.is_floating_point())]
    for leaf in leaves:
        for bad in (float("inf"), float("nan")):
            with torch.no_grad():
                old = leaf.view(-1)[0].clone()
                leaf.view(-1)[0] = bad
                assert not train_loop.state_is_finite(state)
                leaf.view(-1)[0] = old
    assert train_loop.state_is_finite(state)


def _ptb_state(rank=0, nproc=1, fill=None):
    """The cut ptb_medium's state as process ``rank`` of ``nproc`` builds
    it (its carry at its rows of the global batch of 4), the carry filled
    with ``fill`` + the row index."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib

    mesh = meshlib.Mesh((nproc, 1, 1, 1, 1), rank, nproc,
                        torch.device("cpu"))
    state = trainlib.build_state(_cfg("ptb_medium"), torch.device("cpu"),
                                 mesh)
    if fill is not None:
        for leaf in train_loop._leaves(state.carry):
            rows = torch.arange(leaf.shape[0], dtype=leaf.dtype)
            leaf.copy_((fill + rows)[:, None].expand_as(leaf))
    return state


def test_resume_across_a_fleet_resize_resplits_cursor_and_carry(tmp_path):
    """A step written by two processes (each its carry rows, sidecar and
    cursor) restored by one: the carry is both processes' rows in process
    order, the cursor the fleet-minimum sidecar's, the crossing counted
    and audited in ``resize_ledger.json``; then that one-process step
    restored as process 1 of 2 takes rows 2-3 of the carry back."""
    registry = telemetry.MetricsRegistry()
    cursors = {1: {"epoch": 0, "pos": 20}, 0: {"epoch": 0, "pos": 15}}
    for pid in (1, 0):
        mgr = _manager(tmp_path, process_index=pid, process_count=2)
        assert mgr.save(_ptb_state(pid, 2, fill=10.0 * (pid + 1))
                        .replace(step=4), {"dataset": cursors[pid]})
        mgr.wait()
    one = _manager(tmp_path, registry=registry)
    live = _ptb_state()
    state, data = one.restore(live)
    assert state.step == 4 and data == {"dataset": cursors[0]}
    for leaf in train_loop._leaves(state.carry):
        assert leaf[:, 0].tolist() == [10.0, 11.0, 20.0, 21.0]
    assert one.last_resize == {"step": 4, "from_nproc": 2, "to_nproc": 1,
                               "source_pid": 0}
    assert registry.counter(telemetry.CKPT_RESIZE_RESTORES).value == 1
    ledger = json.loads((tmp_path / "checkpoints" / "dataset_states" / "4"
                         / ckptlib.RESIZE_LEDGER).read_text())
    assert (ledger["source_pid"], ledger["adopted_position"]) == (0, [0, 15])
    saved = _manager(tmp_path / "one")
    saved.save(state.replace(step=6), {"dataset": {"epoch": 0, "pos": 30}})
    saved.wait()
    two = _manager(tmp_path / "one", process_index=1, process_count=2)
    back, data = two.restore(_ptb_state(1, 2))
    assert back.step == 6 and data == {"dataset": {"epoch": 0, "pos": 30}}
    for leaf in train_loop._leaves(back.carry):
        assert leaf[:, 0].tolist() == [20.0, 21.0]
