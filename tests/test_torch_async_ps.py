"""The port's async-PS emulator (``parallel/async_ps.py``) against the JAX
package's, and against the port's own sync step.

The mirrors of the JAX package's async tests (``tests/test_parallel.py``):
one worker equals the sync step (here bit for bit, dropout on: the event's
generators are the step's); round robin at K = 4 ramps its staleness 0, 1,
2, 3 then holds K-1; a staleness limit drops events, which advance
nothing; the random schedule is seeded; the EMA shadows advance and a
state restored at step 100 starts its workers at staleness 0; stale
training still learns.  Each runs beside the JAX emulator on the same
weights (LeNet, dropout 0, L2 on, so that the forward *and* the L2 are
taken at the snapshot): the worker picks, the staleness logs and the
dropped flags must equal the JAX package's exactly, the parameters and
EMA shadows to ``STATE_TOL``.  A BN model (the cut ResNet-32) holds the
BatchNorm statistics of a run with dropped events to JAX's.

Across processes (``tests/torch_parallel_worker.py``, the 2-process gloo
cluster of ``tests/torch_parallel_cluster.py``): the emulator on a data
axis of two processes, and at ``mesh_model=2`` on the tiny transformer
with a clip that acts at every event, against one process at the global
batch: each event's loss within ``LOSS_ATOL``, its ``grad_norm`` to 1e-5
and the parameters to 1e-4, the staleness and drops exactly.
"""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

import torch_emulator_cases as cases
import torch_parallel_cluster
import torch_parallel_worker as worker
from distributed_tensorflow_models_tpu.parallel import async_ps as jasync
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.ops import optim
from distributed_tensorflow_models_tpu_torch.parallel import async_ps

jax.config.update("jax_platforms", "cpu")

LOSS_ATOL = 1e-3  # tests/test_torch_parallel_fit.py
WEIGHT_DECAY = 1e-3


def _emulators(case, num_workers, schedule="round_robin", seed=0,
               limit=None, **kw):
    tstate, tloss, jstate, jloss = cases.pair(case, **kw)
    cfg = dict(num_workers=num_workers, schedule=schedule, seed=seed,
               staleness_limit=limit)
    return (async_ps.AsyncPSEmulator(tstate, tloss,
                                     async_ps.AsyncConfig(**cfg)),
            jasync.AsyncPSEmulator(jstate, jloss, jasync.AsyncConfig(**cfg)))


def _run_both(temu, jemu, case, events, same_batch=None):
    trecs, jrecs = [], []
    for i in range(events):
        b = same_batch or cases.batch(case, seed=i)
        trecs.append(temu.step(cases.to_torch(b), 7))
        jrecs.append(jemu.step(b, jax.random.key(7)))
    return trecs, jrecs


def _same_host_decisions(trecs, jrecs):
    for key in ("worker", "staleness", "dropped"):
        assert [r[key] for r in trecs] == [r[key] for r in jrecs], key
    np.testing.assert_allclose(
        [float(r["metrics"]["loss"]) for r in trecs],
        [float(r["metrics"]["loss"]) for r in jrecs], **cases.STATE_TOL)


def test_async_one_worker_matches_sync_bit_for_bit():
    """K = 1 equals the port's own TrainStep on the same batches, bit for
    bit, LeNet's dropout on: the event's generators are seeded as the
    step's."""
    def build():
        model = get_model("lenet", generator=torch.Generator().manual_seed(1))
        return TrainState.create(model, optim.sgd(0.1, num_steps=8),
                                 ema_decay=0.9)

    estate, state = build(), build()
    emu = async_ps.AsyncPSEmulator(
        estate, train_loop.classification_loss_fn(estate.model),
        async_ps.AsyncConfig(num_workers=1))
    step = train_loop.make_train_step(
        train_loop.classification_loss_fn(state.model))
    for i in range(3):
        b = cases.to_torch(cases.batch("lenet", seed=i))
        rec = emu.step(b, 7)
        state, metrics = step(state, b, 7)
        assert torch.equal(rec["metrics"]["loss"], metrics["loss"])
    assert emu.staleness_log == [0, 0, 0] and emu.dropped == 0
    assert emu.state.step == state.step == 3
    for a, b in zip(cases.state_tensors(emu.state),
                    cases.state_tensors(state)):
        assert torch.equal(a, b)


def test_async_round_robin_staleness_matches_jax():
    """K = 4: staleness 0, 1, 2, 3, then K-1; the snapshots are copies
    (a snapshot that followed the canonical parameters would read 0 and
    match nothing), and the forward and the L2 run at the snapshot."""
    temu, jemu = _emulators("lenet", 4, weight_decay=WEIGHT_DECAY)
    trecs, jrecs = _run_both(temu, jemu, "lenet", 8)
    assert temu.staleness_log == [0, 1, 2, 3, 3, 3, 3, 3]
    assert temu.staleness_log == jemu.staleness_log
    assert temu.dropped == jemu.dropped == 0
    _same_host_decisions(trecs, jrecs)
    assert temu.state.step == int(jemu.state.step) == 8
    assert [w.version for w in temu.workers] == [
        w.version for w in jemu.workers]
    cases.assert_state_close(temu.state, jemu.state)


def test_async_staleness_limit_drops_match_jax():
    temu, jemu = _emulators("lenet", 4, limit=2, weight_decay=WEIGHT_DECAY)
    trecs, jrecs = _run_both(temu, jemu, "lenet", 8)
    assert temu.dropped > 0 and any(r["dropped"] for r in trecs)
    _same_host_decisions(trecs, jrecs)
    assert temu.dropped == jemu.dropped
    applied = sum(1 for r in trecs if not r["dropped"])
    assert temu.state.step == int(jemu.state.step) == applied
    cases.assert_state_close(temu.state, jemu.state)


def test_async_random_schedule_deterministic_and_matches_jax():
    temu, jemu = _emulators("lenet", 4, schedule="random", seed=3)
    trecs, jrecs = _run_both(temu, jemu, "lenet", 6)
    _same_host_decisions(trecs, jrecs)
    again, _ = _emulators("lenet", 4, schedule="random", seed=3)
    picks = [again.step(cases.to_torch(cases.batch("lenet", seed=i)), 7)[
        "worker"] for i in range(6)]
    assert picks == [r["worker"] for r in trecs]
    for a, b in zip(cases.state_tensors(again.state),
                    cases.state_tensors(temu.state)):
        assert torch.equal(a, b)
    cases.assert_state_close(temu.state, jemu.state)


def test_async_threads_ema_and_version():
    """EMA shadows advance through the emulator's apply, and workers built
    from a restored (step 100) state start at staleness 0, not 100: the
    shadows against the JAX package's after three events."""
    tstate, tloss, jstate, jloss = cases.pair("lenet", ema_decay=0.9,
                                              steps=110)
    tstate = tstate.replace(step=100)
    tstate.device_step.fill_(100)
    jstate = jstate.replace(step=jax.numpy.asarray(100, jax.numpy.int32))
    cfg = dict(num_workers=2, staleness_limit=2)
    temu = async_ps.AsyncPSEmulator(tstate, tloss,
                                    async_ps.AsyncConfig(**cfg))
    jemu = jasync.AsyncPSEmulator(jstate, jloss, jasync.AsyncConfig(**cfg))
    before = [v.clone() for v in tstate.ema_params.values()]
    trecs, jrecs = _run_both(temu, jemu, "lenet", 3)
    assert trecs[0]["staleness"] == 0 and not trecs[0]["dropped"]
    _same_host_decisions(trecs, jrecs)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, temu.state.ema_params.values()))
    assert temu.state.step == 103
    cases.assert_state_close(temu.state, jemu.state,
                             ("params", "batch_stats", "ema"))


def test_async_loss_decreases():
    """Async training with staleness still learns on a fixed batch."""
    tstate, tloss, _, _ = cases.pair("lenet", lr=0.02)
    emu = async_ps.AsyncPSEmulator(tstate, tloss,
                                   async_ps.AsyncConfig(num_workers=4))
    b = cases.to_torch(cases.batch("lenet", n=16))
    losses = [float(emu.step(b, 0)["metrics"]["loss"]) for _ in range(30)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_async_dropped_events_leave_bn_statistics_as_jax():
    """BatchNorm moves its running statistics in the forward; a dropped
    event's move is undone (the JAX emulator never applies its aux), an
    applied one's kept from the canonical statistics: K = 2 at limit 0
    drops every other event."""
    temu, jemu = _emulators("resnet_bn", 2, limit=0)
    trecs, jrecs = _run_both(temu, jemu, "resnet_bn", 4)
    assert [r["dropped"] for r in trecs] == [False, True, False, True]
    _same_host_decisions(trecs, jrecs)
    assert temu.state.step == int(jemu.state.step) == 2
    cases.assert_state_close(temu.state, jemu.state)


def test_async_config_validation():
    tstate, tloss, _, _ = cases.pair("lenet")
    with pytest.raises(ValueError, match="at least one"):
        async_ps.AsyncPSEmulator(tstate, tloss,
                                 async_ps.AsyncConfig(num_workers=0))
    with pytest.raises(ValueError, match="schedule"):
        async_ps.AsyncPSEmulator(tstate, tloss,
                                 async_ps.AsyncConfig(schedule="fifo"))


def test_gradients_refuse_other_tensors_than_the_model_parameters():
    tstate, tloss, _, _ = cases.pair("lenet")
    step = train_loop.TrainStep(tloss)
    other = {k: v.detach().clone().requires_grad_() for k, v in
             tstate.params.items()}
    with pytest.raises(ValueError, match="model's own parameters"):
        step.gradients(other, tstate,
                       cases.to_torch(cases.batch("lenet")),
                       step.rngs(torch.device("cpu")).reseed(0, 0))


def test_warm_up_leaves_the_emulator_as_it_was():
    """``warm_up`` runs an event's programs and writes every state tensor
    back: the run after it equals a run without it, bit for bit."""
    runs = []
    for warm in (False, True):
        tstate, tloss, _, _ = cases.pair("resnet_bn")
        emu = async_ps.AsyncPSEmulator(tstate, tloss,
                                       async_ps.AsyncConfig(num_workers=2))
        if warm:
            emu.warm_up(cases.to_torch(cases.batch("resnet_bn", seed=9)), 7)
        for i in range(3):
            emu.step(cases.to_torch(cases.batch("resnet_bn", seed=i)), 7)
        runs.append((emu.staleness_log, cases.state_tensors(emu.state)))
    assert runs[0][0] == runs[1][0] == [0, 1, 1]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 2)


@pytest.mark.two_proc
@pytest.mark.parametrize("name", sorted(worker.ASYNC_CASES))
def test_async_across_processes_equals_one_process(cluster2, name):
    got = dict(np.load(cluster2 / f"async_{name}.npz"))
    want = worker.async_run(name, single=True)
    assert sorted(got) == sorted(want)
    for key in ("__staleness", "__dropped"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["__loss"], want["__loss"], atol=LOSS_ATOL)
    np.testing.assert_allclose(got["__grad_norm"], want["__grad_norm"],
                               rtol=1e-5)
    for k in want:
        if not k.startswith("__"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
