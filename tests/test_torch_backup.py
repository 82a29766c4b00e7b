"""The port's backup-replica emulator (``parallel/backup.py``) against the
JAX package's, and against the port's own sync step.

The mirrors of the JAX package's backup tests (``tests/test_parallel.py``):
with N == M and equal shards a round equals the sync step on the global
batch (LeNet, dropout 0); the discarded replica's data does not reach the
update (its batch poisoned, the state equal bit for bit); the config and
the shard split validate.  Beside the JAX emulator on the same weights:
the chosen and discarded sets of every round equal the JAX package's
exactly (the same seeded permutations), the parameters to ``STATE_TOL``;
on a BN model (the cut ResNet-32) the kept BatchNorm statistics are one
update from the canonical ones by the last chosen replica, as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

import torch_emulator_cases as cases
from distributed_tensorflow_models_tpu.parallel import backup as jbackup
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.parallel import backup

jax.config.update("jax_platforms", "cpu")


def _emulators(case, total, aggregate, seed=0, **kw):
    tstate, tloss, jstate, jloss = cases.pair(case, **kw)
    cfg = dict(total_replicas=total, replicas_to_aggregate=aggregate,
               seed=seed)
    return (backup.SyncBackupEmulator(tstate, tloss,
                                      backup.BackupConfig(**cfg)),
            jbackup.SyncBackupEmulator(jstate, jloss,
                                       jbackup.BackupConfig(**cfg)))


def _shards(case, n, total, seed=0):
    global_batch = cases.batch(case, n=n, seed=seed)
    return (backup.split_into_shards(cases.to_torch(global_batch), total),
            jbackup.split_into_shards(global_batch, total))


def test_full_aggregation_matches_sync_step():
    """N == M anchors to the sync step on the global batch: the mean of the
    shards' mean-loss gradients is the global mean gradient."""
    temu, jemu = _emulators("lenet", 4, 4)
    tstate, tloss, _, _ = cases.pair("lenet")
    global_batch = cases.batch("lenet", n=16)
    temu.step(backup.split_into_shards(cases.to_torch(global_batch), 4), 7)
    jemu.step(jbackup.split_into_shards(global_batch, 4), jax.random.key(7))
    ref, _ = train_loop.make_train_step(tloss)(
        tstate, cases.to_torch(global_batch), 7)
    for a, b in zip(temu.state.params.values(), ref.params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=1e-6)
    assert temu.discarded == jemu.discarded == 0
    assert temu.state.step == 1
    cases.assert_state_close(temu.state, jemu.state)


def test_straggler_gradients_are_discarded():
    """The late M - N replicas' data must not reach the update: poisoning
    only the discarded replica's batch leaves the state bit for bit."""
    runs = []
    late = None
    for poison in (False, True):
        tstate, tloss, _, _ = cases.pair("lenet")
        emu = backup.SyncBackupEmulator(
            tstate, tloss, backup.BackupConfig(3, 2, seed=5))
        shards, _ = _shards("lenet", 12, 3, seed=1)
        if poison:
            shards[late] = {"image": torch.zeros_like(shards[late]["image"]),
                            "label": shards[late]["label"] * 0}
        rec = emu.step(shards, 7)
        (late,) = rec["discarded"]
        runs.append((emu, cases.state_tensors(emu.state)))
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert runs[0][0].discarded == runs[1][0].discarded == 1


@pytest.mark.parametrize("total,aggregate", [(3, 2), (5, 4), (4, 1)])
def test_rounds_match_jax(total, aggregate):
    """Four rounds of first-N-of-M: every round's chosen and discarded
    replicas equal the JAX emulator's, the metrics and parameters to
    STATE_TOL."""
    temu, jemu = _emulators("lenet", total, aggregate, seed=3,
                            weight_decay=1e-3)
    for r in range(4):
        tsh, jsh = _shards("lenet", 4 * total, total, seed=r)
        trec = temu.step(tsh, 7)
        jrec = jemu.step(jsh, jax.random.key(7))
        assert trec["chosen"] == jrec["chosen"]
        assert trec["discarded"] == jrec["discarded"]
        np.testing.assert_allclose(float(trec["metrics"]["loss"]),
                                   float(jrec["metrics"]["loss"]),
                                   **cases.STATE_TOL)
    assert temu.discarded == jemu.discarded == 4 * (total - aggregate)
    assert temu.state.step == int(jemu.state.step) == 4
    cases.assert_state_close(temu.state, jemu.state)


def test_bn_statistics_are_the_last_chosen_replicas():
    """On a BN model every chosen replica's forward starts from the
    canonical statistics, and the kept ones are the last chosen replica's
    single update (not N updates compounded): against JAX's after two
    rounds of M = 3, N = 2."""
    temu, jemu = _emulators("resnet_bn", 3, 2, seed=1)
    for r in range(2):
        tsh, jsh = _shards("resnet_bn", 6, 3, seed=r)
        trec = temu.step(tsh, 7)
        jrec = jemu.step(jsh, jax.random.key(7))
        assert trec["chosen"] == jrec["chosen"]
    cases.assert_state_close(temu.state, jemu.state)


def test_warm_up_leaves_the_emulator_as_it_was():
    runs = []
    for warm in (False, True):
        tstate, tloss, _, _ = cases.pair("resnet_bn")
        emu = backup.SyncBackupEmulator(tstate, tloss,
                                        backup.BackupConfig(3, 2))
        if warm:
            emu.warm_up(_shards("resnet_bn", 6, 3, seed=9)[0], 7)
        recs = [emu.step(_shards("resnet_bn", 6, 3, seed=i)[0], 7)
                for i in range(2)]
        runs.append(([r["chosen"] for r in recs],
                     cases.state_tensors(emu.state)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_config_validation():
    with pytest.raises(ValueError):
        backup.BackupConfig(total_replicas=2, replicas_to_aggregate=3)
    with pytest.raises(ValueError):
        backup.BackupConfig(total_replicas=2, replicas_to_aggregate=0)
    with pytest.raises(ValueError):
        backup.split_into_shards({"x": torch.zeros(5, 2)}, 2)
    tstate, tloss, _, _ = cases.pair("lenet")
    emu = backup.SyncBackupEmulator(tstate, tloss, backup.BackupConfig(3, 2))
    with pytest.raises(ValueError, match="need 3 shard batches"):
        emu.step(_shards("lenet", 4, 2)[0], 0)


def test_split_into_shards_matches_jax():
    b = cases.batch("lenet", n=12)
    got = backup.split_into_shards(cases.to_torch(b), 3)
    want = jbackup.split_into_shards(jax.tree.map(jnp.asarray, b), 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
