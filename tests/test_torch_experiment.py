"""The port's async-vs-sync A/B (``harness/experiment.py``) and the CLI's
``ab``, against the JAX package's and against the port's own steps.

- ``async_vs_sync`` on ``lenet_mnist`` (dropout 0, batch 16) from the
  port's seeded weights (carried into the JAX package's ``build_state`` by
  a monkeypatch) against the JAX package's ``async_vs_sync`` on the
  8-device CPU mesh: both modes' losses to ``STATE_TOL``, the staleness
  histogram, mean and drops exactly, ``to_json``'s keys;
- one worker: the async mode equals the sync mode bit for bit (losses and
  every state tensor), and the sync mode equals plain eager steps from a
  fresh state (the warm-up leaves the timed state as it found it);
- the CLI's ``ab`` with ``--device cpu`` prints a last line with the JAX
  CLI's keys; ``--steps`` above the config's ``train_steps`` runs (the
  optimizer's tables cover the A/B); ``--multihost`` without a cluster,
  and the default device on a machine without CUDA, raise.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.harness import cli as jcli
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import experiment as jexperiment
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import experiment
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
STATE_TOL = dict(atol=5e-4, rtol=5e-4)  # tests/test_torch_zoo.py
LENET = dict(global_batch_size=16, model_kwargs={"dropout_rate": 0.0})


def _keys(tree):
    """The nested key structure of a JSON object."""
    return {k: _keys(v) if isinstance(v, dict) and k != "staleness_hist"
            else type(v).__name__ for k, v in tree.items()}


@pytest.mark.parametrize("workers,limit", [(2, None), (4, 1)])
def test_async_vs_sync_matches_jax(monkeypatch, mesh8, workers, limit):
    tcfg = tconfig.get_config("lenet_mnist", **LENET)
    jcfg = jconfig.get_config("lenet_mnist", **LENET)
    tree = interop.to_flax_variables(trainlib.build_model(tcfg, CPU))
    real = jtrain.build_state

    def bridged(cfg, mesh):
        s = real(cfg, mesh)
        params = jax.tree.map(jax.numpy.asarray, tree["params"])
        return s.replace(params=params, opt_state=s.tx.init(params))

    monkeypatch.setattr(jtrain, "build_state", bridged)
    kw = dict(num_workers=workers, staleness_limit=limit)
    want = jexperiment.async_vs_sync(jcfg, 6, mesh=mesh8, **kw)
    got = experiment.async_vs_sync(tcfg, 6, device="cpu", **kw)
    np.testing.assert_allclose(got.sync_losses, want.sync_losses,
                               **STATE_TOL)
    np.testing.assert_allclose(got.async_losses, want.async_losses,
                               **STATE_TOL)
    assert got.staleness_hist == want.staleness_hist
    assert got.mean_staleness == want.mean_staleness
    assert got.dropped == want.dropped
    assert sum(got.staleness_hist.values()) == len(got.staleness_log) == 6
    assert _keys(got.to_json()) == _keys(want.to_json())
    assert json.loads(json.dumps(got.to_json()))["async"][
        "staleness_hist"] == want.to_json()["async"]["staleness_hist"]


def test_one_worker_equals_sync_and_sync_equals_eager_steps():
    cfg = tconfig.get_config("resnet50_synthetic_tiny", train_steps=4)
    res = experiment.async_vs_sync(cfg, 4, num_workers=1, device="cpu",
                                   keep_states=True)
    assert res.async_losses == res.sync_losses
    assert res.staleness_hist == {0: 4} and res.dropped == 0
    assert res.sync_state.step == res.async_state.step == 4
    a = train_loop.copy_state(res.sync_state)
    b = train_loop.copy_state(res.async_state)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # The sync mode against eager steps from a fresh state: the warm-up
    # left the timed state untouched.
    state = trainlib.build_state(cfg, CPU)
    step = trainlib.build_step(cfg, state)
    mesh = meshlib.local_mesh("cpu")
    losses = []
    for batch in experiment.ab_batches(cfg, 4, mesh):
        state, metrics = step(state, batch, cfg.seed + 1)
        losses.append(float(metrics["loss"]))
    assert losses == res.sync_losses
    assert all(torch.equal(x, y) for x, y in
               zip(train_loop.copy_state(state), a))


def test_cli_ab_on_cpu_has_the_jax_cli_keys(mesh8, capsys):
    argv = ["ab", "--config", "lenet_mnist", "--steps", "3",
            "--async-workers", "2", "--batch-size", "16"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _keys(got) == _keys(want)
    assert got["async"]["staleness_hist"] == want["async"]["staleness_hist"]
    assert set(got) == {"sync", "async"}


def test_cli_ab_runs_past_train_steps(capsys):
    """transformer_lm_tiny trains 2 steps; the A/B's 3 read the
    optimizer's tables past them, which cover the A/B's length."""
    assert tconfig.get_config("transformer_lm_tiny").train_steps == 2
    assert cli.main(["ab", "--config", "transformer_lm_tiny", "--steps", "3",
                     "--async-workers", "2", "--staleness-limit", "0",
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["sync"]["losses"]) == len(out["async"]["losses"]) == 3
    assert out["async"]["staleness_hist"] == {"0": 2, "1": 1}
    assert out["async"]["dropped"] == 1
    assert np.isfinite(out["sync"]["losses"] + out["async"]["losses"]).all()


def test_build_state_tables_cover_num_steps():
    cfg = tconfig.get_config("transformer_lm_tiny")
    assert trainlib.build_state(cfg, CPU).tx.num_steps == cfg.train_steps
    assert trainlib.build_state(cfg, CPU, num_steps=9).tx.num_steps == 9


def test_entry_points_refuse_to_fall_back_to_the_cpu(capsys):
    cfg = tconfig.get_config("resnet50_synthetic_tiny")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiment.async_vs_sync(cfg, 1)
    with pytest.raises(SystemExit, match="no cluster"):
        cli.main(["ab", "--config", "resnet50_synthetic_tiny", "--steps",
                  "1", "--multihost", "--device", "cpu"])
    with pytest.raises(ValueError, match="steps must be"):
        experiment.async_vs_sync(cfg, 0, device="cpu")
