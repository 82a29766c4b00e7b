"""The port's mesh, sharding and cluster bootstrap, in one process on the
CPU: ``core/mesh.py``, ``core/sharding.py``, ``launch.py`` and the
data-parallel paths of BatchNorm, dropout, ``TrainStep`` and ``fit``.

- ``MeshSpec.sizes`` (copied) against the JAX package's over a grid of
  specs and device counts, its raises included; ``local_batch_size``'s
  raises; ``batch_rows``; ``initialize_from_env`` without the cluster's
  variables; the axes, configs and sharding rules that are not ported.
- Dropout under a data axis of W processes (a simulated mesh: dropout
  reads only the axis's size and this process's index) draws the global
  batch's mask and keeps its rows.
- A gloo process group of one process (a ``FileStore`` under the test's
  directory, destroyed however the test ends: a group left behind would
  route every later ``fit`` in the same worker through it): ``fit`` of cut
  LeNet and ResNet-32 equals the ``fit`` without a group bit for bit,
  losses and state, while every collective of the step runs (counted once
  per step: the gradient bucket, each BatchNorm's moments and their
  cotangents, the metric vector).
"""

from __future__ import annotations

import json
import os
import socket

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)
import torch.distributed as dist

from distributed_tensorflow_models_tpu.core import mesh as jmesh
from distributed_tensorflow_models_tpu_torch import launch
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm

CPU = torch.device("cpu")
SPECS = [dict(), dict(data=2), dict(data=-1, model=2), dict(model=-1),
         dict(data=2, model=2), dict(data=-1, seq=3), dict(data=-1, model=-1),
         dict(data=4), dict(data=-1, pipe=2, expert=2)]


def _sizes(spec_cls, kw, n):
    try:
        return spec_cls(**kw).sizes(n)
    except ValueError as e:
        return f"ValueError: {e}".replace("MeshSpec", "")


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: str(kw) or "default")
def test_mesh_spec_sizes_match_jax(kw, n):
    assert _sizes(meshlib.MeshSpec, kw, n) == _sizes(jmesh.MeshSpec, kw, n)


def _mesh(world, rank=0):
    return meshlib.Mesh((world, 1, 1, 1, 1), rank, world, CPU)


def test_local_batch_size_and_its_raises():
    assert meshlib.local_batch_size(8, _mesh(2, 1)) == 4
    assert meshlib.local_batch_size(8, meshlib.local_mesh("cpu")) == 8
    with pytest.raises(ValueError, match="not divisible by data-axis size 3"):
        meshlib.local_batch_size(8, _mesh(3))
    with pytest.raises(ValueError, match="not divisible by process count 3"):
        meshlib.local_batch_size(4, _ProcessCountMesh())


class _ProcessCountMesh:
    """A mesh whose data axis (2) splits the batch but whose process count
    (3) does not: the second of ``local_batch_size``'s raises."""
    shape = {"data": 2}
    world_size = 3


def test_batch_rows_split_the_leading_axis_in_process_order():
    assert [sharding.batch_rows(_mesh(4, r), 12) for r in range(4)] == [
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)]
    assert sharding.batch_rows(meshlib.local_mesh("cpu"), 5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        sharding.batch_rows(_mesh(4), 10)


def test_mesh_checks_rank_and_axes():
    with pytest.raises(ValueError, match="rank 2"):
        meshlib.Mesh((2, 1, 1, 1, 1), 2, 2, CPU)
    assert _mesh(2).shape == dict(data=2, model=1, seq=1, pipe=1, expert=1)


def test_initialize_from_env_without_cluster_env(monkeypatch):
    for var in (launch.ENV_COORDINATOR, launch.ENV_NUM_PROCESSES,
                launch.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize_from_env() is False
    assert launch.initialize_from_env(device="cpu") is False
    assert not dist.is_initialized()


def test_a_cuda_group_without_cuda_raises():
    """No fallback: a CUDA process group on a machine without CUDA raises
    before it joins anything; it never turns into gloo on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.initialize_multihost("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("field,value", [
    ("mesh_model", 2), ("mesh_seq", 2), ("mesh_pipe", 2), ("mesh_expert", 2),
    ("param_rules", "head_tp")])
def test_non_data_parallel_configs_raise_not_ported(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        tconfig.get_config("lenet_mnist", **{field: value})
    tconfig.get_config("lenet_mnist", mesh_data=1)


def test_axes_and_rules_beyond_data_raise_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        meshlib._data_only((1, 2, 1, 1, 1))
    params = {"w": torch.zeros(2)}
    assert sharding.tree_param_shardings(_mesh(1), params) == {
        "w": sharding.REPLICATED}
    with pytest.raises(NotImplementedError, match="not ported"):
        sharding.tree_param_shardings(_mesh(1), params, [("w", None)])
    with pytest.raises(ValueError, match="wants 2 devices, have 1"):
        trainlib.mesh_from_config(tconfig.get_config("lenet_mnist",
                                                     mesh_data=2), "cpu")


@pytest.mark.parametrize("world", [2, 3])
def test_dropout_draws_the_global_mask_and_keeps_its_rows(world):
    """Under a data axis of W, process r's mask (and scaled output) is rows
    [r b, (r + 1) b) of the mask one process draws at the global batch W b,
    from the same generator state; the generator ends in the same state."""
    b, seed = 3, 7
    x = torch.arange(world * b * 5, dtype=torch.float32).reshape(
        world * b, 5) + 1

    def draw(xs, mesh):
        gen = torch.Generator().manual_seed(seed)
        with meshlib.data_parallel(mesh):
            out = dropout(xs, 0.5, True, {"dropout": gen})
        return out, gen.get_state()

    full, full_gen = draw(x, None)
    assert 0 < int((full == 0).sum()) < full.numel()
    for r in range(world):
        rows = slice(r * b, (r + 1) * b)
        part, gen = draw(x[rows], _mesh(world, r))
        assert torch.equal(part, full[rows])
        assert torch.equal(gen, full_gen)
    assert meshlib.current_mesh() is None


def test_a_wide_axis_without_a_group_cannot_reduce():
    """BatchNorm under a simulated axis of 2 has no group to reduce its
    moments over: it raises rather than normalise by local moments."""
    bn = BatchNorm(4)
    with meshlib.data_parallel(_mesh(2)):
        with pytest.raises(RuntimeError, match="no process group"):
            bn(torch.ones(2, 4), use_running_average=False)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    """A gloo process group of one process on a FileStore, destroyed when
    the test ends, whatever its outcome."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


FIT_CASES = {
    "lenet_mnist": dict(global_batch_size=4),
    "resnet32_cifar10": dict(global_batch_size=4,
                             model_kwargs={"blocks_per_stage": 1}),
}
BN_LAYERS = {"lenet_mnist": 0, "resnet32_cifar10": 9}


def _state(result):
    return [t.detach().clone() for t in train_loop._state_leaves(
        result.state)]


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_in_a_group_of_one_equals_fit_without(gloo_world_of_one, name):
    cfg = tconfig.get_config(name, train_steps=3, steps_per_loop=2,
                             **FIT_CASES[name])
    alone = trainlib.fit(cfg, device="cpu", mesh=meshlib.local_mesh("cpu"))
    assert alone.registry.snapshot()["train/collectives"] == 0
    mesh = trainlib.mesh_from_config(cfg, "cpu")
    assert (mesh.world_size, mesh.backend) == (1, "gloo")
    before = sharding.collective_counts()
    grouped = trainlib.fit(cfg, device="cpu")
    issued = sharding.counts_since(before)
    assert [h["loss"] for h in grouped.history] == [
        h["loss"] for h in alone.history]
    assert [h["grad_norm"] for h in grouped.history] == [
        h["grad_norm"] for h in alone.history]
    a, g = _state(alone), _state(grouped)
    assert len(a) == len(g) and all(torch.equal(x, y) for x, y in zip(a, g))
    steps, bn = cfg.train_steps, BN_LAYERS[name]
    counts = {site: n for site, (n, _) in issued.items()}
    want = {"replica_check": 2, "grads": steps, "metrics": steps}
    if bn:
        want.update(bn_moments=bn * steps, bn_moments_grad=bn * steps)
    assert counts == want
    n_params = sum(t.numel() for t in grouped.state.params.values())
    assert issued["grads"][1] == 4 * n_params * steps
    snap = grouped.registry.snapshot()
    assert snap["train/collectives"] == sum(want.values()) - 2
    assert snap["train/collective_bytes"] == sum(
        b for site, (_, b) in issued.items() if site != "replica_check")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_joins_the_cluster_of_its_env(monkeypatch, tmp_path,
                                                capsys):
    """``train`` started with the cluster's variables (one process, gloo
    with ``--device cpu``) joins the group first, trains as process 0 of
    the data axis (the chief writes ``metrics.jsonl``) and leaves no
    group behind."""
    monkeypatch.setenv(launch.ENV_COORDINATOR, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(launch.ENV_NUM_PROCESSES, "1")
    monkeypatch.setenv(launch.ENV_PROCESS_ID, "0")
    before = sharding.collective_counts()
    rc = cli.main(["train", "--config", "lenet_mnist", "--workdir",
                   str(tmp_path), "--train-steps", "2", "--batch-size", "4",
                   "--device", "cpu"])
    assert rc == 0
    assert not dist.is_initialized()
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 2 and result["device"] == "cpu"
    assert sharding.counts_since(before)["grads"][0] == 2
    assert os.path.exists(tmp_path / "metrics.jsonl")
