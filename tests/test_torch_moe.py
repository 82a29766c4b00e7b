"""The port's Switch-MoE FFN (``parallel/moe.py``) against the JAX
package's, on numpy-seeded f32 inputs.

- ``moe_ffn_reference`` at 1, 2 and 4 ranks and capacity factors 0.5 and
  1.25 (tokens dropped at 0.5) and 8.0 (none dropped): output to atol 1e-5, aux
  to rtol 1e-5, the dropped fraction exactly (it counts 0/1 slots), and
  the gradients of ``mean(out^2) + 0.01 aux`` to atol 1e-5 / rtol 1e-4, as
  ``tests/test_moe.py`` holds the JAX expert-parallel layer to its oracle.
- A token past its expert's capacity gets a zero row, without an error;
  the validation errors read as JAX's.
- Two processes over gloo (the cluster of
  ``tests/test_torch_data_parallel.py``, :func:`torch_data_parallel_worker.moe_check`),
  each with half the tokens: their output rows are JAX ``moe_ffn`` on a
  ``data=2`` CPU mesh, i.e. routed over the global token set, and their
  averaged gradients are one process's on the global batch.  f32 sums run
  in another order across the processes: 1e-5 there too.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_models_tpu.core import mesh as jmesh
from distributed_tensorflow_models_tpu.parallel import moe as jmoe
from distributed_tensorflow_models_tpu_torch.core import mesh as tmesh
from distributed_tensorflow_models_tpu_torch.parallel import moe as tmoe

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_data_parallel_worker as worker  # noqa: E402
from test_torch_data_parallel import cluster  # noqa: E402,F401

jax.config.update("jax_platforms", "cpu")

E, D, F_ = 4, 16, 32
TOKENS = 64
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(seed=0, experts=E, tokens=TOKENS):
    rng = np.random.default_rng(seed)
    params = {"router": rng.standard_normal((D, experts)) / np.sqrt(D),
              "w_in": rng.standard_normal((experts, D, F_)) / np.sqrt(D),
              "w_out": rng.standard_normal((experts, F_, D)) / np.sqrt(F_)}
    x = rng.standard_normal((tokens, D))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def _torch(params, x):
    return ({k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}, torch.tensor(x, requires_grad=True))


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_reference_matches_jax(ranks, cf):
    params, x = _inputs(seed=ranks)
    want = jmoe.moe_ffn_reference(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), num_ranks=ranks,
        capacity_factor=cf)
    tp, tx = _torch(params, x)
    got = tmoe.moe_ffn_reference(tp, tx, num_ranks=ranks, capacity_factor=cf)
    np.testing.assert_allclose(got.out.detach().numpy(), np.asarray(want.out),
                               **OUT_TOL)
    np.testing.assert_allclose(float(got.aux_loss.detach()),
                               float(want.aux_loss), rtol=1e-5)
    assert float(got.dropped_fraction) == float(want.dropped_fraction)
    if cf == 8.0:
        assert float(got.dropped_fraction) == 0.0
    if cf == 0.5:
        assert float(got.dropped_fraction) > 0.0

    def jloss(p, x):
        r = jmoe.moe_ffn_reference(p, x, num_ranks=ranks, capacity_factor=cf)
        return jnp.mean(r.out ** 2) + 0.01 * r.aux_loss

    jgrads = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    loss = torch.mean(got.out ** 2) + 0.01 * got.aux_loss
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    for name, g in zip([*tp, "x"], grads):
        want_g = jgrads[1] if name == "x" else jgrads[0][name]
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                                   err_msg=name, **GRAD_TOL)


def test_out_of_capacity_rows_are_zero():
    """At capacity 1 a token past the first in its expert's queue is
    dropped: an all-zero output row, no error (the one-hot of its place is
    built by comparison, not ``F.one_hot``)."""
    params, x = _inputs(seed=5)
    tp, tx = _torch(params, x)
    res = tmoe.moe_ffn_reference(tp, tx, num_ranks=1, capacity_factor=1e-3)
    assert tmoe.capacity(1e-3, TOKENS, E) == 1
    kept = (res.out.detach().abs().sum(1) > 0).sum().item()
    assert 1 <= kept <= E
    assert float(res.dropped_fraction) == 1.0 - kept / TOKENS
    want = jmoe.moe_ffn_reference(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(x), num_ranks=1,
                                  capacity_factor=1e-3)
    np.testing.assert_allclose(res.out.detach().numpy(),
                               np.asarray(want.out), **OUT_TOL)


def test_validation_errors_match_jax():
    params, x = _inputs(tokens=62)
    with pytest.raises(ValueError) as want:
        jmoe.moe_ffn_reference(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x), num_ranks=4)
    tp, tx = _torch(params, x)
    with pytest.raises(ValueError) as got:
        tmoe.moe_ffn_reference(tp, tx, num_ranks=4)
    assert str(got.value) == str(want.value)


def test_moe_ffn_without_a_group_is_the_one_rank_reference():
    """No mesh, or a mesh of one with no group: ``moe_ffn`` is the
    reference at one rank, bit for bit; a data axis of 2 with no group to
    gather over raises, and so does an expert axis of 2 with no group to
    exchange over (the expert axis is ported:
    ``tests/test_torch_expert_parallel.py``)."""
    params, x = _inputs(seed=3)
    tp, tx = _torch(params, x)
    want = tmoe.moe_ffn_reference(tp, tx, num_ranks=1)
    for mesh in (None, tmesh.local_mesh("cpu")):
        got = tmoe.moe_ffn(tp, tx, mesh=mesh)
        assert torch.equal(got.out, want.out)
        assert torch.equal(got.aux_loss, want.aux_loss)
    two = tmesh.Mesh((2, 1, 1, 1, 1), 0, 2, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no process group"):
        tmoe.moe_ffn(tp, tx, mesh=two)
    expert = tmesh.Mesh((1, 1, 1, 1, 2), 0, 1, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no process group"):
        tmoe.moe_ffn(tp, tx, mesh=expert)


def test_init_params_shapes_and_scales():
    p = tmoe.init_moe_params(8, 64, 256, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 8), "w_in": (8, 64, 256), "w_out": (8, 256, 64)}
    for k, fan in (("router", 64), ("w_in", 64), ("w_out", 256)):
        assert p[k].dtype == torch.float32
        assert abs(float(p[k].std()) * fan ** 0.5 - 1.0) < 0.05, k


def _jax_data2(params, x, cf):
    mesh = jmesh.create_mesh(jmesh.MeshSpec(data=2), jax.devices()[:2])
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    return jax.jit(lambda p, x: jmoe.moe_ffn(p, x, mesh=mesh,
                                             capacity_factor=cf))(
        jax.tree.map(jnp.asarray, params), xs)


@pytest.mark.two_proc
@pytest.mark.parametrize("cf", worker.MOE_FACTORS)
def test_two_processes_route_the_global_batch(cluster, cf):  # noqa: F811
    """Each process's rows of ``moe_ffn`` over its half of the tokens are
    the rows of JAX ``moe_ffn`` on a ``data=2`` mesh over all of them (and
    of the port's one-rank reference): routing and capacity see the global
    set, which per-process routing would not.  The gathers count once a
    call, their backward's sums once."""
    params, x, g = worker.moe_inputs()
    parts = [np.load(cluster / f"moe_p{p}.npz") for p in (0, 1)]
    got = np.concatenate([p[f"{cf}/out"] for p in parts])
    want = _jax_data2(params, x, cf)
    np.testing.assert_allclose(got, np.asarray(want.out), **OUT_TOL)
    tp, tx = _torch(params, x)
    ref = tmoe.moe_ffn_reference(tp, tx, num_ranks=1, capacity_factor=cf)
    np.testing.assert_allclose(got, ref.out.detach().numpy(), **OUT_TOL)
    local = tmoe.moe_ffn_reference(tp, tx, num_ranks=2, capacity_factor=cf)
    assert not np.allclose(got, local.out.detach().numpy(), **OUT_TOL)
    for p in parts:
        np.testing.assert_allclose(float(p[f"{cf}/aux"]),
                                   float(want.aux_loss), rtol=1e-5)
        assert float(p[f"{cf}/dropped"]) == float(want.dropped_fraction)
        assert int(p[f"{cf}/gathers"]) == 1
        assert int(p[f"{cf}/gather_grads"]) == 1

    loss = (ref.out * torch.from_numpy(g)).sum() / TOKENS + ref.aux_loss
    grads = dict(zip([*tp, "x"], torch.autograd.grad(loss,
                                                     [*tp.values(), tx])))
    for k in tp:
        for p in parts:
            np.testing.assert_allclose(p[f"{cf}/d{k}"], grads[k].numpy(),
                                       err_msg=k, **GRAD_TOL)
    # Each process's loss is the mean over its half: its token gradient is
    # twice its rows of the global loss's.
    dx = np.concatenate([p[f"{cf}/dx"] for p in parts]) / 2
    np.testing.assert_allclose(dx, grads["x"].numpy(), **GRAD_TOL)
