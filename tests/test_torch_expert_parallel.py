"""The port's expert parallelism (the expert axis of ``parallel/moe.py``)
against the JAX package's, on the CPU.

- ``moe_param_spec`` equals the JAX package's (``PartitionSpec`` read as a
  tuple of axis names).
- The MoE FFN over ``expert=2``, ``expert=4`` and ``data=2 x expert=2``
  gloo processes (``tests/torch_parallel_cluster.py``; the JAX test's 8
  experts, d 16, f 32, 64 tokens): out, aux, the dropped fraction and the
  gradients of ``mean(out**2) + 0.01 * aux`` (router, experts, tokens)
  against the JAX package's ``moe_ffn`` on an expert mesh of the same
  size (8 fake CPU devices) and its ``moe_ffn_reference(num_ranks=E)``, at
  its test's tolerances (``tests/test_moe.py``: 1e-5; dropped atol 1e-6;
  gradients atol 1e-5, rtol 1e-4); every process holds the same aux and
  its experts' gradients only.
- ``moe.emulate`` (the E ranks' arithmetic in one process, as the card
  runs it) equals ``moe_ffn_reference(num_ranks=E)``, and the JAX
  package's, forward and gradients; the JAX ``ValueError`` texts.
- The MoE layer cut over ``expert`` keeps its experts and routes through
  the expert layout; ``eval`` of an ``expert=2`` checkpoint (whole
  experts) on the expert mesh equals one process at capacity factor 8;
  the CLI's ``train --mesh-expert 2`` on ``transformer_lm_moe``.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

import torch_parallel_cluster
import torch_parallel_worker as worker
from distributed_tensorflow_models_tpu.core import mesh as jmesh
from distributed_tensorflow_models_tpu.parallel import moe as jmoe
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.harness import evaluate
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    TransformerLM,
)
from distributed_tensorflow_models_tpu_torch.parallel import moe
from distributed_tensorflow_models_tpu_torch.parallel import tensor

jax.config.update("jax_platforms", "cpu")

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 4)


CASES = [(w, name) for w in (2, 4) for name in worker.EXPERT_CASES[w]]


def test_moe_param_spec_matches_jax():
    assert moe.moe_param_spec() == {
        k: tuple(v) for k, v in jmoe.moe_param_spec().items()}


def _jax_loss(fn):
    def loss(p, x):
        r = fn(p, x)
        return jnp.mean(r.out ** 2) + 0.01 * r.aux_loss
    return loss


_JAX: dict = {}


def _jax_runs(E):
    """The JAX package's ``moe_ffn`` on a ``data x expert=E`` mesh and its
    ``moe_ffn_reference(num_ranks=E)``: (out, aux, dropped, grads of
    params, grad of x) each."""
    if E in _JAX:
        return _JAX[E]
    params, x = worker.moe_inputs()
    p, xj = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    mesh = jmesh.create_mesh(jmesh.MeshSpec(data=-1, expert=E))
    runs = []
    for fn in (lambda p, x: jmoe.moe_ffn(p, x, mesh=mesh),
               lambda p, x: jmoe.moe_ffn_reference(p, x, num_ranks=E)):
        r = jax.jit(fn)(p, xj)
        gp, gx = jax.jit(jax.grad(_jax_loss(fn), argnums=(0, 1)))(p, xj)
        runs.append((np.asarray(r.out), float(r.aux_loss),
                     float(r.dropped_fraction),
                     jax.tree.map(np.asarray, gp), np.asarray(gx)))
    _JAX[E] = runs
    return runs


@pytest.mark.two_proc
@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_expert_moe_on_gloo_matches_jax(cluster2, cluster4, world, name):
    spec = worker.EXPERT_CASES[world][name]
    data, E = spec["data"], spec["expert"]
    out_dir = {2: cluster2, 4: cluster4}[world]
    parts = [np.load(out_dir / f"experts_{name}_p{p}.npz")
             for p in range(world)]
    # Rank = data * E + expert coordinate (the rank unravelled).
    out = np.concatenate([parts[d * E]["out"] for d in range(data)])
    dx = np.concatenate([parts[d * E]["dx"] for d in range(data)])
    grads = {"router": parts[0]["d_router"],
             **{k: np.concatenate([parts[r][f"d_{k}"] for r in range(E)])
                for k in ("w_in", "w_out")}}
    for p in parts:
        assert float(p["aux"]) == float(parts[0]["aux"])
        np.testing.assert_array_equal(p["d_router"], parts[0]["d_router"])
    for jout, jaux, jdrop, jgp, jgx in _jax_runs(E):
        np.testing.assert_allclose(out, jout, **FWD)
        np.testing.assert_allclose(float(parts[0]["aux"]), jaux, rtol=1e-5)
        np.testing.assert_allclose(float(parts[0]["dropped"]), jdrop,
                                   atol=1e-6)
        for k, g in grads.items():
            np.testing.assert_allclose(g, jgp[k], **GRAD, err_msg=k)
        np.testing.assert_allclose(dx, jgx, **GRAD)


@pytest.mark.parametrize("E", [1, 2, 4])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_emulate_matches_the_reference_and_jax(E, capacity_factor):
    params, x = worker.moe_inputs()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    runs = []
    for fn in (moe.emulate, moe.moe_ffn_reference):
        r = fn(tp, tx, num_ranks=E, capacity_factor=capacity_factor)
        loss = torch.mean(r.out ** 2) + 0.01 * r.aux_loss
        runs.append((r, torch.autograd.grad(loss, [tx, *tp.values()])))
    (em, gem), (ref, gref) = runs
    np.testing.assert_allclose(em.out.detach().numpy(),
                               ref.out.detach().numpy(), **FWD)
    assert float(em.aux_loss.detach()) == pytest.approx(
        float(ref.aux_loss.detach()), rel=1e-6)
    assert float(em.dropped_fraction) == float(ref.dropped_fraction)
    for a, b in zip(gem, gref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
    jr = jmoe.moe_ffn_reference(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x), num_ranks=E,
                                capacity_factor=capacity_factor)
    np.testing.assert_allclose(em.out.detach().numpy(), np.asarray(jr.out),
                               **FWD)
    np.testing.assert_allclose(float(em.aux_loss.detach()),
                               float(jr.aux_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(em.dropped_fraction),
                               float(jr.dropped_fraction), atol=1e-6)
    if capacity_factor < 1:
        assert float(em.dropped_fraction) > 0


@pytest.mark.parametrize("experts,tokens,E", [(8, 64, 3), (8, 60, 8)],
                         ids=["experts", "tokens"])
def test_errors_match_jax(experts, tokens, E):
    params, x = worker.moe_inputs()
    params = {k: v[..., :experts] if k == "router" else v[:experts]
              for k, v in params.items()}
    x = x[:tokens]
    jmesh_ = type("FakeMesh", (), {"shape": {"expert": E}})()
    with pytest.raises(ValueError) as jerr:
        jmoe.moe_ffn(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                     mesh=jmesh_)
    with pytest.raises(ValueError) as terr:
        moe.emulate({k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x), num_ranks=E)
    assert str(terr.value) == str(jerr.value)
    if experts % E:
        mesh = meshlib.Mesh((1, 1, 1, 1, E), 0, 1, CPU,
                            coords=(0, 0, 0, 0, 1))
        model = TransformerLM(num_layers=2, num_heads=2, d_model=16,
                              d_ff=32, max_len=8, vocab_size=32,
                              num_experts=experts)
        with pytest.raises(ValueError) as cut_err:
            tensor.shard_model(model, [], mesh)
        assert str(cut_err.value) == str(jerr.value)


def test_the_cut_keeps_this_processs_experts():
    """``shard_model`` at expert 2 keeps expert rank 1's half of
    ``w_in``/``w_out`` of every MoE block, records ``(expert, 0)``, keeps
    the router whole and gives the layer the mesh."""
    kw = dict(num_layers=4, num_heads=2, d_model=16, d_ff=32, max_len=8,
              vocab_size=32, num_experts=4)
    whole = TransformerLM(**kw, generator=torch.Generator().manual_seed(0))
    model = TransformerLM(**kw, generator=torch.Generator().manual_seed(0))
    mesh = meshlib.Mesh((1, 1, 1, 1, 2), 0, 1, CPU, coords=(0, 0, 0, 0, 1))
    dims = tensor.shard_model(model, [], mesh)
    assert dims == {f"blocks_{i}.moe.{k}": ("expert", 0)
                    for i in (1, 3) for k in ("w_in", "w_out")}
    wp = dict(whole.named_parameters())
    for name, p in model.named_parameters():
        want = wp[name][2:] if name in dims else wp[name]
        assert torch.equal(p, want), name
    assert model.blocks_1.moe.expert_mesh is mesh


@pytest.mark.two_proc
def test_eval_on_the_expert_mesh_equals_one_process(cluster2):
    """At capacity factor 8 no token is dropped on either layout, so the
    nll of the ``expert=2`` checkpoint is one process's (eval sows no aux
    loss)."""
    got = json.loads((cluster2 / "eval_expert.json").read_text())
    cfg = worker.LM.replace(**worker.FIT_CASES[2]["expert"])
    want = evaluate.evaluate_lm(cfg.replace(**worker.LAYOUT),
                                str(cluster2 / "eval_expert"),
                                max_batches=2, device="cpu",
                                mesh=meshlib.local_mesh("cpu"))
    assert got["step"] == want.step == 2
    np.testing.assert_allclose(got["nll"], want.metrics["nll"], rtol=1e-5)
    manifest = json.loads((cluster2 / "eval_expert" / "checkpoints" / "2"
                           / "manifest.json").read_text())["tensors"]
    d, f = worker.LM_KW["d_model"], worker.LM_KW["d_ff"]
    assert manifest["params/blocks_1.moe.w_in"]["shape"] == [4, d, f]


@pytest.mark.two_proc
def test_cli_trains_on_an_expert_mesh(cluster2):
    workdir = cluster2 / "cli_expert"
    report = json.loads((workdir / "telemetry.json").read_text())
    assert report["steps"] == 1
    manifest = json.loads((workdir / "checkpoints" / "1" / "manifest.json")
                          .read_text())["tensors"]
    assert manifest["params/blocks_1.moe.w_in"]["shape"][0] == 4
