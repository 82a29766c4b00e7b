"""The port's tensor parallelism (``parallel/tensor.py``) against the JAX
package's, on the CPU.

- The four rule sets equal the JAX package's, regex for regex and spec for
  spec (its ``PartitionSpec`` read as a tuple of axis names), and so does
  the ``KeyError`` of an unknown set.
- ``tree_param_shardings`` under ``cnn_tp`` on LeNet and ``transformer_tp``
  on the tiny transformer names the same parameters with the same specs as
  the JAX package's on the same flax trees (``tests/test_parallel.py``).
- One SGD step at ``model=2`` over two gloo processes
  (``tests/torch_parallel_cluster.py``) of LeNet under ``cnn_tp`` and
  ``head_tp``, the tiny transformer under ``transformer_tp`` (unfused and
  fused head) and a cut PTB LSTM under ``lstm_tp``, every bias a seeded
  nonzero value: the loss and the whole parameters after the step equal
  the port's one-process step and the JAX package's step from the same
  flax tree (``interop.to_flax_variables`` of the whole model) at the JAX
  suite's tolerances (``tests/test_parallel.py``: loss rtol 1e-5, params
  rtol 1e-4 / atol 1e-5; the fused head's bf16 chunks against JAX at
  rtol 1e-4, as ``tests/test_torch_transformer.py`` holds it); and the
  gradients of every replicated parameter are equal bit for bit on both
  ``model`` processes (no average over ``model`` hides a difference).
- ``interop`` puts a whole flax tree into a cut model as each process's
  slices, exactly.
- The MoE FFN on each process's ``[B, Tl, d]`` block under data x seq
  equals ``moe_ffn_reference(num_ranks=1)`` over the whole batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

import torch_parallel_cluster
import torch_parallel_worker as worker
from distributed_tensorflow_models_tpu.core import mesh as jmesh
from distributed_tensorflow_models_tpu.core import sharding as jsharding
from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.parallel import tensor as jtensor
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.parallel import moe
from distributed_tensorflow_models_tpu_torch.parallel import tensor

jax.config.update("jax_platforms", "cpu")

LOSS_RTOL = 1e-5
PARAMS = dict(rtol=1e-4, atol=1e-5)
FUSED = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 2)


@pytest.mark.parametrize("name", sorted(tensor.RULE_SETS))
def test_rule_sets_match_jax(name):
    want = [(pattern, tuple(spec)) for pattern, spec in jtensor.get_rules(name)]
    assert tensor.get_rules(name) == want
    assert tensor.get_rules("") == jtensor.get_rules("") == []
    with pytest.raises(KeyError) as port:
        tensor.get_rules("nope")
    with pytest.raises(KeyError) as jax_err:
        jtensor.get_rules("nope")
    assert str(port.value) == str(jax_err.value)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.mark.parametrize("name,rules", [("lenet_cnn_tp", "cnn_tp"),
                                        ("transformer_tp", "transformer_tp")])
def test_tree_param_shardings_match_jax(name, rules):
    model = worker.tp_model(name)
    flax = interop.to_flax_variables(model)["params"]
    jm = jmesh.create_mesh(jmesh.MeshSpec(data=-1, model=2))
    got = sharding.tree_param_shardings(
        meshlib.local_mesh("cpu"), dict(model.named_parameters()),
        tensor.get_rules(rules))
    want = _flat(jax.tree.map(lambda s: tuple(s.spec),
                              jsharding.tree_param_shardings(
                                  jm, flax, jtensor.get_rules(rules)),
                              is_leaf=lambda s: hasattr(s, "spec")))
    got = {sharding.flax_path(k): (() if v == sharding.REPLICATED else v)
           for k, v in got.items()}
    assert got == want
    assert any(v for v in got.values()) and any(not v for v in got.values())


def _jax_model(name):
    model_name, kw, _, _ = worker.TP_CASES[name]
    kw = dict(kw)
    kw.pop("image_size", None)
    if model_name == "transformer_lm":
        kw["dtype"] = jnp.float32
    return jget_model(model_name, **kw)


class _Stub:
    """The fields of a JAX train state the loss functions read."""

    def __init__(self, carry=None):
        self.batch_stats = {}
        self.carry = carry


def _jax_step(name, flax):
    """The JAX package's loss and one SGD step from the whole flax tree."""
    kind = worker.TP_CASES[name][3]
    jm = _jax_model(name)
    if kind == "classification":
        loss_fn = jtrain.classification_loss_fn(jm.apply)
    else:
        loss_fn = jtrain.lm_loss_fn(jm.apply,
                                    fused_unembed=kind == "lm_fused")
    carry = None
    if name.startswith("ptb"):
        carry = tuple(tuple(jnp.asarray(t.numpy()) for t in layer)
                      for layer in worker.tp_carry())
    batch = {k: jnp.asarray(v) for k, v in worker.tp_batch(name).items()}
    params = jax.tree.map(jnp.asarray, flax)

    def f(p):
        return loss_fn(p, _Stub(carry), batch, {})

    (loss, _), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    new = jax.tree.map(lambda p, g: p - worker.TP_LR * g, params, grads)
    return float(loss), _flat(jax.tree.map(np.asarray, new))


def _port_step(name):
    """The port's one-process step on the whole model."""
    model = worker.tp_model(name)
    state = worker.tp_state(name, model)
    batch = {k: torch.from_numpy(v) for k, v in worker.tp_batch(name).items()}
    state, metrics = train_loop.make_train_step(worker.tp_loss(name, model))(
        state, batch, 0)
    return float(metrics["loss"]), _flat(interop.to_flax_variables(
        model)["params"])


@pytest.mark.two_proc
@pytest.mark.parametrize("name", sorted(worker.TP_CASES))
def test_model2_step_matches_data_parallel_and_jax(cluster2, name):
    got = dict(np.load(cluster2 / f"tp_{name}.npz"))
    loss = float(got.pop("__loss"))
    flax = interop.to_flax_variables(worker.tp_model(name))["params"]
    dp_loss, dp_params = _port_step(name)
    j_loss, j_params = _jax_step(name, flax)
    np.testing.assert_allclose(loss, dp_loss, rtol=LOSS_RTOL)
    tol = FUSED if worker.TP_CASES[name][3] == "lm_fused" else dict(
        rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, j_loss, rtol=tol["rtol"])
    assert sorted(got) == sorted(dp_params) == sorted(j_params)
    for k, v in got.items():
        np.testing.assert_allclose(v, dp_params[k], err_msg=k, **PARAMS)
        np.testing.assert_allclose(
            v, j_params[k], err_msg=k,
            **(FUSED if worker.TP_CASES[name][3] == "lm_fused" else PARAMS))


@pytest.mark.two_proc
@pytest.mark.parametrize("name", sorted(worker.TP_CASES))
def test_replicated_grads_equal_on_both_model_processes(cluster2, name):
    """LayerNorm's, the unsplit biases' and the unmatched layers'
    gradients: Megatron's *f* sums each column layer's input cotangent
    over ``model``, so both processes hold the same gradient, bit for bit
    (the LSTM under ``lstm_tp`` replicates nothing)."""
    p0, p1 = (np.load(cluster2 / f"tp_{name}_grads_p{p}.npz")
              for p in (0, 1))
    assert sorted(p0) == sorted(p1)
    split = set(tensor.shard_model(worker.tp_model(name), tensor.get_rules(
        worker.TP_CASES[name][2]), meshlib.local_mesh("cpu")))
    names = {k for k, _ in worker.tp_model(name).named_parameters()}
    assert set(p0) == names - split
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k


def test_interop_loads_each_processes_slices_exactly():
    """A whole flax tree into a model cut for process 1 of a model axis of
    2 (simulated: no exchange is made): each split parameter is its
    slice, the rest whole."""
    whole = worker.tp_model("transformer_tp")
    flax = interop.to_flax_variables(whole)
    mesh = meshlib.Mesh((1, 2, 1, 1, 1), 0, 1, CPU, coords=(0, 1, 0, 0, 0),
                        process_index=1, process_count=2)
    cut = worker.tp_model("transformer_tp")
    dims = tensor.shard_model(cut, tensor.get_rules("transformer_tp"), mesh)
    assert dims["blocks_0.attn.out.kernel"] == ("model", 0)
    assert dims["head.kernel"] == ("model", 1)
    assert "blocks_0.ln1.scale" not in dims
    with torch.no_grad():
        for p in cut.parameters():
            p.zero_()
    interop.load_flax_variables(cut, flax)
    ref = dict(whole.named_parameters())
    for k, p in cut.named_parameters():
        want = ref[k] if k not in dims else ref[k].chunk(2, dims[k][1])[1]
        assert torch.equal(p, want), k


@pytest.mark.two_proc
def test_moe_on_seq_blocks_matches_the_global_reference(cluster2):
    params = {k: v.requires_grad_() for k, v in moe.init_moe_params(
        4, 8, 16, torch.Generator().manual_seed(3)).items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8)).astype(np.float32))
    x.requires_grad_()
    ref = moe.moe_ffn_reference(params, x.reshape(-1, 8), num_ranks=1)
    # Each process's loss is its block's sum of squares plus aux.
    loss = (ref.out ** 2).sum() + 2 * ref.aux_loss
    grads = torch.autograd.grad(loss, [x, *params.values()])
    parts = [np.load(cluster2 / f"moe_seq_p{p}.npz") for p in (0, 1)]
    np.testing.assert_allclose(
        np.concatenate([p["out"] for p in parts], axis=1),
        ref.out.detach().reshape(2, 6, 8).numpy(), rtol=1e-5, atol=1e-6)
    for p in parts:
        np.testing.assert_allclose(p["aux"], float(ref.aux_loss), rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([p["dx"] for p in parts], axis=1), grads[0].numpy(),
        rtol=1e-5, atol=1e-6)
    for k, g in zip(params, grads[1:]):
        np.testing.assert_allclose(parts[0][f"d_{k}"] + parts[1][f"d_{k}"],
                                   g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("sizes,coords,seq_dim", [
    ((2, 1, 2, 1, 1), (1, 0, 0, 0, 0), 1),
    ((1, 1, 4, 1, 1), (0, 0, 3, 0, 0), 1),
    ((2, 2, 2, 1, 1), (0, 1, 1, 0, 0), 1),
    ((1, 2, 1, 1, 1), (0, 1, 0, 0, 0), None),
], ids=["data2-seq2", "seq4", "data2-model2-seq2", "model2"])
def test_dropout_keeps_its_block_of_the_global_mask(sizes, coords, seq_dim):
    """Under a mesh (simulated: dropout reads only the sizes and this
    process's coordinates) the mask is this process's block of the one
    drawn at the global array: rows over data, token columns over seq,
    and the whole features over model (the activations dropped out are
    whole there); the generator ends where one process's would."""
    from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout

    D, S = sizes[0], sizes[2]
    shape = (2 * D, 3 * (S if seq_dim else 1), 4)
    x = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape) + 1
    mesh = meshlib.Mesh(sizes, coords[0], D, CPU, coords=coords,
                        process_index=int(np.ravel_multi_index(coords, sizes)),
                        process_count=int(np.prod(sizes)))
    block = [slice(coords[0] * 2, coords[0] * 2 + 2), slice(None),
             slice(None)]
    if seq_dim:
        block[1] = slice(coords[2] * 3, coords[2] * 3 + 3)
    gen = torch.Generator().manual_seed(5)
    full = dropout(x, 0.5, True, {"dropout": gen})
    full_state = gen.get_state()
    gen = torch.Generator().manual_seed(5)
    with meshlib.data_parallel(mesh, seq_dim):
        part = dropout(x[tuple(block)], 0.5, True, {"dropout": gen})
    assert torch.equal(part, full[tuple(block)])
    assert torch.equal(gen.get_state(), full_state)
