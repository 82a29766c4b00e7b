"""The port's ``fit`` on tensor- and sequence-parallel layouts, port against
port, on the CPU over gloo (``tests/torch_parallel_cluster.py``).

The JAX package's own fit-level layout tests (``tests/test_transformer.py``)
are red on this machine, so the oracle here is the port's one-process
(data-parallel) ``fit`` of the same config over the same steps.  The tiny
transformer (f32, dropout 0.1: the dropout masks are the global array's
blocks, and positions are global, so a wrong block shows in the loss)
trains 3 steps on each layout:

- ``seq=2`` with the ring and with Ulysses, ``model=2`` (``transformer_tp``,
  fused head), the ring with GQA, a window and RoPE, the ring with the
  MoE blocks under remat (the MoE routes the global batch of data x seq),
  and ``model=2 x seq=2`` on 4 processes; the pipelined stack at
  ``pipe=2``, ``pipe=4`` and ``data=2 x pipe=2``, the MoE blocks at
  ``expert=2`` and ``data=2 x expert=2``: each step's loss within 1e-3 of
  the one-process run (the JAX package asks that of its layouts), and each
  layout's collectives on its own axis.  The pipe layouts of one data
  block equal the one-process run bit for bit.  The expert layout routes
  each chunk with its own capacity and averages the chunks' aux losses
  (``moe_ffn_reference(num_ranks=E)``, the per-source accounting of the
  JAX package's layout): its one-process oracle routes so too; at
  capacity factor 8, where no token is dropped either way, the first
  step's nll also equals the plain one-process run's;
- F7: under SGD with a clip that acts at every step, the ``model=2``,
  ``pipe=2`` and ``expert=2`` runs equal the one-process run (losses,
  ``grad_norm``, the parameters): the global norm is the whole arrays';
- the ring's first loss with dropout off against the JAX package's
  single-device loss from the same flax tree (fused head: rtol 1e-4);
- ``eval`` of a ring run's checkpoint on the seq mesh against the same eval
  in one process; a ``model=2`` run killed at step 2 and resumed equals its
  straight run bit for bit, from a checkpoint of whole tensors, and one
  process resumed from that checkpoint ends within the TP step tolerance
  (params rtol 1e-4 / atol 1e-5; the key biases, whose true gradient is
  zero, within 2 x steps x lr) of the straight run; the CLI's
  ``train --mesh-seq 2 --seq-impl ring`` over two processes.
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
from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.harness import evaluate
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

jax.config.update("jax_platforms", "cpu")

pytestmark = pytest.mark.two_proc

LOSS_ATOL = 1e-3
STEPS = worker.LM.train_steps
LAYERS = worker.LM_KW["num_layers"]


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 4)


def _one_process(kw):
    """The layout's config with the layout taken out."""
    return worker.LM.replace(**{**kw, **worker.LAYOUT})


# Collectives a step issues on the layout's axes (per step: per layer
# for the attention and the split pairs).
AXIS_SITES = {
    "ring": {"seq/ring_kv": LAYERS, "seq/ring_kv_grad": LAYERS},
    "ulysses": {"seq/ulysses_qkv": LAYERS, "seq/ulysses_out": LAYERS,
                "seq/ulysses_out_grad": LAYERS,
                "seq/ulysses_qkv_grad": LAYERS},
    "model": {"model/gather": 1, "model/weight_gather": 2,
              "model/sum": 2 * LAYERS, "model/copy_grad": 2 * LAYERS},
    "ring_gqa_window": {"seq/ring_kv": LAYERS, "seq/ring_kv_grad": LAYERS},
    # Remat runs each block's forward again in the backward: its ring and
    # the MoE block's gather once more.
    "moe_remat_ring": {"seq/ring_kv": 2 * LAYERS, "seq/ring_kv_grad": LAYERS,
                       "moe_tokens": 2, "moe_tokens_grad": 1},
    "model_seq": {"seq/ring_kv": LAYERS, "seq/ring_kv_grad": LAYERS,
                  "model/gather": 1, "model/weight_gather": 2,
                  "model/sum": 2 * LAYERS, "model/copy_grad": 2 * LAYERS},
}
# The pipeline's M + n - 2 rotations each way, its input's *f*, its
# output's *g* (the activations; the row ids are returned as given), and
# the norm's sum.
MICRO = worker.PIPE_KW["pipeline_microbatches"]
for _name, _n in (("pipe", 2), ("pipe4", 4), ("data_pipe", 2)):
    AXIS_SITES[_name] = {"pipe/rotate": MICRO + _n - 2,
                         "pipe/rotate_grad": MICRO + _n - 2,
                         "pipe/input_grad": 1, "pipe/output": 1,
                         "pipe/norm": 1}
# One MoE block (blocks_1): its two all-to-alls each way, the chunks'
# gather and its backward, the aux/dropped mean, the router's *f*, and
# the norm's sum over the split experts.
for _name in ("expert", "data_expert"):
    AXIS_SITES[_name] = {
        "expert/dispatch": 1, "expert/return": 1, "expert/dispatch_grad": 1,
        "expert/return_grad": 1, "expert/tokens": 1,
        "expert/tokens_grad": 1, "expert/stats": 1, "expert/router_grad": 1,
        "expert/norm": 1}
AXES = ("model", "seq", "pipe", "expert")
FITS = [(w, name) for w in (2, 4) for name in worker.FIT_CASES[w]]


def _route_by_chunks(monkeypatch, kw):
    """Where ``kw`` splits the MoE's experts over E processes, make the
    one-process MoE route as that layout does: the global tokens in E
    chunks, each with its own capacity (``moe_ffn_reference(num_ranks=
    E)``)."""
    ranks = kw.get("mesh_expert", 1)
    if ranks == 1:
        return
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    def by_chunks(params, x, *, mesh=None, capacity_factor=1.25,
                  activation=torch.relu):
        res = moe.moe_ffn_reference(
            params, x.reshape(-1, x.shape[-1]), num_ranks=ranks,
            capacity_factor=capacity_factor, activation=activation)
        return res._replace(out=res.out.reshape(x.shape))

    monkeypatch.setattr(moe, "moe_ffn", by_chunks)


@pytest.mark.parametrize("world,name", FITS, ids=[n for _, n in FITS])
def test_fit_on_each_layout_matches_one_process(cluster2, cluster4, world,
                                                name, monkeypatch):
    got = json.loads(({2: cluster2, 4: cluster4}[world]
                      / f"fits{world}.json").read_text())[name]
    kw = worker.FIT_CASES[world][name]
    _route_by_chunks(monkeypatch, kw)
    want = trainlib.fit(_one_process(kw), device="cpu",
                        mesh=meshlib.local_mesh("cpu"))
    np.testing.assert_allclose(got["loss"], [float(r["loss"]) for r in
                                             want.history], atol=LOSS_ATOL)
    for site, per_step in AXIS_SITES[name].items():
        assert got["collectives"][site][0] == per_step * STEPS, site
    # Nothing rides an axis of size one.
    axes = {s.split("/")[0] for s in got["collectives"] if "/" in s}
    assert axes == {a for a in AXES if kw.get(f"mesh_{a}", 1) > 1}


@pytest.mark.parametrize("world,name", [(2, "pipe"), (4, "pipe4")])
def test_pipe_fit_equals_one_process_bit_for_bit(cluster2, cluster4, world,
                                                 name):
    """One data block on a pipe axis computes each microbatch's layers as
    the one process does, and its only sums add zeros (the input's *f*,
    the output's *g*): the losses are equal bit for bit."""
    got = json.loads(({2: cluster2, 4: cluster4}[world]
                      / f"fits{world}.json").read_text())[name]
    want = trainlib.fit(_one_process(worker.FIT_CASES[world][name]),
                        device="cpu", mesh=meshlib.local_mesh("cpu"))
    assert got["loss"] == [float(r["loss"]) for r in want.history]
    assert got["nll"] == [float(r["nll"]) for r in want.history]


@pytest.mark.parametrize("world,name", [(2, "expert"), (4, "data_expert")])
def test_expert_fit_first_nll_equals_one_process(cluster2, cluster4, world,
                                                 name):
    """At capacity factor 8 no token is dropped by the expert layout's
    per-chunk capacity nor by one process's global one, so at the initial
    weights the two compute the same outputs: the first step's nll
    agrees to round-off (the aux losses differ by design: a mean of the
    chunks' against the global set's)."""
    got = json.loads(({2: cluster2, 4: cluster4}[world]
                      / f"fits{world}.json").read_text())[name]
    want = trainlib.fit(_one_process(worker.FIT_CASES[world][name]),
                        device="cpu", mesh=meshlib.local_mesh("cpu"))
    np.testing.assert_allclose(got["nll"][0], float(want.history[0]["nll"]),
                               rtol=1e-6)
    assert got["aux_loss"][0] > 0


@pytest.mark.parametrize("name", list(worker.CLIP_CASES))
def test_clipped_fit_on_a_split_layout_matches_one_process(cluster2, name,
                                                           monkeypatch):
    """F7: clipping reads the global norm of the whole arrays.  With a
    clip far below the gradient norm it scales every step, so a norm
    taken over one process's slices of the split gradients would move
    the trajectory (and report a smaller ``grad_norm``).  The norm is
    taken once a step, for the metric and the clip alike: one sum over
    the layout's axis."""
    got = np.load(cluster2 / "clips.npz")
    kw = worker.CLIP_CASES[name]
    _route_by_chunks(monkeypatch, kw)
    want = trainlib.fit(_one_process(kw).replace(optimizer=worker.CLIP),
                        device="cpu", mesh=meshlib.local_mesh("cpu"))
    norms = [float(r["grad_norm"]) for r in want.history]
    assert min(norms) > 10 * worker.CLIP.clip_global_norm
    np.testing.assert_allclose(got[f"{name}/__loss"],
                               [float(r["loss"]) for r in want.history],
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got[f"{name}/__grad_norm"], norms, rtol=1e-5)
    assert int(got[f"{name}/__norm_sums"]) == STEPS
    flat = worker._flat(interop.to_flax_variables(want.state.model)["params"])
    assert {k[len(name) + 1:] for k in got.files
            if k.startswith(f"{name}/") and "__" not in k} == set(flat)
    for k, v in flat.items():
        np.testing.assert_allclose(got[f"{name}/{k}"], np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_first_ring_loss_matches_jax(cluster2):
    """Dropout off: the ring layout's loss at the initial weights (the
    mean of the two processes' block means) is the JAX package's loss of
    the whole batch from the same flax tree."""
    losses = json.loads((cluster2 / "first_loss_ring.json").read_text())
    cfg = _one_process(worker.FIT_CASES[2]["ring"]).replace(
        model_kwargs={**worker.LM_KW, "dropout_rate": 0.0})
    model = trainlib.build_model(cfg, torch.device("cpu"))
    flax = interop.to_flax_variables(model)["params"]
    jm = jget_model("transformer_lm", **{
        **worker.LM_KW, "dropout_rate": 0.0, "dtype": jnp.float32,
        "attn_impl": "reference"})
    batch = next(iter(trainlib.build_dataset(cfg)))
    loss_fn = jtrain.lm_loss_fn(jm.apply, fused_unembed=cfg.fused_unembed)

    class S:
        carry = None
        batch_stats = {}

    jloss, _ = loss_fn(jax.tree.map(jnp.asarray, flax), S(),
                       {k: jnp.asarray(v) for k, v in batch.items()}, {})
    np.testing.assert_allclose(np.mean(losses), float(jloss), rtol=1e-4)


def test_eval_on_the_seq_mesh_equals_one_process(cluster2):
    got = json.loads((cluster2 / "eval_ring.json").read_text())
    cfg = _one_process(worker.FIT_CASES[2]["ring"])
    want = evaluate.evaluate_lm(cfg, str(cluster2 / "eval_ring"),
                                max_batches=2, device="cpu",
                                mesh=meshlib.local_mesh("cpu"))
    assert got["step"] == want.step == 2
    np.testing.assert_allclose(got["nll"], want.metrics["nll"], rtol=1e-5)


def test_resume_on_a_tp_layout_is_bit_identical(cluster2):
    got = np.load(cluster2 / "resume_tp.npz")
    assert int(got["__restored_from"]) == 2
    assert int(got["straight/__step"]) == int(got["resumed/__step"]) == 4
    keys = [k for k in got if k.startswith("straight/") and "__" not in k]
    assert keys
    for k in keys:
        assert np.array_equal(got[k], got["resumed/" + k[len("straight/"):]]), k
    # The checkpoint holds whole tensors, gathered over the model axis.
    manifest = json.loads((cluster2 / "resume_tp" / "checkpoints" / "4"
                           / "manifest.json").read_text())["tensors"]
    d, vocab = worker.LM_KW["d_model"], worker.LM_KW["vocab_size"]
    assert manifest["params/blocks_0.attn.query.kernel"]["shape"] == [d, d]
    assert manifest["params/head.kernel"]["shape"] == [d, vocab]


def test_resume_on_another_layout_continues_the_run(cluster2, tmp_path):
    """The ``model=2`` run's step-2 checkpoint (whole tensors, its dataset
    cursors) resumed by one process trains on to the parameters of the
    ``model=2`` run's own straight 4 steps, within the TP step tolerance
    (the key biases within Adam's steps of round-off)."""
    import shutil

    shutil.copytree(cluster2 / "resume_tp" / "checkpoints",
                    tmp_path / "checkpoints")
    for d in ("4", "dataset_states/4"):  # the straight run's end
        shutil.rmtree(tmp_path / "checkpoints" / d)
    cfg = worker.LM.replace(**worker.FIT_CASES[2]["model"], train_steps=4,
                            log_every_steps=2)
    res = trainlib.fit(cfg.replace(**worker.LAYOUT), str(tmp_path),
                       device="cpu", mesh=meshlib.local_mesh("cpu"))
    assert res.restored_from == 2 and res.state.step == 4
    got = np.load(cluster2 / "resume_tp.npz")
    flat = worker._flat(interop.to_flax_variables(res.state.model)["params"])
    assert set(flat) == {k[len("straight/"):] for k in got
                         if k.startswith("straight/") and "__" not in k}
    lr = cfg.optimizer.learning_rate
    for k, v in flat.items():
        if k.endswith("attn/key/bias"):
            # Its true gradient is exactly zero (softmax is shift-invariant
            # per query); Adam scales each side's round-off to a step of up
            # to lr, so each stays within steps * lr of the start.
            assert np.abs(np.asarray(v) - got["straight/" + k]).max() <= (
                2 * cfg.train_steps * lr), k
            continue
        np.testing.assert_allclose(np.asarray(v), got["straight/" + k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_cli_trains_on_a_seq_mesh(cluster2):
    workdir = cluster2 / "cli_ring"
    report = json.loads((workdir / "telemetry.json").read_text())
    assert report["steps"] == 2
    assert (workdir / "checkpoints" / "2").is_dir()


def test_generate_on_a_seq_config_decodes_with_the_plain_model(tmp_path,
                                                               capsys):
    """``generate`` on a config with ``seq_impl`` builds the plain decode
    model (no sequence-parallel ``attention_fn``, as the JAX CLI builds
    ``get_model(**model_kwargs)``); a seq axis wider than the one process
    raises the mesh's error, as the JAX package's ``mesh_from_config``
    does on one device."""
    from distributed_tensorflow_models_tpu_torch.harness import cli
    from distributed_tensorflow_models_tpu_torch.harness import config

    cfg = config.get_config("transformer_lm_tiny", train_steps=1,
                            seq_impl="ring")
    trainlib.fit(cfg, str(tmp_path), device="cpu",
                 mesh=meshlib.local_mesh("cpu"))
    argv = ["generate", "--config", "transformer_lm_tiny", "--workdir",
            str(tmp_path), "--device", "cpu", "--prompt", "1,2,3",
            "--max-new-tokens", "4", "--seq-impl", "ring"]
    with pytest.raises(ValueError, match="1 devices not divisible by fixed "
                       "axes product 2"):
        cli.main(argv + ["--mesh-seq", "2"])
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 1 and len(out["tokens"]) == 3 + 4
