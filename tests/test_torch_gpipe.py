"""The port's pipeline parallelism (``parallel/pipeline.py`` and the
pipelined block stack of ``models/transformer_lm.py``) against the JAX
package's, on the CPU.

- ``split_microbatches``/``merge_microbatches``, ``stack_stage_params`` and
  ``pipeline_spec`` equal the JAX package's, ``ValueError`` text included.
- ``pipeline_apply`` of the JAX test's four tanh stages on ``pipe=2``,
  ``pipe=4`` and ``data=2 x pipe=2`` gloo processes
  (``tests/torch_parallel_cluster.py``): the output and the gradients
  (stages and input) against the JAX package's ``pipeline_apply`` on its
  ``data=2 x pipe=4`` mesh and its ``sequential_apply``, at its test's
  tolerances (``tests/test_pipeline.py``: 1e-5 forward; gradients atol
  1e-5, rtol 1e-4); the port's ``emulate`` and ``sequential_apply`` too.
- The pipelined ``TransformerLM`` against the JAX ``pipelined=True`` model
  (sequential, and on its ``pipe=2`` mesh) at f32 and 2e-5, weights
  carried by ``interop``; its parameters are named and shaped as flax's.
- The pipelined transformer cut over ``pipe=2``, ``pipe=4`` and ``data=2 x
  pipe=2`` (dropout 0.3) equals the sequential schedule in one process:
  its loss and its gradients; ``emulate`` at 2 and 4 virtual stages and
  4 microbatches equals it bit for bit, dropout included.
- The JAX package's ``ValueError`` texts (the pipelined stack with MoE,
  remat, GQA, a window or RoPE; decode; layers that do not divide).
- A ``pipe=2`` run checkpointed at step 2 and resumed equals its straight
  run bit for bit from whole tensors; one process resumed from that
  checkpoint continues it; ``eval`` on the pipe mesh equals one process.
"""

from __future__ import annotations

import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

import torch_parallel_cluster
import torch_parallel_worker as worker
from distributed_tensorflow_models_tpu.core import mesh as jmesh
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.parallel import pipeline as jpp
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.harness import evaluate
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    TransformerLM,
)
from distributed_tensorflow_models_tpu_torch.parallel import pipeline as pp
from distributed_tensorflow_models_tpu_torch.parallel import tensor

jax.config.update("jax_platforms", "cpu")

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
TINY = dict(num_layers=4, num_heads=4, d_model=32, d_ff=64, max_len=16,
            vocab_size=64, dropout_rate=0.0)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 4)


def _cluster(world, cluster2, cluster4):
    return {2: cluster2, 4: cluster4}[world]


CASES = [(w, name) for w in (2, 4) for name in worker.STAGE_CASES[w]]


def _spec(world, name):
    return worker.STAGE_CASES[world][name]


# ------------------------------------------------------------ the module


def test_split_merge_roundtrip_and_errors_match_jax():
    x = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    got = pp.split_microbatches(torch.from_numpy(x), 8)
    want = jpp.split_microbatches(jnp.asarray(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pp.merge_microbatches(got).numpy(), x)
    with pytest.raises(ValueError) as jerr:
        jpp.split_microbatches(jnp.asarray(x), 7)
    with pytest.raises(ValueError) as terr:
        pp.split_microbatches(torch.from_numpy(x), 7)
    assert str(terr.value) == str(jerr.value)


def test_stack_and_spec_match_jax():
    params, _ = worker.stage_inputs()
    stages = [{k: v[i] for k, v in params.items()}
              for i in range(worker.STAGES)]
    got = pp.stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                  s.items()} for s in stages])
    want = jpp.stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                   for s in stages])
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jspec = jpp.pipeline_spec(want)
    assert pp.pipeline_spec(got) == {k: tuple(v) for k, v in jspec.items()}


_JAX: dict = {}


def _jax_stages():
    """The JAX package's pipeline on its data=2 x pipe=4 mesh and its
    sequential schedule: output and gradients (stages, input)."""
    if _JAX:
        return _JAX
    params, x = worker.stage_inputs()
    mbs = jpp.split_microbatches(jnp.asarray(x), worker.MICRO)
    mesh = jmesh.create_mesh(jmesh.MeshSpec(data=2, pipe=worker.STAGES))

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    for tag, run in (
            ("pipe", functools.partial(jpp.pipeline_apply, stage_fn,
                                       mesh=mesh)),
            ("seq", functools.partial(jpp.sequential_apply, stage_fn))):
        def loss(p, m, run=run):
            return jnp.mean((run(p, m) - 0.3) ** 2)

        p = jax.tree.map(jnp.asarray, params)
        out = jax.jit(run)(p, mbs)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, mbs)
        _JAX[tag] = (np.asarray(out), jax.tree.map(np.asarray, gp),
                     np.asarray(gx))
    return _JAX


def _gathered(out_dir, world, name):
    """The cluster's pipeline runs put together: the output and the input
    gradient over the data rows, each stage's parameter gradients."""
    spec = _spec(world, name)
    data, pipe = spec["data"], spec["pipe"]
    parts = [np.load(out_dir / f"stages_{name}_p{p}.npz")
             for p in range(world)]
    # Rank = data * pipe + pipe coordinate (the rank unravelled).
    out = np.concatenate([parts[d * pipe]["out"] for d in range(data)], 1)
    dx = np.concatenate([parts[d * pipe]["dx"] for d in range(data)], 1)
    grads = {k: np.concatenate([sum(parts[d * pipe + r][f"d_{k}"]
                                    for d in range(data))
                                for r in range(pipe)])
             for k in ("w", "b")}
    for r in range(pipe):  # every pipe process holds the output
        for d in range(data):
            np.testing.assert_array_equal(parts[d * pipe + r]["out"],
                                          parts[d * pipe]["out"])
    return out, grads, dx


@pytest.mark.two_proc
@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_pipeline_apply_on_gloo_matches_jax(cluster2, cluster4, world, name):
    out, grads, dx = _gathered(_cluster(world, cluster2, cluster4), world,
                               name)
    jx = _jax_stages()
    for tag in ("pipe", "seq"):
        jout, jgp, jgx = jx[tag]
        np.testing.assert_allclose(out, jout, **FWD)
        for k in grads:
            np.testing.assert_allclose(grads[k], jgp[k], **GRAD)
        np.testing.assert_allclose(dx, jgx, **GRAD)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_emulate_and_sequential_match_jax(n):
    """The one-process schedule of ``n`` virtual stages (each applying
    4/n of the tanh layers) and the sequential oracle, forward and
    gradients, against the JAX package's sequential schedule."""
    params, x = worker.stage_inputs()
    k = worker.STAGES // n
    stacked = {key: torch.from_numpy(v).reshape(n, k, *v.shape[1:])
               .requires_grad_() for key, v in params.items()}
    xs = pp.split_microbatches(torch.from_numpy(x), worker.MICRO)
    xs.requires_grad_()
    jout, jgp, jgx = _jax_stages()["seq"]
    for run in (pp.emulate, pp.sequential_apply):
        args = (n,) if run is pp.emulate else ()
        out = run(worker.tanh_stage, stacked, xs, *args)
        loss = torch.mean((out - 0.3) ** 2)
        g = torch.autograd.grad(loss, [xs, *stacked.values()])
        np.testing.assert_allclose(out.detach().numpy(), jout, **FWD)
        np.testing.assert_allclose(g[0].numpy(), jgx, **GRAD)
        for key, gk in zip(stacked, g[1:]):
            np.testing.assert_allclose(gk.reshape(jgp[key].shape).numpy(),
                                       jgp[key], **GRAD)


# ------------------------------------------------ the pipelined transformer


def _jax_lm(mesh=None, **kw):
    return jget_model("transformer_lm", **{**TINY, **kw},
                      dtype=jnp.float32, attn_impl="reference",
                      **({"pipe_mesh": mesh} if mesh else
                         {"pipelined": True}))


def _port_lm(**kw):
    return TransformerLM(**{**TINY, **kw}, dtype=torch.float32,
                         attn_impl="reference", pipelined=True,
                         generator=torch.Generator().manual_seed(0))


def test_pipelined_params_are_named_and_shaped_as_flax():
    toks = jnp.zeros((4, 16), jnp.int32)
    jparams = _jax_lm().init(jax.random.key(0), toks)["params"]
    flat = worker._flat(jax.tree.map(lambda a: list(a.shape), jparams))
    got = {k.replace(".", "/"): list(v.shape)
           for k, v in _port_lm().named_parameters()}
    assert got == flat
    assert not any(k.startswith("blocks_") for k in got)


@pytest.mark.parametrize("batch,micro", [(16, 4), (6, 4)],
                         ids=["divides", "clamped"])
def test_pipelined_lm_matches_jax(batch, micro):
    """JAX ``tests/test_transformer.py::TestPipelineParallel``: the
    sequential and the pipe-mesh schedules on the same variables at f32,
    2e-5.  A microbatch count that does not divide the batch runs the
    mesh-free path at one microbatch, as JAX's does."""
    model = _port_lm(pipeline_microbatches=micro)
    variables = jax.tree.map(jnp.asarray, interop.to_flax_variables(model))
    toks = np.random.RandomState(0).randint(0, 64, (batch, 16))
    got, _ = model(torch.from_numpy(toks).long())
    runs = [_jax_lm(pipeline_microbatches=micro)]
    if batch % micro == 0:
        runs.append(_jax_lm(jmesh.create_mesh(jmesh.MeshSpec(data=-1,
                                                             pipe=2)),
                            pipeline_microbatches=micro))
    for jm in runs:
        want, _ = jm.apply(variables, jnp.asarray(toks, jnp.int32))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,micro", [(2, 2), (2, 4), (4, 4)])
def test_pipelined_emulate_equals_sequential_with_dropout(n, micro):
    """``n`` virtual stages at ``micro`` microbatches, dropout 0.3: the
    masks depend only on (layer, sublayer, row), so the schedule draws
    the sequential one's bit for bit, forward and gradients."""
    model = _port_lm(dropout_rate=0.3, pipeline_microbatches=micro)
    x = torch.randn(8, 16, 32, generator=torch.Generator().manual_seed(2))
    runs = []
    for emulate in (False, True):
        gen = {"dropout": torch.Generator().manual_seed(5)}
        y = (model.pipeline.emulate(x, n, True, gen) if emulate
             else model.pipeline(x, True, gen))
        grads = torch.autograd.grad(y.square().sum(),
                                    list(model.pipeline.parameters()))
        runs.append((y.detach(), grads))
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], model.pipeline(x))  # dropout acted
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def _sequential_step(kw=None):
    """The sequential schedule's loss and gradients on the cluster's
    batch, dropout drawn from the same seed."""
    model = worker.pipe_lm(kw)
    batch = {k: torch.from_numpy(v) for k, v in worker.pipe_lm_batch().items()}
    params = dict(model.named_parameters())
    loss, _ = train_loop.lm_loss_fn(model)(params, train_loop.TrainState(
        step=0, params=params, batch_stats={}, opt_state={}, model=model,
        tx=None, device_step=torch.zeros(())), batch,
        {"dropout": torch.Generator().manual_seed(9)})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {f"d/{k}": g.numpy()
                                  for k, g in zip(params, grads)}


@pytest.mark.two_proc
@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_pipelined_lm_on_gloo_equals_sequential(cluster2, cluster4, world,
                                                name):
    """Dropout 0.3: the pipe layouts' loss (the data processes' mean) and
    the whole gradients (averaged over data) against one process's
    sequential schedule; bit for bit on one data block."""
    out = _cluster(world, cluster2, cluster4)
    parts = [np.load(out / f"pipe_lm_{name}_p{p}.npz") for p in range(world)]
    loss, grads = _sequential_step()
    data = _spec(world, name)["data"]
    assert set(grads) == {k for k in parts[0].files if k.startswith("d/")}
    if data == 1:
        for p in parts:
            assert float(p["loss"]) == loss
            for k, g in grads.items():
                np.testing.assert_array_equal(p[k], g, err_msg=k)
        return
    np.testing.assert_allclose(np.mean([float(p["loss"]) for p in parts]),
                               loss, rtol=1e-6)
    for p in parts:
        for k, g in grads.items():
            np.testing.assert_allclose(p[k], g, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("kw", [dict(num_experts=4), dict(remat=True),
                                dict(num_kv_heads=2), dict(attn_window=4),
                                dict(pos_encoding="rope"),
                                dict(decode=True)],
                         ids=["moe", "remat", "gqa", "window", "rope",
                              "decode"])
def test_pipelined_restrictions_raise_jax_errors(kw):
    toks = jnp.zeros((4, 16), jnp.int32)
    jkw = dict(kw)
    if jkw.get("decode"):
        jkw["max_len"] = 16
    with pytest.raises(ValueError) as jerr:
        _jax_lm(**jkw).init(jax.random.key(0), toks)
    with pytest.raises(ValueError) as terr:
        _port_lm(**kw)
    assert str(terr.value) == str(jerr.value)


def test_layers_that_do_not_divide_raise_the_jax_error():
    mesh = meshlib.Mesh((1, 1, 1, 3, 1), 0, 1, CPU,
                        coords=(0, 0, 0, 1, 0))
    with pytest.raises(ValueError) as terr:
        tensor.shard_model(_port_lm(), [], mesh)
    with pytest.raises(ValueError) as jerr:
        # JAX's message, from its stack at a pipe axis of 3 (no mesh
        # needed to reach it: the check precedes the schedule).
        class Fake:
            shape = {"pipe": 3}
        jpp_blocks = _jax_lm(Fake())
        jpp_blocks.init(jax.random.key(0), jnp.zeros((6, 16), jnp.int32))
    assert str(terr.value) == str(jerr.value)


def test_the_cut_keeps_a_stage_and_its_mesh():
    """``shard_model`` at pipe 2 keeps this process's ``[L/2, ...]`` of
    every stacked parameter, records ``(pipe, 0)`` and gives the stack the
    mesh; ``interop`` slices a whole flax tree the same way."""
    whole = _port_lm()
    mesh = meshlib.Mesh((1, 1, 1, 2, 1), 0, 1, CPU, coords=(0, 0, 0, 1, 0))
    model = _port_lm()
    dims = tensor.shard_model(model, [], mesh)
    assert dims == {f"pipeline.{k}": ("pipe", 0)
                    for k in model.pipeline.PARAMS}
    assert model.pipeline.pipe_mesh is mesh
    assert tensor.split_axes(model) == {k: "pipe" for k in dims}
    for k, v in whole.pipeline.named_parameters():
        assert torch.equal(getattr(model.pipeline, k), v[2:])
    again = _port_lm(dropout_rate=0.5)
    tensor.shard_model(again, [], mesh)
    interop.load_flax_variables(again, interop.to_flax_variables(whole))
    for k, v in model.named_parameters():
        assert torch.equal(dict(again.named_parameters())[k], v)


# ------------------------------------------- checkpoints, eval, the harness


@pytest.mark.two_proc
def test_resume_on_the_pipe_layout_is_bit_identical(cluster2):
    got = np.load(cluster2 / "resume_pipe.npz")
    assert int(got["__restored_from"]) == 2
    keys = [k for k in got if k.startswith("straight/") and "__" not in k]
    assert any("pipeline" in k for k in keys)
    for k in keys:
        assert np.array_equal(got[k], got["resumed/" + k[len("straight/"):]]), k
    manifest = json.loads((cluster2 / "resume_pipe" / "checkpoints" / "4"
                           / "manifest.json").read_text())["tensors"]
    d, L = worker.LM_KW["d_model"], worker.PIPE_KW["num_layers"]
    assert manifest["params/pipeline.wq"]["shape"] == [L, d, d]


@pytest.mark.two_proc
def test_one_process_resumes_a_pipe_checkpoint(cluster2, tmp_path):
    """The ``pipe=2`` run's step-2 checkpoint resumed by one process (the
    sequential schedule) trains on to the ``pipe=2`` run's straight 4
    steps: bit for bit, the pipe layout of one data block computing as one
    process does."""
    shutil.copytree(cluster2 / "resume_pipe" / "checkpoints",
                    tmp_path / "checkpoints")
    for d in ("4", "dataset_states/4"):
        shutil.rmtree(tmp_path / "checkpoints" / d)
    cfg = worker.LM.replace(**worker.FIT_CASES[2]["pipe"], train_steps=4,
                            log_every_steps=2)
    res = trainlib.fit(cfg.replace(**worker.LAYOUT), str(tmp_path),
                       device="cpu", mesh=meshlib.local_mesh("cpu"))
    assert res.restored_from == 2 and res.state.step == 4
    got = np.load(cluster2 / "resume_pipe.npz")
    flat = worker._flat(interop.to_flax_variables(res.state.model)["params"])
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), got["straight/" + k],
                                      err_msg=k)


@pytest.mark.two_proc
def test_eval_on_the_pipe_mesh_equals_one_process(cluster2):
    got = json.loads((cluster2 / "eval_pipe.json").read_text())
    cfg = worker.LM.replace(**worker.FIT_CASES[2]["pipe"])
    want = evaluate.evaluate_lm(cfg.replace(**worker.LAYOUT),
                                str(cluster2 / "resume_pipe"), max_batches=2,
                                device="cpu", mesh=meshlib.local_mesh("cpu"))
    assert got["step"] == want.step == 4
    np.testing.assert_allclose(got["nll"], want.metrics["nll"], rtol=1e-6)


@pytest.mark.two_proc
def test_cli_trains_on_a_pipe_mesh(cluster2):
    workdir = cluster2 / "cli_pipe"
    report = json.loads((workdir / "telemetry.json").read_text())
    assert report["steps"] == 2
    manifest = json.loads((workdir / "checkpoints" / "2" / "manifest.json")
                          .read_text())["tensors"]
    assert manifest["params/pipeline.wq"]["shape"][0] == 2  # tiny: 2 layers


def test_mesh_pipe_pipelines_the_transformer():
    """``mesh_pipe > 1`` builds the pipelined stack (the JAX harness's
    ``_init_model_kwargs``), even over ``pipelined=False``, and keeps the
    pipe+seq and pipe+model ``ValueError``s."""
    from distributed_tensorflow_models_tpu_torch.harness import config

    cfg = config.get_config("transformer_lm_tiny", mesh_pipe=2)
    assert trainlib._model_kwargs(cfg)["pipelined"] is True
    cfg = cfg.replace(model_kwargs={**cfg.model_kwargs, "pipelined": False})
    assert trainlib._model_kwargs(cfg)["pipelined"] is True
    assert "pipelined" not in trainlib._model_kwargs(
        config.get_config("transformer_lm_tiny"))
    for kw in (dict(mesh_data=1, mesh_model=2), dict(seq_impl="ring")):
        with pytest.raises(ValueError, match="cannot combine"):
            trainlib._model_kwargs(config.get_config(
                "transformer_lm_tiny", mesh_pipe=2, **kw))


def test_step_flops_count_this_stages_share():
    """The FLOPs count at pipe 2 is one stage's layers on every
    microbatch plus the rest of the model (embedding, head): both stages
    count the same share, half the stack's less than one process."""
    from distributed_tensorflow_models_tpu_torch.harness import config

    cfg = config.get_config("transformer_lm_tiny",
                            model_kwargs={**TINY, "pipelined": True})
    batch = {"inputs": torch.zeros(4, 16, dtype=torch.int64),
             "targets": torch.zeros(4, 16, dtype=torch.int64)}
    one = trainlib.step_flops_fn(cfg, meshlib.Mesh((1, 1, 1, 1, 1), 0, 1,
                                                   CPU))(batch)
    shares = []
    for r in range(2):
        mesh = meshlib.Mesh((1, 1, 1, 2, 1), 0, 1, CPU,
                            coords=(0, 0, 0, r, 0))
        shares.append(trainlib.step_flops_fn(cfg.replace(mesh_pipe=2),
                                             mesh)(batch))
    assert shares[0] == shares[1]
    half_stack = one - shares[0]
    assert half_stack > 0 and shares[0] - half_stack > 0


def test_cli_takes_the_pipe_and_expert_flags_and_generate_refuses_pipes(
        tmp_path):
    """``--mesh-pipe`` and ``--mesh-expert`` reach the config on ``train``,
    ``eval`` and ``generate`` (the JAX CLI's flags); ``generate`` refuses a
    pipelined checkpoint with the JAX CLI's message."""
    from distributed_tensorflow_models_tpu_torch.harness import cli
    from distributed_tensorflow_models_tpu_torch.harness import config

    seen = {}

    def record(cmd):
        def run(cfg, args):
            seen[cmd] = (cfg.mesh_pipe, cfg.mesh_expert)
            return 0
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "_eval", record("eval"))
        mp.setattr(cli, "_generate", record("generate"))
        mp.setattr(cli, "_train", lambda args, over: record("train")(
            config.get_config(args.config, **over), args))
        for cmd in ("train", "eval", "generate"):
            assert cli.main([cmd, "--config", "transformer_lm_tiny",
                             "--workdir", str(tmp_path), "--device", "cpu",
                             "--mesh-pipe", "2", "--mesh-expert", "4"]) == 0
    assert seen == dict.fromkeys(("train", "eval", "generate"), (2, 4))
    with pytest.raises(SystemExit, match="does not support pipelined"):
        cli.main(["generate", "--config", "transformer_lm_tiny", "--workdir",
                  str(tmp_path), "--device", "cpu", "--mesh-pipe", "2"])
