"""Remat (``ops/remat.py``) in the port's transformer, ResNet and
Inception-v3, against the same models without it and against the JAX
package's ``nn.remat`` models.

On the CPU a block's recompute runs the same operators on the same
inputs as its forward, so remat and no-remat agree bit for bit: the
stated bound is 0 for the loss, every gradient, the dropout masks (the
recompute's generators start where the forward's did) and BatchNorm's
running statistics (the recompute leaves them alone, so a step updates
them once).  Against JAX, at dropout 0, the tolerances of the models' own
parity tests: the transformer's f32 loss and gradients to 1e-5 (of the
largest gradient), the small ResNet's logits and statistics to 2e-3 and
its gradients to 5e-4, Inception-v3's logits and statistics to 2e-3.

FLOPs: under remat ``step_flops`` counts what the step runs, so the
recomputed forward of the blocks too (the JAX ``fit`` counts the same
through XLA's cost analysis of the remat'd program).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)
from torch.utils.flop_counter import FlopCounterMode

from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.core.train_state import TrainState as JTrainState
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import mesh as tmesh
from distributed_tensorflow_models_tpu_torch.core import train_loop as ttrain
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.models import transformer_lm as tlm
from distributed_tensorflow_models_tpu_torch.models.inception_v3 import InceptionV3
from distributed_tensorflow_models_tpu_torch.models.resnet import ResNet
from distributed_tensorflow_models_tpu_torch.ops import optim as toptim
from distributed_tensorflow_models_tpu_torch.ops import remat as rematlib

jax.config.update("jax_platforms", "cpu")

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=64, d_ff=128,
            max_len=64)
RESNET = dict(stage_sizes=(1, 1, 1, 1), width=16, num_classes=10)
INCEPTION = dict(num_classes=10, dropout_rate=0.0)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(atol=2e-3, rtol=2e-3)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _tokens(seed=1, batch=4, T=64):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, TINY["vocab_size"], (batch, T + 1))
    return {"inputs": torch.from_numpy(toks[:, :-1]),
            "targets": torch.from_numpy(toks[:, 1:])}


def _lm(remat, params=None, **kw):
    m = tlm.TransformerLM(**TINY, dtype=torch.float32, attn_impl="flash",
                          remat=remat, **kw)
    if params is not None:
        interop.load_flax_variables(m, {"params": params})
    return m


def _lm_grads(model, batch, seed=5, fused=False):
    state = TrainState.create(model, toptim.sgd(0.0))
    loss, aux = ttrain.lm_loss_fn(model, fused_unembed=fused)(
        state.params, state, batch,
        {"dropout": torch.Generator().manual_seed(seed)})
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    return loss, aux["metrics"], dict(zip(names, grads))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_transformer_remat_equals_no_remat(monkeypatch, moe):
    """Dropout 0.3: the loss, the sown aux loss (counted once), every
    gradient and every dropout mask of the remat step equal the no-remat
    step's, and each recomputed mask equals its block's forward mask."""
    kw = dict(dropout_rate=0.3, num_experts=4 if moe else 0)
    params = interop.to_flax_variables(
        _lm(False, generator=torch.Generator().manual_seed(0), **kw))
    calls = []
    real = tlm.dropout

    def recording(x, rate, train, rngs):
        # The mask this call is about to draw, from a copy of its
        # generator (the recompute may stop inside the call, once the
        # last tensor the backward needs exists).
        probe = torch.Generator()
        probe.set_state(rngs["dropout"].get_state())
        keep = torch.rand(x.shape, generator=probe) < 1.0 - rate
        calls.append((rematlib.recomputing(), keep))
        return real(x, rate, train, rngs)

    monkeypatch.setattr(tlm, "dropout", recording)
    runs = {}
    for remat in (False, True):
        calls.clear()
        model = _lm(remat, params["params"], **kw)
        runs[remat] = (*_lm_grads(model, _tokens()), list(calls))
    (l0, m0, g0, c0), (l1, m1, g1, c1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    assert sorted(m0) == sorted(m1)
    assert ("aux_loss" in m1) == moe
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # The no-remat step: the embedding's mask, then each block's
    # attention and (dense blocks) MLP masks; the remat step draws the
    # same in its forward, and its recomputes again.
    per_block = [2, 1 if moe else 2]
    assert len(c0) == 1 + sum(per_block)
    forward = [out for again, out in c1 if not again]
    again = [out for again, out in c1 if again]
    assert len(forward) == len(c0)
    for (_, want), got in zip(c0, forward):
        assert torch.equal(got, want)
    # Recomputes run in the backward, last block first.
    blocks = [c0[1:1 + per_block[0]], c0[1 + per_block[0]:]]
    assert len(again) == sum(per_block)
    want = [out for blk in reversed(blocks) for _, out in blk]
    for got, w in zip(again, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_transformer_remat_matches_jax(moe):
    """JAX's ``nn.remat`` transformer (reference attention, dropout 0)
    against the port's remat one on carried weights: loss, nll, aux and
    every gradient."""
    kw = dict(dropout_rate=0.0, num_experts=4 if moe else 0)
    jm = jget_model("transformer_lm", **TINY, **kw, dtype=jnp.float32,
                    attn_impl="reference", remat=True)
    jparams = jax.tree.map(np.asarray, dict(jax.jit(lambda k: jm.init(
        k, jnp.zeros((2, 64), jnp.int32)))(jax.random.key(7))["params"]))
    batch = _tokens(seed=3)
    jloss = jtrain.lm_loss_fn(jm.apply, fused_unembed=False)
    jstate = JTrainState.create(jm, optax.identity(), jax.random.key(0),
                                jnp.zeros((2, 64), jnp.int32))
    (jl, jaux), jgrads = jax.jit(lambda p, b: jax.value_and_grad(
        lambda p: jloss(p, jstate, b, {}), has_aux=True)(p))(
            jax.tree.map(jnp.asarray, jparams),
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    loss, metrics, grads = _lm_grads(_lm(True, jparams, **kw), batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **F32_TOL)
    for k, v in jaux["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), err_msg=k,
                                   **F32_TOL)
    want = _leaves(jax.tree.map(np.asarray, dict(jgrads)))
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert sorted(want) == sorted(k.replace(".", "/") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k.replace(".", "/")],
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)


def _images(seed, size, batch=2):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        batch, size, size, 3).astype(np.float32))


def _conv_step(model, x, seed=9):
    """One training forward (BN statistics updated in place) and the
    gradients of a fixed linear function of the logits."""
    out = model(x, train=True)
    w = torch.from_numpy(np.random.RandomState(seed).randn(
        *out.shape).astype(np.float32))
    loss = (out * w).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return out.detach(), dict(zip(names, grads)), {
        k: v.clone() for k, v in model.named_buffers()}


def _conv_models(build, variables):
    out = []
    for remat in (False, True):
        m = build(remat)
        interop.load_flax_variables(m, variables)
        out.append(m)
    return out


@pytest.fixture(scope="module")
def resnet_variables():
    m = ResNet(**RESNET, dtype=torch.float32, conv_impl="xla",
               generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(".scale"):
                p.copy_(torch.from_numpy(
                    (rng.rand(*p.shape) * 0.5 + 0.75).astype(np.float32)))
    return interop.to_flax_variables(m)


@pytest.mark.parametrize("impl", ["xla", "mxu"])
def test_resnet_remat_equals_no_remat(resnet_variables, impl):
    """The small ResNet (stages of one bottleneck, the mxu route reaching
    K1's plain version on stages 2 and 3): logits, gradients and the BN
    running statistics after the step, bit for bit: one update, not two."""
    plain, remat = _conv_models(
        lambda r: ResNet(**RESNET, dtype=torch.float32, conv_impl=impl,
                         remat=r), resnet_variables)
    x = _images(2, 32)
    (o0, g0, b0), (o1, g1, b1) = _conv_step(plain, x), _conv_step(remat, x)
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    before = dict(ResNet(**RESNET).named_buffers())
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
        assert b0[k].shape == before[k].shape


def test_resnet_remat_matches_jax(resnet_variables):
    """JAX's remat ResNet (``xla`` convs) on the carried weights at batch
    8: logits, updated statistics, and each gradient to 5e-4 of its
    largest magnitude (at batch 2 the last stage's BN normalises two
    values a channel, and the packages' gradients part by 0.6 %)."""
    from distributed_tensorflow_models_tpu.models.resnet import ResNet as JResNet

    x = _images(2, 32, batch=8)
    w = np.random.RandomState(9).randn(8, 10).astype(np.float32)
    jm = JResNet(**RESNET, dtype=jnp.float32, conv_impl="xla", remat=True)
    variables = jax.tree.map(jnp.asarray, resnet_variables)

    def loss(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x.numpy()), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    _, remat = _conv_models(
        lambda r: ResNet(**RESNET, dtype=torch.float32, conv_impl="xla",
                         remat=r), resnet_variables)
    out, grads, stats = _conv_step(remat, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MODEL_TOL)
    want_stats = _leaves(jax.tree.map(np.asarray, dict(jstats)))
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k.replace(".", "/")],
                                   err_msg=k, **MODEL_TOL)
    want = _leaves(jax.tree.map(np.asarray, dict(jgrads)))
    for k, g in grads.items():
        w_k = want[k.replace(".", "/")]
        np.testing.assert_allclose(g.numpy(), w_k, rtol=5e-4,
                                   atol=5e-4 * np.abs(w_k).max(), err_msg=k)


@pytest.fixture(scope="module")
def inception_variables():
    m = InceptionV3(**INCEPTION, aux_head=False, dtype=torch.float32,
                    conv_impl="xla", generator=torch.Generator().manual_seed(0))
    return interop.to_flax_variables(m)


def test_inception_remat_equals_no_remat(inception_variables):
    """Inception-v3 at its smallest input, 75x75 (no aux head): logits,
    gradients and all 94 layers' BN statistics bit for bit."""
    plain, remat = _conv_models(
        lambda r: InceptionV3(**INCEPTION, aux_head=False,
                              dtype=torch.float32, conv_impl="xla", remat=r),
        inception_variables)
    x = _images(4, 75)
    (o0, g0, b0), (o1, g1, b1) = _conv_step(plain, x), _conv_step(remat, x)
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert len(b0) == 2 * 94
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


def test_inception_remat_matches_jax(inception_variables):
    """JAX's remat Inception-v3 (``xla`` convs, no aux head) at 75x75 on
    the carried weights: the training forward's logits and updated BN
    statistics, at batch 8 (at batch 2 the 1x1 grid's BN normalises two
    values a channel, and the packages' logits part by 2 %)."""
    jm = jget_model("inception_v3", **INCEPTION, aux_head=False,
                    dtype=jnp.float32, conv_impl="xla", remat=True)
    x = _images(4, 75, batch=8)
    jout, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            jax.tree.map(jnp.asarray, inception_variables),
            jnp.asarray(x.numpy()))
    _, remat = _conv_models(
        lambda r: InceptionV3(**INCEPTION, aux_head=False,
                              dtype=torch.float32, conv_impl="xla", remat=r),
        inception_variables)
    out, _, stats = _conv_step(remat, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MODEL_TOL)
    want = _leaves(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k.replace(".", "/")],
                                   err_msg=k, **MODEL_TOL)


def test_remat_is_skipped_without_grad():
    """Eval and decode run the blocks straight: no checkpoint without
    autograd, and the same logits."""
    m = _lm(True, generator=torch.Generator().manual_seed(0))
    toks = _tokens()["inputs"]
    with torch.no_grad():
        a, _ = m(toks)
        m.remat = False
        b, _ = m(toks)
    assert torch.equal(a, b)


def test_recompute_reenters_the_forwards_mesh():
    """The recompute sees the data axis the forward saw, wherever the
    backward runs it."""
    seen = []
    mesh = tmesh.local_mesh("cpu")

    def block(x):
        seen.append((rematlib.recomputing(), tmesh.current_mesh()))
        return torch.sin(x)

    x = torch.ones(3, requires_grad=True)
    with tmesh.data_parallel(mesh):
        y = rematlib.checkpoint(block, x).sum()
    y.backward()
    assert seen == [(False, mesh), (True, mesh)]
    assert not rematlib.recomputing()


def _blocks_forward_flops(cfg):
    with torch.device("meta"):
        model = tlm.TransformerLM(**cfg.model_kwargs)
        ttrain.library_route(model)
        x = torch.empty(cfg.global_batch_size, cfg.num_steps,
                        cfg.model_kwargs["d_model"], dtype=model.dtype)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        for i in range(model.num_layers):
            x = getattr(model, f"blocks_{i}")(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["transformer_lm_tiny", "transformer_lm"])
def test_step_flops_count_the_recompute(name):
    """A remat step's FLOPs are the plain step's plus one forward of every
    block, counted on the meta device."""
    cfg = tconfig.get_config(name)
    remat = cfg.replace(model_kwargs={**cfg.model_kwargs, "remat": True})
    batch = {k: torch.zeros(cfg.global_batch_size, cfg.num_steps,
                            dtype=torch.int64) for k in ("inputs", "targets")}
    mesh = tmesh.local_mesh("cpu")
    plain_flops = trainlib.step_flops_fn(cfg, mesh)(batch)
    remat_flops = trainlib.step_flops_fn(remat, mesh)(batch)
    assert remat_flops == plain_flops + _blocks_forward_flops(cfg)


@pytest.mark.parametrize("name,extra", [
    ("transformer_lm_tiny", {}),
    ("resnet50_synthetic_tiny", {}),
    ("transformer_lm_tiny", {"num_experts": 4}),
], ids=["transformer", "resnet", "transformer-moe"])
def test_fit_trains_with_remat_as_without(name, extra):
    """``fit`` on the CPU, remat on and off, from the same seed: the same
    losses (and aux losses) step for step, bit for bit."""
    histories = {}
    for remat in (False, True):
        cfg = tconfig.get_config(name)
        cfg = cfg.replace(train_steps=2, model_kwargs={
            **cfg.model_kwargs, **extra, "remat": remat})
        result = trainlib.fit(cfg, device="cpu")
        histories[remat] = [{k: h[k] for k in ("loss", "grad_norm",
                                               "aux_loss") if k in h}
                            for h in result.history]
    assert histories[True] == histories[False]
    assert len(histories[True]) == 2
    assert ("aux_loss" in histories[True][0]) == bool(extra)
    assert all(np.isfinite(h["loss"]) for h in histories[True])
