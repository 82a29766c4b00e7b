"""The port's transformer LM slice against the JAX package's, on bridged
weights and numpy-seeded inputs.

The model is ``transformer_lm_tiny``'s shape (2 layers, 4 heads, d_model
64, d_ff 128, vocab 256, sequence 64, batch 4) in f32 with dropout 0 on
both sides; its ``transformer_lm_modern`` form adds rotary positions,
2 KV heads and a 24-token window (the port's backward staged, K5's plain
versions).  The JAX model attends with ``attn_impl="reference"``: its
``attention(impl="flash")`` fixes ``interpret=False`` and cannot lower on
the CPU.  The port's runs ``"flash"``, i.e. the plain versions of K2-K4
under the flash autograd Function (test_torch_attention.py holds those
against JAX's interpret-mode kernels).

Tolerances: the model forward and the unfused loss/gradients agree to f32
round-off, 1e-5 (gradients: of the largest gradient, as round-off is
relative to the whole gradient's scale).  The fused head rounds the
hidden states, the head kernel and their cotangents to bf16 on both sides
at the same points, but the f32 sums before each rounding run in another
order, so now and then a rounded value lands one bf16 ulp (at most 2^-7
relative) apart: 1e-4 there, except for at most 0.1% of the elements,
(at least 2 in a tensor), which may sit one ulp apart.  Adam moves a parameter by lr * mu /
(sqrt(nu) + eps), about lr whatever the gradient's size, so a gradient
element near its round-off can move its parameter anywhere within
2 * lr per step: parameters agree to 2e-3 of lr, except for as few
elements, held to 2 * steps * lr.
"""

import itertools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.core.train_state import TrainState as JTrainState
from distributed_tensorflow_models_tpu.data import datasets as jdata
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.ops import embed as jembed
from distributed_tensorflow_models_tpu.ops import losses as jlosses
from distributed_tensorflow_models_tpu.ops import rotary as jrotary
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import train_loop as ttrain
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import datasets as tdata
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import TransformerLM
from distributed_tensorflow_models_tpu_torch.ops import embed as tembed
from distributed_tensorflow_models_tpu_torch.ops import losses as tlosses
from distributed_tensorflow_models_tpu_torch.ops import optim as toptim
from distributed_tensorflow_models_tpu_torch.ops import rotary as trotary

jax.config.update("jax_platforms", "cpu")

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=64, d_ff=128,
            max_len=64, dropout_rate=0.0)
MODERN = dict(pos_encoding="rope", num_kv_heads=2, attn_window=24)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)
LR, CLIP = 3e-4, 1.0


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _jax_model(**kw):
    return jget_model("transformer_lm", **{**TINY, "dtype": jnp.float32,
                                           "attn_impl": "reference", **kw})


def _port_model(params, **kw):
    m = TransformerLM(**{**TINY, "dtype": torch.float32, "attn_impl": "flash",
                         **kw})
    interop.load_flax_variables(m, {"params": params})
    return m


def _jax_params(model, seed=0):
    v = jax.jit(lambda key: model.init(key, jnp.zeros((2, 64), jnp.int32)))(
        jax.random.key(seed))
    return jax.tree.map(np.asarray, dict(v["params"]))


def _tokens(batch=4, T=64, seed=1):
    ds = tdata.ptb_dataset(batch, T, vocab_size=TINY["vocab_size"])
    it = iter(ds)
    for _ in range(seed):
        b = next(it)
    return b


@pytest.fixture(scope="module")
def tiny_params():
    return _jax_params(_jax_model())


@pytest.mark.parametrize("name", ["transformer_lm", "tiny",
                                  "transformer_lm_modern"])
def test_interop_round_trip_exact(name):
    if name.startswith("transformer_lm"):
        # The full-width tree's structure without running the model; values
        # from a numpy seed.
        cfg = jconfig.get_config(name)
        kw = dict(cfg.model_kwargs)
        shapes = jax.eval_shape(lambda: jget_model(
            "transformer_lm", **kw).init(jax.random.key(0),
                                         jnp.zeros((1, 8), jnp.int32)))
        rng = np.random.default_rng(3)
        params = jax.tree.map(lambda s: rng.standard_normal(
            s.shape, dtype=np.float32), dict(shapes["params"]))
        tm = get_model("transformer_lm", **kw)
        assert ("pos_embedding" in params) == (name == "transformer_lm")
    else:
        params, tm = _jax_params(_jax_model(), 3), TransformerLM(**TINY)
    assert "blocks_0.attn.query.kernel" in dict(tm.named_parameters())
    interop.load_flax_variables(tm, {"params": params})
    back = interop.to_flax_variables(tm)
    assert list(back) == ["params"]
    want, got = _leaves(params), _leaves(back["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [{}, dict(num_kv_heads=2, attn_window=24),
                                MODERN],
                         ids=["mha", "gqa-window", "rope-gqa-window"])
def test_forward_matches_jax(kw):
    params = _jax_params(_jax_model(**kw), 2)
    toks = _tokens()["inputs"]
    jm = _jax_model(**kw)
    run = jax.jit(lambda p, t, h: jm.apply({"params": p}, t, return_hidden=h),
                  static_argnums=2)
    tm = _port_model(params, **kw)
    with torch.no_grad():
        for hidden in (False, True):
            want, carry = run(params, jnp.asarray(toks), hidden)
            got, tcarry = tm(torch.from_numpy(toks), return_hidden=hidden)
            assert carry is None and tcarry is None
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"return_hidden={hidden}",
                                       **F32_TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_lm_loss_and_grads_match_jax(tiny_params, fused):
    batch = _tokens()
    jm = _jax_model()
    jloss = jtrain.lm_loss_fn(jm.apply, fused_unembed=fused)
    jstate = JTrainState.create(jm, optax.identity(), jax.random.key(0),
                                jnp.zeros((2, 64), jnp.int32))

    @jax.jit
    def run(params, batch):
        return jax.value_and_grad(jloss, has_aux=True)(
            params, jstate, batch, {})

    (jl, jaux), jgrads = run(jax.tree.map(jnp.asarray, tiny_params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tm = _port_model(tiny_params)
    tstate = TrainState.create(tm, toptim.sgd(0.0))
    tl, taux = ttrain.lm_loss_fn(tm, fused_unembed=fused)(
        tstate.params, tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, {})
    names = list(tstate.params)
    grads = dict(zip(names, torch.autograd.grad(
        tl, [tstate.params[n] for n in names])))
    tol = FUSED_TOL if fused else F32_TOL
    np.testing.assert_allclose(float(tl.detach()), float(jl), **tol)
    np.testing.assert_allclose(float(taux["metrics"]["nll"]),
                               float(jaux["metrics"]["nll"]), **tol)
    want = _leaves(jax.tree.map(np.asarray, dict(jgrads)))
    got = {k.replace(".", "/"): v.numpy() for k, v in grads.items()}
    _assert_tree_close(got, want, tol["rtol"], one_ulp_rare=fused)


def _assert_mostly_close(got, want, rtol, atol, rare_atol=None,
                         rare_rtol=0.0, what=""):
    """Every element within ``atol + rtol*|want|``, or, where ``rare_atol``
    is given, a few (0.1% of the elements, at least 2) within ``rare_atol
    + rare_rtol*|want|`` instead."""
    err = np.abs(got - want)
    over = err > atol + rtol * np.abs(want)
    if rare_atol is None or over.sum() > max(2, over.size // 1000):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
        return
    limit = rare_atol + rare_rtol * np.abs(want)
    assert (err <= limit).all(), (
        f"{what}: max err {err.max():.4g} past {limit[err > limit].min():.4g}")


def _assert_tree_close(got, want, rtol, what="", one_ulp_rare=False):
    """Elementwise ``rtol`` plus ``rtol`` of the tree's largest magnitude:
    round-off is relative to the whole gradient's scale.  The key biases'
    true gradient is exactly zero (softmax is shift-invariant per query),
    so both sides hold round-off there, ~1e-9.  ``one_ulp_rare`` lets 0.1%
    of the elements differ by one bf16 ulp."""
    assert sorted(got) == sorted(want), what
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        _assert_mostly_close(got[k], w, rtol, rtol * scale,
                             rtol * scale if one_ulp_rare else None,
                             2.0 ** -7, f"{what}{k}")


STEPS = 3


def _jax_steps(params, **kw):
    """The JAX package's fused LM loss + clip(1.0) + Adam(3e-4), three
    jitted steps on consecutive PTB batches: per step the metrics, the
    parameters and the Adam moments (flat numpy dicts)."""
    jm = _jax_model(**kw)
    tx = jconfig.OptimizerConfig(name="adam", learning_rate=LR,
                                 clip_global_norm=CLIP).make()
    params = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState.create(jm, tx, jax.random.key(0),
                                jnp.zeros((2, 64), jnp.int32))
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jstep = jax.jit(jtrain.make_train_step_fn(
        jtrain.lm_loss_fn(jm.apply, fused_unembed=True)))
    ds = iter(tdata.ptb_dataset(4, 64, vocab_size=TINY["vocab_size"]))
    out = []
    for b in itertools.islice(ds, STEPS):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.key(0))
        adam = jstate.opt_state[1][0]
        out.append({
            "metrics": {k: float(v) for k, v in jm_.items()},
            "step": int(jstate.step),
            "count": int(adam.count),
            "params": _leaves(jax.tree.map(np.asarray, dict(jstate.params))),
            "mu": _leaves(jax.tree.map(np.asarray, dict(adam.mu))),
            "nu": _leaves(jax.tree.map(np.asarray, dict(adam.nu))),
        })
    return out


@pytest.fixture(scope="module")
def jax_trajectory(tiny_params):
    return _jax_steps(tiny_params)


@pytest.mark.parametrize("steps", [1, 3])
def test_training_steps_match_jax(tiny_params, jax_trajectory, steps):
    _check_steps(tiny_params, jax_trajectory, steps)


def _check_steps(tiny_params, jax_trajectory, steps, **kw):
    tm = _port_model(tiny_params, **kw)
    opt = tconfig.get_config("transformer_lm_tiny").optimizer
    assert (opt.name, opt.learning_rate, opt.clip_global_norm) == (
        "adam", LR, CLIP)
    tstate = TrainState.create(tm, opt.make())
    tstep = ttrain.make_train_step(ttrain.lm_loss_fn(tm, fused_unembed=True))
    ds = iter(tdata.ptb_dataset(4, 64, vocab_size=TINY["vocab_size"]))
    for b, want in zip(itertools.islice(ds, steps), jax_trajectory):
        tstate, tmetrics = tstep(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()}, 0)
        assert sorted(tmetrics) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(float(tmetrics[k]), v, err_msg=k,
                                       **FUSED_TOL)
    want = jax_trajectory[steps - 1]
    assert want["metrics"]["grad_norm"] > CLIP  # the clip branch ran
    clip_state, adam = tstate.opt_state
    assert clip_state == {} and tstate.step == want["step"] == steps
    assert adam["count"] == want["count"] == steps
    for coll in ("mu", "nu"):
        _assert_tree_close({k.replace(".", "/"): v.numpy()
                            for k, v in adam[coll].items()}, want[coll],
                           FUSED_TOL["rtol"], f"{coll}/", one_ulp_rare=True)
    got = _leaves(interop.to_flax_variables(tm)["params"])
    init = _leaves(tiny_params)
    assert sorted(got) == sorted(want["params"])
    for k, w in want["params"].items():
        if k.endswith("attn/key/bias"):
            # Adam scales each side's round-off gradient (zero in exact
            # arithmetic) to a step of up to lr: both stay that close to
            # where they started.
            for v in (got[k], w):
                assert np.abs(v - init[k]).max() <= steps * LR, k
            continue
        _assert_mostly_close(got[k], w, 1e-5, 2e-3 * LR, 2 * steps * LR,
                             what=f"params/{k}")


@pytest.fixture(scope="module")
def modern_params():
    return _jax_params(_jax_model(**MODERN), 4)


@pytest.fixture(scope="module")
def modern_trajectory(modern_params):
    return _jax_steps(modern_params, **MODERN)


def test_modern_loss_and_grads_match_jax(modern_params, monkeypatch):
    """transformer_lm_modern's form (rope, GQA, window) through the fused
    loss, the port's backward staged: loss and every gradient."""
    monkeypatch.setenv("DTM_FLASH_BWD", "staged")
    batch = _tokens()
    jm = _jax_model(**MODERN)
    jloss = jtrain.lm_loss_fn(jm.apply, fused_unembed=True)
    jstate = JTrainState.create(jm, optax.identity(), jax.random.key(0),
                                jnp.zeros((2, 64), jnp.int32))
    (jl, _), jgrads = jax.jit(lambda p, b: jax.value_and_grad(
        jloss, has_aux=True)(p, jstate, b, {}))(
            jax.tree.map(jnp.asarray, modern_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    tm = _port_model(modern_params, **MODERN)
    tstate = TrainState.create(tm, toptim.sgd(0.0))
    tl, _ = ttrain.lm_loss_fn(tm, fused_unembed=True)(
        tstate.params, tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, {})
    names = list(tstate.params)
    grads = dict(zip(names, torch.autograd.grad(
        tl, [tstate.params[n] for n in names])))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **FUSED_TOL)
    _assert_tree_close({k.replace(".", "/"): v.numpy()
                        for k, v in grads.items()},
                       _leaves(jax.tree.map(np.asarray, dict(jgrads))),
                       FUSED_TOL["rtol"], one_ulp_rare=True)


@pytest.mark.parametrize("steps", [1, 3])
def test_modern_training_steps_match_jax(modern_params, modern_trajectory,
                                         steps, monkeypatch):
    monkeypatch.setenv("DTM_FLASH_BWD", "staged")
    _check_steps(modern_params, modern_trajectory, steps, **MODERN)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_shape", ["T", "BT"])
def test_apply_rope_matches_jax(dtype, pos_shape):
    rng = np.random.RandomState(14)
    x = rng.randn(2, 40, 3, 16).astype(np.float32)
    pos = (np.arange(40) + 7 if pos_shape == "T"
           else rng.randint(0, 500, (2, 40))).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jrotary.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                              500.0)
    got = trotary.apply_rope(torch.tensor(x).to(tdt), torch.from_numpy(pos),
                             500.0)
    assert got.dtype == tdt and got.shape == x.shape
    # The angles in f32 on both sides (a position times a frequency, then
    # cos/sin): a few f32 ulps of the rotated values; in bf16 one ulp of
    # the output where the f32 results straddle a rounding boundary.
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=2.0 ** -7, atol=2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    jc, js = jrotary.rope_angles(jnp.asarray(pos), 16, 500.0)
    tc, ts = trotary.rope_angles(torch.from_numpy(pos), 16, 500.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="even"):
        trotary.rope_angles(torch.arange(3), 15)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [64, 48, 2048], ids=["c64", "c48", "c2048"])
def test_chunked_unembed_xent_matches_jax(compute, chunk):
    """Value and gradients (hidden, kernel, bias) at several chunk sizes:
    48 leaves a short last chunk (160 rows), 2048 one chunk."""
    rng = np.random.RandomState(11)
    B, T, d, V = 2, 80, 32, 100
    hidden = rng.randn(B, T, d).astype(np.float32)
    kernel = (rng.randn(d, V) / np.sqrt(d)).astype(np.float32)
    bias = (rng.randn(V) * 0.1).astype(np.float32)
    targets = rng.randint(0, V, (B, T)).astype(np.int32)
    w = rng.randn(B, T).astype(np.float32)
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)

    # Op by op, not jitted: under jit XLA may keep the bf16 kernel
    # cotangent's sum over chunks in f32 ("excess precision"), where the
    # program rounds each partial sum to bf16, as the port does.
    def run(h, k, b):
        f = lambda h, k, b: jnp.sum(w * jlosses.chunked_unembed_xent(
            h, k, b, jnp.asarray(targets), chunk_rows=chunk,
            compute_dtype=jdt))
        return jax.value_and_grad(f, argnums=(0, 1, 2))(h, k, b)

    jval, jgrads = run(jnp.asarray(hidden), jnp.asarray(kernel),
                       jnp.asarray(bias))
    ts = [torch.tensor(x, requires_grad=True) for x in (hidden, kernel, bias)]
    nll = tlosses.chunked_unembed_xent(*ts, torch.from_numpy(targets),
                                       chunk_rows=chunk, compute_dtype=tdt)
    assert nll.shape == (B, T) and nll.dtype == torch.float32
    val = (torch.from_numpy(w) * nll).sum()
    val.backward()
    tol = F32_TOL if compute == "float32" else FUSED_TOL
    np.testing.assert_allclose(float(val.detach()), float(jval), **tol)
    for name, t, g in zip(("hidden", "kernel", "bias"), ts, jgrads):
        g = np.asarray(g)
        atol = tol["rtol"] * float(np.abs(g).max())
        _assert_mostly_close(t.grad.numpy(), g, tol["rtol"], atol,
                             atol if compute == "bfloat16" else None,
                             2.0 ** -7, name)


def test_unembed_chunk_knob(monkeypatch):
    monkeypatch.setenv("DTM_UNEMBED_CHUNK", "512")
    assert tlosses.resolve_unembed_chunk() == 512
    for bad in ("x", "0"):
        monkeypatch.setenv("DTM_UNEMBED_CHUNK", bad)
        with pytest.raises(ValueError, match="DTM_UNEMBED_CHUNK"):
            tlosses.resolve_unembed_chunk()
    monkeypatch.delenv("DTM_UNEMBED_CHUNK")
    assert tlosses.resolve_unembed_chunk() == jlosses.resolve_unembed_chunk()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_and_grad_match_jax(dtype):
    """Repeated tokens accumulate in f32 and the sum is cast to the
    table's dtype."""
    rng = np.random.RandomState(12)
    table = rng.randn(50, 16).astype(np.float32)
    tokens = rng.randint(0, 50, (3, 40)).astype(np.int32)
    g = rng.randn(3, 40, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    @jax.jit
    def run(t):
        out, vjp = jax.vjp(lambda t: jembed.embed_lookup(t, tokens), t)
        return out, vjp(g.astype(jdt))[0]

    jout, jgrad = run(jnp.asarray(table).astype(jdt))
    t = torch.tensor(table).to(tdt).requires_grad_()
    out = tembed.embed_lookup(t, torch.from_numpy(tokens))
    out.backward(torch.from_numpy(g).to(tdt))
    assert t.grad.dtype == tdt
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout, np.float32))
    np.testing.assert_allclose(t.grad.float().numpy(),
                               np.asarray(jgrad, np.float32),
                               rtol=1e-6 if dtype == "float32" else 2 ** -8,
                               atol=1e-6)


def test_embed_grad_knob(monkeypatch):
    monkeypatch.setenv("DTM_EMBED_GRAD", "matmul")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tembed.resolve_embed_grad_impl()
    monkeypatch.setenv("DTM_EMBED_GRAD", "other")
    with pytest.raises(ValueError, match="DTM_EMBED_GRAD"):
        tembed.resolve_embed_grad_impl()


@pytest.mark.parametrize("kw", [dict(decode=True), dict(num_experts=4),
                                dict(pipelined=True), dict(remat=True),
                                dict(pos_encoding="rope", decode=True)],
                         ids=["decode", "moe", "pipelined", "remat", "rope"])
def test_unported_paths_raise(kw):
    """Rotary positions train; the rotary KV-cache decode is not ported."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TransformerLM(**TINY, **kw)


def test_ptb_batches_and_cursor_equal_jax():
    """The synthetic PTB stream, batch for batch, across an epoch
    boundary, and the cursor after each batch."""
    jds = jdata.ptb_dataset(16, 256, "train", 10000)
    tds = tdata.ptb_dataset(16, 256, "train", 10000)
    assert tds.batches_per_epoch == jds.batches_per_epoch == 48
    for n, (jb, tb) in enumerate(itertools.islice(zip(iter(jds), iter(tds)),
                                                  50)):
        for k in ("inputs", "targets"):
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{n}/{k}")
        assert tds.get_state() == jds.get_state()
    assert tds.get_state() == {"epoch": 1, "pos": 2}
    np.testing.assert_array_equal(tdata.load_ptb_tokens("valid", 256),
                                  jdata.load_ptb_tokens("valid", 256))


def test_lm_configs_match_jax():
    for name in ("transformer_lm", "transformer_lm_modern"):
        j, t = jconfig.get_config(name), tconfig.get_config(name)
        for field in ("model", "task", "model_kwargs", "dataset",
                      "global_batch_size", "num_steps", "vocab_size",
                      "attn_impl", "fused_unembed", "train_steps", "seed"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        for field in ("name", "learning_rate", "clip_global_norm"):
            assert getattr(t.optimizer, field) == getattr(j.optimizer, field)
    tiny = tconfig.get_config("transformer_lm_tiny")
    assert (tiny.num_steps, tiny.global_batch_size, tiny.vocab_size,
            tiny.train_steps) == (64, 4, 256, 2)
    assert tiny.model_kwargs["vocab_size"] == tiny.vocab_size


def test_cli_trains_tiny_lm_with_flash_on_cpu(tmp_path, capsys):
    rc = cli.main(["train", "--config", "transformer_lm_tiny", "--workdir",
                   str(tmp_path), "--attn-impl", "flash", "--device", "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 2 and result["device"] == "cpu"
    assert math.isfinite(result["final_metrics"]["loss"])
    assert result["tokens_per_sec"] > 0
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["tokens"] for r in rows] == [4 * 64] * 2


def test_cli_lm_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", "transformer_lm_tiny", "--workdir",
                  str(tmp_path), "--attn-impl", "flash"])
    assert not (tmp_path / "metrics.jsonl").exists()
