"""The port's PTB LSTM, its train step with the threaded carry and the
``ptb_*`` configs against the JAX package's.

The model runs in f32 with a small vocabulary and hidden size (50 and 16,
two layers, dropout 0) on the port's seeded weights carried to the JAX
model by ``interop``; tokens and carries are made with numpy.  Both sides
compute the same f32 operations in the same order per timestep, so
logits, carries and gradients are held to 1e-5 relative to the largest
magnitude (``F32_TOL``: the round-off of 2x20 sequential steps, where the
JAX suite's model tolerance is 2e-3).  The fused head projects in bf16 on
both sides (``chunked_unembed_xent``): its loss and gradients are held to
one bf16 ulp (2^-7) of their scale.  ``ptb_small`` (dropout 0) trains
three steps under a clip that acts and the staged schedule, with an epoch
of one step so that every step crosses a decay; its state is held to 5e-4
(``STATE_TOL`` of the conv zoo's tests).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.core.train_state import TrainState as JTrainState
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import train_loop as ttrain
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.models.ptb_lstm import PTB_CONFIGS

jax.config.update("jax_platforms", "cpu")

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
STATE_TOL = dict(atol=5e-4, rtol=5e-4)
SMALL = dict(config="small", vocab_size=50, hidden_size=16, num_layers=2,
             dropout_rate=0.0)
B, T = 3, 20


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _port(seed=0, **kw):
    return get_model("ptb_lstm", generator=torch.Generator().manual_seed(seed),
                     **{**SMALL, **kw})


def _tokens(seed, batch=B, steps=T, vocab=50):
    return np.random.RandomState(seed).randint(0, vocab, (batch, steps + 1)
                                               ).astype(np.int32)


def _carry(seed, layers=2, batch=B, hidden=16):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(batch, hidden).astype(np.float32) * 0.5,
                  rng.randn(batch, hidden).astype(np.float32) * 0.5)
                 for _ in range(layers))


def _jcarry(c):
    return tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in c)


def _tcarry(c):
    return tuple((torch.from_numpy(a), torch.from_numpy(b)) for a, b in c)


@pytest.mark.parametrize("config", sorted(PTB_CONFIGS))
def test_interop_round_trip_exact(config):
    """The JAX model's init tree at the config's full widths (its structure
    by ``jax.eval_shape``, values from a numpy seed): the embedding, each
    layer's ``lstm_{l}_ih`` kernel and bias and its recurrent
    ``lstm_{l}/hh/kernel`` (no time axis: the scan broadcasts it), the
    head; loaded into the port's model and back unchanged."""
    shapes = jax.eval_shape(lambda: jget_model("ptb_lstm", config=config).init(
        jax.random.key(0), jnp.zeros((2, 5), jnp.int32)))
    rng = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda s: rng.standard_normal(s.shape, dtype=s.dtype),
        {k: dict(v) for k, v in shapes.items()})
    h = PTB_CONFIGS[config]["hidden_size"]
    assert variables["params"]["lstm_1"]["hh"]["kernel"].shape == (h, 4 * h)
    tm = get_model("ptb_lstm", config=config)
    interop.load_flax_variables(tm, variables)
    want, got = _leaves(variables), _leaves(interop.to_flax_variables(tm))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_recurrent_gate_blocks_are_orthogonal_at_init():
    """Each h x h gate block of every recurrent kernel is orthogonal (the
    blockwise init flax's per-gate cells give): QᵀQ = I to 1e-5."""
    tm = _port(seed=2, hidden_size=64)
    for layer in range(2):
        k = getattr(tm, f"lstm_{layer}").hh.kernel.detach().double()
        assert tuple(k.shape) == (64, 256)
        for g in range(4):
            q = k[:, 64 * g:64 * (g + 1)]
            torch.testing.assert_close(q.T @ q, torch.eye(64,
                                                          dtype=torch.double),
                                       rtol=0, atol=1e-5)
    assert getattr(tm, "lstm_0").hh.bias is None
    assert float(tm.lstm_0_ih.bias.detach().abs().max()) == 0.0


@pytest.fixture(scope="module")
def bridged():
    tm = _port()
    return tm, interop.to_flax_variables(tm)


def _jax_apply(variables, toks, carry, **kw):
    jm = jget_model("ptb_lstm", **SMALL)
    return jax.jit(lambda v, t, c: jm.apply(v, t, carry=c, **kw))(
        variables, jnp.asarray(toks), carry)


@pytest.mark.parametrize("start", ["zero", "given"])
def test_forward_matches_jax(bridged, start):
    """Logits and the new carry from a zero (omitted) or a given carry;
    the carry stays f32 ``[B, hidden]`` per layer."""
    tm, variables = bridged
    toks = _tokens(3)[:, :-1]
    c0 = None if start == "zero" else _carry(4)
    want, wc = _jax_apply(variables, toks, None if c0 is None else _jcarry(c0))
    with torch.no_grad():
        got, gc = tm(torch.from_numpy(toks),
                     carry=None if c0 is None else _tcarry(c0))
    _close(got, want, F32_TOL, "logits")
    assert len(gc) == 2
    for layer, ((c, h), (jc, jh)) in enumerate(zip(gc, wc)):
        assert c.dtype == h.dtype == torch.float32
        assert tuple(c.shape) == tuple(h.shape) == (B, 16)
        _close(c, jc, F32_TOL, f"c{layer}")
        _close(h, jh, F32_TOL, f"h{layer}")


def test_two_segments_thread_the_carry_like_jax(bridged):
    """Truncated BPTT: segment 2 starts from segment 1's final carry, and
    the result equals JAX's two segments, not a run from zeros."""
    tm, variables = bridged
    toks = _tokens(5, steps=2 * T)
    seg1, seg2 = toks[:, :T], toks[:, T:2 * T]
    _, jc1 = _jax_apply(variables, seg1, None)
    want, jc2 = _jax_apply(variables, seg2, jc1)
    with torch.no_grad():
        _, c1 = tm(torch.from_numpy(seg1))
        got, c2 = tm(torch.from_numpy(seg2), carry=c1)
        fresh, _ = tm(torch.from_numpy(seg2))
    _close(got, want, F32_TOL, "segment 2 logits")
    for (c, h), (jc, jh) in zip(c2, jc2):
        _close(c, jc, F32_TOL, "c")
        _close(h, jh, F32_TOL, "h")
    assert float((fresh - got).abs().max()) > 1e-3


def _jax_loss_and_grads(variables, batch, carry, fused):
    jm = jget_model("ptb_lstm", **SMALL)
    loss_fn = jtrain.lm_loss_fn(jm.apply, fused_unembed=fused)

    class S:
        pass

    state = S()
    state.carry = carry

    def f(params):
        return loss_fn(params, state, batch, {})

    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"])
    return float(loss), _leaves(jax.tree.map(np.asarray, dict(grads))), aux


@pytest.mark.parametrize("fused", [False, True], ids=["f32_head", "fused"])
def test_loss_and_grads_match_jax(bridged, fused):
    """The LM loss (mean NLL of the shifted tokens) and every parameter's
    gradient from a given carry, with the f32 head or the fused chunked
    bf16 head (``return_hidden``)."""
    _, variables = bridged
    tm = _port()
    toks = _tokens(6)
    c0 = _carry(7)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads, jaux = _jax_loss_and_grads(
        variables, {k: jnp.asarray(v) for k, v in batch.items()},
        _jcarry(c0), fused)
    state = TrainState.create(tm, ttrain.optim.sgd(0.0), carry=_tcarry(c0))
    loss, aux = ttrain.lm_loss_fn(tm, fused_unembed=fused)(
        state.params, state, {k: torch.from_numpy(v).long()
                              for k, v in batch.items()}, {})
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[k] for k in names])
    tol = BF16_TOL if fused else F32_TOL
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=tol)
    got = {"params/" + k.replace(".", "/"): g.numpy()
           for k, g in zip(names, grads)}
    assert sorted(got) == sorted("params/" + k for k in jgrads)
    for k, w in jgrads.items():
        _close(got["params/" + k], w, tol, k)
    for (c, h), (jc, jh) in zip(aux["carry"], jaux["carry"]):
        _close(c.detach(), jc, F32_TOL, "c")
        _close(h.detach(), jh, F32_TOL, "h")


def test_step_stores_the_carry_detached():
    """The step keeps the new carry without its graph: the next step's
    backward does not reach the last one's (freed) graph, and the carry
    moves from zero to the segment's final state."""
    tm = _port(seed=8)
    state = TrainState.create(tm, ttrain.optim.sgd(0.1),
                              carry=tm.initial_carry(B))
    step = ttrain.make_train_step(ttrain.lm_loss_fn(tm))
    toks = torch.from_numpy(_tokens(9, steps=3 * T)).long()
    for i in range(3):
        seg = toks[:, i * T:(i + 1) * T + 1]
        state, metrics = step(state, {"inputs": seg[:, :-1],
                                      "targets": seg[:, 1:]}, 0)
        assert math.isfinite(float(metrics["loss"]))
        for c, h in state.carry:
            for t in (c, h):
                assert t.grad_fn is None and not t.requires_grad
                assert t.dtype == torch.float32 and tuple(t.shape) == (B, 16)
    assert float(state.carry[1][1].abs().max()) > 0


@pytest.mark.parametrize("name", ["ptb_small", "ptb_medium", "ptb_large"])
def test_configs_match_jax(name):
    j, t = jconfig.get_config(name), tconfig.get_config(name)
    for field in ("model", "task", "model_kwargs", "dataset",
                  "global_batch_size", "num_steps", "vocab_size",
                  "train_steps", "seed", "fused_unembed"):
        assert getattr(t, field) == getattr(j, field), field
    for field in ("name", "learning_rate", "decay_rate", "steps_per_epoch",
                  "hold_epochs", "clip_global_norm", "decay_steps"):
        assert (getattr(t.optimizer, field)
                == getattr(j.optimizer, field)), field
    assert t.optimizer.steps_per_epoch == 929_589 // (20 * t.num_steps)
    # The schedule the config builds is JAX's, value for value in f32.
    jsched, tsched = j.optimizer.schedule(), t.optimizer.schedule()
    spe, hold = t.optimizer.steps_per_epoch, t.optimizer.hold_epochs
    for step in (0, spe * hold - 1, spe * hold, spe * (hold + 3) + 1,
                 t.train_steps - 1):
        assert np.float32(tsched(step)) == np.float32(jsched(step)), step


STEPS = 3


def test_ptb_small_trains_like_jax():
    """``ptb_small`` (hidden 200, vocab 10000, 20 steps of unroll, dropout
    0) at batch 4: clip then SGD under the staged schedule, with an epoch
    of one step and a hold of one epoch (the rate halves every step), the
    carry threaded from zeros.  The clip is 0.1, so that it acts at every
    step (the gradient norm at init is ~0.14, under the config's 5).  Loss
    per step, then every parameter and the carry after three steps."""
    tcfg = tconfig.get_config("ptb_small", global_batch_size=4)
    jcfg = jconfig.get_config("ptb_small")
    opt = dict(steps_per_epoch=1, hold_epochs=1, clip_global_norm=0.1)
    ttx = tcfg.optimizer.__class__(**{**tcfg.optimizer.__dict__,
                                      **opt}).make(STEPS)
    jtx = jcfg.optimizer.__class__(**{**jcfg.optimizer.__dict__, **opt}).make()
    tm = trainlib.build_model(tcfg, torch.device("cpu"))
    tree = interop.to_flax_variables(tm)
    jm = jget_model("ptb_lstm", **tcfg.model_kwargs)
    carry = jm.initial_carry(4)
    jstate = JTrainState.create(jm, jtx, jax.random.key(0),
                                jnp.zeros((2, tcfg.num_steps), jnp.int32),
                                carry=carry)
    params = jax.tree.map(jnp.asarray, tree["params"])
    jstate = jstate.replace(params=params, opt_state=jtx.init(params))
    jstep = jax.jit(jtrain.make_train_step_fn(jtrain.lm_loss_fn(jm.apply)))
    tstate = TrainState.create(tm, ttx, carry=tm.initial_carry(4))
    tstep = ttrain.make_train_step(ttrain.lm_loss_fn(tm))
    toks = _tokens(10, batch=4, steps=STEPS * tcfg.num_steps, vocab=10000)
    clipped = 0
    for i in range(STEPS):
        seg = toks[:, i * tcfg.num_steps:(i + 1) * tcfg.num_steps + 1]
        b = {"inputs": seg[:, :-1], "targets": seg[:, 1:]}
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.key(0))
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v).long()
                                     for k, v in b.items()}, 0)
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       err_msg=k, **STATE_TOL)
        clipped += float(tm_["grad_norm"]) > opt["clip_global_norm"]
    assert tstate.step == int(jstate.step) == STEPS
    want = _leaves(jax.tree.map(np.asarray, dict(jstate.params)))
    got = _leaves(interop.to_flax_variables(tm)["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STATE_TOL)
    for (c, h), (jc, jh) in zip(tstate.carry, jstate.carry):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **STATE_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **STATE_TOL)
        assert c.grad_fn is None and h.grad_fn is None
    assert tstate.opt_state[1]["count"] == STEPS and clipped == STEPS


@pytest.mark.parametrize("fused", [False, True], ids=["f32_head", "fused"])
def test_fit_trains_ptb_with_carry_on_cpu(fused):
    """``fit`` on a narrow ``ptb_medium`` (dropout 0.5, so the step's
    dropout generators are used): the state starts from the model's zero
    carry at the global batch, which reaches the end detached and f32;
    the fused head is allowed for the LSTM as for the transformer."""
    cfg = tconfig.get_config(
        "ptb_medium", global_batch_size=4, num_steps=6, vocab_size=64,
        train_steps=3, fused_unembed=fused,
        model_kwargs={"config": "medium", "vocab_size": 64,
                      "hidden_size": 24})
    result = trainlib.fit(cfg, device="cpu")
    assert result.state.step == 3
    assert all(math.isfinite(r["loss"]) for r in result.history)
    assert result.tokens_per_sec > 0
    for c, h in result.state.carry:
        for t in (c, h):
            assert tuple(t.shape) == (4, 24) and t.dtype == torch.float32
            assert t.grad_fn is None


def test_fused_head_needs_a_model_with_return_hidden():
    """The fused head is refused, naming the model, where the model's
    ``forward`` takes no ``return_hidden``."""
    cfg = tconfig.get_config("resnet50_synthetic_tiny", task="lm",
                             fused_unembed=True)
    state = trainlib.build_state(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="return_hidden.*'resnet50'"):
        trainlib.build_loss(cfg, state)


@pytest.mark.parametrize("config,batch", [("lenet_mnist", 4),
                                          ("resnet32_cifar10", 2),
                                          ("ptb_small", 2)])
def test_cli_trains_zoo_configs_on_cpu(tmp_path, capsys, config, batch):
    """The new configs train through ``train --config`` like the others."""
    rc = cli.main(["train", "--config", config, "--workdir", str(tmp_path),
                   "--train-steps", "2", "--batch-size", str(batch),
                   "--device", "cpu"])
    assert rc == 0
    import json

    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 2 and result["device"] == "cpu"
    assert math.isfinite(result["final_metrics"]["loss"])
    if config.startswith("ptb"):
        assert result["tokens_per_sec"] > 0
    else:
        assert result["images_per_sec"] > 0
