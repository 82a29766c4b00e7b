"""The port's optimizers, schedule, EMA, losses and metrics against the JAX
package's (optax underneath), step by step on numpy-seeded values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.ops import ema as jema
from distributed_tensorflow_models_tpu.ops import losses as jlosses
from distributed_tensorflow_models_tpu.ops import metrics as jmetrics
from distributed_tensorflow_models_tpu.ops import optim as joptim
from distributed_tensorflow_models_tpu_torch.ops import ema as tema
from distributed_tensorflow_models_tpu_torch.ops import losses as tlosses
from distributed_tensorflow_models_tpu_torch.ops import metrics as tmetrics
from distributed_tensorflow_models_tpu_torch.ops import optim as toptim

jax.config.update("jax_platforms", "cpu")

TOL = dict(atol=1e-6, rtol=1e-6)


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"a/kernel": rng.randn(3, 4).astype(np.float32),
            "a/bias": rng.randn(4).astype(np.float32)}


def _run_both(jtx, ttx, steps=4):
    params = _params(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    rng = np.random.RandomState(1)
    for _ in range(steps):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tu, tstate = ttx.update({k: torch.tensor(v) for k, v in g.items()},
                                tstate)
        toptim.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), **TOL)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
    return jstate, tstate


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("schedule", [False, True])
def test_tf_momentum_matches_optax(nesterov, schedule):
    jlr = joptim.exponential_decay(0.1, 2, 0.5) if schedule else 0.1
    tlr = toptim.exponential_decay(0.1, 2, 0.5) if schedule else 0.1
    jstate, tstate = _run_both(joptim.tf_momentum(jlr, 0.9, nesterov),
                               toptim.tf_momentum(tlr, 0.9, nesterov,
                                                  num_steps=4))
    for k, v in tstate["trace"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[0].trace[k]),
                                   **TOL)


@pytest.mark.parametrize("schedule", [False, True])
def test_sgd_matches_optax(schedule):
    jlr = joptim.exponential_decay(0.5, 1, 0.9, staircase=False) if schedule else 0.5
    tlr = toptim.exponential_decay(0.5, 1, 0.9, staircase=False) if schedule else 0.5
    _run_both(joptim.sgd(jlr), toptim.sgd(tlr, num_steps=4))


@pytest.mark.parametrize("staircase", [True, False])
def test_exponential_decay_matches(staircase):
    js = joptim.exponential_decay(0.1, 3, 0.94, staircase)
    ts = toptim.exponential_decay(0.1, 3, 0.94, staircase)
    for step in range(12):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_global_norm_matches_optax():
    p = _params(2)
    want = joptim.global_norm({k: jnp.asarray(v) for k, v in p.items()})
    got = toptim.global_norm({k: torch.tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches(smoothing):
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 10).astype(np.float32)
    labels = rng.randint(0, 10, 6).astype(np.int32)
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), smoothing)
    got = tlosses.softmax_cross_entropy(torch.tensor(logits),
                                        torch.tensor(labels), smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        float(tlosses.mean_softmax_cross_entropy(
            torch.tensor(logits), torch.tensor(labels), smoothing)),
        float(jlosses.mean_softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), smoothing)), **TOL)


def test_l2_weight_decay_decays_kernels_only():
    rng = np.random.RandomState(4)
    tree = {"conv": {"kernel": rng.randn(3, 3, 2, 4)},
            "bn": {"scale": rng.randn(4), "bias": rng.randn(4)},
            "head": {"kernel": rng.randn(4, 5), "bias": rng.randn(5)}}
    tree = {m: {k: v.astype(np.float32) for k, v in d.items()}
            for m, d in tree.items()}
    want = jlosses.l2_weight_decay(jax.tree.map(jnp.asarray, tree), 1e-4)
    flat = {f"{m}.{k}": torch.tensor(v) for m, d in tree.items()
            for k, v in d.items()}
    got = tlosses.l2_weight_decay(flat, 1e-4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    only_kernels = 1e-4 * 0.5 * sum(
        float(np.sum(tree[m]["kernel"] ** 2)) for m in ("conv", "head"))
    np.testing.assert_allclose(float(got), only_kernels, rtol=1e-5)


def test_metrics_match():
    rng = np.random.RandomState(5)
    logits = rng.randn(16, 10).astype(np.float32)
    labels = rng.randint(0, 10, 16).astype(np.int32)
    jl, tl = jnp.asarray(logits), torch.tensor(logits)
    jy, ty = jnp.asarray(labels), torch.tensor(labels).long()
    assert float(tmetrics.accuracy(tl, ty)) == float(jmetrics.accuracy(jl, jy))
    for k in (1, 5):
        np.testing.assert_array_equal(
            tmetrics.top_k_correct(tl, ty, k).numpy(),
            np.asarray(jmetrics.top_k_correct(jl, jy, k)))


@pytest.mark.parametrize("schedule", [False, True])
def test_adam_matches_optax(schedule):
    jlr = joptim.exponential_decay(0.01, 2, 0.5) if schedule else 0.01
    tlr = toptim.exponential_decay(0.01, 2, 0.5) if schedule else 0.01
    jstate, tstate = _run_both(joptim.adam(jlr),
                               toptim.adam(tlr, num_steps=4))
    assert tstate["count"] == int(jstate[0].count) == 4
    for slot in ("mu", "nu"):
        for k, v in tstate[slot].items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(getattr(jstate[0], slot)[k]), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_optax(max_norm):
    _run_both(joptim.clip_by_global_norm(max_norm),
              toptim.clip_by_global_norm(max_norm))


def test_chain_of_clip_and_adam_matches_optax():
    """The transformer LM's optimizer: clip(1.0) then Adam."""
    import optax

    _, tstate = _run_both(
        optax.chain(joptim.clip_by_global_norm(1.0), joptim.adam(0.01)),
        toptim.chain(toptim.clip_by_global_norm(1.0),
                     toptim.adam(0.01, num_steps=4)))
    assert tstate[0] == {} and tstate[1]["count"] == 4


@pytest.mark.parametrize("schedule", [False, True])
def test_tf_rmsprop_matches_jax(schedule):
    """TF-1.x RMSProp, five steps: ms from ones, epsilon inside the square
    root, momentum, and the count driving the (Inception) schedule."""
    jlr = joptim.exponential_decay(0.045, 2, 0.94) if schedule else 0.045
    tlr = toptim.exponential_decay(0.045, 2, 0.94) if schedule else 0.045
    jstate, tstate = _run_both(joptim.tf_rmsprop(jlr, 0.9, 0.9, 1.0),
                               toptim.tf_rmsprop(tlr, 0.9, 0.9, 1.0,
                                                 num_steps=5), steps=5)
    assert tstate["count"] == int(jstate.count) == 5
    for slot in ("ms", "mom"):
        for k, v in tstate[slot].items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(getattr(jstate, slot)[k]), **TOL)


def test_tf_rmsprop_starts_ms_at_ones():
    p = {k: torch.tensor(v) for k, v in _params(3).items()}
    state = toptim.tf_rmsprop(0.1).init(p)
    jstate = joptim.tf_rmsprop(0.1).init(
        {k: jnp.asarray(v) for k, v in _params(3).items()})
    for k in p:
        np.testing.assert_array_equal(state["ms"][k].numpy(),
                                      np.asarray(jstate.ms[k]))
        assert float(state["ms"][k].min()) == 1.0
        assert float(state["mom"][k].abs().max()) == 0.0


@pytest.mark.parametrize("num_updates", [None, 0, 1, 9, 100, 10**6])
def test_ema_effective_decay_matches_jax(num_updates):
    want = jema.effective_decay(
        0.9999, None if num_updates is None else jnp.asarray(num_updates))
    got = tema.effective_decay(0.9999, num_updates)
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_update_ema_matches_jax_step_by_step():
    """Five EMA updates of f32 shadows toward changing parameters, with
    the step count as num_updates, in place on the port's side."""
    rng = np.random.RandomState(6)
    params = {k: v for k, v in _params(7).items()}
    jema_p = {k: jnp.asarray(v) for k, v in params.items()}
    tema_p = {k: torch.tensor(v) for k, v in params.items()}
    for step in range(5):
        params = {k: v + rng.randn(*v.shape).astype(np.float32)
                  for k, v in params.items()}
        jema_p = jema.update_ema(jema_p, {k: jnp.asarray(v)
                                          for k, v in params.items()},
                                 0.9999, num_updates=jnp.asarray(step))
        out = tema.update_ema(tema_p, {k: torch.tensor(v)
                                       for k, v in params.items()},
                              0.9999, num_updates=step)
        assert out is tema_p
        for k in params:
            np.testing.assert_allclose(tema_p[k].numpy(),
                                       np.asarray(jema_p[k]), **TOL)


def _f32_schedule_values(jsched, tsched, steps):
    """Each schedule's value per step: JAX's (jitted, over int32 counts as
    optax passes them) and the port's, both as f32."""
    counts = jnp.asarray(steps, jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(jsched))(counts), np.float32)
    got = np.asarray([tsched(int(s)) for s in steps], np.float32)
    return got, want


# The three PTB configs' (lr decay, hold epochs) and an epoch of 7 steps.
ZAREMBA = [(0.5, 4), (0.8, 6), (1 / 1.15, 14)]


@pytest.mark.parametrize("lr", [1.0, 0.7])
@pytest.mark.parametrize("decay,hold", ZAREMBA,
                         ids=["small", "medium", "large"])
def test_zaremba_decay_equals_jax_in_f32(decay, hold, lr):
    """The staged schedule as f32 values, equal to JAX's bit for bit on
    both sides of every epoch boundary out to 60 decays (the large config
    decays 41 times over its 55 epochs).  The decay rate raised in double
    and rounded once sits an f32 ulp away at most of them (the rate is
    rounded to f32 first in JAX), numpy's f32 power at about a sixth."""
    spe = 7
    steps = sorted({e * spe + d for e in range(hold + 61)
                    for d in (-1, 0, 1) if e * spe + d >= 0})
    got, want = _f32_schedule_values(
        joptim.zaremba_decay(lr, spe, hold, decay),
        toptim.zaremba_decay(lr, spe, hold, decay), steps)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(lr) and got[-1] < got[0]


@pytest.mark.parametrize("boundaries,values", [
    ([3], [1.0, 0.5]),
    ([2, 5, 9], [1.0, 0.8, 0.64, 0.512]),
    ([4, 8], [0.1, 0.01 / 3, 0.0007]),
], ids=["one", "zaremba_like", "uneven"])
def test_piecewise_constant_equals_jax_in_f32(boundaries, values):
    """TF semantics (the old value at the boundary step, the new one from
    boundary + 1) with optax's cumulative ratios in f32: equal to JAX's
    values bit for bit at, before and after every boundary."""
    steps = sorted({max(0, b + d) for b in boundaries for d in (-1, 0, 1, 2)}
                   | {0, boundaries[-1] + 10})
    got, want = _f32_schedule_values(
        joptim.piecewise_constant(boundaries, values),
        toptim.piecewise_constant(boundaries, values), steps)
    np.testing.assert_array_equal(got, want)
    for s, v in zip(steps, got):
        i = sum(s > b for b in boundaries)
        np.testing.assert_allclose(v, values[i], rtol=1e-6)


def test_piecewise_constant_rejects_mismatched_lists():
    with pytest.raises(ValueError, match="len"):
        toptim.piecewise_constant([1, 2], [1.0, 0.5])


@pytest.mark.parametrize("schedule", ["constant", "zaremba"])
def test_sgd_with_clip_matches_jax_under_schedules(schedule):
    """The PTB optimizer, clip then SGD, with the staged schedule crossing
    an epoch boundary every step: updates and parameters step by step."""
    import optax

    lr = {"constant": (1.0, 1.0),
          "zaremba": (joptim.zaremba_decay(1.0, 1, 1, 0.5),
                      toptim.zaremba_decay(1.0, 1, 1, 0.5))}[schedule]
    _run_both(optax.chain(joptim.clip_by_global_norm(0.5), joptim.sgd(lr[0])),
              toptim.chain(toptim.clip_by_global_norm(0.5),
                           toptim.sgd(lr[1], num_steps=5)),
              steps=5)


@pytest.mark.parametrize("schedule", [False, True])
def test_centered_tf_rmsprop_matches_jax(schedule):
    """TF-1.x centered RMSProp: the mean gradient's square taken out of
    the denominator, mg from zeros; five steps, every slot compared."""
    jlr = joptim.piecewise_constant([1, 3], [0.045, 0.02, 0.01]) if (
        schedule) else 0.045
    tlr = toptim.piecewise_constant([1, 3], [0.045, 0.02, 0.01]) if (
        schedule) else 0.045
    jstate, tstate = _run_both(
        joptim.tf_rmsprop(jlr, 0.9, 0.9, 1.0, centered=True),
        toptim.tf_rmsprop(tlr, 0.9, 0.9, 1.0, centered=True, num_steps=5),
        steps=5)
    assert tstate["count"] == int(jstate.count) == 5
    for slot in ("ms", "mg", "mom"):
        for k, v in tstate[slot].items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(getattr(jstate, slot)[k]), **TOL)
    assert "mg" not in toptim.tf_rmsprop(0.1).init(
        {k: torch.tensor(v) for k, v in _params(3).items()})
