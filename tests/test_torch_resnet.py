"""The port's ResNet and training step against the JAX package's, on
bridged weights.

A small ResNet (one bottleneck per stage, width 16, 10 classes) at 32x32,
batch 2, f32: stages 2 and 3 have 3x3 convs with cin >= 64, so the ``mxu``
route reaches K1 (its plain version on the CPU).  The JAX side runs
``conv_mxu`` in interpret mode, without remat (interpret mode cannot sit
under ``jax.checkpoint``).  Tolerances: the JAX suite's model forward
2e-3 (tests/test_conv_mxu.py::test_resnet_forward_parity_mxu_vs_xla) for
logits and statistics, its grad tolerance 5e-4 for parameters and
momentum buffers after training steps.

Images are standardized (zero-mean) as normalized ImageNet inputs are:
with [0, 1] pixels the first BN's ``E[x^2] - E[x]^2`` cancels in f32, and
the JAX side's CPU reductions then drift from an f64 run by up to 5% in
some gradients, where the port's stay within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.core.train_state import TrainState as JTrainState
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.models.resnet import ResNet as JResNet
from distributed_tensorflow_models_tpu.ops import optim as joptim
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import train_loop as ttrain
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.models.resnet import ResNet
from distributed_tensorflow_models_tpu_torch.ops import optim

jax.config.update("jax_platforms", "cpu")

MODEL_TOL = dict(atol=2e-3, rtol=2e-3)
STATE_TOL = dict(atol=5e-4, rtol=5e-4)
SMALL = dict(stage_sizes=(1, 1, 1, 1), width=16, num_classes=10)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _jax_init(model, seed=0):
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(seed), x)
    return jax.tree.map(np.asarray, {k: dict(v[k]) for k in v})


def _randomized(variables, seed):
    """Init tree with random BN parameters and statistics, so that every
    block's main branch (its last BN scale is zero-initialized) counts."""
    rng = np.random.RandomState(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
            elif k in ("scale", "var"):
                out[k] = (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(t, c) for c, t in variables.items()}


@pytest.fixture(scope="module")
def small_variables():
    jm = JResNet(**SMALL, dtype=jnp.float32, conv_impl="xla")
    return _randomized(_jax_init(jm), 1)


def _port_model(variables, impl):
    m = ResNet(**SMALL, dtype=torch.float32, conv_impl=impl)
    interop.load_flax_variables(m, variables)
    return m


@pytest.mark.parametrize("name", ["resnet50", "small"])
def test_interop_round_trip_exact(name):
    if name == "resnet50":
        # The init tree's structure without running ResNet-50's forward in
        # JAX on the CPU; values from a numpy seed.
        rng = np.random.default_rng(3)
        shapes = jax.eval_shape(
            lambda: jget_model("resnet50", conv_impl="xla").init(
                jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
        variables = jax.tree.map(
            lambda s: rng.standard_normal(s.shape, dtype=s.dtype),
            {k: dict(v) for k, v in shapes.items()})
        tm = get_model("resnet50")
    else:
        variables, tm = _jax_init(JResNet(**SMALL, conv_impl="xla"), 3), ResNet(**SMALL)
    interop.load_flax_variables(tm, variables)
    back = interop.to_flax_variables(tm)
    want, got = _leaves(variables), _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_interop_rejects_mismatched_trees(small_variables):
    m = ResNet(**SMALL)
    bad = {"params": dict(small_variables["params"]),
           "batch_stats": small_variables["batch_stats"]}
    bad["params"].pop("head")
    with pytest.raises(KeyError, match="head"):
        interop.load_flax_variables(m, bad)


@pytest.mark.parametrize("impl", ["mxu", "xla"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_small_resnet_matches_jax(small_variables, impl, train):
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    jm = JResNet(**SMALL, dtype=jnp.float32, conv_impl=impl)
    # jit: the interpreted kernel runs many times faster compiled than
    # op by op.
    if train:
        want, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(
                small_variables, jnp.asarray(x))
        want_stats = _leaves(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            small_variables, jnp.asarray(x))
        want_stats = _leaves(small_variables["batch_stats"])
    tm = _port_model(small_variables, impl)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    got_stats = _leaves(interop.to_flax_variables(tm)["batch_stats"])
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k],
                                   err_msg=k, **MODEL_TOL)


def _batches(n, seed=4, batch=8):
    # Batch 8 for training: at batch 2 the 1x1 stage-3 maps give BN two
    # values per channel, the gradient norm reaches ~600 and f32 rounding,
    # not the port, sets the agreement.
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(batch, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, 10, batch).astype(np.int32)}
            for _ in range(n)]


LR, WD, STEPS = 0.002, 1e-4, 3


@pytest.fixture(scope="module")
def jax_trajectory(small_variables):
    """The JAX package's classification loss + L2 + tf_momentum, three
    steps on ``_batches(STEPS)``: per step its metrics, parameters, BN
    statistics and momentum buffers (flat numpy dicts)."""
    jm = JResNet(**SMALL, dtype=jnp.float32, conv_impl="xla")
    params = jax.tree.map(jnp.asarray, small_variables["params"])
    jstate = JTrainState.create(jm, joptim.tf_momentum(LR, 0.9),
                                jax.random.key(0),
                                jnp.zeros((1, 32, 32, 3), jnp.float32))
    jstate = jstate.replace(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, small_variables["batch_stats"]),
        opt_state=joptim.tf_momentum(LR, 0.9).init(params),
    )
    jstep = jax.jit(jtrain.make_train_step_fn(
        jtrain.classification_loss_fn(jm.apply, weight_decay=WD)))
    out = []
    for b in _batches(STEPS):
        jstate, jmetrics = jstep(
            jstate, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.key(0))
        out.append({
            "metrics": {k: float(v) for k, v in jmetrics.items()},
            "step": int(jstate.step),
            "params": _leaves(jax.tree.map(np.asarray, dict(jstate.params))),
            "batch_stats": _leaves(
                jax.tree.map(np.asarray, dict(jstate.batch_stats))),
            "trace": _leaves(jax.tree.map(
                np.asarray, dict(jstate.opt_state[0].trace))),
        })
    return out


@pytest.mark.parametrize("impl", ["mxu", "xla"])
@pytest.mark.parametrize("steps", [1, 3])
def test_training_steps_match_jax(small_variables, jax_trajectory, impl,
                                  steps):
    """classification loss + L2 + tf_momentum, step by step on the same
    batches: loss and metrics per step, then parameters, momentum buffers
    and BN statistics.  The JAX side runs its ``xla`` convs for both of
    the port's routes (its interpreted kernel under the jitted step's
    autodiff would dominate the suite's time; the conv tests hold the two
    routes together).

    The learning rate is small enough that three steps stay where both f32
    runs agree with an f64 run of the port: at lr 0.02 the JAX side's
    second-step gradients drift from f64 by up to 10% while the port's
    stay within 1e-5 of it."""
    tm = _port_model(small_variables, impl)
    tstate = TrainState.create(tm, optim.tf_momentum(LR, 0.9))
    tstep = ttrain.make_train_step(
        ttrain.classification_loss_fn(tm, weight_decay=WD))
    for b, want in zip(_batches(steps), jax_trajectory):
        tstate, tmetrics = tstep(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()}, 0)
        assert sorted(tmetrics) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(float(tmetrics[k]), v, err_msg=k,
                                       **STATE_TOL)
    want = jax_trajectory[steps - 1]
    assert tstate.step == want["step"] == steps
    got = interop.to_flax_variables(tm)
    got_trace = {k.replace(".", "/"): v.numpy()
                 for k, v in tstate.opt_state["trace"].items()}
    for coll, g in (("params", _leaves(got["params"])),
                    ("batch_stats", _leaves(got["batch_stats"])),
                    ("trace", got_trace)):
        assert sorted(g) == sorted(want[coll]), coll
        for k, w in want[coll].items():
            np.testing.assert_allclose(g[k], w, err_msg=f"{coll}/{k}",
                                       **STATE_TOL)
