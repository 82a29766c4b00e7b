"""The port's LeNet, CIFAR ResNet-32, VGG-16 and AlexNet against the JAX
package's, on bridged weights, and ``lenet_mnist`` and ``resnet32_cifar10``
trained three steps against the JAX train step.

Weights are the port's seeded initialization (random BN scales, biases
and statistics for ResNet-32, so every branch counts) carried to the JAX
models by ``interop``; dropout is 0 on both sides (the two frameworks
draw different bits).  Inputs are standardized normal images made with
numpy.  VGG-16 and AlexNet keep their real channel widths on small inputs
(32x32 and 67x67, batch 2: a 1x1 map at the flatten) and once more where
the flatten sees a 2x2 map (64x64 and 99x99, batch 1), which an NCHW
flatten would scramble; the first dense layer's width follows from the
image size given at construction.  ``patches`` and ``mxu`` run on both
sides with the same ``impl`` (on the CPU the port's ``mxu`` route runs
K1's plain version, JAX's its Pallas kernel in interpret mode).

Tolerances: the JAX suite's model tolerance 2e-3 relative (``MODEL_TOL``
of ``tests/test_torch_resnet.py``) for f32 logits and BN statistics, with
the absolute part taken of the output's largest magnitude (VGG-16's
logits at this initialization are ~1e-2, so a fixed 2e-3 would hold
nothing).  In bf16 (VGG-16's and AlexNet's default) both sides round each
layer's output to 8 bits at different points, so the port is held to the
JAX package's own bf16 accuracy: its distance from the f32 JAX logits at
most twice that of the JAX bf16 logits.  Training steps: parameters,
momentum buffers and BN statistics to 5e-4 (``STATE_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.core.train_state import TrainState as JTrainState
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.ops.conv import max_pool as jmax_pool
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch import models as tmodels
from distributed_tensorflow_models_tpu_torch.core import train_loop as ttrain
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.ops.conv import max_pool

jax.config.update("jax_platforms", "cpu")

MODEL_RTOL = 2e-3
STATE_TOL = dict(atol=5e-4, rtol=5e-4)

# name: (JAX kwargs, port kwargs, input shape) at the parity sizes.
ZOO = {
    "lenet": (dict(dropout_rate=0.0), dict(dropout_rate=0.0),
              (2, 28, 28, 1)),
    "resnet32_cifar": ({}, {}, (2, 32, 32, 3)),
    "vgg16": (dict(dropout_rate=0.0), dict(dropout_rate=0.0, image_size=32),
              (2, 32, 32, 3)),
    "alexnet": (dict(dropout_rate=0.0),
                dict(dropout_rate=0.0, image_size=67), (2, 67, 67, 3)),
}
# Where the flatten sees a 2x2 map.
FLATTEN = {"vgg16": (1, 64, 64, 3), "alexnet": (1, 99, 99, 3)}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _images(shape, seed=2):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(name, shape, impl="patches", dtype=torch.float32, **extra):
    _, tkw, _ = ZOO[name]
    kw = dict(tkw, **extra)
    if "image_size" in kw:
        kw["image_size"] = shape[1]
    return get_model(name, conv_impl=impl, dtype=dtype, **kw)


def _jax(name, impl="patches", dtype=jnp.float32):
    jkw, _, _ = ZOO[name]
    return jget_model(name, conv_impl=impl, dtype=dtype, **jkw)


def _randomized_bn(variables, seed):
    """Random BN scales and biases (and the head's bias) and running
    statistics."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(t) for c, t in variables.items()}


def _variables(name, shape):
    """The port's seeded initialization as a flax tree, BN randomized."""
    tree = interop.to_flax_variables(
        _port(name, shape, generator=torch.Generator().manual_seed(1)))
    return _randomized_bn(tree, 3) if "batch_stats" in tree else tree


@pytest.fixture(scope="module")
def zoo_variables():
    cache = {}

    def get(name, shape):
        key = (name, shape)
        if key not in cache:
            cache[key] = _variables(name, shape)
        return cache[key]

    return get


@pytest.mark.parametrize("name", sorted(ZOO))
def test_interop_round_trip_exact(name):
    """The JAX model's init tree (its structure by ``jax.eval_shape``,
    values from a numpy seed) loads into the port's model name for name
    and shape for shape, and comes back unchanged."""
    shape = ZOO[name][2]
    shapes = jax.eval_shape(lambda: _jax(name).init(
        jax.random.key(0), jnp.zeros(shape), train=False))
    rng = np.random.default_rng(4)
    variables = jax.tree.map(
        lambda s: rng.standard_normal(s.shape, dtype=s.dtype),
        {k: dict(v) for k, v in shapes.items()})
    tm = _port(name, shape)
    interop.load_flax_variables(tm, variables)
    want, got = _leaves(variables), _leaves(interop.to_flax_variables(tm))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resnet32_names_match_flax():
    """A block's own convs and norms are auto-named, its shortcut named:
    the flax tree of ResNet-32 and the port's state dict list the same
    names, ``proj``/``proj_bn`` only where stages 1 and 2 begin."""
    shapes = jax.eval_shape(lambda: _jax("resnet32_cifar").init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    want = set(_leaves({k: dict(v) for k, v in shapes.items()}))
    got = set(_leaves(interop.to_flax_variables(get_model("resnet32_cifar"))))
    assert got == want
    assert {k.split("/")[1] for k in got if "/proj/" in k} == {
        "stage1_block0", "stage2_block0"}
    assert "params/stage0_block4/BatchNorm_1/scale" in got


def _jax_forward(name, variables, x, train, impl, dtype=jnp.float32):
    jm = _jax(name, impl, dtype)
    if train and "batch_stats" in variables:
        y, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                        jnp.asarray(x))
        stats = _leaves(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
    else:
        y = jax.jit(lambda v, x: jm.apply(v, x, train=train))(
            variables, jnp.asarray(x))
        stats = _leaves(variables.get("batch_stats", {}))
    return np.asarray(y, np.float32), stats


def _assert_close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL,
                               atol=MODEL_RTOL * scale, err_msg=what)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("impl", ["patches", "mxu"])
@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_matches_jax(zoo_variables, name, impl, train):
    """f32 logits (and the updated BN statistics in training) of the
    port's model against the JAX model's on the same weights and inputs."""
    shape = ZOO[name][2]
    variables = zoo_variables(name, shape)
    x = _images(shape)
    want, want_stats = _jax_forward(name, variables, x, train, impl)
    tm = _port(name, shape, impl)
    interop.load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_close(got.numpy(), want, "logits")
    got_stats = _leaves(interop.to_flax_variables(tm).get("batch_stats", {}))
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        _assert_close(got_stats[k], want_stats[k], k)


@pytest.mark.parametrize("name", sorted(FLATTEN))
def test_flatten_is_nhwc_like_flax(zoo_variables, name):
    """At an input whose last map is 2x2, the first dense layer reads the
    flatten in flax's NHWC order: the logits match the JAX model's, and
    the same weights read in NCHW order would not."""
    shape = FLATTEN[name]
    variables = zoo_variables(name, shape)
    x = _images(shape, seed=5)
    want, _ = _jax_forward(name, variables, x, False, "patches")
    tm = _port(name, shape)
    interop.load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        _assert_close(got, want, "logits")
        # The fc6 kernel's rows permuted from NHWC to NCHW order.
        c = tm.fc6.kernel.shape[0] // 4
        perm = torch.arange(4 * c).reshape(2, 2, c).permute(2, 0, 1).reshape(-1)
        tm.fc6.kernel.copy_(tm.fc6.kernel[perm])
        scrambled = tm(torch.from_numpy(x)).numpy()
    assert np.abs(scrambled - want).max() > 10 * MODEL_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_bf16_zoo_matches_jax_bf16(zoo_variables, name):
    """The default dtype (bf16 activations, f32 head) against JAX in bf16:
    the port's distance from the f32 JAX logits is at most twice the JAX
    bf16 run's."""
    shape = ZOO[name][2]
    variables = zoo_variables(name, shape)
    x = _images(shape)
    want32, _ = _jax_forward(name, variables, x, False, "patches")
    want16, _ = _jax_forward(name, variables, x, False, "patches",
                             jnp.bfloat16)
    tm = _port(name, shape, dtype=torch.bfloat16)
    interop.load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    jax_err = np.abs(want16 - want32).max()
    assert 0 < jax_err
    assert np.abs(got - want32).max() <= 2 * jax_err


@pytest.mark.parametrize("name", ["lenet", "vgg16", "alexnet"])
def test_wrong_input_size_raises(name):
    """The first dense width is fixed from ``image_size``: another input
    size raises instead of reshaping into the wrong width."""
    shape = ZOO[name][2]
    tm = _port(name, shape)
    bad = (shape[0], shape[1] + 4, shape[2] + 4, shape[3])
    with pytest.raises(ValueError, match="built for"):
        tm(torch.zeros(bad))


@pytest.mark.parametrize("impl", ["patches", "mxu"])
def test_max_pool_gradient_with_ties_matches_jax(impl):
    """The patches/mxu max pool is a chain of maximums: where a window
    holds ties (ReLU's zeros, repeated values) the gradient is split as
    JAX's same ``impl`` splits it, not routed to one element."""
    rng = np.random.RandomState(6)
    x = np.maximum(np.round(rng.randn(2, 9, 9, 3)), 0).astype(np.float32)
    g = rng.randn(2, 4, 4, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jmax_pool(x, (3, 3), strides=(2, 2),
                                         impl=impl), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    max_pool(xt, (3, 3), strides=(2, 2), impl=impl).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["lenet_mnist", "resnet32_cifar10"])
def test_configs_build_the_zoo(name):
    """The configs name the JAX package's models with its values, and the
    port's harness builds them at the configured image size."""
    j, t = jconfig.get_config(name), tconfig.get_config(name)
    model = trainlib.build_model(t, torch.device("cpu"))
    assert type(model).__name__ == type(jget_model(j.model)).__name__
    x = torch.zeros(2, t.image_size, t.image_size,
                    1 if t.model == "lenet" else 3)
    assert tuple(model(x).shape) == (2, 10)


@pytest.mark.parametrize("name", tmodels.available_models())
def test_harness_sizes_every_builder_that_takes_image_size(name):
    """``build_model`` hands ``cfg.image_size`` to a builder because its
    signature names it, not because a list in the harness names the model:
    exactly the models whose first dense width follows from the input
    take it, and they are built at the config's size."""
    sized = {"lenet": "Dense_0", "vgg16": "fc6", "alexnet": "fc6"}
    assert tmodels.builder_takes(name, "image_size") == (name in sized)
    if name in sized:
        cfg = tconfig.get_config("resnet50_synthetic", model=name,
                                 image_size=99, model_kwargs={})
        model = trainlib.build_model(cfg, torch.device("cpu"))
        assert model.image_size == 99
        side = {"lenet": 99 // 4, "vgg16": 99 // 32, "alexnet": 2}[name]
        channels = {"lenet": 64, "vgg16": 512, "alexnet": 256}[name]
        assert getattr(model, sized[name]).kernel.shape[0] == (
            side * side * channels)


# Three steps of each config's own loss, L2 and optimizer on the same
# batches; ResNet-32 cut to one block a stage.
STEP_CASES = {
    "lenet_mnist": (dict(dropout_rate=0.0), (8, 28, 28, 1)),
    "resnet32_cifar10": (dict(blocks_per_stage=1), (8, 32, 32, 3)),
}
STEPS = 3


def _step_batches(shape, seed=7):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(*shape).astype(np.float32),
             "label": rng.randint(0, 10, shape[0]).astype(np.int32)}
            for _ in range(STEPS)]


@pytest.mark.parametrize("impl", ["patches", "mxu"])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_training_steps_match_jax(name, impl):
    """The config's loss (softmax cross entropy plus its L2) and optimizer
    (SGD 0.1 for LeNet; TF momentum 0.1 with its staircase decay for
    ResNet-32) built by each package's own config, three steps on the same
    batches: metrics per step, then parameters, momentum buffers and BN
    statistics.  The JAX side runs its patches lowering for both of the
    port's routes (its interpreted kernel under the jitted step's autodiff
    would dominate the suite's time; the forward tests hold the routes
    together)."""
    kw, shape = STEP_CASES[name]
    jcfg, tcfg = jconfig.get_config(name), tconfig.get_config(name)
    model_name = tcfg.model
    tm = get_model(model_name, conv_impl=impl, generator=torch.Generator()
                   .manual_seed(8), **kw)
    tree = interop.to_flax_variables(tm)
    if "batch_stats" in tree:
        tree = _randomized_bn(tree, 9)
        interop.load_flax_variables(tm, tree)
    jm = jget_model(model_name, conv_impl="patches", **kw)
    jtx = jcfg.optimizer.make()
    params = jax.tree.map(jnp.asarray, tree["params"])
    jstate = JTrainState.create(jm, jtx, jax.random.key(0),
                                jnp.zeros((1,) + shape[1:], jnp.float32))
    jstate = jstate.replace(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, tree.get("batch_stats", {})),
        opt_state=jtx.init(params))
    jstep = jax.jit(jtrain.make_train_step_fn(jtrain.classification_loss_fn(
        jm.apply, weight_decay=jcfg.weight_decay)))
    tstate = TrainState.create(tm, tcfg.optimizer.make(STEPS))
    tstep = ttrain.make_train_step(ttrain.classification_loss_fn(
        tm, weight_decay=tcfg.weight_decay))
    for b in _step_batches(shape):
        jstate, jmetrics = jstep(
            jstate, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.key(0))
        tstate, tmetrics = tstep(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()}, 0)
        for k in ("loss", "xent", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                       err_msg=k, **STATE_TOL)
    assert tstate.step == int(jstate.step) == STEPS
    got = interop.to_flax_variables(tm)
    want = {"params": _leaves(jax.tree.map(np.asarray, dict(jstate.params))),
            "batch_stats": _leaves(jax.tree.map(
                np.asarray, dict(jstate.batch_stats)))}
    if jcfg.optimizer.name == "momentum":
        want["trace"] = _leaves(jax.tree.map(
            np.asarray, dict(jstate.opt_state[0].trace)))
        got["trace"] = {k.replace(".", "/"): v.numpy()
                        for k, v in tstate.opt_state["trace"].items()}
        assert tstate.opt_state["count"] == STEPS
    for coll, w in want.items():
        g = _leaves(got.get(coll, {})) if coll != "trace" else got[coll]
        assert sorted(g) == sorted(w), coll
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{coll}/{k}",
                                       **STATE_TOL)
