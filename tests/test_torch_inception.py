"""The port's Inception-v3 and its training step against the JAX package's,
on bridged weights.

The model has 10 classes and dropout 0 on both sides; inputs are batch 2,
standardized normal values made with numpy.  The weights are the port's
initialization (a seeded generator), with random BN scales and biases,
and running statistics taken from one training-mode batch so that the
eval path sees activations of a sane size; ``interop`` carries them to
the JAX model.  The JAX side runs its ``xla`` convs; the port runs
``F.conv2d`` (``xla``) or, in one case, the ``mxu`` route (K1's plain
version on the CPU).

The aux head needs the 17x17 grid of a 299x299 input: on a smaller grid
its pool and 5x5 conv are empty, the JAX model's aux logits are NaN (the
mean of an empty map) and the port raises instead.  So everything that
involves the aux head runs at 299x299; 75x75, the smallest input the stem
takes, holds the main branch with ``aux_head=False`` on the port's side.

Tolerances: the JAX suite's model tolerance 2e-3 (relative and absolute)
for f32 logits and BN statistics through the 94 conv+BN layers.  The
gradient is another matter.  At this initialization it explodes through
the BN layers (norm ~330 against a loss of 3.6), which amplifies every
run's f32 round-off: the port's f32 gradients and JAX's differ by 3.7 % in
relative L2, and the port's f32 run differs by 3.1 % from its own run with
f64 activations (the BN statistics stay f32 in both packages), by up to
5 % of the largest gradient in the stem's kernels.  So the training steps
are compared at learning rate 1e-4, where three steps stay near the
bridged weights (at the config's 0.045 the first step moves the stem's
kernels by more than their size and the two runs part ways), and the
state is held in relative L2 per collection, at limits a few times the
measured agreement (``STATE_L2``), and so is its change since the bridged
init (``DELTA_L2``), which a step left undone or a wrong EMA decay fails.  The config's smoothing, aux weight,
L2, RMSProp decay, momentum and epsilon, schedule and EMA decay are used
as they are.  In
bf16 both sides round every layer's output to 8 bits, in different places
(the JAX convolution rounds once, the port's BN adds in bf16 after a bf16
multiply), and through this depth at batch 2 each side's bf16 logits land
20-25 % of their largest magnitude from the f32 ones (the aux logits,
behind a BN over two values per channel, up to 70 %).  So the bf16 case
holds the port to the JAX package's own bf16 accuracy: its distance from
the f32 JAX run at most 1.5 times that of the JAX bf16 run.
"""

import dataclasses

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
from distributed_tensorflow_models_tpu.ops import ema as jema
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import train_loop as ttrain
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.models.inception_v3 import InceptionV3

jax.config.update("jax_platforms", "cpu")

MODEL_TOL = dict(atol=2e-3, rtol=2e-3)
SMALL = dict(num_classes=10, dropout_rate=0.0)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _images(seed, size=299, batch=2):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(
        np.float32)


def _jax_model(**kw):
    return jget_model("inception_v3", **{**SMALL, "dtype": jnp.float32,
                                         "conv_impl": "xla", **kw})


def _port_model(variables, **kw):
    m = InceptionV3(**{**SMALL, "dtype": torch.float32, "conv_impl": "xla",
                       **kw})
    interop.load_flax_variables(m, variables)
    return m


@pytest.fixture(scope="module")
def variables():
    """The bridged weights: the port's seeded init, random BN scales and
    biases, running statistics from one batch's moments."""
    m = InceptionV3(**SMALL, dtype=torch.float32, conv_impl="xla",
                    generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("BatchNorm_0.scale"):
                p.copy_(torch.from_numpy(
                    (rng.rand(*p.shape) * 0.5 + 0.75).astype(np.float32)))
            elif name.endswith("BatchNorm_0.bias"):
                p.copy_(torch.from_numpy(
                    (rng.randn(*p.shape) * 0.1).astype(np.float32)))
        bns = [mod for mod in m.modules() if hasattr(mod, "momentum")]
        for bn in bns:
            bn.momentum = 0.0
        m(torch.from_numpy(_images(2)), train=True)
        for bn in bns:
            bn.momentum = 0.9997
    return interop.to_flax_variables(m)


@pytest.fixture(scope="module")
def full_shapes():
    """The JAX model's 1000-class variable tree, shapes only: traced, not
    run."""
    shapes = jax.eval_shape(lambda: jget_model(
        "inception_v3", conv_impl="xla").init(
            jax.random.key(0), jnp.zeros((1, 299, 299, 3)), train=False))
    return {k: dict(v) for k, v in shapes.items()}


def test_param_count_matches_jax(full_shapes):
    want = sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(full_shapes["params"]))
    got = sum(p.numel() for p in get_model("inception_v3").parameters())
    assert got == want and 26e6 < got < 28.5e6


@pytest.mark.parametrize("name", ["inception_v3_1000", "small"])
def test_interop_round_trip_exact(name, variables, full_shapes):
    if name == "small":
        tree, tm = variables, InceptionV3(**SMALL)
    else:
        # The full tree's structure from JAX; values from a numpy seed.
        rng = np.random.default_rng(3)
        tree = jax.tree.map(lambda s: rng.standard_normal(
            s.shape, dtype=np.float32), full_shapes)
        tm = get_model("inception_v3")
    interop.load_flax_variables(tm, tree)
    back = interop.to_flax_variables(tm)
    want, got = _leaves(tree), _leaves(back)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("params/AuxHead/aux_logits") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_apply(variables, x, train, **kw):
    jm = _jax_model(**kw)
    if train:
        (logits, aux), upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                        jnp.asarray(x))
        stats = _leaves(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
        return np.asarray(logits, np.float32), np.asarray(aux, np.float32), stats
    logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return np.asarray(logits, np.float32), None, None


@pytest.mark.parametrize("case", [
    dict(train=True), dict(train=False), dict(train=True, impl="mxu"),
    dict(train=True, dtype="bfloat16"),
], ids=["train", "eval", "train-mxu", "train-bf16"])
def test_forward_matches_jax(variables, case):
    """Logits, aux logits and the updated BN statistics (training), or the
    logits from the running statistics (eval), at 299x299."""
    train = case["train"]
    dtype = case.get("dtype", "float32")
    x = _images(4)
    want, want_aux, want_stats = _jax_apply(
        variables, x, train, dtype=getattr(jnp, dtype))
    tm = _port_model(variables, conv_impl=case.get("impl", "xla"),
                     dtype=getattr(torch, dtype))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=train)
    if not train:
        np.testing.assert_allclose(out.numpy(), want, **MODEL_TOL)
        return
    logits, aux = out
    if dtype == "bfloat16":
        # Both bf16 runs against the f32 JAX run: the port's error at most
        # 1.5 times JAX's own (see the module docstring).
        ref, ref_aux, _ = _jax_apply(variables, x, True)
        for what, got, w, r in (("logits", logits, want, ref),
                                ("aux", aux, want_aux, ref_aux)):
            port_err = float(np.abs(got.float().numpy() - r).max())
            jax_err = float(np.abs(w - r).max())
            assert 0 < jax_err and port_err <= 1.5 * jax_err, (
                what, port_err, jax_err)
        return
    np.testing.assert_allclose(logits.numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(aux.numpy(), want_aux, **MODEL_TOL)
    got_stats = _leaves(interop.to_flax_variables(tm)["batch_stats"])
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, err_msg=k, **MODEL_TOL)


def test_small_input_aux_head(variables):
    """At 75x75 the JAX aux logits are NaN and the port's aux head raises;
    with the aux head off, the port's logits and main-branch statistics are
    JAX's.  Batch 8: the last blocks run on a 1x1 grid there, where a BN
    over two values would make f32 round-off, not the port, set the
    agreement."""
    x = _images(5, size=75, batch=8)
    want, want_aux, want_stats = _jax_apply(variables, x, True)
    assert np.isnan(want_aux).all() and np.isfinite(want).all()
    tm = _port_model(variables)
    with pytest.raises(ValueError, match="17x17"):
        tm(torch.from_numpy(x), train=True)
    no_aux = {c: {k: v for k, v in t.items() if k != "AuxHead"}
              for c, t in variables.items()}
    tm = _port_model(no_aux, aux_head=False)
    with torch.no_grad():
        logits = tm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(logits.numpy(), want, **MODEL_TOL)
    got_stats = _leaves(interop.to_flax_variables(tm)["batch_stats"])
    for k, g in got_stats.items():
        np.testing.assert_allclose(g, want_stats[k], err_msg=k, **MODEL_TOL)
    with torch.no_grad():
        eval_logits = tm(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(eval_logits.numpy(),
                               _jax_apply(variables, x, False)[0], **MODEL_TOL)


def test_remat_is_not_ported(variables):
    """Remat is ported now (the name is kept from when it raised): the
    remat model builds, carries the same state-dict names, and the
    bridged weights round-trip through it exactly
    (``tests/test_torch_remat.py`` holds its numbers)."""
    tm = _port_model(variables, remat=True)
    assert tm.remat
    assert set(tm.state_dict()) == set(InceptionV3(**SMALL).state_dict())
    back = interop.to_flax_variables(tm)
    want, got = _leaves(variables), _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


STEPS, BATCH, LR = 3, 4, 1e-4


def _batches(n, seed=6):
    rng = np.random.RandomState(seed)
    return [{"image": _images(seed + 100 * i, batch=BATCH),
             "label": rng.randint(0, 10, BATCH).astype(np.int32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_trajectory(variables):
    """The JAX package's inception_v3_imagenet step: label smoothing 0.1,
    aux weight 0.4, L2 4e-5, tf_rmsprop from the config and the EMA at
    0.9999, jitted, three steps: per step the metrics, and the parameters,
    BN statistics, RMSProp slots and EMA shadows (flat numpy dicts)."""
    cfg = jconfig.get_config("inception_v3_imagenet")
    jm = _jax_model()
    tx = dataclasses.replace(cfg.optimizer, learning_rate=LR).make()
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params),
        ema_params=jax.tree.map(lambda p: p.astype(jnp.float32), params),
        carry=None, apply_fn=jm.apply, tx=tx, ema_decay=cfg.ema_decay)
    jstep = jax.jit(jtrain.make_train_step_fn(jtrain.classification_loss_fn(
        jm.apply, label_smoothing=cfg.label_smoothing,
        weight_decay=cfg.weight_decay, aux_loss_weight=cfg.aux_loss_weight)))
    out = []
    for b in _batches(STEPS):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in b.items()},
                                 jax.random.key(0))
        rms = jstate.opt_state
        out.append({
            "metrics": {k: float(v) for k, v in jmetrics.items()},
            "step": int(jstate.step),
            "count": int(rms.count),
            "params": _leaves(jax.tree.map(np.asarray, dict(jstate.params))),
            "batch_stats": _leaves(
                jax.tree.map(np.asarray, dict(jstate.batch_stats))),
            "ms": _leaves(jax.tree.map(np.asarray, dict(rms.ms))),
            "mom": _leaves(jax.tree.map(np.asarray, dict(rms.mom))),
            "ema": _leaves(jax.tree.map(np.asarray, dict(jstate.ema_params))),
        })
    return out


def _flat(tensors):
    """Copies: the step updates the state's tensors in place."""
    return {k.replace(".", "/"): v.detach().numpy().copy()
            for k, v in tensors.items()}


def _minus(tree, base):
    return {k: v.astype(np.float64) - base[k] for k, v in tree.items()}


def _rel_l2(got, want):
    """The relative L2 distance of two trees of arrays, as one vector."""
    num = sum(float(np.sum((got[k].astype(np.float64) - w) ** 2))
              for k, w in want.items())
    den = sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values())
    return (num / den) ** 0.5


# Relative L2 limits of the state after 1 and 3 steps (see the module
# docstring; measured: params 5e-6 and 1.6e-4, EMA 4e-6 and 1.2e-4, BN
# statistics 4e-8 and 7e-6, ms 1.1e-3 and 3.0e-2).
STATE_L2 = {"params": 1e-3, "ema": 1e-3, "batch_stats": 1e-4, "ms": 0.1}
# At lr 1e-4 a step moves the parameters by ~1e-4 of their size, so the
# state limits cannot tell a step from none.  The change since the bridged
# init is held too, in relative L2 of (port - init) against (JAX - init).
# Measured after 1 step: params 0.045, EMA 0.045, mom 0.045 (the gradient
# gap of the module docstring), ms 9.8e-3, BN statistics 7.8e-4; after 3
# steps params 0.43, EMA 0.38, ms 0.081, BN statistics 0.046 (the runs part
# ways).  An EMA left unchanged reads 1.0; one decayed with num_updates =
# step + 1 reads 0.10 after 1 step and 0.37 after 3.
DELTA_L2 = {
    1: {"params": 0.07, "ema": 0.07, "mom": 0.07, "ms": 0.02,
        "batch_stats": 2e-3},
    3: {"params": 0.6, "ema": 0.6, "ms": 0.15, "batch_stats": 0.1},
}
# Each step's change of the EMA shadows against the JAX package's
# update_ema on the port's own shadows and parameters: measured 0 (bitwise
# equal); num_updates = step + 1 reads 0.09, an EMA left unchanged 1.0.
EMA_RULE_L2 = 1e-3


@pytest.mark.parametrize("steps", [1, 3])
def test_training_steps_match_jax(variables, jax_trajectory, steps):
    """The port's step built as its harness builds it for
    inception_v3_imagenet (at the comparison's learning rate), step by step
    on the same batches: the metrics of every step, then the parameters,
    BN statistics, RMSProp slots, EMA shadows, step and count."""
    cfg = tconfig.get_config("inception_v3_imagenet")
    tm = _port_model(variables)
    tstate = TrainState.create(
        tm, dataclasses.replace(cfg.optimizer,
                                learning_rate=LR).make(steps),
        ema_decay=cfg.ema_decay)
    tstep = ttrain.make_train_step(ttrain.classification_loss_fn(
        tm, label_smoothing=cfg.label_smoothing,
        weight_decay=cfg.weight_decay, aux_loss_weight=cfg.aux_loss_weight))
    init = {"params": _leaves(variables["params"]),
            "batch_stats": _leaves(variables["batch_stats"])}
    init["ema"] = init["params"]
    init["ms"] = {k: np.ones_like(v) for k, v in init["params"].items()}
    init["mom"] = {k: np.zeros_like(v) for k, v in init["params"].items()}
    shadows = init["ema"]
    for n, (b, want) in enumerate(zip(_batches(steps), jax_trajectory)):
        tstate, tmetrics = tstep(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()}, 0)
        # This step's change of the shadows against the JAX package's own
        # EMA rule applied to the port's previous shadows and new
        # parameters.
        rule = jax.tree.map(np.asarray, jema.update_ema(
            shadows, _flat(tstate.params), cfg.ema_decay,
            num_updates=jnp.asarray(n, jnp.int32)))
        got_ema = _flat(tstate.ema_params)
        err = _rel_l2(_minus(got_ema, shadows), _minus(rule, shadows))
        assert err <= EMA_RULE_L2, ("ema rule", n, err)
        shadows = got_ema
        assert sorted(tmetrics) == sorted(want["metrics"])
        m, w = {k: float(v) for k, v in tmetrics.items()}, want["metrics"]
        # The first forward is the bridged model's: f32 round-off.  Later
        # ones run on parameters that the two runs' gradients moved apart.
        rtol = 1e-4 if n == 0 else 1e-2
        for k in ("loss", "xent"):
            np.testing.assert_allclose(m[k], w[k], rtol=rtol, err_msg=k)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=2e-2)
        assert abs(m["accuracy"] - w["accuracy"]) <= (0 if n == 0
                                                       else 1 / BATCH)
    want = jax_trajectory[steps - 1]
    assert tstate.step == want["step"] == steps
    assert tstate.opt_state["count"] == want["count"] == steps
    tree = interop.to_flax_variables(tm)
    got = {"params": _leaves(tree["params"]),
           "batch_stats": _leaves(tree["batch_stats"]),
           "ms": _flat(tstate.opt_state["ms"]),
           "mom": _flat(tstate.opt_state["mom"]),
           "ema": _flat(tstate.ema_params)}
    for coll, g in got.items():
        assert sorted(g) == sorted(want[coll]), coll
    for coll, limit in STATE_L2.items():
        err = _rel_l2(got[coll], want[coll])
        assert err <= limit, (coll, err, limit)
    for coll, limit in DELTA_L2[steps].items():
        err = _rel_l2(_minus(got[coll], init[coll]),
                      _minus(want[coll], init[coll]))
        assert err <= limit, ("change", coll, err, limit)
    if steps == 3:
        # Three momentum-weighted gradients of turning directions largely
        # cancel, so their sum is not conditioned for an elementwise
        # comparison: its size is.
        norm = lambda t: sum(float(np.sum(v.astype(np.float64) ** 2))
                             for v in t.values()) ** 0.5
        np.testing.assert_allclose(norm(got["mom"]), norm(want["mom"]),
                                   rtol=0.1)
    assert ttrain.state_is_finite(tstate)


def test_eval_step_restores_ema_shadows(variables):
    """make_eval_step(use_ema=True) evaluates the EMA shadows, as the JAX
    eval step does; use_ema=False the raw parameters."""
    tm = _port_model(variables)
    state = TrainState.create(tm, tconfig.get_config(
        "inception_v3_imagenet").optimizer.make(1), ema_decay=0.9999)
    shadows = {k: v * 0.5 for k, v in state.ema_params.items()}
    state = state.replace(ema_params=shadows)
    x = _images(7)
    labels = np.array([3, -1], np.int32)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    jm = _jax_model()
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=(), ema_params=jax.tree.map(lambda p: p * 0.5, jparams),
        carry=None, apply_fn=jm.apply, tx=None, ema_decay=0.9999)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    for use_ema in (True, False):
        got = ttrain.make_eval_step(tm, use_ema=use_ema)(state, batch)
        want = jtrain.make_eval_step(jm.apply, use_ema=use_ema)(jstate, jbatch)
        assert sorted(got) == sorted(want)
        assert float(got["count"]) == float(want["count"]) == 1.0
        for k in ("top1_count", "top5_count"):
            assert float(got[k]) == float(want[k]), k
        np.testing.assert_allclose(float(got["xent_sum"]),
                                   float(want["xent_sum"]), **MODEL_TOL)
    # The eval step leaves the model's own parameters in place.
    for k, v in _leaves(interop.to_flax_variables(tm)["params"]).items():
        np.testing.assert_array_equal(v, _leaves(variables["params"])[k])
