"""Shared cases of the emulator tests (``tests/test_torch_async_ps.py``,
``tests/test_torch_backup.py``): the same model in both packages from the
port's seeded initialization, carried to the JAX package by ``interop``,
and numpy batches.

- ``lenet``: LeNet with dropout 0 (the two frameworks draw different
  dropout bits), 28x28x1;
- ``resnet_bn``: the CIFAR ResNet-32 cut to one block a stage (the zoo
  tests' cut), 32x32x3, for the BatchNorm statistics.

Both run the patches lowering on both sides and SGD.  Tolerances are the
zoo tests' (``tests/test_torch_zoo.py``): ``MODEL_RTOL`` for a model's
values, ``STATE_TOL`` for parameters, BN statistics and EMA shadows after
steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_tensorflow_models_tpu.core import train_loop as jtrain
from distributed_tensorflow_models_tpu.core.train_state import TrainState as JTrainState
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.ops import optim as joptim
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.ops import optim

MODEL_RTOL = 2e-3
STATE_TOL = dict(atol=5e-4, rtol=5e-4)

# name: (model, kwargs on both sides, image shape)
CASES = {
    "lenet": ("lenet", dict(dropout_rate=0.0), (28, 28, 1)),
    "resnet_bn": ("resnet32_cifar", dict(blocks_per_stage=1), (32, 32, 3)),
}


def batch(case: str, n: int = 8, seed: int = 0) -> dict:
    """A numpy batch of ``n`` images in [0, 1) and labels, from ``seed``."""
    rng = np.random.RandomState(seed)
    shape = CASES[case][2]
    return {"image": rng.rand(n, *shape).astype(np.float32),
            "label": rng.randint(0, 10, (n,)).astype(np.int32)}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


def pair(case: str, lr: float = 0.1, weight_decay: float = 0.0,
         ema_decay=None, steps: int = 64):
    """``(port state, port loss, JAX state, JAX loss)`` of ``case``: SGD at
    ``lr``, the classification loss with ``weight_decay``, the port's
    seeded weights (and BN statistics) on both sides."""
    name, kw, shape = CASES[case]
    tm = get_model(name, conv_impl="patches",
                   generator=torch.Generator().manual_seed(1), **kw)
    tree = interop.to_flax_variables(tm)
    tstate = TrainState.create(tm, optim.sgd(lr, num_steps=steps),
                               ema_decay=ema_decay)
    tloss = train_loop.classification_loss_fn(tm, weight_decay=weight_decay)
    jm = jget_model(name, conv_impl="patches", **kw)
    jtx = joptim.sgd(lr)
    jstate = JTrainState.create(jm, jtx, jax.random.key(0),
                                jnp.zeros((1, *shape), jnp.float32),
                                ema_decay=ema_decay)
    params = jax.tree.map(jnp.asarray, tree["params"])
    jstate = jstate.replace(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, tree.get("batch_stats", {})),
        opt_state=jtx.init(params),
        ema_params=(None if ema_decay is None else
                    jax.tree.map(lambda x: x.astype(jnp.float32), params)))
    jloss = jtrain.classification_loss_fn(jm.apply,
                                          weight_decay=weight_decay)
    return tstate, tloss, jstate, jloss


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


def assert_state_close(tstate, jstate, colls=("params", "batch_stats")):
    """The port's parameters and BN statistics (and, with ``"ema"`` in
    ``colls``, EMA shadows) against the JAX state's, to ``STATE_TOL``."""
    got = interop.to_flax_variables(tstate.model)
    for coll in colls:
        if coll == "ema":
            g = {k.replace(".", "/"): v.numpy()
                 for k, v in tstate.ema_params.items()}
            w = flat(jax.tree.map(np.asarray, dict(jstate.ema_params)))
        else:
            g = flat(got.get(coll, {}))
            w = flat(jax.tree.map(np.asarray, dict(getattr(jstate, coll))))
        assert sorted(g) == sorted(w), coll
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{coll}/{k}",
                                       **STATE_TOL)


def state_tensors(state) -> list:
    return [t.detach().clone() for t in train_loop._state_leaves(state)]
