"""Optimizers and LR schedules with TF 1.x update semantics.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/optim.py``,
written as functional transformations over dicts of tensors in the shape of
optax's: ``init(params) -> state`` and
``update(grads, state) -> (updates, new_state)``.  :func:`apply_updates`
adds the updates to the parameters in place (the model's own tensors),
which saves a copy of every parameter per step.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Union

import torch

Tensors = Mapping[str, torch.Tensor]
Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], dict]
    update: Callable[[Tensors, dict], tuple[dict, dict]]


def _lr_at(learning_rate: ScalarOrSchedule, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


def tf_momentum(learning_rate: ScalarOrSchedule, momentum: float = 0.9,
                use_nesterov: bool = False) -> GradientTransformation:
    """``tf.train.MomentumOptimizer`` (optax ``trace`` then ``-lr``)::

        accum <- momentum * accum + g
        var   <- var - lr * accum                      (heavy-ball)
        var   <- var - lr * (g + momentum * accum)     (nesterov)
    """

    def init(params):
        return {"count": 0,
                "trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state):
        lr = _lr_at(learning_rate, state["count"])
        trace = {k: g + momentum * state["trace"][k] for k, g in grads.items()}
        if use_nesterov:
            direction = {k: g + momentum * trace[k] for k, g in grads.items()}
        else:
            direction = trace
        updates = {k: -lr * d for k, d in direction.items()}
        return updates, {"count": state["count"] + 1, "trace": trace}

    return GradientTransformation(init, update)


def sgd(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """``tf.train.GradientDescentOptimizer``: ``var <- var - lr * g``."""

    def init(params):
        return {"count": 0}

    def update(grads, state):
        lr = _lr_at(learning_rate, state["count"])
        return ({k: -lr * g for k, g in grads.items()},
                {"count": state["count"] + 1})

    return GradientTransformation(init, update)


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax ``scale_by_adam`` then ``-lr`` (``tf.train.AdamOptimizer``)::

        mu <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        var <- var - lr u

    with ``t`` the step count after the increment; eps is added after the
    square root and the bias correction."""

    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state):
        lr = _lr_at(learning_rate, state["count"])
        count = state["count"] + 1
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1.0 - b2) * torch.square(g) + b2 * state["nu"][k]
            updates[k] = -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule (``tf.clip_by_global_norm``): leave the gradients alone
    when their global norm is under ``max_norm``, else scale every one by
    ``max_norm / norm``.  Decided on the device, with no host sync."""

    def init(params):
        return {}

    def update(grads, state):
        norm = global_norm(grads)
        keep = norm < max_norm
        return ({k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                 for k, g in grads.items()}, state)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax ``chain``: the updates pass through each transformation in
    turn; the state is the tuple of their states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def exponential_decay(initial_lr: float, decay_steps: int, decay_rate: float,
                      staircase: bool = True) -> Schedule:
    """``tf.train.exponential_decay``: ``lr * decay_rate ** (step /
    decay_steps)``, the exponent floored when ``staircase``."""

    def schedule(count: int) -> float:
        p = count / decay_steps
        if staircase:
            p = math.floor(p)
        return initial_lr * decay_rate ** p

    return schedule


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``params += updates``, in place."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(v.float()))
                          for v in tree.values()))
