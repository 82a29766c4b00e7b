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

import numpy as np
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


def tf_rmsprop(learning_rate: ScalarOrSchedule, decay: float = 0.9,
               momentum: float = 0.9, epsilon: float = 1.0,
               centered: bool = False) -> GradientTransformation:
    """``tf.train.RMSPropOptimizer`` with TF 1.x kernel semantics (epsilon
    inside the square root, unlike optax's default)::

        ms  <- decay * ms + (1 - decay) * g^2
        mg  <- decay * mg + (1 - decay) * g            (centered only)
        mom <- momentum * mom + lr * g / sqrt(ms [- mg^2] + epsilon)
        var <- var - mom

    ``ms`` starts at ones, as in TF (with epsilon 1.0 this changes the
    first steps materially), ``mg`` at zeros.  The defaults are slim
    Inception-v3's."""

    def init(params):
        state = {"count": 0,
                 "ms": {k: torch.ones_like(v) for k, v in params.items()},
                 "mom": {k: torch.zeros_like(v) for k, v in params.items()}}
        if centered:
            state["mg"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    def update(grads, state):
        lr = _lr_at(learning_rate, state["count"])
        ms, mg, mom, updates = {}, {}, {}, {}
        for k, g in grads.items():
            ms[k] = decay * state["ms"][k] + (1.0 - decay) * torch.square(g)
            if centered:
                mg[k] = decay * state["mg"][k] + (1.0 - decay) * g
                denom = ms[k] - torch.square(mg[k]) + epsilon
            else:
                denom = ms[k] + epsilon
            mom[k] = momentum * state["mom"][k] + lr * g * torch.rsqrt(denom)
            updates[k] = -mom[k]
        new_state = {"count": state["count"] + 1, "ms": ms, "mom": mom}
        if centered:
            new_state["mg"] = mg
        return updates, new_state

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


def _f32_power(base: float, exponent: int) -> np.float32:
    """``base ** exponent`` as XLA computes it in f32 on these values: the
    f32 base raised exactly and rounded once to f32, with results below
    f32's smallest normal flushed to zero (XLA flushes denormals)."""
    p = np.float32(float(np.float32(base)) ** exponent)
    return p if abs(p) >= np.finfo(np.float32).tiny else np.float32(0.0)


def zaremba_decay(initial_lr: float, steps_per_epoch: int, hold_epochs: int,
                  decay_rate: float) -> Schedule:
    """The PTB staged schedule (Zaremba et al.): constant for the first
    ``hold_epochs`` epochs, then multiplied by ``decay_rate`` once per
    epoch, ``lr * decay_rate ** max(0, epoch + 1 - hold_epochs)`` with
    ``epoch = step // steps_per_epoch``.  Computed in f32 as the JAX
    package computes it, so the value equals JAX's bit for bit at every
    step (a double-precision power can sit one f32 ulp away)."""

    def schedule(count: int) -> float:
        exponent = max(0, count // steps_per_epoch + 1 - hold_epochs)
        return float(np.float32(initial_lr)
                     * _f32_power(decay_rate, exponent))

    return schedule


def piecewise_constant(boundaries: list[int],
                       values: list[float]) -> Schedule:
    """``tf.train.piecewise_constant``: ``values[i]`` while ``step <=
    boundaries[i]``, so the old value still applies at the boundary step
    and the drop lands at ``boundary + 1``.  The arithmetic is optax's
    ``piecewise_constant_schedule`` on the shifted boundaries, in f32: the
    value starts at ``values[0]`` and, past each boundary in order, is
    multiplied by the ratio ``values[i + 1] / values[i]``, so it equals
    JAX's bit for bit (and may differ from ``values[i]`` by the
    cumulative rounding, as there)."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    scales = sorted({b + 1: values[i + 1] / values[i]
                     for i, b in enumerate(boundaries)}.items())

    def schedule(count: int) -> float:
        v = np.float32(values[0])
        for threshold, scale in scales:
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``params += updates``, in place."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(v.float()))
                          for v in tree.values()))
