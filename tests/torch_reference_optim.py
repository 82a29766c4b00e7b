"""The port's optimizers and EMA update as they were before they became
safe to capture in a CUDA graph: per tensor, new slot tensors each step,
the step count and the learning rate as Python numbers.  The tests hold
the in-place forms of ``ops/optim.py`` and ``ops/ema.py`` to these bit for
bit, on the CPU and on the card.  No jax here: the card's tests import it.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.ops import ema as emalib
from distributed_tensorflow_models_tpu_torch.ops import optim
from distributed_tensorflow_models_tpu_torch.ops.optim import (
    GradientTransformation,
    ScalarOrSchedule,
)


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


@torch.no_grad()
def update_ema(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float,
               num_updates: Optional[int] = None
               ) -> Mapping[str, torch.Tensor]:
    """``shadow <- shadow - (1 - decay) * (shadow - value)`` for every
    shadow, in place; returns ``ema_params``."""
    # A 0-d CPU tensor enters a CUDA op as a scalar: no copy per leaf.
    w = 1.0 - emalib.effective_decay(decay, num_updates)
    for k, s in ema_params.items():
        s.sub_(w * (s - params[k].to(s.dtype)))
    return ema_params


# Each case: (in-place transformation, its per-tensor form), under a rate
# that falls every step.
CASES = ("momentum", "nesterov", "rmsprop", "centered", "sgd", "adam",
         "clip_adam")


def _pair(name: str, steps: int):
    sched = optim.exponential_decay(0.1, 2, 0.5, staircase=False)
    n = dict(num_steps=steps)
    return {
        "momentum": lambda: (optim.tf_momentum(sched, 0.9, **n),
                             tf_momentum(sched)),
        "nesterov": lambda: (optim.tf_momentum(sched, 0.9, True, **n),
                             tf_momentum(sched, 0.9, True)),
        "rmsprop": lambda: (optim.tf_rmsprop(sched, **n), tf_rmsprop(sched)),
        "centered": lambda: (optim.tf_rmsprop(sched, centered=True, **n),
                             tf_rmsprop(sched, centered=True)),
        "sgd": lambda: (optim.sgd(sched, **n), sgd(sched)),
        "adam": lambda: (optim.adam(sched, **n), adam(sched)),
        "clip_adam": lambda: (
            optim.chain(optim.clip_by_global_norm(1.0),
                        optim.adam(3e-4, **n)),
            optim.chain(optim.clip_by_global_norm(1.0), adam(3e-4))),
    }[name]()


def check_against_per_tensor_form(name: str, device, steps: int = 5) -> None:
    """``steps`` updates of case ``name`` and of the EMA (decay 0.999, the
    count as a device tensor against a Python int) on seeded f32 values on
    ``device``: updates, parameters and shadows equal the per-tensor
    form's bit for bit at every step."""
    new, old = _pair(name, steps)
    rng = np.random.default_rng(31)
    shapes = {"a.kernel": (64, 33), "a.bias": (33,), "b.scale": (7,)}

    def values():
        return {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=device) for k, s in shapes.items()}

    p_new = values()
    p_old = {k: v.clone() for k, v in p_new.items()}
    e_new = {k: v.clone() for k, v in p_new.items()}
    e_old = {k: v.clone() for k, v in p_new.items()}
    s_new, s_old = new.init(p_new), old.init(p_old)
    count = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(steps):
        g = values()
        u_new, s_new = new.update(g, s_new)
        u_old, s_old = old.update(g, s_old)
        optim.apply_updates(p_new, u_new)
        for k, p in p_old.items():
            p.add_(u_old[k].to(p.dtype))
        emalib.update_ema(e_new, p_new, 0.999, num_updates=count)
        update_ema(e_old, p_old, 0.999, num_updates=t)
        count.add_(1)
        for k in shapes:
            for what, a, b in (("update", u_new, u_old),
                               ("param", p_new, p_old),
                               ("ema", e_new, e_old)):
                assert torch.equal(a[k], b[k]), (name, t, what, k)
