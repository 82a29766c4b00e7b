"""Optimizers and LR schedules with TF 1.x update semantics.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/optim.py``,
written as functional transformations over dicts of tensors in the shape of
optax's: ``init(params) -> state`` and
``update(grads, state, norm=None) -> (updates, state)``.  ``norm``, where
the caller has it, is the global norm of ``grads`` as whole arrays (the
train step's ``grad_norm``, summed over the processes that hold split
gradients): :func:`clip_by_global_norm` reads it in place of taking its
own of this process's tensors.

The updates are safe to capture in a CUDA graph: the step count is a 0-d
int64 tensor on the parameters' device, a schedule is read from a device
table by that count, and every slot is updated in place (``torch._foreach_*``
for products and sums, per tensor for roots and quotients), so a replayed
step reads and writes the same buffers the eager step did.  The arithmetic
is the per-tensor form's, op for op (no fused multiply-add it did not do),
so the values equal it bit for bit.  ``update`` returns the state it was
given, advanced in place.  :func:`apply_updates` adds the updates to the
parameters in place (the model's own tensors).

A table covers the steps of one run, so a transformation that reads one (a
schedule, or Adam's bias corrections) must be told the run's length,
``num_steps``, and refuses to be made without it; it carries that length
as :attr:`GradientTransformation.num_steps`, which the train step checks
on the host before each step (``core/train_loop.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

Tensors = Mapping[str, torch.Tensor]
Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], dict]
    update: Callable[..., tuple[dict, dict]]
    # The steps its device tables cover; None when it reads no table.
    num_steps: Optional[int] = None


class _CountTable:
    """A host function of the step count, tabulated: its values at counts
    0 .. ``num_steps`` rounded to f32 (a step reads its count before the
    increment, Adam's corrections the count after it), put on a device
    once by :meth:`init` and read there by a 0-d count tensor
    (``index_select``, no host sync).  A replayed step so reads its own
    count's value, and that value is the one an op on f32 tensors rounds
    the host's Python float to.  ``what`` names the function in the error
    raised when ``num_steps`` is not given."""

    def __init__(self, fn: Callable[[int], float], num_steps: Optional[int],
                 what: str):
        if num_steps is None:
            raise ValueError(f"{what} is read from a device table of the "
                             f"run's step counts: pass num_steps")
        self._fn = fn
        self._len = int(num_steps) + 1
        self._values: Optional[np.ndarray] = None
        self._tables: dict[torch.device, torch.Tensor] = {}

    def init(self, device: torch.device) -> None:
        if device in self._tables:
            return
        if self._values is None:
            self._values = np.array([self._fn(c) for c in range(self._len)],
                                    np.float32)
        self._tables[device] = torch.from_numpy(self._values).to(device)

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        table = self._tables[count.device]
        return table.index_select(0, count.reshape(1)).reshape(())


Rate = Union[float, _CountTable]


class _Divisor:
    """Division by a host function of the count, rounded as PyTorch
    divides a tensor by a Python float: on the CPU by the float rounded to
    f32, on CUDA by a product with its reciprocal taken in double and
    rounded to f32.  Both are tabulated (:class:`_CountTable`)."""

    def __init__(self, fn: Callable[[int], float], num_steps: Optional[int],
                 what: str):
        self._value = _CountTable(fn, num_steps, what)
        self._inverse = _CountTable(
            lambda c: 1.0 / fn(c) if fn(c) else math.inf, num_steps, what)

    def init(self, device: torch.device) -> None:
        self._value.init(device)
        self._inverse.init(device)

    def __call__(self, tensors: list[torch.Tensor],
                 count: torch.Tensor) -> list[torch.Tensor]:
        if count.device.type == "cuda":
            return torch._foreach_mul(tensors, self._inverse(count))
        value = self._value(count)
        return [t / value for t in tensors]


def _rate(learning_rate: ScalarOrSchedule, num_steps: Optional[int]) -> Rate:
    """A constant stays a Python float (a constant of a captured step too);
    a schedule becomes a :class:`_CountTable`."""
    if callable(learning_rate):
        return _CountTable(learning_rate, num_steps,
                           "a learning-rate schedule")
    return learning_rate


def _steps(rate: Rate, num_steps: Optional[int]) -> Optional[int]:
    """The transformation's :attr:`GradientTransformation.num_steps`."""
    return num_steps if isinstance(rate, _CountTable) else None


def _init_count(params: Tensors, *tables) -> torch.Tensor:
    """The step count, 0, on the parameters' device, with every table
    (a constant rate has none) put there."""
    device = next(iter(params.values())).device if params else (
        torch.device("cpu"))
    for table in tables:
        if hasattr(table, "init"):
            table.init(device)
    return torch.zeros((), dtype=torch.int64, device=device)


def _at(rate: Rate, count: torch.Tensor):
    return rate(count) if isinstance(rate, _CountTable) else rate


def tf_momentum(learning_rate: ScalarOrSchedule, momentum: float = 0.9,
                use_nesterov: bool = False,
                num_steps: Optional[int] = None) -> GradientTransformation:
    """``tf.train.MomentumOptimizer`` (optax ``trace`` then ``-lr``)::

        accum <- momentum * accum + g
        var   <- var - lr * accum                      (heavy-ball)
        var   <- var - lr * (g + momentum * accum)     (nesterov)

    ``num_steps``: the run's length, which a schedule is tabulated for
    (every transformation here takes it; required with a schedule)."""
    rate = _rate(learning_rate, num_steps)

    def init(params):
        return {"count": _init_count(params, rate),
                "trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(grads, state, norm=None):
        lr = _at(rate, state["count"])
        names = list(grads)
        g = [grads[k] for k in names]
        trace = [state["trace"][k] for k in names]
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, g)
        direction = trace
        if use_nesterov:
            direction = torch._foreach_mul(trace, momentum)
            torch._foreach_add_(direction, g)
        updates = torch._foreach_mul(direction, -lr)
        state["count"].add_(1)
        return dict(zip(names, updates)), state

    return GradientTransformation(init, update, _steps(rate, num_steps))


def tf_rmsprop(learning_rate: ScalarOrSchedule, decay: float = 0.9,
               momentum: float = 0.9, epsilon: float = 1.0,
               centered: bool = False,
               num_steps: Optional[int] = None) -> GradientTransformation:
    """``tf.train.RMSPropOptimizer`` with TF 1.x kernel semantics (epsilon
    inside the square root, unlike optax's default)::

        ms  <- decay * ms + (1 - decay) * g^2
        mg  <- decay * mg + (1 - decay) * g            (centered only)
        mom <- momentum * mom + lr * g / sqrt(ms [- mg^2] + epsilon)
        var <- var - mom

    ``ms`` starts at ones, as in TF (with epsilon 1.0 this changes the
    first steps materially), ``mg`` at zeros.  The defaults are slim
    Inception-v3's."""
    rate = _rate(learning_rate, num_steps)

    def init(params):
        state = {"count": _init_count(params, rate),
                 "ms": {k: torch.ones_like(v) for k, v in params.items()},
                 "mom": {k: torch.zeros_like(v) for k, v in params.items()}}
        if centered:
            state["mg"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    @torch.no_grad()
    def update(grads, state, norm=None):
        lr = _at(rate, state["count"])
        names = list(grads)
        g = [grads[k] for k in names]
        ms = [state["ms"][k] for k in names]
        mom = [state["mom"][k] for k in names]
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - decay)
        torch._foreach_mul_(ms, decay)
        torch._foreach_add_(ms, sq)
        if centered:
            mg = [state["mg"][k] for k in names]
            part = torch._foreach_mul(g, 1.0 - decay)
            torch._foreach_mul_(mg, decay)
            torch._foreach_add_(mg, part)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, epsilon)
        else:
            denom = torch._foreach_add(ms, epsilon)
        step = torch._foreach_mul(g, lr)
        torch._foreach_mul_(step, [torch.rsqrt(d) for d in denom])
        torch._foreach_mul_(mom, momentum)
        torch._foreach_add_(mom, step)
        state["count"].add_(1)
        return dict(zip(names, torch._foreach_neg(mom))), state

    return GradientTransformation(init, update, _steps(rate, num_steps))


def sgd(learning_rate: ScalarOrSchedule,
        num_steps: Optional[int] = None) -> GradientTransformation:
    """``tf.train.GradientDescentOptimizer``: ``var <- var - lr * g``."""
    rate = _rate(learning_rate, num_steps)

    def init(params):
        return {"count": _init_count(params, rate)}

    @torch.no_grad()
    def update(grads, state, norm=None):
        lr = _at(rate, state["count"])
        names = list(grads)
        updates = torch._foreach_mul([grads[k] for k in names], -lr)
        state["count"].add_(1)
        return dict(zip(names, updates)), state

    return GradientTransformation(init, update, _steps(rate, num_steps))


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8,
         num_steps: Optional[int] = None) -> GradientTransformation:
    """optax ``scale_by_adam`` then ``-lr`` (``tf.train.AdamOptimizer``)::

        mu <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        var <- var - lr u

    with ``t`` the step count after the increment; eps is added after the
    square root and the bias correction.  The corrections ``1 - b^t`` are
    taken on the host in double and divide as the Python floats they were
    (:class:`_Divisor`), so ``num_steps`` is required even with a constant
    rate."""
    rate = _rate(learning_rate, num_steps)
    c1 = _Divisor(lambda t: 1.0 - b1 ** t, num_steps,
                  "Adam's bias correction")
    c2 = _Divisor(lambda t: 1.0 - b2 ** t, num_steps,
                  "Adam's bias correction")

    def init(params):
        return {"count": _init_count(params, rate, c1, c2),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(grads, state, norm=None):
        count = state["count"]
        lr = _at(rate, count)
        count.add_(1)
        names = list(grads)
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        part = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, part)
        part = torch._foreach_mul(g, g)
        torch._foreach_mul_(part, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, part)
        num = c1(mu, count)
        den = [torch.sqrt(t) for t in c2(nu, count)]
        torch._foreach_add_(den, eps)
        updates = [n / d for n, d in zip(num, den)]
        return dict(zip(names, torch._foreach_mul(updates, -lr))), state

    return GradientTransformation(init, update, num_steps)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule (``tf.clip_by_global_norm``): leave the gradients alone
    when their global norm (``update``'s ``norm`` where given, the whole
    arrays' where the gradients are split over processes; else
    :func:`global_norm`) is under ``max_norm``, else scale every one by
    ``max_norm / norm``.  Decided on the device, with no host sync."""

    def init(params):
        return {}

    def update(grads, state, norm=None):
        if norm is None:
            norm = global_norm(grads)
        keep = norm < max_norm
        return ({k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                 for k, g in grads.items()}, state)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax ``chain``: the updates pass through each transformation in
    turn; the state is the tuple of their states, the step limit the
    least of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, norm=None):
        new_state = []
        for t, s in zip(transforms, state):
            # ``norm`` is the norm of the gradients as they came in: the
            # first transformation's alone.
            grads, s = (t.update(grads, s) if norm is None
                        else t.update(grads, s, norm))
            norm = None
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update, min(
        (t.num_steps for t in transforms if t.num_steps is not None),
        default=None))


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
    names = list(params)
    torch._foreach_add_([params[k] for k in names],
                        [updates[k].to(params[k].dtype) for k in names])


def global_norm(tree: Tensors) -> torch.Tensor:
    """The L2 norm of all of ``tree``'s tensors together, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(v.float()))
                          for v in tree.values()))
