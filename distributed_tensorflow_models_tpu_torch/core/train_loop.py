"""The synchronous train step and its builders.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/train_loop.py``
for one device.  The step runs eagerly: forward, loss, ``autograd.grad``
over the parameter dict, one optimizer update applied in place, and the
metrics as 0-d tensors (the caller decides when to read them back).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.ops import losses as losslib
from distributed_tensorflow_models_tpu_torch.ops import metrics as metriclib
from distributed_tensorflow_models_tpu_torch.ops import optim

Batch = Mapping[str, torch.Tensor]
# loss_fn(params, state, batch, rngs) -> (loss, aux); aux may carry
# 'metrics' (dict of scalars) and 'batch_stats' (updated BN state).
LossFn = Callable[
    [Mapping[str, torch.Tensor], TrainState, Batch,
     Mapping[str, torch.Generator]],
    tuple[torch.Tensor, dict],
]


def classification_loss_fn(model: torch.nn.Module, *,
                           weight_decay: float = 0.0) -> LossFn:
    """Forward + loss for image classification: softmax cross entropy and
    slim-style L2 on kernels.  The model's BN layers update its running
    statistics in place."""

    def loss_fn(params, state, batch, rngs):
        logits = model(batch["image"], train=True)
        labels = batch["label"]
        xent = losslib.mean_softmax_cross_entropy(logits, labels)
        loss = xent
        if weight_decay:
            loss = loss + losslib.l2_weight_decay(params, weight_decay)
        metrics = {
            "loss": loss.detach(),
            "xent": xent.detach(),
            "accuracy": metriclib.accuracy(logits.detach(), labels),
        }
        return loss, {"metrics": metrics, "batch_stats": state.batch_stats}

    return loss_fn


def per_step_rngs(seed: int, salt: int, rng_names: Sequence[str],
                  device: torch.device | str = "cpu"
                  ) -> dict[str, torch.Generator]:
    """The per-step named generators: one seed derived from
    ``(seed, salt, index of the name)`` each, so a step's randomness depends
    only on the base seed and the step."""
    out = {}
    for i, name in enumerate(rng_names):
        s = np.random.SeedSequence([seed, salt, i]).generate_state(1)[0]
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        out[name] = g
    return out


def apply_gradients(state: TrainState, grads: Mapping[str, torch.Tensor],
                    aux: dict) -> TrainState:
    """Optimizer update + state advance from one gradient computation."""
    updates, new_opt_state = state.tx.update(grads, state.opt_state)
    optim.apply_updates(state.params, updates)
    return state.replace(
        step=state.step + 1,
        batch_stats=aux.get("batch_stats", state.batch_stats),
        opt_state=new_opt_state,
    )


def make_train_step_fn(loss_fn: LossFn,
                       rng_names: Sequence[str] = ("dropout",)
                       ) -> Callable[[TrainState, Batch, int],
                                     tuple[TrainState, dict]]:
    """The ``(state, batch, seed) -> (state, metrics)`` step."""

    def step_fn(state: TrainState, batch: Batch, seed: int):
        device = next(iter(state.params.values())).device
        rngs = per_step_rngs(seed, state.step, rng_names, device)
        loss, aux = loss_fn(state.params, state, batch, rngs)
        names = list(state.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state.params[k] for k in names])))
        metrics = dict(aux.get("metrics", {}))
        metrics["grad_norm"] = optim.global_norm(grads)
        return apply_gradients(state, grads, aux), metrics

    return step_fn


def make_train_step(loss_fn: LossFn, rng_names: Sequence[str] = ("dropout",)):
    """The step a driver calls.  PyTorch runs eagerly, so unlike the JAX
    package there is no compiled single-step scan around it."""
    return make_train_step_fn(loss_fn, rng_names)


def make_eval_step(model: torch.nn.Module) -> Callable[[TrainState, Batch], dict]:
    """Eval step returning top-1/top-5 counts summed over the batch; rows
    with a negative label are padding and are not counted."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Batch):
        logits = model(batch["image"], train=False)
        labels = batch["label"]
        valid = (labels >= 0).to(torch.float32)
        return {
            "top1_count": torch.sum(
                metriclib.top_k_correct(logits, labels, 1) * valid),
            "top5_count": torch.sum(
                metriclib.top_k_correct(logits, labels, 5) * valid),
            "count": torch.sum(valid),
            "xent_sum": torch.sum(
                losslib.softmax_cross_entropy(logits, labels.clamp(min=0))
                * valid),
        }

    return eval_fn
