"""The synchronous train step and its builders.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/train_loop.py``
for one device.  The step runs eagerly: forward, loss, ``autograd.grad``
over the parameter dict, one optimizer update applied in place (then the
EMA shadows, when kept), and the metrics as 0-d tensors (the caller
decides when to read them back).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.ops import ema as emalib
from distributed_tensorflow_models_tpu_torch.ops import losses as losslib
from distributed_tensorflow_models_tpu_torch.ops import metrics as metriclib
from distributed_tensorflow_models_tpu_torch.ops import optim

Batch = Mapping[str, torch.Tensor]
# loss_fn(params, state, batch, rngs) -> (loss, aux); aux may carry
# 'metrics' (dict of scalars), 'batch_stats' (updated BN state) and
# 'carry' (updated recurrent state).
LossFn = Callable[
    [Mapping[str, torch.Tensor], TrainState, Batch,
     Mapping[str, torch.Generator]],
    tuple[torch.Tensor, dict],
]


def classification_loss_fn(model: torch.nn.Module, *,
                           label_smoothing: float = 0.0,
                           weight_decay: float = 0.0,
                           aux_loss_weight: float = 0.0) -> LossFn:
    """Forward + loss for image classification: softmax cross entropy with
    optional label smoothing, slim-style L2 on kernels, and Inception-v3's
    weighted auxiliary-logits loss.  The model returns ``logits`` or, in
    training with an auxiliary head, ``(logits, aux_logits)``.  Its BN
    layers update their running statistics in place."""

    def loss_fn(params, state, batch, rngs):
        outputs = model(batch["image"], train=True, rngs=rngs)
        if isinstance(outputs, (tuple, list)):
            logits, aux_logits = outputs
        else:
            logits, aux_logits = outputs, None
        labels = batch["label"]
        xent = losslib.mean_softmax_cross_entropy(logits, labels,
                                                  label_smoothing)
        loss = xent
        if aux_logits is not None and aux_loss_weight:
            loss = loss + aux_loss_weight * losslib.mean_softmax_cross_entropy(
                aux_logits, labels, label_smoothing)
        if weight_decay:
            loss = loss + losslib.l2_weight_decay(params, weight_decay)
        metrics = {
            "loss": loss.detach(),
            "xent": xent.detach(),
            "accuracy": metriclib.accuracy(logits.detach(), labels),
        }
        return loss, {"metrics": metrics, "batch_stats": state.batch_stats}

    return loss_fn


def lm_loss_fn(model: torch.nn.Module, fused_unembed: bool = False) -> LossFn:
    """Forward + loss for language models: mean per-token NLL of
    ``targets`` (``inputs`` shifted by one) given ``inputs``, both
    ``[B, T]`` int.

    ``fused_unembed=True`` stops the model at the post-``ln_f`` hidden
    states (``return_hidden=True``) and runs the head projection and the
    cross entropy chunked in bf16 (:func:`...ops.losses.chunked_unembed_xent`)
    on the model's own ``head`` parameters; otherwise the model's f32 head
    gives full logits.  The carry is read from ``state.carry`` and the
    updated value returned through aux.  Metrics: ``loss`` and ``nll``
    (perplexity = exp(nll))."""

    def loss_fn(params, state, batch, rngs):
        if fused_unembed:
            hidden, new_carry = model(batch["inputs"], carry=state.carry,
                                      train=True, return_hidden=True,
                                      rngs=rngs)
            nll = torch.mean(losslib.chunked_unembed_xent(
                hidden, params["head.kernel"], params.get("head.bias"),
                batch["targets"]))
        else:
            logits, new_carry = model(batch["inputs"], carry=state.carry,
                                      train=True, rngs=rngs)
            nll = torch.mean(losslib.softmax_cross_entropy(
                logits, batch["targets"]))
        metrics = {"loss": nll.detach(), "nll": nll.detach()}
        return nll, {"metrics": metrics, "carry": new_carry}

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


def _detached(tree):
    """``tree`` (tensors in nested tuples, lists and dicts) with every
    tensor cut from its autograd graph."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, Mapping):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def apply_gradients(state: TrainState, grads: Mapping[str, torch.Tensor],
                    aux: dict) -> TrainState:
    """Optimizer update, EMA update and state advance from one gradient
    computation.  The new carry is stored detached: the JAX package never
    differentiates through ``state.carry``, and a carry that kept its
    graph would tie each step's backward to the last one's (freed) graph
    and hold its memory."""
    updates, new_opt_state = state.tx.update(grads, state.opt_state)
    optim.apply_updates(state.params, updates)
    if state.ema_params is not None:
        # The shadows follow the updated parameters, the decay damped by
        # the step count before this step (TF's num_updates).
        emalib.update_ema(state.ema_params, state.params, state.ema_decay,
                          num_updates=state.step)
    return state.replace(
        step=state.step + 1,
        batch_stats=aux.get("batch_stats", state.batch_stats),
        opt_state=new_opt_state,
        carry=_detached(aux.get("carry", state.carry)),
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


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _float_leaves(v)


def state_is_finite(state: TrainState) -> bool:
    """True when every float tensor of the trajectory-carrying state —
    parameters, BN statistics, carry, optimizer slots, EMA shadows — is
    finite; one reduction per tensor and one read back in all."""
    leaves = [leaf for tree in (state.params, state.batch_stats, state.carry,
                                state.opt_state, state.ema_params)
              for leaf in _float_leaves(tree)]
    if not leaves:
        return True
    return bool(torch.stack([torch.isfinite(leaf).all().to(leaves[0].device)
                             for leaf in leaves]).all())


def make_eval_step(model: torch.nn.Module, use_ema: bool = True
                   ) -> Callable[[TrainState, Batch], dict]:
    """Eval step returning top-1/top-5 counts summed over the batch; rows
    with a negative label are padding and are not counted.  With
    ``use_ema`` the model runs on ``state.eval_params`` (the EMA shadows
    when kept), else on ``state.params``."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Batch):
        params = state.eval_params if use_ema else state.params
        outputs = torch.func.functional_call(
            model, {**params, **state.batch_stats}, (batch["image"],),
            {"train": False})
        logits = (outputs[0] if isinstance(outputs, (tuple, list))
                  else outputs)
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
