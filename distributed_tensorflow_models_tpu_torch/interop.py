"""Parameter bridge between the JAX package's flax variable trees and the
port's modules.

A flax tree is given as nested dicts of numpy arrays with ``params`` and
``batch_stats`` collections.  The port's modules carry the flax module and
variable names, so the flax path ``stage0_block0/Conv2D_1/kernel`` is the
state-dict name ``stage0_block0.Conv2D_1.kernel``; conv kernels stay HWIO
and the head kernel stays ``[in, out]`` (the port's ``Dense`` is not
``nn.Linear``).  Values are copied unchanged, so the round trip is exact.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _targets(model: nn.Module) -> dict[str, dict[str, torch.Tensor]]:
    return {"params": dict(model.named_parameters()),
            "batch_stats": dict(model.named_buffers())}


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy a flax variable tree into ``model``'s parameters and buffers.

    Every tensor of the model must be given, with its exact shape; a
    missing, extra or misshapen entry raises."""
    targets = _targets(model)
    for coll in COLLECTIONS:
        flat = _flatten(variables.get(coll, {}))
        want = targets[coll]
        if set(flat) != set(want):
            raise KeyError(
                f"{coll}: missing {sorted(set(want) - set(flat))}, "
                f"unexpected {sorted(set(flat) - set(want))}"
            )
        for name, value in flat.items():
            t = want[name]
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(
                    f"{coll}/{name}: shape {value.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def to_flax_variables(model: nn.Module) -> dict[str, dict]:
    """``model``'s parameters and buffers as a flax-shaped tree of numpy
    arrays; a collection the model has nothing in (the transformer's
    ``batch_stats``) is left out, as flax leaves it out."""
    return {
        coll: _unflatten({name: t.detach().cpu().numpy().copy()
                          for name, t in tensors.items()})
        for coll, tensors in _targets(model).items()
        if tensors
    }
