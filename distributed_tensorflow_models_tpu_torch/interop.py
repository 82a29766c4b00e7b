"""Parameter bridge between the JAX package's flax variable trees and the
port's modules.

A flax tree is given as nested dicts of numpy arrays with ``params`` and
``batch_stats`` collections.  The port's modules carry the flax module and
variable names, so the flax path ``stage0_block0/Conv2D_1/kernel`` is the
state-dict name ``stage0_block0.Conv2D_1.kernel``; conv kernels stay HWIO
and the head kernel stays ``[in, out]`` (the port's ``Dense`` is not
``nn.Linear``).  Values are copied unchanged, so the round trip is exact.

A model cut to its slices over the model, pipe or expert axis
(``parallel/tensor.py::shard_model``) takes a whole flax tree: each split
parameter gets this process's slice of it; and gives one back, its slices
all-gathered over their axis (a collective every process of the axis
makes).  Both exact.

The transformer's decode state converts too: the JAX ``cache`` collection
(per block ``attn/cached_key``, ``attn/cached_value`` and
``attn/cache_index``, and the model's ``pos_index``) to the port's
``KVCache`` and back (:func:`cache_from_flax`, :func:`cache_to_flax`).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

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
    from distributed_tensorflow_models_tpu_torch.parallel import tensor

    targets = _targets(model)
    dims = getattr(model, "split_dims", {})
    mesh = getattr(model, "split_mesh", None)
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
            if coll == "params":
                value = tensor.local_slice(name, value, dims, mesh)
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(
                    f"{coll}/{name}: shape {value.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def cache_from_flax(cache: Mapping[str, Any],
                    device: Optional[str | torch.device] = None):
    """The port's ``KVCache`` of a JAX decode model's ``cache`` collection
    (nested dicts of numpy arrays, values kept).  Every block's
    ``cache_index`` and the ``pos_index`` must agree."""
    from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
        KVCache,
    )

    blocks = sorted((k for k in cache if k.startswith("blocks_")),
                    key=lambda k: int(k.split("_")[1]))
    indices = {int(np.asarray(cache[b]["attn"]["cache_index"]))
               for b in blocks}
    if "pos_index" in cache:
        indices.add(int(np.asarray(cache["pos_index"])))
    if len(indices) != 1:
        raise ValueError(f"the cache's indices disagree: {sorted(indices)}")

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    return KVCache(
        [tensor(cache[b]["attn"]["cached_key"]) for b in blocks],
        [tensor(cache[b]["attn"]["cached_value"]) for b in blocks],
        torch.tensor(indices.pop(), dtype=torch.int64, device=device))


def cache_to_flax(cache) -> dict:
    """A ``KVCache`` as the JAX decode model's ``cache`` collection: numpy
    keys and values, int32 indices."""
    index = np.asarray(int(cache.index), dtype=np.int32)
    tree = {f"blocks_{i}": {"attn": {
        "cached_key": k.detach().cpu().numpy().copy(),
        "cached_value": v.detach().cpu().numpy().copy(),
        "cache_index": index.copy()}}
        for i, (k, v) in enumerate(zip(cache.keys, cache.values))}
    tree["pos_index"] = index.copy()
    return tree


def to_flax_variables(model: nn.Module) -> dict[str, dict]:
    """``model``'s parameters and buffers as a flax-shaped tree of numpy
    arrays, split parameters gathered whole; a collection the model has
    nothing in (the transformer's ``batch_stats``) is left out, as flax
    leaves it out."""
    from distributed_tensorflow_models_tpu_torch.parallel import tensor

    dims = getattr(model, "split_dims", {})
    mesh = getattr(model, "split_mesh", None)

    def whole(coll, name, t):
        if coll == "params" and name in dims and mesh is not None and (
                mesh.shape[dims[name][0]] > 1):
            t = tensor.gather_whole(t.detach(), mesh, *dims[name])
        return t.detach().cpu().numpy().copy()

    return {
        coll: _unflatten({name: whole(coll, name, t)
                          for name, t in tensors.items()})
        for coll, tensors in _targets(model).items()
        if tensors
    }
