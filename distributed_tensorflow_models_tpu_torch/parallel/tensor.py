"""Tensor parallelism: the weight-split rule sets and the split layers.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/parallel/tensor.py``.
A rule maps a regex over a parameter's flax path (``core/sharding.py::
flax_path``) to a spec, a tuple of axis names per dimension; the first
match wins (``sharding.tree_param_shardings``).  The rule sets are the JAX
package's, regex for regex and spec for spec, the specs written as tuples
of axis names instead of ``PartitionSpec``.

The JAX package lets XLA's partitioner insert the collectives.  Here
:func:`shard_model` cuts each matched parameter to this process's slice
over the ``model`` axis, in place, and tells the module that owns it how
to compute on the slice (a :class:`Split` in its ``tp`` attribute):

- a kernel split ``(..., None, model)`` is **column-parallel**: the layer
  computes this process's slice of the output features (or the output
  channels of an HWIO conv) with its slice of the bias.  Its input is
  whole on every process; Megatron's *f* (``sharding.copy_in``) sums the
  input's cotangent over ``model`` in the backward.  Without a row
  partner it all-gathers its output over ``model`` (``sharding.gather``),
  so the next layer sees the whole activation;
- a kernel split ``(model, None)`` is **row-parallel**: its input is this
  process's feature slice (the output of its column partner), its product
  is summed over ``model`` (Megatron's *g*, ``sharding.reduce_sum``) and
  the unsplit bias is added once, after the sum;
- an embedding split ``(None, model)`` all-gathers its columns.

A module that pairs layers names them in ``TP_PAIRS``: ``((columns...),
row)``.  When every column is column-split and the row row-split, the
columns keep their output split (the activation between them stays on this
process's heads or hidden units) and the module applies *f* once to their
shared input (:func:`enter`).  A row-parallel layer without its pair
raises.

The pipe and expert axes split the parameters their layers declare
(``param_spec()``: :func:`...parallel.pipeline.pipeline_spec` for the
pipelined block stack, :func:`...parallel.moe.moe_param_spec` for the MoE
FFN): :func:`shard_model` cuts those too, dim 0 over the axis, and gives
the layer the mesh it was cut on (``pipe_mesh``, ``expert_mesh``).  One
record serves the three axes: ``model.split_dims`` maps each split
parameter to ``(axis, dim)``, and the cut (:func:`local_slice`), the
gather (:func:`gather_whole`), ``interop``'s flax trees and the gradient
norm (:func:`split_axes`) read it.

:func:`whole_state` and :func:`scatter_state_` gather a train state's
split tensors to whole ones (a checkpoint holds whole tensors, as the JAX
package's global arrays) and put a whole state's slices back in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.core.mesh import AxisNames, Mesh
from distributed_tensorflow_models_tpu_torch.core.sharding import ShardingRule

M = AxisNames.MODEL


def transformer_tp_rules() -> list[ShardingRule]:
    """Megatron-style rules for :class:`...models.transformer_lm.TransformerLM`.

    Column-parallel (output-dim split, no forward communication): Q/K/V
    projections and the MLP up-projection.  Row-parallel (input-dim split,
    one sum after): attention output projection and MLP down-projection.
    The embedding and LM head are split over the model/vocab dim."""
    return [
        (r"attn/(query|key|value)/kernel$", (None, M)),
        (r"attn/(query|key|value)/bias$", (M,)),
        (r"attn/out/kernel$", (M, None)),
        (r"mlp/up/kernel$", (None, M)),
        (r"mlp/up/bias$", (M,)),
        (r"mlp/down/kernel$", (M, None)),
        (r"embedding/embedding$", (None, M)),
        (r"head/kernel$", (None, M)),
        (r"head/bias$", (M,)),
    ]


def lstm_tp_rules() -> list[ShardingRule]:
    """Rules for the PTB LSTM (fused-gate layout, models/ptb_lstm.py): the
    hoisted input projection ``lstm_<i>_ih`` and the recurrent
    ``lstm_<i>/hh`` are ``[in, 4h]`` fused-gate matmuls, column-split over
    ``model`` (each gathers its gates)."""
    return [
        (r"lstm_\d+_ih/kernel$", (None, M)),
        (r"lstm_\d+_ih/bias$", (M,)),
        (r"lstm_\d+/hh/kernel$", (None, M)),
        (r"embedding/embedding$", (None, M)),
        (r"head/kernel$", (None, M)),
        (r"head/bias$", (M,)),
    ]


def cnn_tp_rules() -> list[ShardingRule]:
    """Rules for the CNN zoo: the output channels of convolutions and the
    dense head split over ``model``.  Conv kernels are HWIO, so the split
    is on the last (output-channel) dim."""
    return [
        (r"[Cc]onv[^/]*/kernel$", (None, None, None, M)),
        (r"[Cc]onv[^/]*/bias$", (M,)),
        (r"head/kernel$", (None, M)),
        (r"head/bias$", (M,)),
    ]


def head_tp_rules() -> list[ShardingRule]:
    """Classifier-head-only split: the minimum-communication layout (the
    JAX package's ``core.sharding.head_tensor_parallel_rules``)."""
    return [
        (r"head/kernel$", (None, M)),
        (r"head/bias$", (M,)),
    ]


# Named rule sets, selectable from ExperimentConfig.param_rules.
RULE_SETS = {
    "transformer_tp": transformer_tp_rules,
    "lstm_tp": lstm_tp_rules,
    "cnn_tp": cnn_tp_rules,
    "head_tp": head_tp_rules,
}


def get_rules(name: str) -> list[ShardingRule]:
    """Resolve a named rule set; '' means no rules (replicated params)."""
    if not name:
        return []
    if name not in RULE_SETS:
        raise KeyError(f"unknown rule set {name!r}; have {sorted(RULE_SETS)}")
    return RULE_SETS[name]()


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The JAX package pins an activation's sharding here for XLA's
    partitioner; the port lays activations out explicitly, so there is
    nothing to pin.  Checks the axis names and returns ``x``."""
    for a in axes:
        if a is not None and a not in AxisNames.ALL:
            raise ValueError(f"unknown mesh axis {a!r}; have "
                             f"{AxisNames.ALL}")
    return x


@dataclasses.dataclass
class Split:
    """How a layer computes on its slice: ``kind`` is ``"column"``,
    ``"row"`` or ``"embed"``; a column layer all-gathers its output unless
    it is ``paired``, and then its module applies *f* to the input."""

    mesh: Mesh
    kind: str
    paired: bool = False

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The layer's input: under *f* for an unpaired column layer."""
        if self.kind == "column" and not self.paired:
            return shardlib.copy_in(x, self.mesh)
        return x

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """A row layer's product summed over ``model`` (before its bias)."""
        return shardlib.reduce_sum(y, self.mesh) if self.kind == "row" else y

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """The layer's output: gathered over the last dim where the layer
        is a column layer without a pair, or an embedding."""
        if self.kind == "embed" or (self.kind == "column"
                                    and not self.paired):
            return shardlib.gather(y, self.mesh, -1)
        return y


def enter(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """*f* on the input that a module's paired column layers share (the
    module's ``tp_mesh``, set by :func:`shard_model`); ``x`` itself where
    the module is not split."""
    mesh = getattr(module, "tp_mesh", None)
    return x if mesh is None else shardlib.copy_in(x, mesh)


def whole(t: Optional[torch.Tensor], split: Optional[Split],
          dim: int = -1) -> Optional[torch.Tensor]:
    """A split parameter gathered whole over ``model`` along ``dim``,
    differentiably (the backward slices); ``t`` itself when not split."""
    if t is None or split is None:
        return t
    return shardlib.gather(t, split.mesh, dim, site="weight_gather")


# The layer types a spec can split, and what each split makes them:
# (type name, parameter, split dim) -> kind.
_KINDS = {
    ("Dense", "kernel", 1): "column",
    ("Dense", "kernel", 0): "row",
    ("Dense", "bias", 0): None,  # follows its kernel
    ("Conv2D", "kernel", 3): "column",
    ("Conv2D", "bias", 0): None,
    ("TokenEmbed", "embedding", 1): "embed",
}


def _split_dim(name: str, spec: Any, ndim: int) -> Optional[int]:
    if spec is shardlib.REPLICATED:
        return None
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more dims than {name} ({ndim})")
    dims = [i for i, a in enumerate(spec) if a == M]
    others = [a for a in spec if a not in (None, M)]
    if others:
        raise NotImplementedError(
            f"{name}: spec {spec} splits over {others}; the port splits "
            f"parameters over the model axis only")
    if len(dims) > 1:
        raise ValueError(f"{name}: spec {spec} names the model axis twice")
    return dims[0] if dims else None


def _cut(owner: nn.Module, leaf: str, mesh: Mesh, axis: str, dim: int
         ) -> None:
    """Replace ``owner.<leaf>`` by this process's slice over ``axis``."""
    param = getattr(owner, leaf)
    piece = param.detach().chunk(mesh.shape[axis], dim=dim)[
        mesh.coord(axis)].clone()
    setattr(owner, leaf, nn.Parameter(piece,
                                      requires_grad=param.requires_grad))


def _layer_axis(name: str, spec: tuple) -> Optional[tuple[str, int]]:
    """The ``(axis, dim)`` a layer's own spec splits a parameter over."""
    dims = [(a, i) for i, a in enumerate(spec) if a is not None]
    if len(dims) > 1:
        raise ValueError(f"{name}: spec {spec} splits more than one dim")
    return dims[0] if dims else None


def shard_model(model: nn.Module, rules, mesh: Mesh
                ) -> dict[str, tuple[str, int]]:
    """Cut every parameter of ``model`` that ``rules`` split over
    ``model``, and every parameter that its layer's ``param_spec()``
    splits over ``pipe`` or ``expert`` (``param_spec(mesh)``), to this process's slice, in place;
    give the model axis's layers their :class:`Split` (module docstring)
    and a pipe or expert layer the mesh it was cut on (``pipe_mesh``,
    ``expert_mesh``).  Returns ``{name: (axis, dim)}`` of the split
    parameters (also kept as ``model.split_dims``, the mesh as
    ``model.split_mesh``).  At an axis of one nothing changes: a slice of
    the whole is the whole, and no layer is told to communicate."""
    specs = shardlib.tree_param_shardings(mesh, dict(model.named_parameters()),
                                          rules)
    n, m = mesh.model_size, mesh.coord(M)
    dims: dict[str, tuple[str, int]] = {}
    modules = dict(model.named_modules())
    for owner_name, owner in modules.items():
        spec_of = getattr(owner, "param_spec", None)
        if spec_of is None:
            continue
        for leaf, spec in spec_of(mesh).items():
            name = f"{owner_name}.{leaf}" if owner_name else leaf
            split = _layer_axis(name, tuple(spec))
            if split is None:
                continue
            axis, dim = split
            size = mesh.shape[axis]
            param = getattr(owner, leaf)
            if param.shape[dim] % size:
                raise ValueError(f"{name}: dim {dim} of "
                                 f"{tuple(param.shape)} does not split over "
                                 f"a {axis} axis of {size}")
            dims[name] = (axis, dim)
            if size > 1:
                _cut(owner, leaf, mesh, axis, dim)
                setattr(owner, f"{axis}_mesh", mesh)
    for name, param in list(model.named_parameters()):
        if name in dims:
            continue
        dim = _split_dim(name, specs[name], param.ndim)
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = modules[owner_name]
        key = (type(owner).__name__, leaf, dim)
        if key not in _KINDS:
            raise NotImplementedError(
                f"{name}: a {type(owner).__name__}'s {leaf} split on dim "
                f"{dim} is not a split the port computes")
        if param.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(param.shape)} "
                             f"does not split over a model axis of {n}")
        dims[name] = (M, dim)
        if n == 1:
            continue
        _cut(owner, leaf, mesh, M, dim)
        kind = _KINDS[key]
        if kind is not None:
            owner.tp = Split(mesh, kind)
    for owner_name, owner in modules.items():
        if n == 1:
            break
        bias = getattr(owner, "bias", None)
        if (isinstance(bias, nn.Parameter) and f"{owner_name}.bias" in dims
                and getattr(owner, "tp", None) is None):
            raise ValueError(f"{owner_name}.bias is split but its kernel is "
                             "not")
        pairs = getattr(owner, "TP_PAIRS", None)
        if pairs is None:
            continue
        columns, row = pairs
        kinds = [getattr(getattr(owner, c, None), "tp", None)
                 for c in columns]
        row_tp = getattr(getattr(owner, row, None), "tp", None)
        if all(k is not None and k.kind == "column" for k in kinds) and (
                row_tp is not None and row_tp.kind == "row"):
            for k in kinds:
                k.paired = True
            owner.tp_mesh = mesh
    for owner_name, owner in modules.items():
        tp = getattr(owner, "tp", None)
        parent = modules[owner_name.rpartition(".")[0]]
        if (isinstance(tp, Split) and tp.kind == "row"
                and getattr(parent, "tp_mesh", None) is None):
            raise ValueError(
                f"{owner_name} is row-parallel without its column-parallel "
                f"partner: its input would have to be split first")
    model.split_dims = dims
    model.split_mesh = mesh
    return dims


def split_axes(model: nn.Module) -> dict[str, str]:
    """``{name: axis}`` of ``model``'s parameters split over an axis wider
    than one (empty for a model that was not cut)."""
    mesh = getattr(model, "split_mesh", None)
    return {name: axis for name, (axis, _) in
            getattr(model, "split_dims", {}).items()
            if mesh is not None and mesh.shape[axis] > 1}


# ------------------------------------------------------- whole state trees


def _map_named(tree, dims: Mapping[str, tuple[str, int]], fn: Callable,
               key=None):
    """``tree`` with every tensor leaf stored under a split parameter's
    name replaced by ``fn(leaf, axis, dim)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *dims[key]) if key in dims else tree
    if isinstance(tree, Mapping):
        return type(tree)((k, _map_named(v, dims, fn, k))
                          for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        out = [_map_named(v, dims, fn, None) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return tree


@torch.no_grad()
def gather_whole(t: torch.Tensor, mesh: Mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """``t``'s slices over ``axis`` concatenated along ``dim`` (a counted
    all-gather outside the step)."""
    return torch.cat(shardlib._gather_list(t, mesh.axis_group(axis),
                                           mesh.shape[axis],
                                           f"{axis}/state_gather"), dim=dim)


def _wide_dims(model: nn.Module, mesh: Mesh) -> dict[str, tuple[str, int]]:
    """The split dims of ``model`` over the axes of ``mesh`` wider than
    one."""
    return {k: v for k, v in getattr(model, "split_dims", {}).items()
            if mesh.shape[v[0]] > 1}


def whole_state(state, mesh: Mesh):
    """``state`` with its split tensors (the parameters, their optimizer
    slots and EMA shadows) gathered whole, the others the live tensors
    themselves.  ``state`` itself when nothing is split."""
    dims = _wide_dims(state.model, mesh)
    if not dims:
        return state

    def full(t, axis, dim):
        return gather_whole(t, mesh, axis, dim)

    return state.replace(
        params=_map_named(state.params, dims, full),
        opt_state=_map_named(state.opt_state, dims, full),
        ema_params=_map_named(state.ema_params, dims, full))


@torch.no_grad()
def scatter_state_(state, whole, mesh: Mesh):
    """Copy this process's slices of ``whole`` (a state of
    :func:`whole_state`'s layout, restored) into ``state``'s live split
    tensors; returns ``whole`` with them in place of its gathered ones."""
    dims = _wide_dims(state.model, mesh)
    if not dims:
        return whole

    def put(live, saved, key=None):
        if isinstance(live, torch.Tensor):
            if key in dims:
                live.copy_(local_slice(key, saved, dims, mesh))
                return live
            return saved
        if isinstance(live, Mapping):
            return type(live)((k, put(live[k], saved[k], k)) for k in live)
        if isinstance(live, (tuple, list)):
            out = [put(a, b) for a, b in zip(live, saved)]
            return (type(live)(*out) if hasattr(live, "_fields")
                    else type(live)(out))
        return saved

    return whole.replace(
        params=put(state.params, whole.params),
        opt_state=put(state.opt_state, whole.opt_state),
        ema_params=put(state.ema_params, whole.ema_params))


def local_slice(name: str, value, dims: Mapping[str, tuple[str, int]],
                mesh: Optional[Mesh]):
    """This process's slice of a whole parameter ``value`` (a tensor or a
    numpy array) named ``name`` over its axis (``value`` itself where it
    is not split, or its axis has size one)."""
    if mesh is None or name not in dims:
        return value
    axis, dim = dims[name]
    n, c = mesh.shape[axis], mesh.coord(axis)
    if n == 1:
        return value
    if isinstance(value, torch.Tensor):
        return value.chunk(n, dim=dim)[c]
    return np.split(np.asarray(value), n, axis=dim)[c]
