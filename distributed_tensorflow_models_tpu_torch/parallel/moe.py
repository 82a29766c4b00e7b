"""Switch-style mixture of experts: top-1 routing with a per-expert
capacity, ReLU experts, and the load-balancing loss.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/parallel/moe.py``.
The routing is the JAX package's, to the op:

- the router product ``x @ router`` and its softmax in f32 (with TF32 off
  for the product: a rounded router can flip ``argmax`` on near-ties and
  move whole tokens between experts);
- top-1 by ``argmax`` (the first index on ties), the gate its probability;
- each token's place in its expert's queue by ``cumsum(onehot) * onehot -
  onehot``, in token order;
- capacity ``C = max(1, int(capacity_factor * tokens / E))``; a token past
  it gets an all-zero ``[E, C]`` slot row (the one-hot of an out-of-range
  place is built by comparison with ``arange(C)``, so it is zero, not an
  error), is dropped, and its residual carries it;
- dispatch and combine ``[n, E, C]``, the experts' ``relu(x W_in) W_out``
  on ``[E, C, d]`` slots, the output cast to the input's dtype;
- aux ``E * sum(fraction * mean_prob)``, ``dropped = 1 - sum(dispatch) / n``.

The dispatch, expert and combine products are plain XLA products in the
JAX package, and plain ``einsum`` here.

Under a data axis of W processes (:func:`moe_ffn`) the JAX package's
``moe_ffn`` maps tokens over the ``expert`` axis only, so XLA gathers the
data-sharded tokens and routes the *global* token set.  Here each process
all-gathers the tokens over the data group (``core/sharding.py``, counted;
its backward sums the cotangents), routes and runs the experts on the
global set, and keeps its own rows: the redundant compute XLA does.

Over an expert axis of E processes (the JAX ``moe_ffn``'s ``shard_map``):
each process holds ``num_experts / E`` experts (:func:`moe_param_spec`,
cut by ``parallel/tensor.py::shard_model``); the global tokens, gathered
as above, are split into E chunks and expert rank ``r`` routes chunk
``r`` with the capacity of its own token count (``sharding.split``: its
backward all-gathers the chunks' cotangents); one all-to-all sends each
expert's ``[C, d]`` slots to the process that holds it, the local experts
run on every source's slots, and a second all-to-all sends the results
back; the chunk is combined, the chunks all-gathered over ``expert``, and
this process's rows returned.  The router enters through *f* on
``expert`` (its gradient the sum of the chunks'); aux and the dropped
fraction are the chunks' means.  That is ``moe_ffn_reference(num_ranks=E)``
over the global tokens.  :func:`emulate` runs the E ranks' arithmetic in
one process, the exchanges as list transposes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib


class MoEOutput(NamedTuple):
    out: torch.Tensor  # [tokens, d_model] combined expert outputs
    aux_loss: torch.Tensor  # scalar load-balancing loss
    dropped_fraction: torch.Tensor  # scalar diagnostic


def init_moe_params(num_experts: int, d_model: int, d_ff: int,
                    generator: Optional[torch.Generator] = None
                    ) -> dict[str, torch.Tensor]:
    """Per-expert FFN (``w_in [E, d, f]``, ``w_out [E, f, d]``) and
    ``router [d, E]``, f32 normals scaled by ``1/sqrt(d)`` (router, w_in)
    and ``1/sqrt(f)`` (w_out), drawn in that order."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    return {
        "router": normal(d_model, num_experts) * d_model ** -0.5,
        "w_in": normal(num_experts, d_model, d_ff) * d_model ** -0.5,
        "w_out": normal(num_experts, d_ff, d_model) * d_ff ** -0.5,
    }


def moe_param_spec(axis: str = meshlib.AxisNames.EXPERT) -> dict[str, tuple]:
    """Each parameter's spec: the experts' weights split over ``axis`` on
    their expert dim, the router replicated (the JAX package's
    ``P(axis)`` and ``P()``)."""
    return {"router": (), "w_in": (axis,), "w_out": (axis,)}


def capacity(capacity_factor: float, tokens: int, num_experts: int) -> int:
    return max(1, int(capacity_factor * tokens / num_experts))


@contextlib.contextmanager
def _exact_f32_matmul():
    """cuBLAS's f32 products without TF32 while the block runs, whatever
    the process has set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _route_local(x, router, num_experts: int, capacity: int):
    """Top-1 routing of tokens ``x [n, d]`` (f32) -> ``(dispatch [n, E,
    C] 0/1, combine [n, E, C] gate-weighted, aux_loss, dropped_fraction)``;
    places within an expert's capacity are given in token order."""
    n = x.shape[0]
    with _exact_f32_matmul():
        logits = x @ router
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
    experts = torch.arange(num_experts, device=x.device)
    onehot = (expert_idx[:, None] == experts).to(torch.float32)
    position = torch.cumsum(onehot, dim=0) * onehot - onehot
    pos = torch.sum(position, dim=-1).to(torch.int32)
    slots = torch.arange(capacity, device=x.device, dtype=torch.int32)
    pos_onehot = (pos[:, None] == slots).to(torch.float32)
    dispatch = onehot[:, :, None] * pos_onehot[:, None, :]
    combine = dispatch * gate[:, None, None]
    fraction = torch.mean(onehot, dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = num_experts * torch.sum(fraction * mean_prob)
    dropped = 1.0 - torch.sum(dispatch) / n
    return dispatch, combine, aux, dropped


def _experts(params, xl, capacity_: int, activation):
    """Route ``xl [n, d]`` (f32) and run the experts: ``(out [n, d] f32,
    aux, dropped)``."""
    num_experts = params["w_in"].shape[0]
    dispatch, combine, aux, dropped = _route_local(
        xl, params["router"], num_experts, capacity_)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xl)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, params["w_in"]))
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_out"])
    return torch.einsum("nec,ecd->nd", combine, expert_out), aux, dropped


def moe_ffn_reference(params: dict, x: torch.Tensor, *, num_ranks: int,
                      capacity_factor: float = 1.25,
                      activation: Callable = torch.relu) -> MoEOutput:
    """Single-device oracle: the token shards of ``num_ranks`` expert
    ranks routed shard by shard, each with the capacity of its own token
    count (the per-source-rank accounting expert parallelism implies);
    aux and the dropped fraction are the shards' means."""
    num_experts = params["w_in"].shape[0]
    tokens = x.shape[0]
    if tokens % num_ranks:
        raise ValueError(
            f"tokens {tokens} not divisible by num_ranks {num_ranks}")
    local = tokens // num_ranks
    cap = capacity(capacity_factor, local, num_experts)
    outs, auxes, drops = [], [], []
    for r in range(num_ranks):
        xl = x[r * local:(r + 1) * local].to(torch.float32)
        out, aux, dropped = _experts(params, xl, cap, activation)
        outs.append(out.to(x.dtype))
        auxes.append(aux)
        drops.append(dropped)
    return MoEOutput(out=torch.cat(outs, dim=0),
                     aux_loss=torch.mean(torch.stack(auxes)),
                     dropped_fraction=torch.mean(torch.stack(drops)))


def _dispatch(router, xl, num_experts: int, capacity_: int, ranks: int):
    """A source rank's routing of its tokens ``xl [n, d]`` (f32):
    ``(slots [ranks, num_experts / ranks, C, d], combine, aux, dropped)``,
    the slots grouped by the rank that holds their expert."""
    dispatch, combine, aux, dropped = _route_local(xl, router, num_experts,
                                                   capacity_)
    slots = torch.einsum("nec,nd->ecd", dispatch, xl)
    return (slots.reshape(ranks, num_experts // ranks, capacity_, -1),
            combine, aux, dropped)


def _local_experts(recv, w_in, w_out, activation):
    """An expert rank's experts on every source's slots ``recv [ranks,
    experts_local, C, d]``."""
    h = activation(torch.einsum("slcd,ldf->slcf", recv, w_in))
    return torch.einsum("slcf,lfd->slcd", h, w_out)


def _combine(combine, back):
    """A source rank's output from its slots' results ``back [ranks,
    experts_local, C, d]``."""
    E, C = combine.shape[1], combine.shape[2]
    return torch.einsum("nec,ecd->nd", combine, back.reshape(E, C, -1))


def _check_expert_axis(num_experts: int, tokens: int, e_size: int) -> None:
    if num_experts % e_size:
        raise ValueError(
            f"num_experts {num_experts} not divisible by expert axis {e_size}"
        )
    if tokens % e_size:
        raise ValueError(
            f"tokens {tokens} not divisible by expert axis {e_size}"
        )


def _expert_parallel(params: dict, x: torch.Tensor, mesh: meshlib.Mesh,
                     capacity_factor: float, activation) -> MoEOutput:
    """The expert axis's layout (module docstring) over this process's
    tokens ``x``."""
    E = mesh.expert_size
    axis = meshlib.AxisNames.EXPERT
    num_experts = params["router"].shape[-1]
    meta = x.device.type == "meta"
    # On the meta device (the FLOPs count) ``x`` already holds the global
    # rows, and the collectives keep only their shapes.
    xg = (x.reshape(-1, x.shape[-1]) if meta
          else shardlib.all_gather_rows(x, mesh, "moe_tokens"))
    _check_expert_axis(num_experts, xg.shape[0], E)
    cap = capacity(capacity_factor, xg.shape[0] // E, num_experts)
    xl = shardlib.split(xg, mesh, 0, axis, site="tokens_grad").to(
        torch.float32)
    router = shardlib.copy_in(params["router"], mesh, axis,
                              site="router_grad")
    slots, combine, aux, dropped = _dispatch(router, xl, num_experts, cap, E)
    recv = shardlib.all_to_all(slots, mesh, axis, site="dispatch")
    back = shardlib.all_to_all(
        _local_experts(recv, params["w_in"], params["w_out"], activation),
        mesh, axis, site="return")
    out = shardlib.gather(_combine(combine, back), mesh, 0, axis,
                          site="tokens")
    stats = shardlib.reduce_sum(torch.stack([aux, dropped]), mesh, axis,
                                site="stats") / E
    out = (out.reshape(x.shape) if meta
           else shardlib.own_rows(out, mesh, x.shape[:-1]))
    return MoEOutput(out=out.to(x.dtype), aux_loss=stats[0],
                     dropped_fraction=stats[1].detach())


def moe_ffn(params: dict, x: torch.Tensor, *,
            mesh: Optional[meshlib.Mesh] = None,
            capacity_factor: float = 1.25,
            activation: Callable = torch.relu) -> MoEOutput:
    """The Switch FFN over this process's tokens ``x [..., d]`` (``[n,
    d]``, or the ``[Bl, Tl, d]`` block of a batch under a seq axis) under
    ``mesh`` (by default the current one).  At an expert axis of one: the
    tokens of the data x seq processes gathered in the global batch's
    order (``sharding.all_gather_rows``), routed with the capacity of the
    global count, the experts run on them, and this process's tokens of
    the output returned in ``x``'s shape; aux and the dropped fraction are
    the global set's.  Over an expert axis of E: the expert-parallel
    layout (module docstring), ``params`` holding this process's experts.
    Without a process group it is :func:`moe_ffn_reference` with one
    rank."""
    mesh = meshlib.current_mesh() if mesh is None else mesh
    if mesh is not None and mesh.expert_size > 1:
        return _expert_parallel(params, x, mesh, capacity_factor, activation)
    if mesh is None or mesh.dp_group is None:
        if mesh is not None and mesh.dp_size > 1:
            raise RuntimeError(
                f"a data axis of {mesh.dp_size} with no process group "
                f"cannot gather the tokens of its processes")
        res = moe_ffn_reference(params, x.reshape(-1, x.shape[-1]),
                                num_ranks=1, capacity_factor=capacity_factor,
                                activation=activation)
        return res._replace(out=res.out.reshape(x.shape))
    num_experts = params["w_in"].shape[0]
    xg = shardlib.all_gather_rows(x, mesh, "moe_tokens")
    cap = capacity(capacity_factor, xg.shape[0], num_experts)
    out, aux, dropped = _experts(params, xg.to(torch.float32), cap,
                                 activation)
    return MoEOutput(out=shardlib.own_rows(out, mesh, x.shape[:-1]).to(
                         x.dtype), aux_loss=aux,
                     dropped_fraction=dropped)


def emulate(params: dict, x: torch.Tensor, *, num_ranks: int,
            capacity_factor: float = 1.25,
            activation: Callable = torch.relu) -> MoEOutput:
    """The expert axis's per-rank arithmetic for ``num_ranks`` virtual
    expert ranks in one process, on the whole ``params`` and tokens ``x
    [N, d]``: rank ``r`` routes chunk ``r`` (:func:`_dispatch`), the first
    all-to-all is a transpose of the ranks' slot lists, rank ``r`` runs
    experts ``r * E/num_ranks ..`` on every source's slots, the second
    all-to-all transposes back, and each rank combines its chunk.  The
    semantics of :func:`moe_ffn_reference` with ``num_ranks``.
    Differentiable; no collective is issued."""
    num_experts = params["router"].shape[-1]
    _check_expert_axis(num_experts, x.shape[0], num_ranks)
    local, el = x.shape[0] // num_ranks, num_experts // num_ranks
    cap = capacity(capacity_factor, local, num_experts)
    sent = [_dispatch(params["router"],
                      x[r * local:(r + 1) * local].to(torch.float32),
                      num_experts, cap, num_ranks)
            for r in range(num_ranks)]
    done = [_local_experts(
        torch.stack([sent[s][0][r] for s in range(num_ranks)]),
        params["w_in"][r * el:(r + 1) * el],
        params["w_out"][r * el:(r + 1) * el], activation)
        for r in range(num_ranks)]
    outs = [_combine(sent[s][1],
                     torch.stack([done[r][s] for r in range(num_ranks)]))
            for s in range(num_ranks)]
    return MoEOutput(
        out=torch.cat(outs).to(x.dtype),
        aux_loss=torch.mean(torch.stack([s[2] for s in sent])),
        dropped_fraction=torch.mean(torch.stack([s[3] for s in sent])))
