"""Decoder-only transformer LM: the dense, non-pipelined stack.

PyTorch counterpart of
``distributed_tensorflow_models_tpu/models/transformer_lm.py``: pre-LN
causal blocks (LayerNorm -> self-attention -> residual, LayerNorm -> GELU
MLP -> residual) over a token embedding plus a learned position table, a
final LayerNorm and an f32 head; with ``pos_encoding="rope"`` there is no
position table and q and k are rotated inside attention instead. Attention
goes through :func:`...ops.attention.attention` (``attn_impl`` auto /
reference / blockwise / flash; flash runs kernels K2-K5 on the card).

flax's defaults are kept where PyTorch's differ: LayerNorm eps 1e-6,
statistics ``E[x^2] - E[x]^2`` in f32 and an f32 output; GELU in its tanh
form; ``Dense(dtype=bf16)`` casts input, kernel and bias to bf16; the
position table is normal(0.02) and cast to the activation dtype before
the add.  Module and parameter names are the flax paths
(``blocks_0.attn.query.kernel``, ``embedding.embedding``,
``pos_embedding``...), so ``interop`` maps a flax tree onto the state
dict name for name.

``pipelined=True`` replaces the blocks by :class:`PipelinedBlocks`
(``pipeline``): the JAX package's stacked ``[L, ...]`` parameters
(``pipeline.wq``, ...), run as a GPipe pipeline over the pipe axis
(``parallel/pipeline.py``) when the stack is cut over one, and by the
sequential schedule otherwise; dense MHA blocks with learned positions
only (the JAX package's ``ValueError`` otherwise).

``num_experts > 0`` makes every odd block's FFN a Switch-MoE layer
(:class:`MoEFFN`, ``parallel/moe.py``; parameters ``blocks_{i}.moe.router``,
``.w_in``, ``.w_out``, f32).  Its load-balancing loss, times
``aux_loss_weight``, is the JAX module's ``sow`` into the ``losses``
collection: a forward given a ``losses`` dict adds it there under the
flax path (``blocks_1.moe.moe_aux``), as a tensor that carries its
gradient and that the loss sums (``core/train_loop.py::lm_loss_fn``);
without one (eval, decode) it is dropped.  ``remat=True`` recomputes each
block in the backward (``ops/remat.py``); the aux loss comes out of the
checkpoint with the block's output, once.

Parallel layouts (``core/mesh.py``): under ``transformer_tp``
(``parallel/tensor.py::shard_model``) the attention's projections and
the MLP are split Megatron-style over the model axis (each process runs
attention on its ``H/M`` query and ``H_kv/M`` KV heads), the embedding
gathers its columns and the head its logits (or, in the fused chunked
head, its weights).  ``attention_fn`` (the harness's sequence-parallel
closure, ``parallel/ring.py``) replaces the attention call, and then the
window lives in the closure (``attn_window`` with an ``attention_fn``
raises the JAX package's error); positions are global: a process on the
seq axis holds tokens ``rank_seq * T ..`` (:func:`position_offset`), so
the position table and RoPE are read there.

Decode: a forward given a :class:`KVCache` (``model.init_cache``; required
with ``decode=True``) runs the JAX package's decode mode.  The tokens of
row ``b`` sit at global positions ``index[b] .. index[b] + T - 1`` (one
index for every row, or one per row: the serving engine's lanes): the
position table is read there (or q and k are rotated there), each block's
keys (after rotation) and values are written into its cache at those rows
(``index_copy_`` at a device index; a write that would run past
``max_len`` starts at ``max_len - T`` instead, as JAX's
``dynamic_update_slice`` clamps it), and attention runs over the whole
cache through :func:`...ops.attention.rowwise_attention` with the
causal mask (and window) in global positions, which also hides the
cache's unwritten tail.  The index then advances by ``T`` in place.  No
host read is made, so a one-token decode step can be captured as a CUDA
graph over the cache's static storage (``harness/generate.py``).

Every decode product is row-invariant (``ops/rowwise.py``, kernel R1 on
the card): the Dense projections, the MLP, the f32 head, attention's
scores and probabilities x values over the cache, and the sums of the
LayerNorm statistics and the softmax normaliser.  So a row's logits and
the K/V it writes do not depend on the rows around it: a prompt passed
whole, in chunks, or beside other lanes gives the same bits, which is
what lets a served stream equal a solo ``generate``.  RoPE's angles come
from one table of every position, gathered per token, for the same
reason.  Training does not take this path.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops import remat as rematlib
from distributed_tensorflow_models_tpu_torch.ops import rotary
from distributed_tensorflow_models_tpu_torch.ops import rowwise
from distributed_tensorflow_models_tpu_torch.ops.conv import Dense
from distributed_tensorflow_models_tpu_torch.ops import dropout as droplib
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.embed import TokenEmbed
from distributed_tensorflow_models_tpu_torch.parallel import moe as moelib
from distributed_tensorflow_models_tpu_torch.parallel import pipeline as pplib
from distributed_tensorflow_models_tpu_torch.parallel import tensor as tensorlib


DECODE_DENSE_ONLY = ("decode mode supports the dense non-pipelined stack "
                     "without a sequence-parallel attention_fn")
WINDOW_IN_CLOSURE = (
    "attn_window is not threaded through the harness's sequence-parallel "
    "attention_fn closures — training would use full causal attention "
    "while decode applies the window.  (ring_attention/ulysses_attention "
    "DO accept window= at the library level; pass a closure that sets it "
    "and leave attn_window unset here.)")
PIPELINED_DENSE_ONLY = (
    "pipelined path supports dense MHA blocks with remat=False, full "
    "causal attention, and learned positions; num_kv_heads/attn_window/"
    "rope are not plumbed into the stacked layout — training would "
    "silently diverge from the non-pipelined model")


def position_offset(T: int) -> int:
    """The global position of this process's first token: ``rank_seq * T``
    when the current mesh splits the token axis over seq
    (``core/mesh.py::current_seq_dim``), else 0."""
    mesh = meshlib.current_mesh()
    if meshlib.current_seq_dim() != 1:
        return 0
    return mesh.coord(meshlib.AxisNames.SEQ) * T


@dataclasses.dataclass
class KVCache:
    """Decode state the caller owns: per block the keys (after rotation)
    and values, ``[B, max_len, Hkv, Dh]`` in the model's dtype, and the
    number of positions written so far, ``index``: an int64 tensor on the
    cache's device, 0-d (one count for every row: the JAX package's
    ``cache_index`` of every block and the model's ``pos_index``) or
    ``[B]`` (one per row: the serving engine's lanes, each at its own
    length).  A decode forward writes its rows and advances ``index`` in
    place; :meth:`reorder` gathers the rows of the batch in place (beam
    search's parents)."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]
    index: torch.Tensor

    @torch.no_grad()
    def reorder(self, rows: torch.Tensor) -> None:
        """Row ``i`` of every block's keys and values becomes the old row
        ``rows[i]``, in the same storage."""
        for t in (*self.keys, *self.values):
            t.copy_(t.index_select(0, rows))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: f32 statistics
    ``E[x^2] - E[x]^2`` (clamped at 0), eps 1e-6, f32 output."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self._normalize(x, x.mean(-1, keepdim=True),
                               (x * x).mean(-1, keepdim=True))

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """The decode path's: each row's sums by ``ops/rowwise.py`` (a
        row's statistics then do not depend on the rows beside it)."""
        x = x.float()
        d = x.shape[-1]
        return self._normalize(x, rowwise.row_sum(x) / d,
                               rowwise.row_sum(x * x) / d)

    def _normalize(self, x, mean, ex2):
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class SelfAttention(nn.Module):
    """Causal multi-head self-attention: ``query`` (H heads) and
    ``key``/``value`` (``num_kv_heads`` heads, GQA when fewer), q and k
    rotated by their global positions when ``use_rope``, attention (or
    the sequence-parallel ``attention_fn(q, k, v, causal=True)`` of the
    harness, ``parallel/ring.py``), ``out``, dropout.

    Under ``transformer_tp`` (``parallel/tensor.py``) the three
    projections are column-parallel and ``out`` row-parallel: this
    process runs attention on its ``H/M`` query and ``H_kv/M`` KV heads
    (both must divide by the model axis's M), and ``out`` sums the heads'
    products over the model axis before its bias."""

    TP_PAIRS = (("query", "key", "value"), "out")

    def __init__(self, num_heads: int, d_model: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 generator: Optional[torch.Generator] = None,
                 attention_fn=None):
        super().__init__()
        self.attention_fn = attention_fn
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = d_model // num_heads
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.attn_impl = attn_impl
        self.attn_window = attn_window
        kv = self.num_kv_heads * self.head_dim
        dense = dict(dtype=dtype, generator=generator)
        self.query = Dense(d_model, d_model, **dense)
        self.key = Dense(d_model, kv, **dense)
        self.value = Dense(d_model, kv, **dense)
        self.out = Dense(d_model, d_model, **dense)

    def forward(self, x, train: bool = False, rngs=None, cache=None):
        """``cache``: ``(keys, values, step)`` of this block, in decode
        (``step``: the forward's :class:`_DecodePositions`)."""
        B, T, _ = x.shape
        H, Hkv, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        mesh = getattr(self, "tp_mesh", None)
        if mesh is not None:
            n = mesh.model_size
            if H % n or Hkv % n:
                raise ValueError(
                    f"query heads {H} and kv heads {Hkv} must both divide "
                    f"by the model axis size {n} (the tensor-parallel rules "
                    f"split the head axis)")
            H, Hkv = H // n, Hkv // n
        x = tensorlib.enter(self, x)
        if cache is not None:
            ck, cv, step = cache
            q = rowwise.dense(self.query, x).reshape(B, T, H, Dh)
            k = rowwise.dense(self.key, x).reshape(B, T, Hkv, Dh)
            v = rowwise.dense(self.value, x).reshape(B, T, Hkv, Dh)
            if self.use_rope:
                cos, sin = step.rope(Dh, self.rope_theta)
                q = rotary.rotate(q, cos, sin)
                k = rotary.rotate(k, cos, sin)
            step.write(ck, k)
            step.write(cv, v)
            out = attnlib.rowwise_attention(q, ck, cv, causal=True,
                                            q_offset=step.index,
                                            window=self.attn_window)
            out = rowwise.dense(self.out, out.reshape(B, T, H * Dh))
            return dropout(out, self.dropout_rate, train, rngs)
        q = self.query(x).reshape(B, T, H, Dh)
        k = self.key(x).reshape(B, T, Hkv, Dh)
        v = self.value(x).reshape(B, T, Hkv, Dh)
        if self.use_rope:
            off = position_offset(T)
            pos = torch.arange(off, off + T, device=x.device)
            q = rotary.apply_rope(q, pos, self.rope_theta)
            k = rotary.apply_rope(k, pos, self.rope_theta)
        if self.attention_fn is not None:
            out = self.attention_fn(q, k, v, causal=True)
        else:
            out = attnlib.attention(q, k, v, causal=True,
                                    impl=self.attn_impl,
                                    window=self.attn_window)
        out = self.out(out.reshape(B, T, H * Dh))
        return dropout(out, self.dropout_rate, train, rngs)


class MLP(nn.Module):
    """``up`` -> GELU -> ``down`` -> dropout; under ``transformer_tp`` the
    pair column-/row-parallel over the model axis."""

    TP_PAIRS = (("up",), "down")

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.up = Dense(d_model, d_ff, dtype=dtype, generator=generator)
        self.down = Dense(d_ff, d_model, dtype=dtype, generator=generator)

    def forward(self, x, train: bool = False, rngs=None):
        h = F.gelu(self.up(tensorlib.enter(self, x)), approximate="tanh")
        return dropout(self.down(h), self.dropout_rate, train, rngs)


class MoEFFN(nn.Module):
    """Switch-MoE FFN (the JAX ``MoEFFN``): parameters ``router [d, E]``,
    ``w_in [E, d, f]``, ``w_out [E, f, d]`` in f32, normals scaled by
    ``1/sqrt(d)``, ``1/sqrt(d)`` and ``1/sqrt(f)``; the tokens ``[B, T, d]``
    through :func:`...parallel.moe.moe_ffn` over the current mesh's data x
    seq processes, or, cut over an expert axis (``param_spec``; its
    ``expert_mesh`` set by ``parallel/tensor.py::shard_model``), over
    that mesh's expert-parallel layout with this process's experts.
    Returns ``(out [B, T, d] in x's dtype, aux_loss_weight * aux)``."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        init = moelib.init_moe_params(num_experts, d_model, d_ff, generator)
        self.router = nn.Parameter(init["router"])
        self.w_in = nn.Parameter(init["w_in"])
        self.w_out = nn.Parameter(init["w_out"])

    def param_spec(self, mesh: meshlib.Mesh) -> dict[str, tuple]:
        """The JAX package's ``moe_param_spec``: the experts over
        ``expert``; its ``ValueError`` where they do not divide."""
        e_size = mesh.expert_size
        if self.router.shape[-1] % e_size:
            raise ValueError(f"num_experts {self.router.shape[-1]} not "
                             f"divisible by expert axis {e_size}")
        return moelib.moe_param_spec()

    def forward(self, x):
        params = {"router": self.router, "w_in": self.w_in,
                  "w_out": self.w_out}
        res = moelib.moe_ffn(params, x, mesh=getattr(self, "expert_mesh",
                                                     None),
                             capacity_factor=self.capacity_factor)
        return res.out.to(x.dtype), self.aux_loss_weight * res.aux_loss


class Block(nn.Module):
    """Pre-LN block; its FFN is the dense :class:`MLP` (``mlp``) or, with
    ``num_experts``, the :class:`MoEFFN` (``moe``), and then the block
    returns ``(x, weighted aux loss)``."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dropout_rate: float, dtype: torch.dtype, attn_impl: str,
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 num_experts: int = 0, moe_capacity_factor: float = 1.25,
                 generator: Optional[torch.Generator] = None,
                 attention_fn=None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(d_model)
        self.attn = SelfAttention(num_heads, d_model, dropout_rate, dtype,
                                  attn_impl, num_kv_heads, attn_window,
                                  use_rope, rope_theta, generator,
                                  attention_fn)
        self.ln2 = LayerNorm(d_model)
        if num_experts:
            self.moe = MoEFFN(num_experts, d_model, d_ff,
                              moe_capacity_factor, generator=generator)
        else:
            self.mlp = MLP(d_model, d_ff, dropout_rate, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None, cache=None):
        if cache is not None:
            # Decode: the row-invariant products (``ops/rowwise.py``).
            x = x + self.attn(self.ln1.decode(x).to(self.dtype), train, rngs,
                              cache)
            mlp = self.mlp
            h = F.gelu(rowwise.dense(mlp.up, self.ln2.decode(x).to(
                self.dtype)), approximate="tanh")
            return x + dropout(rowwise.dense(mlp.down, h), mlp.dropout_rate,
                               train, rngs)
        x = x + self.attn(self.ln1(x).to(self.dtype), train, rngs, cache)
        h = self.ln2(x).to(self.dtype)
        if hasattr(self, "moe"):
            out, aux = self.moe(h)
            return x + out, aux
        return x + self.mlp(h, train, rngs)


def _stack_ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    """The pipelined stack's LayerNorm (JAX ``PipelinedBlocks._ln``): f32,
    two-pass variance, eps 1e-6."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + 1e-6) * scale + bias


class PipelinedBlocks(nn.Module):
    """The block stack with per-layer-stacked parameters (the JAX
    ``PipelinedBlocks``): ``ln1_scale``, ``ln1_bias``, ``wq``, ``wk``,
    ``wv``, ``wo``, ``ln2_scale``, ``ln2_bias``, ``w_up``, ``w_down``, each
    ``[L, ...]`` in f32, the projections normals scaled by ``d**-0.5``
    (``w_down`` by ``f**-0.5``).  A layer is JAX's ``one_layer``: LN (f32,
    then cast), bias-free projections, causal ``attention(impl=attn_impl)``
    (K2-K4 on the card under ``flash``), tanh GELU, dropout on both
    residual branches.

    The batch is split into ``num_microbatches`` and run through stages of
    ``L/n`` layers: as a GPipe pipeline over the pipe axis
    (:func:`...parallel.pipeline.pipeline_apply`) when the stack was cut
    over one (``param_spec``; ``pipe_mesh`` set by ``shard_model``, each
    process holding its ``[L/n, ...]`` slice), else by the sequential
    schedule, where a count that does not divide the batch is clamped to
    one.  Dropout masks depend only on (step, layer, sublayer, global
    batch row): the masks of every layer are drawn at once for the global
    batch (``ops/dropout.py::uniform``) and each microbatch reads its
    rows, whose ids travel with it through the stages; so every schedule,
    microbatch count and data layout draws the same masks (Philox bits,
    not JAX's)."""

    PARAMS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "ln2_scale",
              "ln2_bias", "w_up", "w_down")

    def __init__(self, num_layers: int, num_heads: int, d_model: int,
                 d_ff: int, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", num_microbatches: int = 4,
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        L, d, f = num_layers, d_model, d_ff
        self.num_layers, self.num_heads = L, num_heads
        self.dtype, self.attn_impl = dtype, attn_impl
        self.num_microbatches = num_microbatches
        self.dropout_rate = dropout_rate

        def stacked(shape, stddev):
            return nn.Parameter(torch.randn((L, *shape), generator=generator)
                                * stddev)

        self.ln1_scale = nn.Parameter(torch.ones(L, d))
        self.ln1_bias = nn.Parameter(torch.zeros(L, d))
        self.wq = stacked((d, d), d ** -0.5)
        self.wk = stacked((d, d), d ** -0.5)
        self.wv = stacked((d, d), d ** -0.5)
        self.wo = stacked((d, d), d ** -0.5)
        self.ln2_scale = nn.Parameter(torch.ones(L, d))
        self.ln2_bias = nn.Parameter(torch.zeros(L, d))
        self.w_up = stacked((d, f), d ** -0.5)
        self.w_down = stacked((f, d), f ** -0.5)

    def param_spec(self, mesh: meshlib.Mesh) -> dict[str, tuple]:
        """Every stacked parameter's layer dim over ``pipe``
        (``pipeline_spec``); the JAX package's ``ValueError`` where the
        layers do not divide."""
        n = mesh.pipe_size
        if self.num_layers % n:
            raise ValueError(
                f"num_layers {self.num_layers} not divisible by pipe axis {n}"
            )
        return pplib.pipeline_spec({k: getattr(self, k) for k in self.PARAMS})

    def _layer(self, p, i: int, x, rid, keep):
        """JAX's ``one_layer`` on this stage's ``i``-th layer."""
        B, T, d = x.shape
        H = self.num_heads
        Dh, dt = d // H, self.dtype

        def drop(y, sub):
            if keep is None:
                return y
            k = keep[p["layer_id"][i], sub].index_select(0, rid)
            rate = self.dropout_rate
            return torch.where(k, y / (1.0 - rate), torch.zeros_like(y))

        h = _stack_ln(x, p["ln1_scale"][i], p["ln1_bias"][i]).to(dt)
        q = (h @ p["wq"][i].to(dt)).reshape(B, T, H, Dh)
        k = (h @ p["wk"][i].to(dt)).reshape(B, T, H, Dh)
        v = (h @ p["wv"][i].to(dt)).reshape(B, T, H, Dh)
        a = attnlib.attention(q, k, v, causal=True, impl=self.attn_impl)
        a = a.reshape(B, T, d) @ p["wo"][i].to(dt)
        x = x + drop(a, 0)
        h = _stack_ln(x, p["ln2_scale"][i], p["ln2_bias"][i]).to(dt)
        h = F.gelu(h @ p["w_up"][i].to(dt), approximate="tanh")
        h = h @ p["w_down"][i].to(dt)
        return x + drop(h, 1)

    def stage_fn(self, keep):
        """``(stage_params, {"x", "rid"}) -> {"x", "rid"}``: a stage's
        layers (each parameter indexed by layer, ``stage_params
        ["layer_id"]`` their global ids as host ints) on a microbatch and
        its row ids; ``keep`` the drawn masks ``[L, 2, rows, T, d]`` (None
        without dropout)."""
        def fn(p, xm):
            x = xm["x"]
            for i in range(len(p["wq"])):
                x = self._layer(p, i, x, xm["rid"], keep)
            return {"x": x, "rid": xm["rid"]}

        return fn

    def _schedule_inputs(self, x, train: bool, rngs, m: int):
        """The drawn masks (None without dropout) and the microbatches of
        ``x`` with their row ids."""
        keep = None
        if train and self.dropout_rate:
            u = droplib.uniform((self.num_layers, 2, *x.shape), rngs,
                                x.device, 2)
            keep = u < 1.0 - self.dropout_rate
        B = x.shape[0]
        return keep, {"x": pplib.split_microbatches(x, m),
                      "rid": torch.arange(B, device=x.device).reshape(
                          m, B // m)}

    def forward(self, x, train: bool = False, rngs=None):
        mesh = getattr(self, "pipe_mesh", None)
        m = self.num_microbatches
        if mesh is None and x.shape[0] % m:
            # The sequential schedule's result does not depend on the
            # count: clamp rather than reject (the JAX mesh-free path).
            m = 1
        keep, tree = self._schedule_inputs(x, train, rngs, m)
        # Each layer's slice of every stacked parameter, taken once: the
        # backward then stacks the layers' gradients in one node.
        params = {k: list(getattr(self, k).unbind(0)) for k in self.PARAMS}
        fn = self.stage_fn(keep)
        if mesh is None:
            staged = {k: [v] for k, v in params.items()}
            staged["layer_id"] = [list(range(self.num_layers))]
            out = pplib.sequential_apply(fn, staged, tree)
        else:
            per = len(params["wq"])
            start = mesh.coord(meshlib.AxisNames.PIPE) * per
            out = pplib.pipeline_apply(
                fn, {**params, "layer_id": list(range(start, start + per))},
                tree, mesh=mesh)
        return pplib.merge_microbatches(out["x"])

    def emulate(self, x, n: int, train: bool = False, rngs=None):
        """The whole stack's forward by the pipelined schedule of ``n``
        virtual stages in one process (:func:`...parallel.pipeline.
        emulate`) at ``num_microbatches``: what ``n`` pipe processes
        compute, with no collective."""
        L = self.num_layers
        if L % n:
            raise ValueError(f"num_layers {L} not divisible by pipe axis {n}")
        keep, tree = self._schedule_inputs(x, train, rngs,
                                           self.num_microbatches)
        staged = {k: getattr(self, k).reshape(n, L // n,
                                               *getattr(self, k).shape[1:])
                  for k in self.PARAMS}
        staged["layer_id"] = [list(range(r * L // n, (r + 1) * L // n))
                              for r in range(n)]
        out = pplib.emulate(self.stage_fn(keep), staged, tree, n)
        return pplib.merge_microbatches(out["x"])


class _DecodePositions:
    """Where a decode forward's tokens sit: ``index`` (the cache's, 0-d or
    ``[B]``), their global positions ``pos`` (``[1, T]`` or ``[B, T]``:
    ``index + t``, what the mask and RoPE read) and the rows they are
    written to, ``rows``: ``pos`` with each row's start clamped to
    ``max_len - T`` (JAX's ``dynamic_update_slice``), which the position
    table is also read at.  Only a row that has run past its cache (a
    finished serving lane's overrun) has ``rows != pos``."""

    def __init__(self, index: torch.Tensor, T: int, max_len: int):
        if index.dim() > 1:
            raise ValueError(f"a cache index is 0-d or [B], got "
                             f"{tuple(index.shape)}")
        self.index, self.max_len = index, max_len
        self._rope: dict = {}
        t = torch.arange(T, device=index.device)
        start = index.reshape(-1, 1)
        self.pos = start + t
        self.rows = torch.clamp(start, 0, max_len - T) + t

    def write(self, cache: torch.Tensor, x: torch.Tensor) -> None:
        """``x [B, T, ...]`` into ``cache [B, max_len, ...]`` at ``rows``,
        in place."""
        x = x.to(cache.dtype)
        if self.index.dim() == 0:
            cache.index_copy_(1, self.rows[0], x)
            return
        B, T = x.shape[:2]
        flat = (torch.arange(B, device=x.device)[:, None] * self.max_len
                + self.rows).reshape(-1)
        cache.view(B * self.max_len, *cache.shape[2:]).index_copy_(
            0, flat, x.reshape(B * T, *x.shape[2:]))

    def rope(self, dim: int, theta: float):
        """``(cos, sin)`` ``[1 or B, T, dim/2]`` at ``pos``, gathered from
        one table of positions ``0 .. 2 max_len - 1`` (a row's angles then
        do not depend on how many rows were computed with it; positions
        past the table, overrun only, read its last row).  Taken once a
        forward."""
        if (dim, theta) not in self._rope:
            table = torch.arange(2 * self.max_len, device=self.index.device)
            cos, sin = rotary.rope_angles(table, dim, theta)
            at = torch.clamp(self.pos, 0, 2 * self.max_len - 1)
            self._rope[dim, theta] = cos[at], sin[at]
        return self._rope[dim, theta]


class TransformerLM(nn.Module):
    """Input ``tokens [B, T]`` int; returns ``(logits [B, T, V], carry)``.
    The carry passes through unchanged (the LM train-step contract shared
    with the PTB LSTM).  ``return_hidden=True`` returns the post-``ln_f``
    hidden states instead of logits, for the fused chunked head.  Given a
    ``cache`` (:meth:`init_cache`) the forward decodes (module docstring);
    ``decode=True`` makes the cache required."""

    def __init__(self, vocab_size: int = 10000, num_layers: int = 4,
                 num_heads: int = 8, d_model: int = 256, d_ff: int = 1024,
                 max_len: int = 1024, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 pos_encoding: str = "learned", rope_theta: float = 10000.0,
                 num_experts: int = 0, moe_capacity_factor: float = 1.25,
                 pipelined: bool = False, pipeline_microbatches: int = 4,
                 remat: bool = False, decode: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attention_fn=None):
        super().__init__()
        if decode and (pipelined or num_experts or attention_fn is not None):
            raise ValueError(DECODE_DENSE_ONLY)
        if attn_window is not None and attention_fn is not None:
            raise ValueError(WINDOW_IN_CLOSURE)
        if pipelined and (num_experts or remat or num_kv_heads
                          or attn_window is not None
                          or pos_encoding != "learned"):
            raise ValueError(PIPELINED_DENSE_ONLY)
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {pos_encoding!r} "
                             "(want 'learned' or 'rope')")
        attnlib._check_window(attn_window)
        self.dtype = dtype
        self.decode = decode
        self.attention_fn = attention_fn
        self.remat = remat
        self.num_experts = num_experts
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = d_model // num_heads
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.max_len = max_len
        self.embedding = TokenEmbed(vocab_size, d_model, dtype=dtype,
                                    generator=generator)
        # Rotary positions enter inside attention: no absolute table.
        if pos_encoding == "learned":
            self.pos_embedding = nn.Parameter(torch.empty(max_len, d_model))
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        else:
            self.register_parameter("pos_embedding", None)
        self.pipelined = pipelined
        if pipelined:
            self.pipeline = PipelinedBlocks(
                num_layers, num_heads, d_model, d_ff, dtype, attn_impl,
                pipeline_microbatches, dropout_rate, generator)
        for i in range(0 if pipelined else num_layers):
            self.add_module(f"blocks_{i}", Block(
                num_heads, d_model, d_ff, dropout_rate, dtype, attn_impl,
                num_kv_heads, attn_window, pos_encoding == "rope",
                rope_theta, num_experts if i % 2 == 1 else 0,
                moe_capacity_factor, generator, attention_fn))
        self.ln_f = LayerNorm(d_model)
        self.head = Dense(d_model, vocab_size, dtype=torch.float32,
                          generator=generator)

    def init_cache(self, batch_size: int,
                   device: Optional[str | torch.device] = None) -> KVCache:
        """An empty cache for ``batch_size`` rows: zeros of ``[B, max_len,
        num_kv_heads, head_dim]`` in the model's dtype per block, index 0.
        The MoE and pipelined stacks have no decode mode (the JAX
        ``ValueError``)."""
        if self.num_experts or self.pipelined:
            raise ValueError(DECODE_DENSE_ONLY)
        shape = (batch_size, self.max_len, self.num_kv_heads, self.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=device)

        return KVCache([zeros() for _ in range(self.num_layers)],
                       [zeros() for _ in range(self.num_layers)],
                       torch.zeros((), dtype=torch.int64, device=device))

    def forward(self, tokens, carry=None, train: bool = False,
                return_hidden: bool = False,
                rngs: Optional[Mapping[str, torch.Generator]] = None,
                cache: Optional[KVCache] = None,
                losses: Optional[dict] = None):
        """``losses``: the ``losses`` collection to sow into (module
        docstring); None drops what the MoE blocks would sow."""
        T = tokens.shape[1]
        if self.decode and cache is None:
            raise ValueError("decode mode needs a KVCache (model.init_cache)")
        if cache is not None and (self.num_experts or self.pipelined
                                  or self.attention_fn is not None):
            raise ValueError(DECODE_DENSE_ONLY)
        x = self.embedding(tokens)
        if cache is not None:
            if T > self.max_len:
                raise ValueError(f"decode of {T} tokens exceeds max_len "
                                 f"{self.max_len}")
            step = _DecodePositions(cache.index, T, self.max_len)
            if self.pos_embedding is not None:
                x = x + self.pos_embedding[step.rows].to(self.dtype)
        elif self.pos_embedding is not None:
            off = position_offset(T)
            if off + T > self.max_len:
                raise ValueError(f"sequence length {off + T} exceeds "
                                 f"max_len {self.max_len}")
            x = x + self.pos_embedding[off:off + T].to(self.dtype)
        x = dropout(x, self.dropout_rate, train, rngs)
        if self.pipelined:
            x = self.pipeline(x, train, rngs)
        for i in range(0 if self.pipelined else self.num_layers):
            block = getattr(self, f"blocks_{i}")
            if cache is not None:
                x = block(x, train, rngs,
                          (cache.keys[i], cache.values[i], step))
                continue
            if self.remat:
                x = rematlib.checkpoint(block, x, train, rngs=rngs)
            else:
                x = block(x, train, rngs)
            if isinstance(x, tuple):
                x, aux = x
                if losses is not None:
                    key = f"blocks_{i}.moe.moe_aux"
                    losses[key] = losses.get(key, 0.0) + aux
        if cache is not None:
            with torch.no_grad():
                cache.index.add_(T)
            x = self.ln_f.decode(x)
            if return_hidden:
                return x, carry
            return rowwise.dense(self.head, x), carry
        x = self.ln_f(x)
        if return_hidden:
            return x, carry
        return self.head(x), carry


@register("transformer_lm")
def build_transformer_lm(**kwargs) -> TransformerLM:
    return TransformerLM(**kwargs)
