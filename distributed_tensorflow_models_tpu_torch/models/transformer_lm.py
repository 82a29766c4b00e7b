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
dict name for name.  The pipelined stack is not ported yet and raises.

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
with ``decode=True``) runs the JAX package's decode mode.  The tokens sit
at global positions ``cache.index .. cache.index + T - 1``: the position
table is read there (or q and k are rotated there), each block's keys
(after rotation) and values are written into its cache at those rows
(``index_copy_`` at a device index), and attention runs over the whole
cache through :func:`...ops.attention.reference_attention` with the
causal mask (and window) in global positions, which also hides the
cache's unwritten tail.  The index then advances by ``T`` in place.  No
host read is made, so a one-token decode step can be captured as a CUDA
graph over the cache's static storage (``harness/generate.py``).
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
from distributed_tensorflow_models_tpu_torch.ops.conv import Dense
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.embed import TokenEmbed
from distributed_tensorflow_models_tpu_torch.parallel import moe as moelib
from distributed_tensorflow_models_tpu_torch.parallel import tensor as tensorlib


def _not_ported(what: str):
    return NotImplementedError(f"transformer_lm: {what} is not ported yet")


DECODE_DENSE_ONLY = ("decode mode supports the dense non-pipelined stack "
                     "without a sequence-parallel attention_fn")
WINDOW_IN_CLOSURE = (
    "attn_window is not threaded through the harness's sequence-parallel "
    "attention_fn closures — training would use full causal attention "
    "while decode applies the window.  (ring_attention/ulysses_attention "
    "DO accept window= at the library level; pass a closure that sets it "
    "and leave attn_window unset here.)")


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
    number of positions written so far, ``index`` (a 0-d int64 tensor on
    the cache's device: the JAX package's ``cache_index`` of every block
    and the model's ``pos_index``).  A decode forward writes its rows and
    advances ``index`` in place; :meth:`reorder` gathers the rows of the
    batch in place (beam search's parents)."""

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
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
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
        """``cache``: ``(keys, values, index)`` of this block, in decode."""
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
        q = self.query(x).reshape(B, T, H, Dh)
        k = self.key(x).reshape(B, T, Hkv, Dh)
        v = self.value(x).reshape(B, T, Hkv, Dh)
        if cache is not None:
            ck, cv, index = cache
            pos = index + torch.arange(T, device=x.device)
            if self.use_rope:
                q = rotary.apply_rope(q, pos, self.rope_theta)
                k = rotary.apply_rope(k, pos, self.rope_theta)
            ck.index_copy_(1, pos, k.to(ck.dtype))
            cv.index_copy_(1, pos, v.to(cv.dtype))
            out = attnlib.reference_attention(q, ck, cv, causal=True,
                                              q_offset=index,
                                              window=self.attn_window)
        else:
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
    seq processes.
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

    def forward(self, x):
        params = {"router": self.router, "w_in": self.w_in,
                  "w_out": self.w_out}
        res = moelib.moe_ffn(params, x, capacity_factor=self.capacity_factor)
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
        x = x + self.attn(self.ln1(x).to(self.dtype), train, rngs, cache)
        h = self.ln2(x).to(self.dtype)
        if hasattr(self, "moe"):
            out, aux = self.moe(h)
            return x + out, aux
        return x + self.mlp(h, train, rngs)


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
                 pipelined: bool = False, remat: bool = False,
                 decode: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attention_fn=None):
        super().__init__()
        if decode and (pipelined or num_experts or attention_fn is not None):
            raise ValueError(DECODE_DENSE_ONLY)
        if attn_window is not None and attention_fn is not None:
            raise ValueError(WINDOW_IN_CLOSURE)
        if pipelined:
            raise _not_ported("the pipelined block stack")
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
        for i in range(num_layers):
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
        The MoE stack has no decode mode (the JAX ``ValueError``)."""
        if self.num_experts:
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
        if cache is not None and (self.num_experts
                                  or self.attention_fn is not None):
            raise ValueError(DECODE_DENSE_ONLY)
        x = self.embedding(tokens)
        if cache is not None:
            pos = cache.index + torch.arange(T, device=tokens.device)
            if self.pos_embedding is not None:
                x = x + self.pos_embedding.index_select(0, pos).to(self.dtype)
        elif self.pos_embedding is not None:
            off = position_offset(T)
            if off + T > self.max_len:
                raise ValueError(f"sequence length {off + T} exceeds "
                                 f"max_len {self.max_len}")
            x = x + self.pos_embedding[off:off + T].to(self.dtype)
        x = dropout(x, self.dropout_rate, train, rngs)
        for i in range(self.num_layers):
            block = getattr(self, f"blocks_{i}")
            if cache is not None:
                x = block(x, train, rngs,
                          (cache.keys[i], cache.values[i], cache.index))
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
        x = self.ln_f(x)
        if return_hidden:
            return x, carry
        return self.head(x), carry


@register("transformer_lm")
def build_transformer_lm(**kwargs) -> TransformerLM:
    return TransformerLM(**kwargs)
