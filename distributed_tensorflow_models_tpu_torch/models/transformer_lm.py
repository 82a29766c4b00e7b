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
dict name for name.  MoE, the pipelined stack and remat are not ported
yet and raise.

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

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops import rotary
from distributed_tensorflow_models_tpu_torch.ops.conv import Dense
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.embed import TokenEmbed


def _not_ported(what: str):
    return NotImplementedError(f"transformer_lm: {what} is not ported yet")


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
    rotated by their positions ``0..T-1`` when ``use_rope``, attention,
    ``out``, dropout."""

    def __init__(self, num_heads: int, d_model: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
                pos = torch.arange(T, device=x.device)
                q = rotary.apply_rope(q, pos, self.rope_theta)
                k = rotary.apply_rope(k, pos, self.rope_theta)
            out = attnlib.attention(q, k, v, causal=True,
                                    impl=self.attn_impl,
                                    window=self.attn_window)
        out = self.out(out.reshape(B, T, self.d_model))
        return dropout(out, self.dropout_rate, train, rngs)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.up = Dense(d_model, d_ff, dtype=dtype, generator=generator)
        self.down = Dense(d_ff, d_model, dtype=dtype, generator=generator)

    def forward(self, x, train: bool = False, rngs=None):
        h = F.gelu(self.up(x), approximate="tanh")
        return dropout(self.down(h), self.dropout_rate, train, rngs)


class Block(nn.Module):
    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dropout_rate: float, dtype: torch.dtype, attn_impl: str,
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(d_model)
        self.attn = SelfAttention(num_heads, d_model, dropout_rate, dtype,
                                  attn_impl, num_kv_heads, attn_window,
                                  use_rope, rope_theta, generator)
        self.ln2 = LayerNorm(d_model)
        self.mlp = MLP(d_model, d_ff, dropout_rate, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None, cache=None):
        x = x + self.attn(self.ln1(x).to(self.dtype), train, rngs, cache)
        return x + self.mlp(self.ln2(x).to(self.dtype), train, rngs)


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
                 num_experts: int = 0,
                 pipelined: bool = False, remat: bool = False,
                 decode: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decode and (pipelined or num_experts):
            raise ValueError("decode mode supports the dense non-pipelined "
                             "stack")
        if num_experts:
            raise _not_ported("the MoE FFN (num_experts > 0)")
        if pipelined:
            raise _not_ported("the pipelined block stack")
        if remat:
            raise _not_ported("remat")
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {pos_encoding!r} "
                             "(want 'learned' or 'rope')")
        attnlib._check_window(attn_window)
        self.dtype = dtype
        self.decode = decode
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
                rope_theta, generator))
        self.ln_f = LayerNorm(d_model)
        self.head = Dense(d_model, vocab_size, dtype=torch.float32,
                          generator=generator)

    def init_cache(self, batch_size: int,
                   device: Optional[str | torch.device] = None) -> KVCache:
        """An empty cache for ``batch_size`` rows: zeros of ``[B, max_len,
        num_kv_heads, head_dim]`` in the model's dtype per block, index 0."""
        shape = (batch_size, self.max_len, self.num_kv_heads, self.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=device)

        return KVCache([zeros() for _ in range(self.num_layers)],
                       [zeros() for _ in range(self.num_layers)],
                       torch.zeros((), dtype=torch.int64, device=device))

    def forward(self, tokens, carry=None, train: bool = False,
                return_hidden: bool = False,
                rngs: Optional[Mapping[str, torch.Generator]] = None,
                cache: Optional[KVCache] = None):
        T = tokens.shape[1]
        if self.decode and cache is None:
            raise ValueError("decode mode needs a KVCache (model.init_cache)")
        x = self.embedding(tokens)
        if cache is not None:
            pos = cache.index + torch.arange(T, device=tokens.device)
            if self.pos_embedding is not None:
                x = x + self.pos_embedding.index_select(0, pos).to(self.dtype)
        elif self.pos_embedding is not None:
            if T > self.max_len:
                raise ValueError(f"sequence length {T} exceeds max_len "
                                 f"{self.max_len}")
            x = x + self.pos_embedding[:T].to(self.dtype)
        x = dropout(x, self.dropout_rate, train, rngs)
        for i in range(self.num_layers):
            block_cache = (None if cache is None else
                           (cache.keys[i], cache.values[i], cache.index))
            x = getattr(self, f"blocks_{i}")(x, train, rngs, block_cache)
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
