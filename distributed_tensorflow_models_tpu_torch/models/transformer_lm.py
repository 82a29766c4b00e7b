"""Decoder-only transformer LM: the dense, non-pipelined stack.

PyTorch counterpart of
``distributed_tensorflow_models_tpu/models/transformer_lm.py``: pre-LN
causal blocks (LayerNorm -> self-attention -> residual, LayerNorm -> GELU
MLP -> residual) over a token embedding plus a learned position table, a
final LayerNorm and an f32 head.  Attention goes through
:func:`...ops.attention.attention` (``attn_impl`` auto / reference /
blockwise / flash; flash runs kernels K2-K4 on the card).

flax's defaults are kept where PyTorch's differ: LayerNorm eps 1e-6,
statistics ``E[x^2] - E[x]^2`` in f32 and an f32 output; GELU in its tanh
form; ``Dense(dtype=bf16)`` casts input, kernel and bias to bf16; the
position table is normal(0.02) and cast to the activation dtype before
the add.  Module and parameter names are the flax paths
(``blocks_0.attn.query.kernel``, ``embedding.embedding``,
``pos_embedding``...), so ``interop`` maps a flax tree onto the state
dict name for name.  Decode (KV cache), MoE, the pipelined stack, rotary
positions and remat are not ported yet and raise.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops.conv import Dense
from distributed_tensorflow_models_tpu_torch.ops.embed import TokenEmbed


def _not_ported(what: str):
    return NotImplementedError(f"transformer_lm: {what} is not ported yet")


def _dropout(x: torch.Tensor, rate: float, train: bool,
             rngs: Optional[Mapping[str, torch.Generator]]) -> torch.Tensor:
    """``flax.linen.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate).  Its bits come from ``rngs['dropout']``
    and differ from JAX's."""
    if not rate or not train:
        return x
    if not rngs or "dropout" not in rngs:
        raise ValueError("dropout in training needs rngs={'dropout': gen}")
    keep = torch.rand(x.shape, generator=rngs["dropout"],
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
    ``key``/``value`` (``num_kv_heads`` heads, GQA when fewer), attention,
    ``out``, dropout."""

    def __init__(self, num_heads: int, d_model: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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

    def forward(self, x, train: bool = False, rngs=None):
        B, T, _ = x.shape
        H, Hkv, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.query(x).reshape(B, T, H, Dh)
        k = self.key(x).reshape(B, T, Hkv, Dh)
        v = self.value(x).reshape(B, T, Hkv, Dh)
        out = attnlib.attention(q, k, v, causal=True, impl=self.attn_impl,
                                window=self.attn_window)
        out = self.out(out.reshape(B, T, self.d_model))
        return _dropout(out, self.dropout_rate, train, rngs)


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
        return _dropout(self.down(h), self.dropout_rate, train, rngs)


class Block(nn.Module):
    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dropout_rate: float, dtype: torch.dtype, attn_impl: str,
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(d_model)
        self.attn = SelfAttention(num_heads, d_model, dropout_rate, dtype,
                                  attn_impl, num_kv_heads, attn_window,
                                  generator)
        self.ln2 = LayerNorm(d_model)
        self.mlp = MLP(d_model, d_ff, dropout_rate, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None):
        x = x + self.attn(self.ln1(x).to(self.dtype), train, rngs)
        return x + self.mlp(self.ln2(x).to(self.dtype), train, rngs)


class TransformerLM(nn.Module):
    """Input ``tokens [B, T]`` int; returns ``(logits [B, T, V], carry)``.
    The carry passes through unchanged (the LM train-step contract shared
    with the PTB LSTM).  ``return_hidden=True`` returns the post-``ln_f``
    hidden states instead of logits, for the fused chunked head."""

    def __init__(self, vocab_size: int = 10000, num_layers: int = 4,
                 num_heads: int = 8, d_model: int = 256, d_ff: int = 1024,
                 max_len: int = 1024, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 num_kv_heads: int = 0, attn_window: Optional[int] = None,
                 pos_encoding: str = "learned", num_experts: int = 0,
                 pipelined: bool = False, remat: bool = False,
                 decode: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decode:
            raise _not_ported("decode mode (the KV cache)")
        if num_experts:
            raise _not_ported("the MoE FFN (num_experts > 0)")
        if pipelined:
            raise _not_ported("the pipelined block stack")
        if remat:
            raise _not_ported("remat")
        if pos_encoding != "learned":
            raise _not_ported(f"pos_encoding={pos_encoding!r}")
        attnlib._check_window(attn_window)
        self.dtype = dtype
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.max_len = max_len
        self.embedding = TokenEmbed(vocab_size, d_model, dtype=dtype,
                                    generator=generator)
        self.pos_embedding = nn.Parameter(torch.empty(max_len, d_model))
        with torch.no_grad():
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        for i in range(num_layers):
            self.add_module(f"blocks_{i}", Block(
                num_heads, d_model, d_ff, dropout_rate, dtype, attn_impl,
                num_kv_heads, attn_window, generator))
        self.ln_f = LayerNorm(d_model)
        self.head = Dense(d_model, vocab_size, dtype=torch.float32,
                          generator=generator)

    def forward(self, tokens, carry=None, train: bool = False,
                return_hidden: bool = False,
                rngs: Optional[Mapping[str, torch.Generator]] = None):
        T = tokens.shape[1]
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len "
                             f"{self.max_len}")
        x = self.embedding(tokens)
        x = x + self.pos_embedding[:T].to(self.dtype)
        x = _dropout(x, self.dropout_rate, train, rngs)
        for i in range(self.num_layers):
            x = getattr(self, f"blocks_{i}")(x, train, rngs)
        x = self.ln_f(x)
        if return_hidden:
            return x, carry
        return self.head(x), carry


@register("transformer_lm")
def build_transformer_lm(**kwargs) -> TransformerLM:
    return TransformerLM(**kwargs)
