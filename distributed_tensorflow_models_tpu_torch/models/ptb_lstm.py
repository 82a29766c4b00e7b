"""PTB LSTM language model (Zaremba et al. 2014): truncated BPTT over
``num_steps`` tokens, the carry of each segment threaded into the next.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/models/ptb_lstm.py``,
with its layout:
- ``embedding.embedding`` and dropout on its output;
- per layer ``l``, the input-to-hidden projection ``lstm_{l}_ih`` (kernel
  and the gates' one bias) for every timestep as one matmul, then a
  Python loop over time (JAX's ``nn.scan``) adding the recurrent product
  with ``lstm_{l}.hh.kernel`` (no bias; one kernel for all steps, as the
  scan broadcasts it), gates fused i|f|g|o, and dropout on the layer's
  output sequence;
- c and h in f32 whatever ``dtype`` (the long additive recurrence bf16
  would lose), h cast to ``dtype`` for the next layer;
- an f32 ``head``, or the last layer's output with ``return_hidden`` for
  the fused chunked head.

The recurrent kernel is orthogonal per h x h gate block, drawn from the
explicit generator.  ``forward`` returns ``(logits, new_carry)``; the
carry is a tuple of ``(c, h)`` per layer, each ``[B, hidden]`` f32.  Its
matmuls are plain products, as the JAX package leaves them to XLA: the
LSTM runs no hand-written kernel.

Under ``lstm_tp`` (``parallel/tensor.py``) ``lstm_<l>_ih`` and the
recurrent ``lstm_<l>.hh`` are column-parallel over the model axis: each
process computes its block of the fused gates' columns and all-gathers
them, ``hh`` once every time step; the embedding gathers its columns and
the head its logits, so the carry stays whole on every process.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops.conv import Dense
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.embed import TokenEmbed

Carry = tuple[tuple[torch.Tensor, torch.Tensor], ...]


def blockwise_orthogonal(shape, generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """An orthogonal ``[h, h]`` matrix per gate block of a fused ``[h, 4h]``
    recurrent kernel (flax's ``orthogonal`` initializer: the Q of a
    Gaussian matrix, its columns signed by R's diagonal)."""
    h, four_h = shape
    blocks = []
    for _ in range(four_h // h):
        q, r = torch.linalg.qr(torch.randn(h, h, generator=generator))
        blocks.append(q * torch.sign(torch.diagonal(r)))
    return torch.cat(blocks, dim=1)


class _RecurrentCore(nn.Module):
    """The sequential part of one layer: consumes the precomputed input
    gates ``gx [B, T, 4h]`` one timestep at a time."""

    def __init__(self, hidden_size: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.hh = Dense(hidden_size, 4 * hidden_size, dtype=dtype,
                        use_bias=False, kernel_init=blockwise_orthogonal,
                        generator=generator)

    def forward(self, carry, gx):
        c, h = carry
        kernel = self.hh.kernel.to(self.dtype)
        tp = self.hh.tp
        outs = []
        for t in range(gx.shape[1]):
            if tp is None:
                gh = torch.matmul(h.to(self.dtype), kernel)
            else:
                # Column-parallel under lstm_tp: this process's gate columns
                # of the product, gathered over the model axis every step.
                gh = tp.exit(torch.matmul(tp.enter(h.to(self.dtype)), kernel))
            gates = (gx[:, t] + gh).float()
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)  # f32, like c
            outs.append(h.to(self.dtype))
        return (c, h), torch.stack(outs, dim=1)


class PTBLSTM(nn.Module):
    """Input ``tokens [B, T]`` int and a carry; returns ``(logits [B, T,
    V], new_carry)``."""

    def __init__(self, vocab_size: int = 10000, hidden_size: int = 650,
                 num_layers: int = 2, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.embedding = TokenEmbed(vocab_size, hidden_size, dtype=dtype,
                                    generator=generator)
        for layer in range(num_layers):
            self.add_module(f"lstm_{layer}_ih", Dense(
                hidden_size, 4 * hidden_size, dtype=dtype,
                generator=generator))
            self.add_module(f"lstm_{layer}", _RecurrentCore(
                hidden_size, dtype, generator))
        self.head = Dense(hidden_size, vocab_size, dtype=torch.float32,
                          generator=generator)

    def initial_carry(self, batch_size: int,
                      device: Optional[torch.device] = None) -> Carry:
        """Zeros, f32 whatever the compute dtype."""
        def zeros():
            return torch.zeros(batch_size, self.hidden_size,
                               dtype=torch.float32, device=device)

        return tuple((zeros(), zeros()) for _ in range(self.num_layers))

    def forward(self, tokens, carry: Optional[Carry] = None,
                train: bool = False, return_hidden: bool = False, rngs=None):
        if carry is None:
            carry = self.initial_carry(tokens.shape[0], tokens.device)
        x = dropout(self.embedding(tokens), self.dropout_rate, train, rngs)
        new_carry = []
        for layer in range(self.num_layers):
            gx = getattr(self, f"lstm_{layer}_ih")(x)  # [B, T, 4h]
            c_out, x = getattr(self, f"lstm_{layer}")(tuple(carry[layer]),
                                                      gx)
            new_carry.append(c_out)
            x = dropout(x, self.dropout_rate, train, rngs)
        if return_hidden:
            return x, tuple(new_carry)
        return self.head(x), tuple(new_carry)


# The three Zaremba configs.
PTB_CONFIGS = {
    "small": dict(hidden_size=200, dropout_rate=0.0),
    "medium": dict(hidden_size=650, dropout_rate=0.5),
    "large": dict(hidden_size=1500, dropout_rate=0.65),
}


@register("ptb_lstm")
def build_ptb_lstm(config: str = "medium", **kwargs) -> PTBLSTM:
    return PTBLSTM(**{**PTB_CONFIGS[config], **kwargs})
