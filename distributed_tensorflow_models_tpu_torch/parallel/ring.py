"""Sequence parallelism: ring attention and Ulysses all-to-all.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/parallel/ring.py``.
The sequence of a language model's batch is split into column blocks over
the ``seq`` mesh axis (``core/sharding.py::seq_split``): each process
holds the queries, keys and values of its block, ``[B, Tl, H, D]`` (BTHD,
``Tl = T / n``), and attention runs over the whole sequence, its causal
mask and window in global positions.  Both functions take and return this
process's block.

- :func:`ring_attention` — the KV blocks rotate around the ring
  (``sharding.ring``: one send to the next process and one receive from
  the previous per rotation, K and V together at ``H_kv`` width, ``n - 1``
  rotations: the last block received is sent on no more) while
  each process folds every visiting block into its streaming-softmax
  state.  The arithmetic of one rotation is :func:`ring_step`, a function
  of ``(carry, q, k_r, v_r, q_off, kv_off)`` apart from the
  communication, so a single process can drive a ring's ranks one after
  the other (``chip_smoke.py`` phase 17).  Its three impls:

  * ``fold`` — the streaming-softmax fold in f32 (the recurrence of
    ``ops/attention.py::_block_update``), query groups folded into rows
    so KV is never repeated, and a rotation whose block is wholly masked
    (in the future of every query, or older than every query's window)
    skipped;
  * ``flash`` — ``ops/attention.py::flash_attention_chunk`` per visiting
    block at the global offsets ``q_off = rank_seq * Tl``, ``kv_off =
    src * Tl``: kernel K2 forward and K3 + K4 backward on the card (the
    chunk API's backward is the pair, never K5), every rotation, wholly
    masked ones too (such a block gives ``lse = NEG_INF`` and out 0, so
    it weighs nothing in the merge).  The ``(out, lse)`` pairs merge by
    the JAX package's log-sum-exp recurrence;
  * ``auto`` — ``flash`` on a CUDA tensor in bf16 at a head dim the
    kernels have (32, 64, 128), whatever the block length ``Tl`` (the
    kernels mask the rows past a partial tile); ``fold`` otherwise (on
    the CPU always), as the JAX package takes its Pallas kernel on the
    TPU and the fold elsewhere.  ``flash`` asked for by name never
    folds: on the card a tensor the kernels do not take raises.

  Each rotation's arithmetic runs under ``ops/remat.py::checkpoint`` when
  the ring has more than one process (the JAX package checkpoints each
  rotation's body): the backward recomputes it, so the memory kept is
  the O(T/n) blocks and carries, not every rotation's scores or kernel
  residuals.  A ring of one keeps its one step (there is nothing to
  stack), so the flash ring of one launches K2 once.
- :func:`ulysses_attention` — ``all_to_all_single`` (``sharding.
  all_to_all``) scatters the heads and gathers the sequence, ``[B, Tl, H,
  D] -> [B, T, H/n, D]``, for q, k and v in one exchange (GQA at its
  native ``H_kv``), the local attention runs through
  ``ops/attention.py::attention`` (kernels K2-K4 under ``impl="flash"``),
  and one more exchange puts the output back: two exchanges forward, two
  in the backward.  Both head counts must divide by the axis.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.core.mesh import AxisNames, Mesh
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops import remat as rematlib

RING_IMPLS = ("auto", "fold", "flash")


def split_sequence(x: torch.Tensor, mesh: Mesh,
                   seq_axis: str = AxisNames.SEQ) -> torch.Tensor:
    """This process's block of a global ``[B, T, ...]`` tensor over the
    seq axis; an indivisible ``T`` raises the JAX package's error."""
    n = mesh.shape[seq_axis]
    if x.shape[1] % n:
        raise ValueError(f"seq len {x.shape[1]} not divisible by seq axis "
                         f"{n}")
    Tl = x.shape[1] // n
    i = mesh.coord(seq_axis)
    return x[:, i * Tl:(i + 1) * Tl]


def fully_masked(q_off: int, kv_off: int, Tq: int, Tkv: int, causal: bool,
                 window: Optional[int]) -> bool:
    """True when no query of the block at ``q_off`` sees any key of the
    block at ``kv_off``: every key in its future (causal), or older than
    every query's window."""
    masked = causal and kv_off > q_off + Tq - 1
    if window is not None:
        masked = masked or q_off - (kv_off + Tkv - 1) >= window
    return masked


def resolve_impl(impl: str, q: torch.Tensor) -> str:
    """``auto`` made concrete for ``q``, this process's block (module
    docstring); an unknown impl raises the JAX package's error."""
    if impl not in RING_IMPLS:
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if impl != "auto":
        return impl
    fits = (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and q.shape[-1] in attnlib._HEAD_DIMS)
    return "flash" if fits else "fold"


def ring_init(q: torch.Tensor, k: torch.Tensor, impl: str):
    """The empty streaming-softmax state of a ring over ``q``'s block:
    ``(m, l, acc)`` in f32, m at NEG_INF; ``[B, H_kv, g Tl, ...]`` with
    the query groups folded into rows for ``fold``, ``[B, Tl, H, ...]``
    for ``flash``."""
    B, Tl, H, D = q.shape
    if impl == "fold":
        rows = (B, k.shape[2], H // k.shape[2] * Tl)
        m = torch.full((*rows, 1), attnlib.NEG_INF, dtype=torch.float32,
                       device=q.device)
        return m, torch.zeros_like(m), torch.zeros(
            (*rows, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Tl, H), attnlib.NEG_INF, dtype=torch.float32,
                   device=q.device)
    return m, torch.zeros_like(m), torch.zeros(
        (B, Tl, H, D), dtype=torch.float32, device=q.device)


def _fold_q(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """``[B, Tl, H, D] -> [B, H_kv, g Tl, D]``: head ``h`` in KV head
    ``h // g``'s rows (the kernels' ``_kv_row`` mapping); row ``r`` sits
    at position ``r % Tl``."""
    B, Tl, H, D = q.shape
    return q.transpose(1, 2).reshape(B, Hkv, (H // Hkv) * Tl, D)


def ring_step(carry, q, k_r, v_r, q_off: int, kv_off: int, *, impl: str,
              causal: bool, scale: Optional[float],
              window: Optional[int]):
    """One rotation's arithmetic: the KV block ``(k_r, v_r)`` at global
    offset ``kv_off`` folded into ``carry`` (:func:`ring_init`) for the
    queries ``q`` at ``q_off``; returns the new carry.  ``impl`` is
    ``fold`` or ``flash`` (:func:`resolve_impl`)."""
    m, l, acc = carry
    if impl == "flash":
        o_r, lse_r = attnlib.flash_attention_chunk(
            q, k_r, v_r, q_off, kv_off, causal=causal, scale=scale,
            window=window)
        m_new = torch.maximum(m, lse_r)
        alpha = torch.exp(m - m_new)
        w_r = torch.exp(lse_r - m_new)
        l = alpha * l + w_r
        acc = acc * alpha[..., None] + o_r.float() * w_r[..., None]
        return m_new, l, acc
    Tl, Tkv, Hkv = q.shape[1], k_r.shape[1], k_r.shape[2]
    qf = _fold_q(q, Hkv)
    s = torch.einsum("bhqd,bkhd->bhqk", qf.float(), k_r.float()) * (
        attnlib._scale(q, scale))
    if causal or window is not None:
        qi = q_off + (torch.arange(qf.shape[2], device=q.device) % Tl)[:,
                                                                       None]
        kj = kv_off + torch.arange(Tkv, device=q.device)[None, :]
        valid = qi >= kj if causal else torch.ones_like(qi >= kj)
        if window is not None:
            valid = valid & (qi - kj < window)
        s = torch.where(valid, s, torch.full_like(s, attnlib.NEG_INF))
    return attnlib._block_update((m, l, acc), s, v_r.transpose(1, 2))


def ring_finish(carry, q: torch.Tensor, impl: str) -> torch.Tensor:
    """The output block ``[B, Tl, H, D]`` in q's dtype from the final
    carry: ``acc / max(l, 1e-30)``."""
    m, l, acc = carry
    if impl == "flash":
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    B, Tl, H, D = q.shape
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Tl, D).transpose(1, 2).to(q.dtype)


def _checked(q, k, window):
    attnlib._group_size(q, k)  # H % H_kv == 0
    return attnlib._check_window(window)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Optional[Mesh], *, causal: bool = False,
                   scale: Optional[float] = None, impl: str = "auto",
                   window: Optional[int] = None,
                   seq_axis: str = AxisNames.SEQ) -> torch.Tensor:
    """Attention over the whole sequence for this process's block of it
    (module docstring): ``q [B, Tl, H, D]``, ``k``/``v [B, Tl, H_kv, D]``
    at global positions ``rank_seq * Tl ..``; returns the output block.
    ``impl`` is ``auto``, ``fold`` or ``flash``."""
    window = _checked(q, k, window)
    impl = resolve_impl(impl, q)
    n = 1 if mesh is None else mesh.shape[seq_axis]
    my = 0 if mesh is None else mesh.coord(seq_axis)
    Tl = q.shape[1]
    q_off = my * Tl
    step = functools.partial(ring_step, impl=impl, causal=causal,
                             scale=scale, window=window)
    carry = ring_init(q, k, impl)
    for r, (k_r, v_r) in enumerate(shardlib.ring((k, v), mesh, seq_axis,
                                                 "ring_kv")):
        kv_off = ((my - r) % n) * Tl
        if impl == "fold" and fully_masked(q_off, kv_off, Tl, k_r.shape[1],
                                           causal, window):
            continue
        if n > 1:
            carry = rematlib.checkpoint(step, carry, q, k_r, v_r, q_off,
                                        kv_off)
        else:
            carry = step(carry, q, k_r, v_r, q_off, kv_off)
    return ring_finish(carry, q, impl)


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int, *,
            impl: str, causal: bool = False, scale: Optional[float] = None,
            window: Optional[int] = None,
            dout: Optional[torch.Tensor] = None):
    """A ring of ``n`` processes driven in this one, one virtual rank after
    the other: the global ``q``, ``k``, ``v`` cut into ``n`` blocks, each
    virtual rank folding the KV blocks in the order it would receive them
    through :func:`ring_step` (skipping what :func:`ring_attention` skips).
    Returns the output ``[B, T, H, D]``; with ``dout``, ``(out, dq, dk,
    dv)``, the KV gradients of each block summed in the order the ring's
    backward sums them (``sharding._Ring``), so that every value can
    equal the ring's across processes bit for bit."""
    window = _checked(q, k, window)
    impl = resolve_impl(impl, q)
    Tl = q.shape[1] // n
    grad = dout is not None

    def block(x, i):
        return x[:, i * Tl:(i + 1) * Tl].detach().requires_grad_(grad)

    qs = [block(q, i) for i in range(n)]
    used: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
    outs = []
    step = functools.partial(ring_step, impl=impl, causal=causal,
                             scale=scale, window=window)
    for i in range(n):
        carry = ring_init(qs[i], k, impl)
        for r in range(n):
            src = (i - r) % n
            if impl == "fold" and fully_masked(i * Tl, src * Tl, Tl, Tl,
                                               causal, window):
                continue
            k_r, v_r = block(k, src), block(v, src)
            used[(i, r)] = (k_r, v_r)
            carry = step(carry, qs[i], k_r, v_r, i * Tl, src * Tl)
        outs.append(ring_finish(carry, qs[i], impl))
    out = torch.cat(outs, dim=1)
    if not grad:
        return out.detach()
    torch.autograd.backward(outs, [dout[:, i * Tl:(i + 1) * Tl]
                                   for i in range(n)])

    def g(i, r, j):
        kv = used.get((i % n, r))
        if kv is None or kv[j].grad is None:
            return torch.zeros_like(k[:, :Tl])
        return kv[j].grad

    dkv = []
    for j in range(2):
        blocks = []
        for s in range(n):
            acc = g(s + n - 1, n - 1, j)
            for r in range(n - 2, -1, -1):
                acc = acc + g(s + r, r, j)
            blocks.append(acc)
        dkv.append(torch.cat(blocks, dim=1))
    dq = torch.cat([x.grad for x in qs], dim=1)
    return out.detach(), dq, dkv[0], dkv[1]


def _scatter_heads(xs, mesh: Mesh, axis: str, site: str):
    """Each ``[B, Tl, H_x, D]`` of ``xs`` -> ``[B, n Tl, H_x/n, D]``: head
    block ``j`` to process ``j``, the sequence blocks received concatenated
    in process order; the tensors' blocks travel together in one
    exchange."""
    B, Tl, _, D = xs[0].shape
    n = mesh.shape[axis]
    widths = [x.shape[2] // n for x in xs]
    blocks = torch.cat([x.reshape(B, Tl, n, w, D) for x, w in
                        zip(xs, widths)], dim=3).permute(2, 0, 1, 3, 4)
    got = shardlib.all_to_all(blocks.contiguous(), mesh, axis, site)
    got = got.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, sum(widths), D)
    return got.split(widths, dim=2)


def _gather_heads(x: torch.Tensor, mesh: Mesh, axis: str, site: str):
    """``[B, n Tl, H/n, D] -> [B, Tl, H, D]``, the inverse exchange."""
    B, T, Hn, D = x.shape
    n = mesh.shape[axis]
    blocks = x.reshape(B, n, T // n, Hn, D).permute(1, 0, 2, 3, 4)
    got = shardlib.all_to_all(blocks.contiguous(), mesh, axis, site)
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hn, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Optional[Mesh], *, causal: bool = False,
                      scale: Optional[float] = None,
                      impl: str = "blockwise",
                      window: Optional[int] = None,
                      seq_axis: str = AxisNames.SEQ) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style) on this
    process's block (module docstring).  Both the query and KV head counts
    must divide by the seq axis's size.  A contiguous head split keeps the
    ``h // g`` group mapping on every process (local head ``h'`` of
    process ``p`` is global ``p H/n + h'``, whose KV head is local
    ``h' // g`` of the same process), so the local attention sees a
    self-consistent GQA problem."""
    n = 1 if mesh is None else mesh.shape[seq_axis]
    H, Hkv = q.shape[2], k.shape[2]
    attnlib._group_size(q, k)
    if H % n or Hkv % n:
        raise ValueError(
            f"query heads {H} and kv heads {Hkv} must both divide by the "
            f"seq axis size {n} (the all_to_all splits the head axis)")
    window = attnlib._check_window(window)
    if n == 1:
        return attnlib.attention(q, k, v, causal=causal, scale=scale,
                                 impl=impl, window=window)
    qh, kh, vh = _scatter_heads((q, k, v), mesh, seq_axis, "ulysses_qkv")
    out = attnlib.attention(qh, kh, vh, causal=causal, scale=scale,
                            impl=impl, window=window)
    return _gather_heads(out, mesh, seq_axis, "ulysses_out")
