"""Attention: reference, blockwise, and flash (kernels K2 to K5).

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/attention.py``,
with the same API and the layout ``[batch, seq, heads, head_dim]`` (BTHD)
everywhere:

- :func:`reference_attention` — O(T^2) materialised scores; the oracle.
- :func:`blockwise_attention` — a loop over KV blocks with the running
  (max, sum, acc) recurrence of :func:`_block_update`, differentiated by
  autograd through the loop; the ``auto`` default.
- :func:`flash_attention` / :func:`flash_attention_chunk` —
  ``torch.autograd.Function``s whose forward is K2 and whose backward is
  K3 (dK, dV) then K4 (dQ), or with ``bwd_staged`` (``DTM_FLASH_BWD=staged``)
  K5: the dKV launch that also stages each dS tile in an O(T^2) bf16
  buffer, then the dQ launch that reads it back instead of rebuilding S
  and P; all in ``csrc/flash_attention.cu``.  On CPU tensors each runs its
  plain version beside it here (:func:`_flash_forward_reference`,
  :func:`_flash_dkv_reference`, :func:`_flash_dq_reference`,
  :func:`_flash_dkv_staged_reference`, :func:`_flash_dq_staged_reference`);
  on CUDA tensors it launches the kernel or raises.

The public ``block_q``/``block_kv``, ``_check_blocks``' divisibility rule
and ``DTM_FLASH_TILE`` keep their JAX meaning and validation here.  The
kernels choose their own tiles for the card: K2 128 x 128 (its loop over
KV tiles is :func:`_kv_tile_range`), K3-K5 64 x 64.  The tile changes which
fully-masked tiles are visited, and so only the values of rows with no
valid key at all, which are documented garbage in both packages
(:func:`_check_window`).
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Optional

import torch

from . import _kernels

NEG_INF = -1e30  # finite "-inf": keeps exp(s - m) well-defined in masked rows
_SOURCE = "flash_attention.cu"
_HEAD_DIMS = (32, 64, 128)


def _scale(q, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def _check_window(window: Optional[int]) -> Optional[int]:
    """A window must cover at least the query itself: with the finite
    NEG_INF an all-masked row would silently get uniform attention."""
    if window is not None and window < 1:
        raise ValueError(f"attention window must be >= 1, got {window}")
    return window


def _group_size(q, k) -> int:
    """Grouped-query attention from the shapes: ``H % H_kv == 0`` query
    heads share each KV head in groups of ``H / H_kv``."""
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"query heads {H} not divisible by kv heads {Hkv}")
    return H // Hkv


def _kv_row(H: int, Hkv: int, g: int):
    """Flat query-head row (b*H + h) -> its KV head row (b*H_kv + h//g):
    the one mapping the kernels use (``h / group`` in the CUDA source)."""
    return lambda b: (b // H) * Hkv + (b % H) // g


def _expand_kv(q, k, v):
    """Gather each query head's KV head by :func:`_kv_row` (the plain GQA
    path; the kernels index the KV head instead)."""
    H, Hkv = q.shape[2], k.shape[2]
    g = _group_size(q, k)
    if g == 1:
        return k, v
    rows = _kv_row(H, Hkv, g)
    idx = torch.tensor([rows(h) for h in range(H)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _valid(Tq: int, Tkv: int, causal: bool, window: Optional[int],
           q_offset: int, kv_offset: int, device) -> Optional[torch.Tensor]:
    """``[Tq, Tkv]`` mask in global positions, or None when nothing is
    masked."""
    if not causal and window is None:
        return None
    qi = q_offset + torch.arange(Tq, device=device)[:, None]
    kj = kv_offset + torch.arange(Tkv, device=device)[None, :]
    valid = qi >= kj if causal else torch.ones(Tq, Tkv, dtype=torch.bool,
                                               device=device)
    if window is not None:
        valid = valid & (qi - kj < window)
    return valid


def _scores(q, k, scale: float, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``[B, H, Tq, Tkv]`` f32 scores: the product of the input-dtype
    values accumulated in f32 (bf16 products are exact in f32), times the
    scale in f32, masked to NEG_INF."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return s


def reference_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_offset: int = 0,
                        window: Optional[int] = None) -> torch.Tensor:
    """Materialised-scores attention, BTHD in and out.  ``q_offset`` and
    ``kv_offset`` are the global positions of the first query and key
    rows (a chunk of a longer sequence)."""
    s = _scale(q, scale)
    window = _check_window(window)
    k, v = _expand_kv(q, k, v)
    valid = _valid(q.shape[1], k.shape[1], causal, window, q_offset,
                   kv_offset, q.device)
    p = torch.softmax(_scores(q, k, s, valid), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


# --------------------------------------------------------------- blockwise


def _block_update(carry, s_block, v_block):
    """One step of the streaming-softmax recurrence over ``(m, l, acc)``:
    running row max and normalizer ``[..., q, 1]`` and the unnormalized
    output ``[..., q, d]``, all f32."""
    m, l, acc = carry
    m_new = torch.maximum(m, s_block.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s_block - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    # p V with p in the value dtype and f32 accumulation.
    acc_new = alpha * acc + torch.matmul(p.to(v_block.dtype).float(),
                                         v_block.float())
    return m_new, l_new, acc_new


def blockwise_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, block_kv: int = 512,
                        q_offset: int = 0, kv_offset: int = 0,
                        window: Optional[int] = None,
                        block_q: Optional[int] = None) -> torch.Tensor:
    """Attention as a loop over KV blocks, BTHD in and out; the same math
    as :func:`reference_attention`.  A KV length the block does not divide
    leaves a shorter last block.  Autograd stores each block's scores for
    the backward (the JAX package rematerialises them under
    ``jax.checkpoint``)."""
    if block_q is not None or os.environ.get("DTM_BLOCKWISE_QBLOCK"):
        raise NotImplementedError(
            "blockwise q-chunking (block_q / DTM_BLOCKWISE_QBLOCK) is not "
            "ported yet")
    window = _check_window(window)
    k, v = _expand_kv(q, k, v)
    Tq, Tkv = q.shape[1], k.shape[1]
    block_kv = min(block_kv, Tkv)
    s = _scale(q, scale)
    qf = q.transpose(1, 2)  # [B, H, Tq, D]
    kf = k.transpose(1, 2)
    vf = v.transpose(1, 2)
    qi = q_offset + torch.arange(Tq, device=q.device)[:, None]
    m = torch.full((*qf.shape[:-1], 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for lo in range(0, Tkv, block_kv):
        k_j = kf[:, :, lo:lo + block_kv]
        v_j = vf[:, :, lo:lo + block_kv]
        s_block = torch.matmul(qf.float(), k_j.float().transpose(-1, -2)) * s
        if causal or window is not None:
            kj = kv_offset + lo + torch.arange(k_j.shape[2],
                                               device=q.device)[None, :]
            valid = qi >= kj if causal else torch.ones_like(qi >= kj)
            if window is not None:
                valid = valid & (qi - kj < window)
            s_block = torch.where(valid, s_block,
                                  torch.full_like(s_block, NEG_INF))
        m, l, acc = _block_update((m, l, acc), s_block, v_j)
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


# --------------------------------------------------------- block predicates


def _block_should_run(i, j, q_base, kv_base, *, causal, block_q, block_kv,
                      window=None):
    """True iff ANY (q, k) pair of block (i, j) passes the causal/window
    mask: the tile-skip test of all three kernels."""
    should = True
    if causal:
        should = q_base + i * block_q + block_q - 1 >= kv_base + j * block_kv
    if window is not None:
        should = should & (q_base + i * block_q
                           - (kv_base + (j + 1) * block_kv - 1) < window)
    return should


def _block_fully_valid(i, j, q_base, kv_base, *, causal, block_q, block_kv,
                       window=None):
    """True iff EVERY (q, k) pair of block (i, j) passes the mask, so the
    per-element mask can be skipped."""
    full = True
    if causal:
        full = q_base + i * block_q >= kv_base + (j + 1) * block_kv - 1
    if window is not None:
        full = full & (q_base + i * block_q + block_q - 1
                       - (kv_base + j * block_kv) < window)
    return full


def _kv_tile_range(i, Tq, Tkv, bq, bkv, causal, window, q_offset,
                   kv_offset):
    """``(begin, end)``: the KV tiles ``j`` of ``bkv`` rows, begin <= j <
    end, for which :func:`_block_should_run` holds with query tile ``i`` of
    ``bq`` rows, in closed form: causality bounds the range above, the
    window below.  K2 loops over exactly this range; its device twin is
    ``kv_tile_range`` in ``csrc/flash_attention.cu``."""
    if not 0 <= i < -(-Tq // bq):
        raise ValueError(f"query tile {i} outside {Tq} rows of {bq}")
    q_lo = q_offset + i * bq
    lo, hi = 0, -(-Tkv // bkv)
    if causal:
        hi = min(hi, (q_lo + bq - 1 - kv_offset) // bkv + 1)
    if window is not None:
        lo = max(lo, (q_lo - kv_offset - bkv + 1 - window) // bkv + 1)
    return lo, max(lo, hi)


def _auto_block(T: int) -> int:
    """The JAX package's forward default tile: 256 where it divides."""
    return 256 if T % 256 == 0 else 128


def _auto_block_bwd(T: int) -> int:
    """The JAX package's backward default tile."""
    return 128 if T >= 128 else T


def _check_blocks(Tq, Tkv, block_q, block_kv):
    block_q = min(block_q if block_q is not None else _auto_block(Tq), Tq)
    block_kv = min(block_kv if block_kv is not None else _auto_block(Tkv),
                   Tkv)
    if Tq % block_q or Tkv % block_kv:
        raise ValueError(f"seq lens ({Tq},{Tkv}) not divisible by blocks "
                         f"({block_q},{block_kv})")
    return block_q, block_kv


# ----------------------------------------------- plain versions of K2-K4
# The same formulas and rounding points as the kernels, on materialised
# [B, H, Tq, Tkv] scores.  lse and delta are [B, H, Tq] f32 (the kernels'
# [B*H, Tq] rows).


def _flash_forward_reference(q, k, v, *, scale, causal, window, q_offset,
                             kv_offset):
    """Plain K2: ``(out [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32)``:
    P = exp(S - m) cast to V's dtype before P V, out = acc / max(l, 1e-30),
    lse = m + log(max(l, 1e-30))."""
    ke, ve = _expand_kv(q, k, v)
    valid = _valid(q.shape[1], k.shape[1], causal, window, q_offset,
                   kv_offset, q.device)
    s = _scores(q, ke, scale, valid)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), ve.float().transpose(1, 2))
    out = (acc / l).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def _p_and_ds(q, k, v, do, lse, delta, *, scale, causal, window, q_offset,
              kv_offset):
    """The backward recurrence of both gradient kernels on full scores:
    P = exp(S - LSE), dS = P * (dO V^T - delta), all f32; k, v expanded."""
    valid = _valid(q.shape[1], k.shape[1], causal, window, q_offset,
                   kv_offset, q.device)
    p = torch.exp(_scores(q, k, scale, valid) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _flash_dkv_reference(q, k, v, do, lse, delta, *, scale, causal, window,
                         q_offset, kv_offset):
    """Plain K3: per-query-head ``(dk, dv)`` as ``[B, Tkv, H, D]`` in k's
    and v's dtypes: dV = P(dO's dtype)^T dO, dK = scale * dS(q's dtype)^T
    Q, each accumulated in f32."""
    ke, ve = _expand_kv(q, k, v)
    p, ds = _p_and_ds(q, ke, ve, do, lse, delta, scale=scale, causal=causal,
                      window=window, q_offset=q_offset, kv_offset=kv_offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                              q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_from_ds(ds, ke, scale, dtype):
    """``scale * dS K`` accumulated in f32, for dS ``[B, H, Tq, Tkv]`` in
    K's dtype and K expanded to the query heads."""
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds.float(), ke.float())
    return dq.to(dtype)


def _flash_dq_reference(q, k, v, do, lse, delta, *, scale, causal, window,
                        q_offset, kv_offset):
    """Plain K4: ``dq [B, Tq, H, D]`` in q's dtype, scale * dS(k's dtype)
    K accumulated in f32."""
    ke, ve = _expand_kv(q, k, v)
    _, ds = _p_and_ds(q, ke, ve, do, lse, delta, scale=scale, causal=causal,
                      window=window, q_offset=q_offset, kv_offset=kv_offset)
    return _dq_from_ds(ds.to(k.dtype), ke, scale, q.dtype)


def _flash_dkv_staged_reference(q, k, v, do, lse, delta, *, scale, causal,
                                window, q_offset, kv_offset):
    """Plain K5 dKV launch: plain K3's ``(dk, dv)`` and the dS stage
    ``[B*H, Tq, Tkv]`` in k's dtype, every pair written (a masked pair's
    dS is 0)."""
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    dk, dv = _flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    ke, ve = _expand_kv(q, k, v)
    _, ds = _p_and_ds(q, ke, ve, do, lse, delta, **kw)
    B, H, Tq, Tkv = ds.shape
    return dk, dv, ds.to(k.dtype).reshape(B * H, Tq, Tkv)


def _flash_dq_staged_reference(ds, k, *, scale, causal, window, q_offset,
                               kv_offset):
    """Plain K5 dQ launch: ``dq [B, Tq, H, D]`` (bf16 for bf16 K) from the
    dS stage ``[B*H, Tq, Tkv]`` and K, scale * dS K accumulated in f32.  It
    reads every pair of the stage, where the kernel reads only the tiles
    that run; the mask arguments are the kernel's and unused here."""
    del causal, window, q_offset, kv_offset
    B = k.shape[0]
    H = ds.shape[0] // B
    Tq = ds.shape[1]
    # _expand_kv reads only the query's shape.
    ke, _ = _expand_kv(torch.empty(B, Tq, H, k.shape[3], device="meta"), k, k)
    return _dq_from_ds(ds.reshape(B, H, Tq, -1), ke, scale, k.dtype)


# ------------------------------------------------------- kernel wrappers


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The flash library with its entry points typed, once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _kernels.load(_SOURCE)
    tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_void_p]
    # Pointers first: q, k, v, o, lse (K2); q, k, v, dout, lse, delta, dk,
    # dv (K3); q, k, v, dout, lse, delta, dq (K4).  Then B, Tq, Tkv, H,
    # Hkv, D, scale, causal, window, q_offset, kv_offset, the stream.
    # K5: q, k, v, dout, lse, delta, dk, dv, ds (dKV); ds, k, dq (dQ).
    for name, n_ptr in (("dtm_flash_fwd_bf16", 5), ("dtm_flash_dkv_bf16", 8),
                        ("dtm_flash_dq_bf16", 7),
                        ("dtm_flash_dkv_staged_bf16", 9),
                        ("dtm_flash_dq_staged_bf16", 3)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
        fn.restype = ctypes.c_int
    # K2's tensor maps alone: q, k, v, B, Tq, Tkv, H, Hkv, D, iterations.
    lib.dtm_flash_fwd_encode_bf16.argtypes = ([ctypes.c_void_p] * 3
                                              + [ctypes.c_int] * 7)
    lib.dtm_flash_fwd_encode_bf16.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_kernel_inputs(what: str, q, k, v, *rest) -> None:
    """What the kernels take: CUDA, bf16 activations, contiguous BTHD with
    16-byte aligned rows, head dim 32, 64 or 128, at most 65535 rows of
    (batch, head)."""
    tensors = (q, k, v) + rest
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors only")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: tensors on more than one device")
    for t in (q, k, v) + rest[:1]:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bfloat16 q/k/v/dO, got {t.dtype}")
    if any(t.dtype != torch.float32 for t in rest[1:]):
        raise TypeError(f"{what} takes float32 lse and delta")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} takes 16-byte aligned tensors")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {_HEAD_DIMS}")
    if rest and (rest[0].shape != q.shape
                 or any(t.shape != (B, H, Tq) for t in rest[1:])):
        raise ValueError(f"{what}: dO must be {tuple(q.shape)} and lse, "
                         f"delta {(B, H, Tq)}")
    _group_size(q, k)
    if B * H > 65535:
        raise ValueError(f"{what}: B*H = {B * H} exceeds 65535")


def _tail(q, k, scale, causal, window, q_offset, kv_offset):
    B, Tq, H, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (B, Tq, k.shape[1], H, k.shape[2], D, float(scale), int(causal),
            int(window or 0), int(q_offset), int(kv_offset), stream)


def flash_forward(q, k, v, *, scale, causal, window, q_offset, kv_offset):
    """Launch K2: ``(out [B, Tq, H, D] bf16, lse [B, H, Tq] f32)``.  CUDA
    tensors only; raises on what the kernel does not take.  Each launch
    adds one to ``flash_forward.launches``."""
    _check_kernel_inputs("flash_forward", q, k, v)
    B, Tq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    lib = _load()
    rc = lib.dtm_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        *_tail(q, k, scale, causal, window, q_offset, kv_offset))
    _kernels.check(lib, rc, "flash_forward (K2)")
    flash_forward.launches += 1
    return out, lse


def flash_forward_encode_seconds(q, k, v, iters: int = 1000) -> float:
    """Host seconds to encode K2's three TMA tensor maps for these tensors,
    averaged over ``iters`` encodings (no launch): the part of each K2
    launch's host cost that the maps add."""
    _check_kernel_inputs("flash_forward_encode_seconds", q, k, v)
    B, Tq, H, D = q.shape
    lib = _load()
    t0 = time.perf_counter()
    rc = lib.dtm_flash_fwd_encode_bf16(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), B, Tq, k.shape[1], H,
                                       k.shape[2], D, iters)
    seconds = (time.perf_counter() - t0) / iters
    _kernels.check(lib, rc, "flash_forward_encode_seconds")
    return seconds


def flash_dkv(q, k, v, do, lse, delta, *, scale, causal, window, q_offset,
              kv_offset):
    """Launch K3: per-query-head ``(dk, dv)``, each ``[B, Tkv, H, D]``
    bf16.  Each launch adds one to ``flash_dkv.launches``."""
    _check_kernel_inputs("flash_dkv", q, k, v, do, lse, delta)
    B, _, H, D = q.shape
    dk = torch.empty(B, k.shape[1], H, D, dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _load()
    rc = lib.dtm_flash_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, scale, causal, window, q_offset, kv_offset))
    _kernels.check(lib, rc, "flash_dkv (K3)")
    flash_dkv.launches += 1
    return dk, dv


def flash_dq(q, k, v, do, lse, delta, *, scale, causal, window, q_offset,
             kv_offset):
    """Launch K4: ``dq [B, Tq, H, D]`` bf16.  Each launch adds one to
    ``flash_dq.launches``."""
    _check_kernel_inputs("flash_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    lib = _load()
    rc = lib.dtm_flash_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_tail(q, k, scale, causal, window, q_offset, kv_offset))
    _kernels.check(lib, rc, "flash_dq (K4)")
    flash_dq.launches += 1
    return dq


def flash_dkv_staged(q, k, v, do, lse, delta, *, scale, causal, window,
                     q_offset, kv_offset, ds=None):
    """Launch K5's dKV kernel: K3's per-query-head ``(dk, dv)`` and the dS
    stage ``ds [B*H, Tq, Tkv]`` bf16.  Tiles that no pair of the mask
    reaches stay as ``ds`` held them: pass a buffer to see which (the
    default is ``torch.empty``).  Each launch adds one to
    ``flash_dkv_staged.launches``."""
    _check_kernel_inputs("flash_dkv_staged", q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tkv = k.shape[1]
    if ds is None:
        ds = torch.empty(B * H, Tq, Tkv, dtype=k.dtype, device=q.device)
    elif (ds.shape != (B * H, Tq, Tkv) or ds.dtype != k.dtype
          or ds.device != q.device or not ds.is_contiguous()):
        raise ValueError(f"flash_dkv_staged: ds must be a contiguous "
                         f"{(B * H, Tq, Tkv)} {k.dtype} tensor on {q.device}")
    dk = torch.empty(B, Tkv, H, D, dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _load()
    rc = lib.dtm_flash_dkv_staged_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ds.data_ptr(),
        *_tail(q, k, scale, causal, window, q_offset, kv_offset))
    _kernels.check(lib, rc, "flash_dkv_staged (K5)")
    flash_dkv_staged.launches += 1
    return dk, dv, ds


def flash_dq_staged(ds, k, *, scale, causal, window, q_offset, kv_offset):
    """Launch K5's dQ kernel: ``dq [B, Tq, H, D]`` bf16 from the dS stage
    ``ds [B*H, Tq, Tkv]`` and K, reading only the tiles that run.  Each
    launch adds one to ``flash_dq_staged.launches``."""
    if ds.dim() != 3 or k.dim() != 4 or ds.shape[0] % k.shape[0]:
        raise ValueError(f"flash_dq_staged: ds {tuple(ds.shape)} is not "
                         f"[B*H, Tq, Tkv] for k {tuple(k.shape)}")
    B, Tkv, Hkv, D = k.shape
    H, Tq = ds.shape[0] // B, ds.shape[1]
    if ds.shape[2] != Tkv:
        raise ValueError(f"flash_dq_staged: ds has {ds.shape[2]} keys, k "
                         f"{Tkv}")
    if ds.dtype != torch.bfloat16:
        raise TypeError(f"flash_dq_staged takes a bfloat16 ds, got {ds.dtype}")
    if not (ds.is_cuda and ds.device == k.device and ds.is_contiguous()
            and ds.data_ptr() % 16 == 0):
        raise ValueError("flash_dq_staged takes a contiguous, 16-byte "
                         "aligned ds on k's CUDA device")
    dq = torch.empty(B, Tq, H, D, dtype=k.dtype, device=k.device)
    # dq stands in for q: the checks K2-K4 make of q, k and v.
    _check_kernel_inputs("flash_dq_staged", dq, k, k)
    lib = _load()
    rc = lib.dtm_flash_dq_staged_bf16(
        ds.data_ptr(), k.data_ptr(), dq.data_ptr(),
        *_tail(dq, k, scale, causal, window, q_offset, kv_offset))
    _kernels.check(lib, rc, "flash_dq_staged (K5)")
    flash_dq_staged.launches += 1
    return dq


flash_forward.launches = 0
flash_dkv.launches = 0
flash_dq.launches = 0
flash_dkv_staged.launches = 0
flash_dq_staged.launches = 0


def _on_cpu(*tensors) -> bool:
    """The plain versions run only when every tensor lies on the CPU."""
    return all(t.device.type == "cpu" for t in tensors)


# ---------------------------------------------------------- autograd path


class _Flash(torch.autograd.Function):
    """``(out, lse [B, Tq, H])`` with the FlashAttention-2 backward: K2
    forward; K3 then K4 backward, rebuilding P from the saved LSE, or with
    ``staged`` K5's two launches.  The LSE cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, q_offset, kv_offset,
                staged):
        kw = dict(scale=scale, causal=causal, window=window,
                  q_offset=q_offset, kv_offset=kv_offset)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = (_flash_forward_reference if _on_cpu(q, k, v)
               else flash_forward)
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.staged = staged
        ctx.set_materialize_grads(False)
        return out, lse.transpose(1, 2)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.contiguous()
        # delta = rowsum(dO * O) in f32, minus the LSE cotangent.
        delta = (g_out.float() * out.float()).sum(-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float().transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, g_out, lse, delta)
        cpu = _on_cpu(*args)
        if ctx.staged:
            dkv, dq_of = ((_flash_dkv_staged_reference,
                           _flash_dq_staged_reference) if cpu
                          else (flash_dkv_staged, flash_dq_staged))
            dk, dv, ds = dkv(*args, **ctx.kw)
            dq = dq_of(ds, k, **ctx.kw)
        elif cpu:
            dk, dv = _flash_dkv_reference(*args, **ctx.kw)
            dq = _flash_dq_reference(*args, **ctx.kw)
        else:
            dk, dv = flash_dkv(*args, **ctx.kw)
            dq = flash_dq(*args, **ctx.kw)
        grp = _group_size(q, k)
        if grp > 1:
            # Group-sum the per-query-head grads down to the KV heads, in
            # f32.
            B, Tkv, Hkv, D = k.shape
            dk = dk.float().view(B, Tkv, Hkv, grp, D).sum(3).to(k.dtype)
            dv = dv.float().view(B, Tkv, Hkv, grp, D).sum(3).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def _flash(q, k, v, causal, scale, block_q, block_kv, window, q_offset,
           kv_offset, staged=False):
    window = _check_window(window)
    _group_size(q, k)
    Tq, Tkv = q.shape[1], k.shape[1]
    # Validation only, as the JAX package resolves its tiles per direction:
    # the kernels' own tiles do not change the result of any row with a
    # valid key.
    _check_blocks(Tq, Tkv, block_q, block_kv)
    _check_blocks(Tq, Tkv,
                  block_q if block_q is not None else _auto_block_bwd(Tq),
                  block_kv if block_kv is not None else _auto_block_bwd(Tkv))
    return _Flash.apply(q, k, v, causal, _scale(q, scale), window,
                        q_offset, kv_offset, staged)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    window: Optional[int] = None,
                    bwd_staged: bool = False) -> torch.Tensor:
    """Flash attention, BTHD in and out: K2 forward, K3 + K4 backward, or
    with ``bwd_staged`` the K5 backward (the same gradients, through an
    O(T^2) dS buffer).  (The JAX function's ``interpret`` argument has no
    counterpart.)"""
    out, _ = _flash(q, k, v, causal, scale, block_q, block_kv, window, 0, 0,
                    bwd_staged)
    return out


def flash_attention_chunk(q, k, v, q_offset: int = 0, kv_offset: int = 0,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_kv: Optional[int] = None,
                          window: Optional[int] = None):
    """Attention of a chunk of a longer sequence: ``(out, lse [B, T, H])``
    so partial results over several KV chunks merge exactly.  Offsets are
    the global positions of the first local rows (Python ints); the
    result is differentiable in q, k, v, through lse too."""
    return _flash(q, k, v, causal, scale, block_q, block_kv, window,
                  int(q_offset), int(kv_offset))


def attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
              impl: str = "auto", window: Optional[int] = None):
    """Dispatching entry point: ``impl`` in {auto, reference, blockwise,
    flash}; ``auto`` is blockwise, as in the JAX package."""
    if impl == "auto":
        impl = "blockwise"
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    if impl == "flash":
        tile = os.environ.get("DTM_FLASH_TILE")
        bq = bkv = None
        if tile:
            try:
                bq = bkv = int(tile)
            except ValueError:
                raise ValueError(
                    f"DTM_FLASH_TILE must be an integer, got {tile!r}"
                ) from None
            if bq <= 0 or bq % 8:
                raise ValueError("DTM_FLASH_TILE must be a positive multiple "
                                 f"of 8, got {tile!r}")
            for which, L in (("query", q.shape[1]), ("key", k.shape[1])):
                if L % bq:
                    raise ValueError(f"DTM_FLASH_TILE={tile} does not divide "
                                     f"the {which} length {L}")
        bwd = os.environ.get("DTM_FLASH_BWD", "pair")
        if bwd not in ("pair", "staged"):
            raise ValueError(
                f"DTM_FLASH_BWD must be 'pair' or 'staged', got {bwd!r}")
        return flash_attention(q, k, v, causal, scale, bq, bkv, window,
                               bwd == "staged")
    raise ValueError(f"unknown attention impl {impl!r}")
