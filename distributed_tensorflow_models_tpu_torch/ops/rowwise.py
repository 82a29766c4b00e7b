"""Row-invariant products for the decode path: kernel R1.

A served stream must equal a solo ``generate`` bit for bit
(``serving/engine.py``), so every decode product has to give each output
row the same bits whatever else is in the call: the number of rows (a
prefill chunk, a whole prompt, one token), the number of lanes or
heads, where the row falls in a tile.  Library products do not promise
that: BLAS and cuBLAS pick kernels and split sums by M, and PyTorch's
CPU matmul over 40 rows differs from the same rows one at a time.

:func:`row_matmul` computes ``a [..., M, K] @ b [K, N]`` (or per group,
``b [G1, G2, K, N]``) with one fixed arithmetic: each output is an f32
sum that starts at 0 and adds the rounded f32 products ``a[m, k] *
b[k, n]`` one at a time, ``k`` ascending, no fused multiply-add, then is
rounded once to the output dtype.  So an output's bits are a function of
its row of ``a``, its column of ``b`` and ``K`` alone.

- **Plain version** (:func:`_plain_matmul`, the CPU path): exactly that
  loop over ``k`` in PyTorch, one elementwise product and one add a
  step, vectorised over every row and column at once.  Elementwise f32
  ops round each element alone, so the result is invariant by
  construction.
- **R1** (``csrc/row_gemm.cu``, CUDA tensors): SIMT, one f32
  accumulator per output updated with ``__fadd_rn(acc, __fmul_rn(a,
  b))``, K walked through shared memory in increasing order; bf16 or
  f32 in, bf16 or f32 out.  A tiled kernel, its tiling picked by shape
  (64 x 64 outputs a block for many rows, 8 x 32, an output a thread,
  for a decode step's or a prefill chunk's few rows), and for
  :func:`row_sum`'s column a kernel of a warp a row.
  It is the plain version's arithmetic, so the two agree bit for bit.
  R1 replaces no TPU kernel: the JAX package gets row invariance from
  XLA's fixed reduction shapes (``serving/engine.py``).  It is bound by
  the weights it reads at decode's few rows; a simple kernel first,
  tensor cores in a fixed order are later work.

The wrapper launches R1 for CUDA tensors or raises; it never falls back.
Each launch adds one to ``row_matmul.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels

_SOURCE = "row_gemm.cu"
# C entry per (input dtype, output dtype).
_ENTRIES = {
    (torch.bfloat16, torch.bfloat16): "dtm_row_gemm_bf16_bf16",
    (torch.bfloat16, torch.float32): "dtm_row_gemm_bf16_f32",
    (torch.float32, torch.float32): "dtm_row_gemm_f32_f32",
    (torch.float32, torch.bfloat16): "dtm_row_gemm_f32_bf16",
}


def _load() -> ctypes.CDLL:
    lib = _kernels.load(_SOURCE)
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll,
                       ll, p]
        fn.restype = i
    return lib


def _operands(a: torch.Tensor, b: torch.Tensor):
    """``(a4, b4, out_shape)``: both as ``[G1, G2, rows, cols]`` strided
    views (a 2-D ``b`` broadcast over the groups by zero strides), and
    the shape the caller's result takes."""
    K = a.shape[-1]
    if b.dim() == 2:
        if b.shape[0] != K:
            raise ValueError(f"inner dims differ: a {tuple(a.shape)}, b "
                             f"{tuple(b.shape)}")
        rows = a.reshape(-1, K)
        return (rows[None, None], b.expand(1, 1, *b.shape),
                (*a.shape[:-1], b.shape[1]))
    if b.dim() != 4 or a.dim() != 4 or a.shape[:2] != b.shape[:2] \
            or b.shape[2] != K:
        raise ValueError(f"row_matmul takes a [..., M, K] @ b [K, N] or a "
                         f"[G1, G2, M, K] @ b [G1, G2, K, N]; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return a, b, (*a.shape[:3], b.shape[3])


def _plain_matmul(a4: torch.Tensor, b4: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """R1's arithmetic in PyTorch: an f32 accumulator from 0, plus the
    rounded product of one ``k`` at a time, ``k`` ascending."""
    a32, b32 = a4.float(), b4.float()
    G1, G2, M, K = a32.shape
    acc = torch.zeros(max(G1, b32.shape[0]), max(G2, b32.shape[1]), M,
                      b32.shape[3], dtype=torch.float32, device=a4.device)
    prod = torch.empty_like(acc)
    for k in range(K):
        torch.mul(a32[..., k:k + 1], b32[..., k:k + 1, :], out=prod)
        acc.add_(prod)
    return acc.to(out_dtype)


def row_matmul(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a [..., M, K] @ b [K, N]`` (or ``a [G1, G2, M, K] @ b [G1, G2,
    K, N]``, any strides) with the module's row-invariant arithmetic;
    the result in ``out_dtype`` (default ``a``'s), contiguous.  ``a`` and
    ``b`` share one dtype, bf16 or f32.  CPU tensors take the plain
    version; CUDA tensors launch R1 or raise."""
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype or (a.dtype, out_dtype) not in _ENTRIES:
        raise TypeError(f"row_matmul takes bf16 or f32 operands of one "
                        f"dtype and a bf16 or f32 result, got {a.dtype} x "
                        f"{b.dtype} -> {out_dtype}")
    a4, b4, shape = _operands(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _plain_matmul(a4, b4, out_dtype).reshape(shape)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"row_matmul takes CPU or CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    G1, G2, M, K = a4.shape
    N = b4.shape[3]
    out = torch.empty(G1, G2, M, N, dtype=out_dtype, device=a.device)
    if out.numel():
        lib = _load()
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, _ENTRIES[(a.dtype, out_dtype)])(
            a4.data_ptr(), b4.data_ptr(), out.data_ptr(), G1, G2, M, N, K,
            *a4.stride(), *b4.stride(), stream)
        _kernels.check(lib, rc, "row_matmul")
        row_matmul.launches += 1
    return out.reshape(shape)


_kernels.counted(row_matmul, "launches")


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x [..., K]`` summed over its last dim in f32, keepdim, by the
    same arithmetic (a product with a column of ones): a row's sum does
    not depend on the rows beside it."""
    ones = torch.ones(x.shape[-1], 1, dtype=x.dtype, device=x.device)
    return row_matmul(x, ones, torch.float32)


def dense(layer, x: torch.Tensor) -> torch.Tensor:
    """A ``Dense`` layer (``ops/conv.py``: kernel ``[in, out]``, cast with
    its input to the layer's dtype, then the bias added in that dtype)
    through :func:`row_matmul`.  Tensor-parallel layers have no decode
    mode."""
    if layer.tp is not None:
        raise ValueError("the row-invariant decode path takes whole layers")
    dt = layer.dtype
    y = row_matmul(x.to(dt), layer.kernel.to(dt))
    return y if layer.bias is None else y + layer.bias.to(dt)
