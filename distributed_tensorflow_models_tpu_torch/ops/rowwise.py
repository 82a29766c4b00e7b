"""Row-invariant products for the decode path: kernel R1.

A served stream must equal a solo ``generate`` bit for bit
(``serving/engine.py``), so every decode product has to give each output
row the same bits whatever else is in the call: the number of rows (a
prefill chunk, a whole prompt, one token), the number of lanes or
heads, where the row falls in a tile, the operands' strides.  Library
products do not promise that: BLAS and cuBLAS pick kernels and split
sums by M, and PyTorch's CPU matmul over 40 rows differs from the same
rows one at a time.

:func:`row_matmul` computes ``a [..., M, K] @ b [K, N]`` (or per group,
``b [G1, G2, K, N]``) so that an output's bits depend on its row of
``a``, its column of ``b``, ``K``, the dtypes and at most ``N``: never
on ``M``, the row's place in a tile, the group count or the strides.
Its form is picked by :func:`_plan` from ``(dtype, out_dtype, N, K)``
alone:

- **Plain version** (:func:`_plain_matmul`, every CPU call): each
  output an f32 sum that starts at 0 and adds the rounded f32 products
  ``a[m, k] * b[k, n]`` one at a time, ``k`` ascending, no fused
  multiply-add, rounded once to the output dtype; one elementwise
  product and one add a step, vectorised over every row and column.
  Elementwise f32 ops round each element alone, so the result is
  invariant by construction, and the CPU path keeps exact equality.
- **The tensor-core form** (``csrc/row_gemm.cu``, CUDA tensors, bf16
  operands with ``N > 1``: a bf16 model's Dense products, attention's
  scores and P·V): ``wgmma`` m64n32k16, f32 += bf16 x bf16, the rows on
  the instruction's 64-row side (zero past M), one register accumulator
  per output from 0, K walked in k16 steps ascending and never split,
  its tail zero in shared memory, one rounding at the end.  The tensor
  core sums a step's 16 products inside the instruction, so this form
  is not the plain version bit for bit: it lies within the error bound
  of an f32 sum of K exact products (``K 2^-22 sum_k |a_k b_k|``, and
  one bf16 ulp more for a bf16 result), and each row equals itself
  across row counts, positions, groups and strides exactly.
- **The SIMT form** (CUDA tensors: f32 operands, and ``N == 1``,
  LayerNorm's and softmax's sums by :func:`row_sum`): the plain
  version's arithmetic, ``__fadd_rn(acc, __fmul_rn(a, b))``, bit for bit
  with it; a tiled kernel and, for one column, a kernel of a warp a row.

R1 replaces no TPU kernel: the JAX package gets row invariance from
XLA's fixed reduction shapes (``serving/engine.py``).  At decode's few
rows a product is bound by its launch and its K chain, not by the bytes
of its weight.

The wrapper launches R1 for CUDA tensors or raises; it never falls back.
Each launch adds one to ``row_matmul.launches`` and one to its form's
count, ``row_matmul.wgmma_launches`` or ``row_matmul.simt_launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _kernels

_SOURCE = "row_gemm.cu"
# The SIMT form's C entry per (input dtype, output dtype).
_ENTRIES = {
    (torch.bfloat16, torch.bfloat16): "dtm_row_gemm_bf16_bf16",
    (torch.bfloat16, torch.float32): "dtm_row_gemm_bf16_f32",
    (torch.float32, torch.float32): "dtm_row_gemm_f32_f32",
    (torch.float32, torch.bfloat16): "dtm_row_gemm_f32_bf16",
}
# The tensor-core form's, per output dtype (bf16 operands).
_TC_ENTRIES = {
    torch.bfloat16: "dtm_row_gemm_tc_bf16_bf16",
    torch.float32: "dtm_row_gemm_tc_bf16_f32",
}
_TC_BK = 64  # k of a ring stage
_TC_MAX_STAGES = 8


class _Plan(NamedTuple):
    """What a launch runs: its form (``"wgmma"`` or ``"simt"``, the name
    of its launch counter), C entry and the extra arguments the entry
    takes before the stream (the tensor-core ring's stages)."""

    form: str
    entry: str
    args: tuple


def _plan(dtype: torch.dtype, out_dtype: torch.dtype, N: int,
          K: int) -> _Plan:
    """The form and tiling of a product, from its dtypes, ``N`` and ``K``
    alone: no ``M`` and no strides, so that neither can pick another
    arithmetic.  bf16 operands with ``N > 1`` take the tensor-core form
    (a ring of stages of 64 k, as many as K fills, at most 8); f32
    operands, and ``N == 1``, the SIMT form."""
    if dtype == torch.bfloat16 and N > 1:
        stages = min(_TC_MAX_STAGES, max(1, -(-K // _TC_BK)))
        return _Plan("wgmma", _TC_ENTRIES[out_dtype], (stages,))
    return _Plan("simt", _ENTRIES[(dtype, out_dtype)], ())


def _load() -> ctypes.CDLL:
    lib = _kernels.load(_SOURCE)
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    common = [p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll]
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [*common, p]
        fn.restype = i
    for name in _TC_ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [*common, i, p]
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
    """The plain version (the SIMT form's arithmetic, in PyTorch): an f32
    accumulator from 0, plus the rounded product of one ``k`` at a time,
    ``k`` ascending."""
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
    K, N]``, any strides), each output row's bits independent of the
    rows, groups and strides beside it; the result in ``out_dtype``
    (default ``a``'s), contiguous.  ``a`` and ``b`` share one dtype, bf16
    or f32.  CPU tensors take the plain version; CUDA tensors launch R1
    in the form :func:`_plan` picks, or raise."""
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
        plan = _plan(a.dtype, out_dtype, N, K)
        lib = _load()
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, plan.entry)(
            a4.data_ptr(), b4.data_ptr(), out.data_ptr(), G1, G2, M, N, K,
            *a4.stride(), *b4.stride(), *plan.args, stream)
        _kernels.check(lib, rc, "row_matmul")
        row_matmul.launches += 1
        counter = f"{plan.form}_launches"
        setattr(row_matmul, counter, getattr(row_matmul, counter) + 1)
    return out.reshape(shape)


_kernels.counted(row_matmul, "launches", "wgmma_launches", "simt_launches")


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x [..., K]`` summed over its last dim in f32, keepdim, by the
    plain arithmetic on either device (a product with a column of ones,
    the SIMT form on the card): a row's sum does not depend on the rows
    beside it."""
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
