"""Implicit-GEMM 2-D convolution: the conv path that runs kernels K1 and K6.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/conv_mxu.py``
with the same routing and structure:

- ``_Core`` — stride-1 VALID conv ``[B,Hp,Wp,Cin] x [kh,kw,Cin,Cout]`` as a
  ``torch.autograd.Function``.  Forward runs K1
  (``csrc/conv_implicit_gemm.cu``) on CUDA tensors, or K6, its persistent
  ring-pipelined form in the same file, when ``DTM_CONV_MXU_PIPELINE=1``
  (read on every call); on CPU tensors it runs :func:`_core_reference`,
  the plain version of both.  Backward: dx re-enters the same
  function on the (kh-1, kw-1)-padded cotangent with the spatially
  rotated, IO-swapped kernel; dw is kh*kw window dots.
- strides are decomposed outside the kernel into a sum of s_h*s_w
  decimated stride-1 convs (``y = sum_pq core(x[p::s, q::s],
  k[p::s, q::s])``) — exact, no wasted FLOPs.  A 3x3 stride-2 conv runs
  the core with 2x2, 2x1, 1x2 and 1x1 tap kernels.
- 1x1 convs and low-lane-utilization input channels route to
  ``conv2d_patches`` by :func:`_use_mxu_kernel`, kept as the JAX package
  has it so that the same convs take the kernel.  Its 128-lane rule is a
  TPU fact, still to be re-derived for the H100.

The TPU kernel's W->8 and cin->128 pads, its VMEM tile search and its
"copy the slab once per sequential grid row" scheme are TPU facts and are
not carried over: K1's blocks run in no order and each loads its own halo.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from . import _kernels
from .conv import Padding, _explicit_padding, _pad_nhwc, conv2d_patches

_MXU_MIN_LANE_UTIL = 0.5
_LANES = 128
_SOURCE = "conv_implicit_gemm.cu"


def _core_reference(xpad: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The plain version of K1: stride-1 VALID conv as kh*kw shifted-window
    matmuls ``[M, Cin] @ [Cin, Cout]`` accumulated in f32, written in the
    input dtype."""
    b, hp, wp, cin = xpad.shape
    kh, kw, _, cout = kernel.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    acc = torch.zeros(b * oh * ow, cout, dtype=torch.float32,
                      device=xpad.device)
    for dy in range(kh):
        for dx in range(kw):
            win = xpad[:, dy:dy + oh, dx:dx + ow, :].reshape(-1, cin)
            acc += torch.matmul(win.float(), kernel[dy, dx].float())
    return acc.reshape(b, oh, ow, cout).to(xpad.dtype)


def _check_kernel_inputs(what: str, xpad: torch.Tensor,
                         kernel: torch.Tensor) -> None:
    """What K1 and K6 take: bf16, contiguous NHWC ``xpad`` and HWIO
    ``kernel`` on one CUDA device, the kernel no larger than the input."""
    if not (xpad.is_cuda and kernel.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if xpad.device != kernel.device:
        raise ValueError(f"devices differ: {xpad.device} vs {kernel.device}")
    if xpad.dtype != torch.bfloat16 or kernel.dtype != torch.bfloat16:
        raise TypeError(
            f"{what} takes bfloat16, got {xpad.dtype} x {kernel.dtype}")
    if xpad.dim() != 4 or kernel.dim() != 4:
        raise ValueError("expected NHWC input and HWIO kernel")
    b, hp, wp, cin = xpad.shape
    kh, kw, kcin, cout = kernel.shape
    if kcin != cin:
        raise ValueError(f"input channels {cin} != kernel input channels {kcin}")
    if kh > hp or kw > wp:
        raise ValueError(f"kernel {kh}x{kw} larger than input {hp}x{wp}")
    if not (xpad.is_contiguous() and kernel.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")


def _launch(what: str, entry: str, xpad: torch.Tensor,
            kernel: torch.Tensor) -> torch.Tensor:
    _check_kernel_inputs(what, xpad, kernel)
    b, hp, wp, cin = xpad.shape
    kh, kw, _, cout = kernel.shape
    y = torch.empty(b, hp - kh + 1, wp - kw + 1, cout, dtype=xpad.dtype,
                    device=xpad.device)
    if y.numel() == 0:
        return y
    lib = _load()
    stream = torch.cuda.current_stream(xpad.device).cuda_stream
    rc = getattr(lib, entry)(xpad.data_ptr(), kernel.data_ptr(), y.data_ptr(),
                             b, hp, wp, cin, kh, kw, cout, stream)
    _kernels.check(lib, rc, what)
    return y


def conv_implicit_gemm(xpad: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors: bf16, contiguous NHWC ``xpad`` and HWIO
    ``kernel`` on one device.  Raises on anything else; never falls back.
    Each launch adds one to ``conv_implicit_gemm.launches``."""
    y = _launch("conv_implicit_gemm", "dtm_conv_implicit_gemm_bf16", xpad,
                kernel)
    if y.numel():
        conv_implicit_gemm.launches += 1
    return y


def conv_implicit_gemm_pipelined(xpad: torch.Tensor,
                                 kernel: torch.Tensor) -> torch.Tensor:
    """Launch K6, the persistent, ring-pipelined K1 (the same function, bit
    for bit), on the tensors K1 takes.  Raises on anything else; never
    falls back.  Each launch adds one to
    ``conv_implicit_gemm_pipelined.launches``."""
    y = _launch("conv_implicit_gemm_pipelined",
                "dtm_conv_implicit_gemm_pipelined_bf16", xpad, kernel)
    if y.numel():
        conv_implicit_gemm_pipelined.launches += 1
    return y


conv_implicit_gemm.launches = 0
conv_implicit_gemm_pipelined.launches = 0


def _load() -> ctypes.CDLL:
    lib = _kernels.load(_SOURCE)
    for name in ("dtm_conv_implicit_gemm_bf16",
                 "dtm_conv_implicit_gemm_pipelined_bf16"):
        fn = getattr(lib, name)
        # x, k, y pointers; B, Hp, Wp, Cin, kh, kw, Cout; the stream.
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _pipeline_enabled() -> bool:
    """``DTM_CONV_MXU_PIPELINE``, read on every call of the core (the JAX
    package reads it once per trace): ``1`` runs K6, ``0`` (the default)
    K1; any other value raises naming the knob."""
    env = os.environ.get("DTM_CONV_MXU_PIPELINE", "0")
    if env not in ("0", "1"):
        raise ValueError(
            f"DTM_CONV_MXU_PIPELINE must be '0' or '1', got {env!r}")
    return env == "1"


def _core_forward(xpad: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """K6 or K1 (by the knob) for CUDA tensors, the plain version for CPU
    tensors; the knob is validated either way."""
    pipelined = _pipeline_enabled()
    if xpad.is_cuda:
        launch = conv_implicit_gemm_pipelined if pipelined else conv_implicit_gemm
        return launch(xpad.contiguous(), kernel.contiguous())
    return _core_reference(xpad, kernel)


class _Core(torch.autograd.Function):
    """Stride-1 VALID conv, NHWC x HWIO, with the JAX package's VJP."""

    @staticmethod
    def forward(ctx, xpad, kernel):
        ctx.save_for_backward(xpad, kernel)
        return _core_forward(xpad, kernel)

    @staticmethod
    def backward(ctx, g):
        xpad, kernel = ctx.saved_tensors
        kh, kw, cin, cout = kernel.shape
        _, oh, ow, _ = g.shape
        dx = dw = None
        if ctx.needs_input_grad[1]:
            # One weight-sized dot per tap, contracting over (B, OH, OW);
            # the matmul accumulates in f32 and the result is cast to the
            # kernel's dtype.
            g2 = g.reshape(-1, cout)
            dw = torch.stack([
                torch.matmul(
                    xpad[:, dy:dy + oh, dx:dx + ow, :].reshape(-1, cin).t(),
                    g2,
                )
                for dy in range(kh) for dx in range(kw)
            ]).reshape(kh, kw, cin, cout).to(kernel.dtype)
        if ctx.needs_input_grad[0]:
            # Full correlation: the same stride-1 conv on the padded
            # cotangent with the rotated, IO-swapped kernel.
            gp = F.pad(g, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
            krot = kernel.flip(0, 1).permute(0, 1, 3, 2).contiguous()
            dx = _Core.apply(gp, krot)
        return dx, dw


def _mxu_lane_utilization(cin: int) -> float:
    """Fraction of the TPU's 128 matrix lanes doing useful work after its
    kernel's cin->128 pad."""
    return cin / (-(-cin // _LANES) * _LANES)


def _use_mxu_kernel(kh: int, kw: int, cin: int) -> bool:
    """The JAX package's routing, unchanged: 1x1 convs and convs whose
    post-pad lane utilization is under 50% go to patches."""
    if kh == kw == 1:
        return False
    return _mxu_lane_utilization(cin) >= _MXU_MIN_LANE_UTIL


def conv2d_mxu(x, kernel, strides=(1, 1), padding: Padding = "SAME"):
    """NHWC x HWIO conv (``lax.conv_general_dilated`` semantics) on the
    implicit-GEMM core."""
    kh, kw, cin, _ = kernel.shape
    sh, sw = strides
    if x.shape[-1] != cin:
        raise ValueError(
            f"input channels {x.shape[-1]} != kernel input channels {cin}"
        )
    if not _use_mxu_kernel(kh, kw, cin):
        return conv2d_patches(x, kernel, strides, padding)
    ph, pw = _explicit_padding(padding, kh, kw, sh, sw, x.shape[1], x.shape[2])
    x = _pad_nhwc(x, ph, pw)
    _, hp, wp, _ = x.shape
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    if sh == 1 and sw == 1:
        return _Core.apply(x, kernel)
    # Phase decomposition: each phase is an exact stride-1 conv on a
    # decimated image; taps partition over phases.
    y = None
    for p in range(min(sh, kh)):
        khp = len(range(p, kh, sh))
        for q in range(min(sw, kw)):
            kwq = len(range(q, kw, sw))
            xs = x[:, p:p + (oh + khp - 2) * sh + 1:sh,
                   q:q + (ow + kwq - 2) * sw + 1:sw, :]
            yp = _Core.apply(xs, kernel[p::sh, q::sw])
            y = yp if y is None else y + yp
    return y
