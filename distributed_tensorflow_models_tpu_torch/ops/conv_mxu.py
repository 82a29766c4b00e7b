"""Implicit-GEMM 2-D convolution: the conv path that runs kernels K1 and K6.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/conv_mxu.py``
with the same routing and the same function:

- the core is a stride-1 VALID conv ``[B,Hp,Wp,Cin] x [kh,kw,Cin,Cout]``
  run by K1 (``csrc/conv_implicit_gemm.cu``) on CUDA tensors, or by K6, its
  persistent form in the same file, when ``DTM_CONV_MXU_PIPELINE=1`` (read
  on every call); on CPU tensors it runs :func:`_core_reference`, the plain
  version of both.  Like the JAX kernel it computes in its input's dtype:
  bf16 (bf16 products) or f32 (TF32 products: the tensor cores keep 10 of
  each operand's 23 mantissa bits), f32 sums, output in the input's dtype;
  any other dtype raises.
- The kernels read the core's input as a *window* of the unpadded input
  (:func:`_core_window`): an origin that may be negative where padding
  lies, a row and column step (the stride phase), zeros outside the
  input.  So ``conv2d_mxu`` pads nothing and slices nothing: a strided
  conv is the sum, in bf16 and in the order below, of s_h*s_w decimated
  stride-1 convs (``y = sum_pq core(xpad[p::s, q::s], k[p::s, q::s])``),
  each one launch on its phase window of ``x``.  A 3x3 stride-2 conv runs
  the core with 2x2, 2x1, 1x2 and 1x1 tap kernels.
- :class:`_MxuConv`, one ``torch.autograd.Function``, holds the JAX
  package's VJP: dx re-enters the core per phase on the cotangent with its
  (khp-1, kwq-1) padding folded into the window and the spatially rotated,
  IO-swapped kernel, writing the phase's disjoint strided window of one dx
  buffer of x's shape; dw is kh*kw window dots.  Its backward is not
  itself differentiable (no caller of the port differentiates twice): a
  backward with ``create_graph=True`` raises.
- 1x1 convs and low-lane-utilization input channels route to
  ``conv2d_patches`` by :func:`_use_mxu_kernel`, kept as the JAX package
  has it so that the same convs take the kernel.  Its 128-lane rule is a
  TPU fact, still to be re-derived for the H100.

The TPU kernel's W->8 and cin->128 pads, its VMEM tile search and its
"copy the slab once per sequential grid row" scheme are TPU facts and are
not carried over: the kernels' blocks run in no order and each gathers its
own halo rows.
"""

from __future__ import annotations

import ctypes
import os

import torch

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


def tf32_error_bound(xpad: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|K1(xpad, kernel) - _core_reference(...)|``
    for f32 operands.  The tensor cores read each f32 as tf32, keeping 10
    of its 23 mantissa bits (relative error under 2^-10 an operand, under
    2^-9 + 2^-20 a product), and both sides sum the K = kh*kw*Cin products
    in f32 in their own orders (under K*2^-24 of the sum of magnitudes
    each).  So the bound is (2^-9 + 2^-20 + 2*K*2^-24) * sum|x||w|, the
    last factor the plain version on the magnitudes."""
    kh, kw, cin, _ = kernel.shape
    rel = 2.0 ** -9 + 2.0 ** -20 + 2 * kh * kw * cin * 2.0 ** -24
    return rel * _core_reference(xpad.abs().float(), kernel.abs().float())


def tf32_cut(t: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as the tensor cores read it for a tf32 product: the
    13 low mantissa bits dropped (truncated, not rounded)."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_order_bound(xpad: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|K1(xpad, kernel) - _core_reference(
    tf32_cut(xpad), tf32_cut(kernel))|`` for f32 operands: both sides form
    the same products (exact in f32: two 11-bit significands), and differ
    only in the order of the K = kh*kw*Cin f32 additions, each under
    2^-23 of the partial sum even when it truncates.  So the bound is
    2*K*2^-24 * sum|x~||w~| over the cut operands.  Operands rounded to
    bf16, or to tf32 by round-to-nearest, or kept in f32 (3xTF32), break
    it at ResNet-32's K = 576."""
    kh, kw, cin, _ = kernel.shape
    rel = 2 * kh * kw * cin * 2.0 ** -24
    return rel * _core_reference(tf32_cut(xpad).abs(),
                                 tf32_cut(kernel).abs())


def _materialize_window(x: torch.Tensor, win) -> torch.Tensor:
    """The window ``win = (h0, w0, sh, sw, hs, ws)`` of ``x`` as a tensor:
    ``out[:, i, j] = x[:, h0 + i*sh, w0 + j*sw]``, zero outside ``x``."""
    h0, w0, sh, sw, hs, ws = win
    _, h, w, _ = x.shape

    def pads(o, s, n, size):
        return max(0, -o), max(0, o + (n - 1) * s + 1 - size)

    (pt, pb), (pl, pr) = pads(h0, sh, hs, h), pads(w0, sw, ws, w)
    x = _pad_nhwc(x, (pt, pb), (pl, pr))
    r0, c0 = h0 + pt, w0 + pl
    return x[:, r0:r0 + (hs - 1) * sh + 1:sh, c0:c0 + (ws - 1) * sw + 1:sw, :]


def _launch_window(x: torch.Tensor, kernel: torch.Tensor, win,
                   pipelined: bool, out=None) -> torch.Tensor:
    """K1 (or K6) on the window ``win = (h0, w0, sh, sw, oh, ow)`` of ``x``:
    the stride-1 VALID conv of the window's ``(oh+kh-1) x (ow+kw-1)``
    positions, ``x[:, h0 + i*sh, w0 + j*sw]`` read as zero outside ``x``.
    Takes bf16 or f32 NHWC ``x`` (channels contiguous, any other strides)
    and a contiguous HWIO ``kernel`` of the same dtype on one CUDA device
    (``win=None``: the public wrappers' form, all of a contiguous input no
    smaller than the kernel); writes into ``out`` (``[B, oh, ow, Cout]``,
    channels contiguous) or a new tensor.  Each launch adds one to the
    launched kernel's ``launches``, and an f32 launch to its
    ``f32_launches`` too."""
    fn = conv_implicit_gemm_pipelined if pipelined else conv_implicit_gemm
    what = fn.__name__
    if not (x.is_cuda and kernel.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if x.device != kernel.device:
        raise ValueError(f"devices differ: {x.device} vs {kernel.device}")
    if x.dtype not in _ENTRIES or kernel.dtype != x.dtype:
        raise TypeError(f"{what} takes bfloat16 or float32 (one dtype for "
                        f"both), got {x.dtype} x {kernel.dtype}")
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError("expected NHWC input and HWIO kernel")
    b, h, w, cin = x.shape
    kh, kw, kcin, cout = kernel.shape
    if kcin != cin:
        raise ValueError(f"input channels {cin} != kernel input channels {kcin}")
    if win is None:
        if kh > h or kw > w:
            raise ValueError(f"kernel {kh}x{kw} larger than input {h}x{w}")
        if not x.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        win = (0, 0, 1, 1, h - kh + 1, w - kw + 1)
    if x.stride(3) != 1 or not kernel.is_contiguous():
        raise ValueError(f"{what} takes contiguous tensors (channels of the "
                         f"input)")
    h0, w0, sh, sw, oh, ow = win
    if out is None:
        out = torch.empty(b, oh, ow, cout, dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != (b, oh, ow, cout) or out.stride(3) != 1
          or out.dtype != x.dtype or out.device != x.device):
        raise ValueError(f"output window {tuple(out.shape)} does not take "
                         f"{(b, oh, ow, cout)}")
    if out.numel() == 0:
        return out
    lib = _load()
    f32 = x.dtype == torch.float32
    if f32:
        # tf32 wgmma reads B K-major: the weight as [Cout, kh*kw*Cin].
        kernel = kernel.reshape(-1, cout).t().contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, _ENTRIES[x.dtype])(
        x.data_ptr(), b, h, w, cin, *x.stride()[:3], h0, w0, sh, sw,
        kernel.data_ptr(), kh, kw, cout, out.data_ptr(), oh, ow,
        *out.stride()[:3], int(pipelined), stream)
    _kernels.check(lib, rc, what)
    fn.launches += 1
    if f32:
        fn.f32_launches += 1
    return out


def conv_implicit_gemm(xpad: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors: bf16 or f32, contiguous NHWC ``xpad`` and
    HWIO ``kernel`` on one device.  Raises on anything else; never falls
    back.  Each launch adds one to ``conv_implicit_gemm.launches`` (and an
    f32 one to ``conv_implicit_gemm.f32_launches``)."""
    return _launch_window(xpad, kernel, None, pipelined=False)


def conv_implicit_gemm_pipelined(xpad: torch.Tensor,
                                 kernel: torch.Tensor) -> torch.Tensor:
    """Launch K6, the persistent form of K1 (the same function, bit for
    bit), on the tensors K1 takes.  Raises on anything else; never falls
    back.  Each launch adds one to
    ``conv_implicit_gemm_pipelined.launches``."""
    return _launch_window(xpad, kernel, None, pipelined=True)


_kernels.counted(conv_implicit_gemm, "launches", "f32_launches")
_kernels.counted(conv_implicit_gemm_pipelined, "launches", "f32_launches")

# The C entry of each dtype the kernels take.
_ENTRIES = {torch.bfloat16: "dtm_conv_window_bf16",
            torch.float32: "dtm_conv_window_f32"}


def bind_window(fn) -> None:
    """Declare the C signature of a window entry (``dtm_conv_window_*``)
    of a built ``conv_implicit_gemm.cu``."""
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    # x, B, H, W, Cin, xs_b/h/w, h0, w0, sh, sw; k, kh, kw, Cout;
    # y, OH, OW, ys_b/h/w; pipelined, stream.
    fn.argtypes = ([p, i, i, i, i, ll, ll, ll, i, i, i, i, p, i, i, i,
                    p, i, i, ll, ll, ll, i, p])
    fn.restype = i


def _load() -> ctypes.CDLL:
    lib = _kernels.load(_SOURCE)
    for name in _ENTRIES.values():
        bind_window(getattr(lib, name))
    lib.dtm_conv_tile_n.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.dtm_conv_tile_n.restype = ctypes.c_int
    return lib


def tile_n(cout: int, m: int) -> int:
    """The N tile K1 and K6 use for ``Cout`` and ``M = B*OH*OW`` (from the
    built library: needs the CUDA toolkit)."""
    return _load().dtm_conv_tile_n(cout, m)


def _pipeline_enabled() -> bool:
    """``DTM_CONV_MXU_PIPELINE``, read on every call of the core (the JAX
    package reads it once per trace): ``1`` runs K6, ``0`` (the default)
    K1; any other value raises naming the knob."""
    env = os.environ.get("DTM_CONV_MXU_PIPELINE", "0")
    if env not in ("0", "1"):
        raise ValueError(
            f"DTM_CONV_MXU_PIPELINE must be '0' or '1', got {env!r}")
    return env == "1"


def _core_window(x: torch.Tensor, kernel: torch.Tensor, win,
                 out=None) -> torch.Tensor:
    """The core on a window of ``x`` (see :func:`_launch_window`): K6 or K1
    (by the knob) for CUDA tensors, the plain version on the materialised
    window otherwise; the knob is validated either way."""
    pipelined = _pipeline_enabled()
    if x.is_cuda:
        return _launch_window(x, kernel.contiguous(), win, pipelined, out)
    kh, kw = kernel.shape[:2]
    h0, w0, sh, sw, oh, ow = win
    y = _core_reference(
        _materialize_window(x, (h0, w0, sh, sw, oh + kh - 1, ow + kw - 1)),
        kernel)
    if out is None:
        return y
    return out.copy_(y)


def _phases(kh, kw, sh, sw):
    """``(p, q, khp, kwq)`` of each stride phase, in the order the forward
    adds them: the taps ``k[p::sh, q::sw]``."""
    return [(p, q, len(range(p, kh, sh)), len(range(q, kw, sw)))
            for p in range(min(sh, kh)) for q in range(min(sw, kw))]


def _out_size(n, lo, hi, k, s):
    return (n + lo + hi - k) // s + 1


def _forward(x, kernel, strides, ph, pw):
    kh, kw = kernel.shape[:2]
    sh, sw = strides
    _, h, w, _ = x.shape
    oh = _out_size(h, *ph, kh, sh)
    ow = _out_size(w, *pw, kw, sw)
    y = None
    for p, q, _, _ in _phases(kh, kw, sh, sw):
        kp = kernel if sh == sw == 1 else kernel[p::sh, q::sw]
        yp = _core_window(x, kp, (p - ph[0], q - pw[0], sh, sw, oh, ow))
        y = yp if y is None else y + yp
    return y


def _crop(p, lo, s, n_out, size):
    """Rows ``[a, e)`` of a phase's dx whose input positions
    ``p - lo + i*s`` lie inside ``[0, size)``."""
    a = max(0, -((p - lo) // s))
    e = min(n_out, (size - 1 - p + lo) // s + 1)
    return a, e


def _covers(kdim, s, lo, n_out, size) -> bool:
    """Whether the phases' dx windows (``n_out + taps - 1`` positions each)
    reach every input position of one dimension; the positions left out
    are zeros."""
    seen = set()
    for p in range(min(s, kdim)):
        n = n_out + len(range(p, kdim, s)) - 1
        seen.update(range(p - lo, p - lo + n * s, s))
    return all(r in seen for r in range(size))


def _dx(g, kernel, x_shape, strides, ph, pw):
    kh, kw, _, _ = kernel.shape
    sh, sw = strides
    _, h, w, _ = x_shape
    _, oh, ow, _ = g.shape
    full = (_covers(kh, sh, ph[0], oh, h)
            and _covers(kw, sw, pw[0], ow, w))
    dx = (torch.empty if full else torch.zeros)(
        x_shape, dtype=g.dtype, device=g.device)
    if g.is_cuda and g.stride(3) != 1:
        g = g.contiguous()
    for p, q, khp, kwq in _phases(kh, kw, sh, sw):
        kp = kernel if sh == sw == 1 else kernel[p::sh, q::sw]
        # Full correlation: the same core on the (khp-1, kwq-1)-padded
        # cotangent with the rotated, IO-swapped kernel.
        krot = kp.flip(0, 1).permute(0, 1, 3, 2).contiguous()
        hs, ws = oh + khp - 1, ow + kwq - 1
        i0, i1 = _crop(p, ph[0], sh, hs, h)
        j0, j1 = _crop(q, pw[0], sw, ws, w)
        if i1 <= i0 or j1 <= j0:
            continue
        r0, c0 = p - ph[0] + i0 * sh, q - pw[0] + j0 * sw
        view = dx[:, r0:r0 + (i1 - i0 - 1) * sh + 1:sh,
                  c0:c0 + (j1 - j0 - 1) * sw + 1:sw, :]
        if g.is_cuda:
            _core_window(g, krot, (i0 - khp + 1, j0 - kwq + 1, 1, 1,
                                   i1 - i0, j1 - j0), out=view)
        else:
            # The plain version computes the whole phase, as the padded
            # route did, and keeps the rows inside x.
            yp = _core_window(g, krot, (1 - khp, 1 - kwq, 1, 1, hs, ws))
            view.copy_(yp[:, i0:i1, j0:j1])
    return dx


def _dw(x, g, kernel, strides, ph, pw):
    """One weight-sized dot per tap, contracting over (B, OH, OW), on the
    padded input built once; the matmul accumulates in f32 and the result
    is cast to the kernel's dtype."""
    kh, kw, cin, cout = kernel.shape
    sh, sw = strides
    _, oh, ow, _ = g.shape
    xp = _pad_nhwc(x, ph, pw)
    g2 = g.reshape(-1, cout)
    return torch.stack([
        torch.matmul(
            xp[:, dy:dy + (oh - 1) * sh + 1:sh,
               dx:dx + (ow - 1) * sw + 1:sw, :].reshape(-1, cin).t(),
            g2,
        )
        for dy in range(kh) for dx in range(kw)
    ]).reshape(kh, kw, cin, cout).to(kernel.dtype)


class _MxuConv(torch.autograd.Function):
    """The routed conv, NHWC x HWIO, strides and explicit padding, with the
    JAX package's VJP."""

    @staticmethod
    def forward(ctx, x, kernel, strides, ph, pw):
        ctx.save_for_backward(x, kernel)
        ctx.geometry = (strides, ph, pw)
        return _forward(x, kernel, strides, ph, pw)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "conv2d_mxu's backward is not differentiable: the mxu conv "
                "does not differentiate twice (create_graph=True)")
        x, kernel = ctx.saved_tensors
        strides, ph, pw = ctx.geometry
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = _dw(x, g, kernel, strides, ph, pw)
        if ctx.needs_input_grad[0]:
            dx = _dx(g, kernel, x.shape, strides, ph, pw)
        return dx, dw, None, None, None


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
    if x.is_cuda and x.stride(3) != 1:
        x = x.contiguous()
    return _MxuConv.apply(x, kernel, (sh, sw), ph, pw)
