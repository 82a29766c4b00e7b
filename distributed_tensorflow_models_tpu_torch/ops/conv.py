"""2-D convolution with a selectable lowering, and the pooling twins.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/conv.py``.
Layouts are that package's: NHWC activations and HWIO kernels, so the two
packages hold the same parameters.  ``impl`` picks the lowering:

- ``xla``: the framework's native convolution, ``F.conv2d``;
- ``patches``: im2col (pad, kh*kw shifted slices, concat) and one matmul;
- ``mxu``: the implicit-GEMM kernel of :mod:`.conv_mxu` (K1 on the GPU).

``impl="auto"`` resolves to ``DTM_CONV_IMPL`` (default ``xla``), as in the
JAX package.  Padding follows TF/XLA SAME exactly: the total pad is split
low-biased, which ``F.conv2d(padding="same")`` does not reproduce for
strided or even kernels, so every lowering pads explicitly with ``F.pad``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[tuple[int, int]]]

_VALID_IMPLS = ("xla", "patches", "mxu")

# Process-wide default used by impl="auto", read when this module is
# imported; set_default_conv_impl changes it afterwards.
_default_impl = os.environ.get("DTM_CONV_IMPL", "xla")


def set_default_conv_impl(impl: str) -> None:
    global _default_impl
    if impl not in _VALID_IMPLS:
        raise ValueError(f"conv impl must be one of {_VALID_IMPLS}, got {impl!r}")
    _default_impl = impl


def get_default_conv_impl() -> str:
    return _default_impl


def resolve_conv_impl(impl: str) -> str:
    if impl == "auto":
        if _default_impl not in _VALID_IMPLS:
            raise ValueError(
                f"default conv impl (DTM_CONV_IMPL) must be one of "
                f"{_VALID_IMPLS}, got {_default_impl!r}"
            )
        return _default_impl
    if impl not in _VALID_IMPLS:
        raise ValueError(
            f"conv impl must be 'auto' or one of {_VALID_IMPLS}, got {impl!r}"
        )
    return impl


def _explicit_padding(
    padding: Padding, kh: int, kw: int, sh: int, sw: int, h: int, w: int
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Resolve SAME/VALID/explicit padding to per-dim (low, high) pairs.

    SAME follows the TF/XLA definition: output size ceil(in/stride), total
    pad ``max((out-1)*stride + k - in, 0)`` split low-biased."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return (0, 0), (0, 0)
        if p == "SAME":
            def same(in_sz, k, s):
                out = -(-in_sz // s)
                total = max((out - 1) * s + k - in_sz, 0)
                return (total // 2, total - total // 2)

            return same(h, kh, sh), same(w, kw, sw)
        raise ValueError(f"unknown padding {padding!r}")
    (ph0, ph1), (pw0, pw1) = padding
    return (int(ph0), int(ph1)), (int(pw0), int(pw1))


def _pad_nhwc(x: torch.Tensor, ph, pw, value: float = 0.0) -> torch.Tensor:
    (ph0, ph1), (pw0, pw1) = ph, pw
    if ph0 or ph1 or pw0 or pw1:
        # F.pad lists pads from the last dim backwards: C, W, H.
        x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1), value=value)
    return x


def _shifted_slices(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int):
    """All kh*kw stride-decimated shifts of a padded NHWC tensor, row-major
    in (dy, dx) — the order a flattened HWIO kernel contracts in."""
    _, h, w, _ = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    out = [
        x[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw, :]
        for dy in range(kh)
        for dx in range(kw)
    ]
    return out, oh, ow


def conv2d_patches(x, kernel, strides=(1, 1), padding: Padding = "SAME"):
    """NHWC x HWIO conv as pad + slices + one matmul."""
    kh, kw, cin, cout = kernel.shape
    sh, sw = strides
    if x.shape[-1] != cin:
        raise ValueError(
            f"input channels {x.shape[-1]} != kernel input channels {cin}"
        )
    ph, pw = _explicit_padding(padding, kh, kw, sh, sw, x.shape[1], x.shape[2])
    x = _pad_nhwc(x, ph, pw)
    if kh == kw == 1:
        # Degenerate im2col: the "patch" is the pixel itself.
        return torch.matmul(x[:, ::sh, ::sw, :], kernel.reshape(cin, cout))
    cols, _, _ = _shifted_slices(x, kh, kw, sh, sw)
    xcol = torch.cat(cols, dim=-1)  # [B, OH, OW, kh*kw*cin]
    return torch.matmul(xcol, kernel.reshape(kh * kw * cin, cout))


def conv2d_xla(x, kernel, strides=(1, 1), padding: Padding = "SAME"):
    """NHWC x HWIO conv through the framework's native ``F.conv2d``."""
    kh, kw, cin, _ = kernel.shape
    if x.shape[-1] != cin:
        raise ValueError(
            f"input channels {x.shape[-1]} != kernel input channels {cin}"
        )
    sh, sw = strides
    ph, pw = _explicit_padding(padding, kh, kw, sh, sw, x.shape[1], x.shape[2])
    x = _pad_nhwc(x, ph, pw)
    # NHWC storage seen as NCHW is the channels_last layout F.conv2d takes.
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


def conv2d(x, kernel, strides=(1, 1), padding: Padding = "SAME",
           impl: str = "auto"):
    """NHWC x HWIO -> NHWC conv through the selected lowering."""
    impl = resolve_conv_impl(impl)
    if impl == "patches":
        return conv2d_patches(x, kernel, strides, padding)
    if impl == "mxu":
        # Deferred import: conv_mxu reuses this module's padding helpers.
        from .conv_mxu import conv2d_mxu

        return conv2d_mxu(x, kernel, strides, padding)
    return conv2d_xla(x, kernel, strides, padding)


def _pool(x, window, strides, padding: Padding, impl: str, kind: str):
    kh, kw = window
    sh, sw = strides
    impl = resolve_conv_impl(impl)
    ph, pw = _explicit_padding(padding, kh, kw, sh, sw, x.shape[1], x.shape[2])
    # Max pads with the dtype's lowest value; avg pads with zeros and
    # divides by the full window (count_include_pad, flax's avg_pool).
    fill = torch.finfo(x.dtype).min if kind == "max" else 0.0
    x = _pad_nhwc(x, ph, pw, value=fill)
    if impl == "xla":
        xn = x.permute(0, 3, 1, 2)
        if kind == "max":
            y = F.max_pool2d(xn, (kh, kw), stride=(sh, sw))
        else:
            y = F.avg_pool2d(xn, (kh, kw), stride=(sh, sw))
        return y.permute(0, 2, 3, 1)
    # "patches" and "mxu": the shifted-slice fold (pooling has no matmul).
    cols, _, _ = _shifted_slices(x, kh, kw, sh, sw)
    acc = cols[0]
    for c in cols[1:]:
        acc = torch.maximum(acc, c) if kind == "max" else acc + c
    if kind == "avg":
        acc = acc / (kh * kw)
    return acc


def max_pool(x, window, strides=None, padding: Padding = "VALID",
             impl: str = "auto"):
    """``flax.linen.max_pool`` semantics (omitted strides = (1, 1))."""
    return _pool(x, window, strides or (1, 1), padding, impl, "max")


def avg_pool(x, window, strides=None, padding: Padding = "VALID",
             impl: str = "auto"):
    """``flax.linen.avg_pool`` semantics (count_include_pad; omitted
    strides = (1, 1))."""
    return _pool(x, window, strides or (1, 1), padding, impl, "avg")


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal (±2 sd) scaled to variance
    1/fan_in."""
    # 0.8796... is the sd of a unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Conv2D(nn.Module):
    """``flax.linen.Conv``-shaped conv (2-D, NHWC/HWIO) with an ``impl``
    knob.  The ``kernel`` (and ``bias``) parameters are f32 and are cast to
    ``dtype`` at the call, flax's ``promote_dtype`` rule."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int],
                 strides: Union[int, tuple[int, int]] = 1,
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = ((strides, strides) if isinstance(strides, int)
                        else tuple(strides))
        self.padding = padding
        self.dtype = dtype
        self.impl = impl
        self.kernel = nn.Parameter(
            torch.empty(kh, kw, in_features, features, dtype=torch.float32))
        lecun_normal_(self.kernel, kh * kw * in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    # How the layer computes on a slice of its output channels under the
    # model axis (parallel/tensor.py::Split); None when it is whole.
    tp = None

    def forward(self, x):
        dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        x = x.to(dtype)
        if self.tp is not None:
            x = self.tp.enter(x)
        y = conv2d(x, self.kernel.to(dtype), self.strides, self.padding,
                   impl=self.impl)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y if self.tp is None else self.tp.exit(y)


class Dense(nn.Module):
    """``flax.linen.Dense``-shaped layer: ``kernel [in, out]`` (not
    ``nn.Linear``'s ``[out, in]``) and ``bias [out]`` (none with
    ``use_bias=False``), so flax trees map onto it unchanged.  The kernel
    is lecun-normal unless ``kernel_init(shape, generator)`` gives it."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True, kernel_init=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, features, dtype=torch.float32))
        if kernel_init is None:
            lecun_normal_(self.kernel, in_features, generator)
        else:
            with torch.no_grad():
                self.kernel.copy_(kernel_init((in_features, features),
                                              generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    # How the layer computes on its slice under the model axis
    # (parallel/tensor.py::Split): a column layer's output features, or a
    # row layer's input features, whose product is summed before the
    # bias.  None when it is whole.
    tp = None

    def forward(self, x):
        tp = self.tp
        x = x.to(self.dtype)
        if tp is not None:
            x = tp.enter(x)
        y = torch.matmul(x, self.kernel.to(self.dtype))
        if tp is not None:
            y = tp.reduce(y)
        y = y if self.bias is None else y + self.bias.to(self.dtype)
        return y if tp is None else tp.exit(y)
