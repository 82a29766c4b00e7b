"""The port's convolutions (distributed_tensorflow_models_tpu_torch/ops/conv.py,
conv_mxu.py) against the JAX package's.

Every input is made with numpy from a seed and handed to both frameworks.
On the CPU the port's ``mxu`` route runs K1's plain version
(``_core_reference``); the JAX side runs ``conv2d_mxu`` in interpret mode
or ``lax.conv_general_dilated``.  Tolerances are the JAX suite's own for
the same comparisons (tests/test_conv_mxu.py): forward 2e-4, grads 5e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from distributed_tensorflow_models_tpu.ops import conv_mxu as jconv_mxu
from distributed_tensorflow_models_tpu_torch.ops import conv as tconv
from distributed_tensorflow_models_tpu_torch.ops import conv_mxu as tconv_mxu

jax.config.update("jax_platforms", "cpu")

FWD_TOL = dict(atol=2e-4, rtol=2e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)

# The stride-1, stride-2, odd, even-kernel, explicit-pad and fallback
# classes of tests/test_conv_mxu.py::CASES.
CASES = [
    ((2, 16, 16, 64), (3, 3, 64, 48), (1, 1), "SAME", "3x3_s1_same"),
    ((2, 17, 15, 64), (3, 3, 64, 48), (2, 2), "SAME", "3x3_s2_odd"),
    ((2, 16, 16, 64), (5, 5, 64, 16), (1, 1), "VALID", "5x5_valid"),
    ((2, 16, 16, 64), (1, 1, 64, 64), (2, 2), "SAME", "1x1_s2"),
    ((2, 24, 24, 3), (7, 7, 3, 32), (2, 2), "SAME", "rgb_stem_fallback"),
    ((2, 16, 16, 32), (3, 3, 32, 48), (1, 1), "SAME", "low_cin_fallback"),
    ((2, 9, 9, 64), (3, 3, 64, 32), (3, 3), "SAME", "stride3"),
    ((2, 12, 12, 64), (2, 2, 64, 32), (2, 2), "VALID", "2x2_s2_valid"),
    ((2, 11, 11, 64), (4, 4, 64, 32), (1, 1), "SAME", "even_kernel_same"),
    ((2, 16, 16, 64), (3, 3, 64, 48), (1, 2), "SAME", "aniso_stride"),
    ((2, 16, 16, 64), (3, 3, 64, 48), (1, 1), ((2, 2), (0, 1)),
     "explicit_pad"),
]
IMPLS = ["patches", "xla", "mxu"]


@pytest.fixture(autouse=True)
def _full_f32():
    # f32 comparisons: no TF32 anywhere (the defaults matter on a GPU).
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _inputs(seed, xshape, kshape):
    rng = np.random.RandomState(seed)
    x = rng.randn(*xshape).astype(np.float32)
    k = (rng.randn(*kshape) * 0.1).astype(np.float32)
    return x, k


def _lax(x, k, strides, padding):
    return lax.conv_general_dilated(
        x, k, window_strides=strides, padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@functools.lru_cache(maxsize=None)
def _lax_forward(xshape, kshape, strides, padding):
    """The reference output of a case, computed once for all impls."""
    x, k = _inputs(0, xshape, kshape)
    return x, k, np.asarray(_lax(jnp.asarray(x), jnp.asarray(k), strides,
                                 padding))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize(
    "xshape,kshape,strides,padding", [c[:4] for c in CASES],
    ids=[c[4] for c in CASES],
)
def test_forward_matches_lax_conv(impl, xshape, kshape, strides, padding):
    x, k, want = _lax_forward(xshape, kshape, strides, padding)
    got = tconv.conv2d(_t(x), _t(k), strides, padding, impl=impl)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@functools.lru_cache(maxsize=None)
def _lax_grads(strides):
    x, k = _inputs(1, (2, 10, 10, 64), (3, 3, 64, 48))

    def jloss(x, k):
        return jnp.sum(jnp.sin(_lax(x, k, strides, "SAME")))

    return x, k, jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(k))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("strides", [(1, 1), (2, 2)], ids=["s1", "s2"])
def test_grads_match_lax_conv(impl, strides):
    x, k, want = _lax_grads(strides)
    tx, tk = _t(x, True), _t(k, True)
    torch.sum(torch.sin(tconv.conv2d(tx, tk, strides, "SAME", impl=impl))
              ).backward()
    for got, w in zip((tx.grad, tk.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


# Interpret mode runs at host speed: these hold the mxu route against the
# JAX kernel itself on small shapes of the kernel-routed classes.
MXU_CASES = [
    ((1, 8, 8, 64), (3, 3, 64, 24), (1, 1), "SAME", "3x3_s1"),
    ((1, 9, 7, 64), (3, 3, 64, 24), (2, 2), "SAME", "3x3_s2_odd"),
    ((1, 7, 7, 64), (4, 4, 64, 16), (1, 1), "SAME", "even_kernel"),
    ((1, 8, 8, 64), (3, 3, 64, 24), (1, 1), ((2, 2), (0, 1)), "explicit_pad"),
]


@pytest.mark.parametrize(
    "xshape,kshape,strides,padding", [c[:4] for c in MXU_CASES],
    ids=[c[4] for c in MXU_CASES],
)
def test_mxu_forward_matches_jax_kernel(xshape, kshape, strides, padding):
    x, k = _inputs(2, xshape, kshape)
    want = jax.jit(lambda x, k: jconv_mxu.conv2d_mxu(
        x, k, strides, padding, interpret=True))(jnp.asarray(x), jnp.asarray(k))
    got = tconv_mxu.conv2d_mxu(_t(x), _t(k), strides, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)], ids=["s1", "s2"])
def test_mxu_grads_match_jax_kernel(strides):
    x, k = _inputs(3, (1, 6, 6, 64), (3, 3, 64, 16))

    def jloss(x, k):
        return jnp.sum(jnp.sin(
            jconv_mxu.conv2d_mxu(x, k, strides, "SAME", interpret=True)))

    want = jax.jit(jax.grad(jloss, (0, 1)))(jnp.asarray(x), jnp.asarray(k))
    tx, tk = _t(x, True), _t(k, True)
    torch.sum(torch.sin(tconv_mxu.conv2d_mxu(tx, tk, strides, "SAME"))
              ).backward()
    for got, w in zip((tx.grad, tk.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


# The tap kernels K1 sees on ResNet-50's path: 3x3, the four phases of a
# stride-2 3x3 conv, and the rotated kernels of their dx.
CORE_CASES = [
    ((1, 6, 6, 64), (3, 3, 64, 16)),
    ((1, 5, 5, 64), (2, 2, 64, 16)),
    ((1, 5, 4, 64), (2, 1, 64, 16)),
    ((1, 4, 5, 64), (1, 2, 64, 16)),
    ((1, 4, 4, 64), (1, 1, 64, 16)),
]


@pytest.mark.parametrize("xshape,kshape", CORE_CASES,
                         ids=["3x3", "2x2", "2x1", "1x2", "1x1"])
def test_core_reference_matches_jax_core(xshape, kshape):
    x, k = _inputs(4, xshape, kshape)
    want = jax.jit(jconv_mxu._core, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(k), True)
    got = tconv_mxu._core_reference(_t(x), _t(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_routing_matches_jax():
    for kh, kw in [(1, 1), (3, 3), (2, 2), (1, 7), (7, 1), (5, 5), (7, 7)]:
        for cin in [1, 3, 16, 32, 63, 64, 65, 96, 128, 160, 192, 256, 320,
                    448, 512, 2048]:
            assert (tconv_mxu._use_mxu_kernel(kh, kw, cin)
                    == jconv_mxu._use_mxu_kernel(kh, kw, cin)), (kh, kw, cin)


@pytest.mark.parametrize("impl", IMPLS)
def test_impl_selector_and_env_default(impl, monkeypatch):
    assert tconv.resolve_conv_impl(impl) == impl
    monkeypatch.setattr(tconv, "_default_impl", impl)
    assert tconv.resolve_conv_impl("auto") == impl
    monkeypatch.setattr(tconv, "_default_impl", "cudnn")
    with pytest.raises(ValueError, match="DTM_CONV_IMPL"):
        tconv.resolve_conv_impl("auto")


def test_bf16_plain_core_keeps_dtype():
    x, k = _inputs(5, (1, 6, 6, 64), (3, 3, 64, 8))
    y = tconv_mxu.conv2d_mxu(_t(x).bfloat16(), _t(k).bfloat16(), (1, 1),
                             "SAME")
    assert y.dtype == torch.bfloat16


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 64, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tconv_mxu.conv_implicit_gemm(x, k)


def test_channel_mismatch_raises():
    with pytest.raises(ValueError, match="input channels"):
        tconv_mxu.conv2d_mxu(torch.zeros(1, 8, 8, 16),
                             torch.zeros(3, 3, 32, 8))



# Inception-v3's taps on small grids, Cin >= 64 so that the mxu route is
# taken: the factorized 1x7, 7x1, 1x3 and 3x1, the aux head's 5x5, and a
# 3x3 stride-2 reduction (its 2x2, 2x1, 1x2 and 1x1 phase kernels).
PIPELINE_CASES = [
    ((1, 9, 9, 64), (1, 7, 64, 24), (1, 1), "SAME", "1x7"),
    ((1, 9, 9, 64), (7, 1, 64, 24), (1, 1), "SAME", "7x1"),
    ((1, 6, 6, 96), (1, 3, 96, 24), (1, 1), "SAME", "1x3"),
    ((1, 6, 6, 96), (3, 1, 96, 24), (1, 1), "SAME", "3x1"),
    ((1, 7, 7, 64), (5, 5, 64, 16), (1, 1), "VALID", "5x5"),
    ((1, 9, 9, 64), (3, 3, 64, 24), (2, 2), "VALID", "3x3_s2"),
]


@pytest.mark.parametrize(
    "xshape,kshape,strides,padding", [c[:4] for c in PIPELINE_CASES],
    ids=[c[4] for c in PIPELINE_CASES],
)
def test_pipeline_knob_matches_jax_pipelined_kernel(monkeypatch, xshape,
                                                    kshape, strides, padding):
    """DTM_CONV_MXU_PIPELINE=1: the port's conv2d_mxu on the CPU (K6's plain
    version, which is K1's) against JAX's interpret-mode pipelined kernel,
    forward and the gradients dx and dw of sum(sin(y))."""
    monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", "1")
    x, k = _inputs(6, xshape, kshape)

    def jloss(x, k):
        y = jconv_mxu.conv2d_mxu(x, k, strides, padding, interpret=True)
        return jnp.sum(jnp.sin(y)), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(k))
    tx, tk = _t(x, True), _t(k, True)
    y = tconv_mxu.conv2d_mxu(tx, tk, strides, padding)
    torch.sum(torch.sin(y)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **FWD_TOL)
    for got, w in zip((tx.grad, tk.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


def test_pipeline_knob_runs_the_same_plain_function_on_cpu(monkeypatch):
    """On CPU tensors both arms of the knob run the one plain version: the
    outputs and gradients are the same bits, and no kernel is launched."""
    x, k = _inputs(7, (1, 9, 9, 64), (3, 3, 64, 24))
    out = {}
    before = (tconv_mxu.conv_implicit_gemm.launches,
              tconv_mxu.conv_implicit_gemm_pipelined.launches)
    for knob in ("0", "1"):
        monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", knob)
        tx, tk = _t(x, True), _t(k, True)
        y = tconv_mxu.conv2d_mxu(tx, tk, (2, 2), "SAME")
        torch.sum(torch.sin(y)).backward()
        out[knob] = (y.detach(), tx.grad, tk.grad)
    for a, b in zip(out["0"], out["1"]):
        assert torch.equal(a, b)
    assert (tconv_mxu.conv_implicit_gemm.launches,
            tconv_mxu.conv_implicit_gemm_pipelined.launches) == before


@pytest.mark.parametrize("bad", ["yes", "2", "true", ""])
def test_pipeline_knob_rejects_bad_values_like_jax(monkeypatch, bad):
    monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", bad)
    with pytest.raises(ValueError, match="DTM_CONV_MXU_PIPELINE"):
        jconv_mxu._pipeline_enabled()
    with pytest.raises(ValueError, match="DTM_CONV_MXU_PIPELINE"):
        tconv_mxu._pipeline_enabled()
    x, k = _inputs(8, (1, 6, 6, 64), (3, 3, 64, 8))
    with pytest.raises(ValueError, match="DTM_CONV_MXU_PIPELINE"):
        tconv_mxu.conv2d_mxu(_t(x), _t(k), (1, 1), "SAME")
    for ok, want in (("0", False), ("1", True)):
        monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", ok)
        assert tconv_mxu._pipeline_enabled() is want
        assert jconv_mxu._pipeline_enabled() is want


def test_pipelined_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 64, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tconv_mxu.conv_implicit_gemm_pipelined(x, k)


# The routed conv reads each stride phase as a window of the unpadded input
# (``_core_window``) inside one autograd Function (``_MxuConv``).  The
# route it replaced padded, sliced and summed with autograd's own pad and
# slice nodes; it is kept here as the oracle, and the two must agree bit
# for bit in f32 and bf16: y, dx and dw.
class _PaddedCore(torch.autograd.Function):
    """The stride-1 VALID core on a materialised padded input, with the
    JAX package's VJP: the route before the window entry."""

    @staticmethod
    def forward(ctx, xpad, kernel):
        ctx.save_for_backward(xpad, kernel)
        return tconv_mxu._core_reference(xpad, kernel)

    @staticmethod
    def backward(ctx, g):
        xpad, kernel = ctx.saved_tensors
        kh, kw, cin, cout = kernel.shape
        _, oh, ow, _ = g.shape
        g2 = g.reshape(-1, cout)
        dw = torch.stack([
            torch.matmul(xpad[:, dy:dy + oh, dx:dx + ow, :].reshape(-1, cin).t(),
                         g2)
            for dy in range(kh) for dx in range(kw)
        ]).reshape(kh, kw, cin, cout).to(kernel.dtype)
        gp = torch.nn.functional.pad(g, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
        krot = kernel.flip(0, 1).permute(0, 1, 3, 2).contiguous()
        return _PaddedCore.apply(gp, krot), dw


def _padded_route(x, kernel, strides, padding):
    kh, kw = kernel.shape[:2]
    sh, sw = strides
    ph, pw = tconv._explicit_padding(padding, kh, kw, sh, sw, x.shape[1],
                                     x.shape[2])
    x = tconv._pad_nhwc(x, ph, pw)
    _, hp, wp, _ = x.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    y = None
    for p in range(min(sh, kh)):
        khp = len(range(p, kh, sh))
        for q in range(min(sw, kw)):
            kwq = len(range(q, kw, sw))
            xs = x[:, p:p + (oh + khp - 2) * sh + 1:sh,
                   q:q + (ow + kwq - 2) * sw + 1:sw, :]
            yp = _PaddedCore.apply(xs, kernel[p::sh, q::sw])
            y = yp if y is None else y + yp
    return y


WINDOW_CASES = [
    ((2, 9, 8, 64), (3, 3, 64, 8), (1, 1), "SAME", "3x3_s1_same"),
    ((2, 9, 8, 64), (3, 3, 64, 8), (2, 2), "SAME", "3x3_s2_same"),
    ((2, 9, 8, 64), (3, 3, 64, 8), (2, 2), "VALID", "3x3_s2_valid"),
    ((2, 8, 9, 64), (3, 3, 64, 8), (1, 1), ((2, 1), (0, 2)), "3x3_explicit"),
    ((2, 8, 9, 64), (3, 3, 64, 8), (2, 2), ((0, 3), (2, 0)), "3x3_s2_explicit"),
    ((2, 7, 9, 64), (1, 7, 64, 8), (1, 1), "SAME", "1x7"),
    ((2, 9, 7, 64), (7, 1, 64, 8), (1, 1), "SAME", "7x1"),
    ((2, 7, 9, 64), (1, 3, 64, 8), (2, 2), "SAME", "1x3_s2_kh_lt_sh"),
    ((2, 7, 9, 64), (1, 3, 64, 8), (2, 2), "VALID", "1x3_s2_valid"),
    ((2, 9, 9, 64), (5, 5, 64, 8), (1, 1), "VALID", "5x5_valid"),
    ((2, 9, 9, 64), (5, 5, 64, 8), (2, 2), "SAME", "5x5_s2_same"),
    ((2, 6, 5, 64), (2, 2, 64, 8), (1, 1), "VALID", "2x2"),
    ((2, 6, 5, 64), (2, 1, 64, 8), (1, 1), "VALID", "2x1"),
    ((2, 6, 5, 64), (1, 2, 64, 8), (1, 1), "SAME", "1x2"),
    ((2, 6, 5, 64), (1, 1, 64, 8), (1, 1), "VALID", "1x1"),
    ((2, 6, 5, 64), (1, 1, 64, 8), (2, 2), "SAME", "1x1_s2"),
    ((2, 10, 10, 64), (3, 3, 64, 8), (3, 3), "SAME", "3x3_s3"),
    ((2, 9, 8, 64), (3, 3, 64, 8), (1, 2), "SAME", "aniso"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "xshape,kshape,strides,padding", [c[:4] for c in WINDOW_CASES],
    ids=[c[4] for c in WINDOW_CASES],
)
def test_window_route_equals_padded_route(xshape, kshape, strides, padding,
                                          dtype):
    """The Function's plain path (every kernel shape it may see, so called
    without the routing rule) against the padded route: the same bits for
    y, dx and dw, and no launch."""
    x, k = _inputs(9, xshape, kshape)
    g = np.random.RandomState(10)
    out = {}
    before = (tconv_mxu.conv_implicit_gemm.launches,
              tconv_mxu.conv_implicit_gemm_pipelined.launches)
    for name in ("window", "padded"):
        tx = _t(x).to(dtype).requires_grad_()
        tk = _t(k).to(dtype).requires_grad_()
        if name == "window":
            kh, kw = kshape[:2]
            ph, pw = tconv._explicit_padding(padding, kh, kw, *strides,
                                             xshape[1], xshape[2])
            y = tconv_mxu._MxuConv.apply(tx, tk, strides, ph, pw)
        else:
            y = _padded_route(tx, tk, strides, padding)
        if name == "window":
            cot = torch.tensor(g.randn(*y.shape).astype(np.float32)).to(dtype)
        y.backward(cot)
        out[name] = (y.detach(), tx.grad, tk.grad)
    for what, a, b in zip(("y", "dx", "dw"), out["window"], out["padded"]):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what
    assert (tconv_mxu.conv_implicit_gemm.launches,
            tconv_mxu.conv_implicit_gemm_pipelined.launches) == before


@pytest.mark.parametrize("win", [
    (0, 0, 1, 1, 5, 4), (-1, -2, 1, 1, 7, 8), (-1, 0, 2, 2, 4, 3),
    (1, -1, 2, 3, 3, 3), (2, 3, 1, 1, 6, 6), (-3, -3, 1, 1, 2, 2),
], ids=["plain", "pad", "phase", "aniso_step", "crop", "outside"])
def test_materialized_window_indexes_the_input(win):
    """The window ``out[:, i, j] = x[:, h0 + i*sh, w0 + j*sw]``, zero
    outside x, element by element."""
    h0, w0, sh, sw, hs, ws = win
    x = torch.arange(2 * 6 * 7 * 3, dtype=torch.float32).reshape(2, 6, 7, 3)
    got = tconv_mxu._materialize_window(x, win)
    assert tuple(got.shape) == (2, hs, ws, 3)
    for i in range(hs):
        for j in range(ws):
            r, c = h0 + i * sh, w0 + j * sw
            want = (x[:, r, c] if 0 <= r < 6 and 0 <= c < 7
                    else torch.zeros(2, 3))
            assert torch.equal(got[:, i, j], want), (i, j)


@pytest.mark.parametrize(
    "xshape,kshape,strides,padding", [c[:4] for c in MXU_CASES],
    ids=[c[4] for c in MXU_CASES],
)
def test_mxu_grads_match_jax_kernel_at_mxu_cases(xshape, kshape, strides,
                                                 padding):
    """y, dx and dw of the routed conv against JAX's interpret-mode
    conv2d_mxu, for sum(sin(y))."""
    x, k = _inputs(11, xshape, kshape)

    def jloss(x, k):
        y = jconv_mxu.conv2d_mxu(x, k, strides, padding, interpret=True)
        return jnp.sum(jnp.sin(y)), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(k))
    tx, tk = _t(x, True), _t(k, True)
    y = tconv_mxu.conv2d_mxu(tx, tk, strides, padding)
    torch.sum(torch.sin(y)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **FWD_TOL)
    for got, w in zip((tx.grad, tk.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


def test_mxu_conv_refuses_double_backward():
    x, k = _inputs(12, (1, 6, 6, 64), (3, 3, 64, 8))
    tx, tk = _t(x, True), _t(k, True)
    y = tconv_mxu.conv2d_mxu(tx, tk, (1, 1), "SAME")
    with pytest.raises(RuntimeError, match="does not differentiate twice"):
        torch.autograd.grad(y.sum(), tx, create_graph=True)
