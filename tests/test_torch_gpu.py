"""Tests of the port that need the card: K1-K6 have no CPU mode, and the
input pipeline's CUDA copy path (page-locked staging, the copy stream, the
consumer's ``wait_event`` and ``record_stream``) shows only there.

Every test here carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false.  This file imports no jax, so it
runs on a machine with the card and without JAX, past the JAX suite's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Inputs are bf16 made from numpy seeds; the reference is K1's plain
version (or the ``patches`` lowering) in f32 on the same values, with
TF32 off.  Tolerances: K1 rounds its f32 sums to bf16 once (half an ulp,
2^-8 relative) and sums in another order, so one ulp (2^-7) relative
plus 1e-3 of the output scale; through ``conv2d_mxu`` a stride-2 forward
also adds its phase outputs in bf16, so 2^-6 of the scale.

K2-K4 (``csrc/flash_attention.cu``) are held against their plain versions
in ``ops/attention.py`` on the same bf16 inputs, K3/K4 on the kernel's own
LSE and delta.  Both round P and dS to bf16 at the same points, so they
differ by the f32 summation order (the kernel's running max rescales what
the plain version sums at once), rare one-ulp flips of a rounded P or dS,
and the bf16 rounding of each output (half an ulp, 2^-9): 2^-6 relative
plus 1e-2 of the output's largest magnitude; the f32 LSE to 1e-4.  Rows
with no valid key are left out: their values depend on the tiles visited,
in the JAX package too.

K6 (the persistent, ring-pipelined K1) must equal K1 bit for bit.  K5's
dK and dV come from K3's own code and must equal K3's bit for bit; its dQ
is held to its plain version at the K2-K4 tolerance, on a dS stage filled
with NaN first so that a tile read but never written shows, and must equal
K4's bit for bit (the JAX package's pair and staged backwards promise the
same dQ).
"""

import math
import threading

import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
from distributed_tensorflow_models_tpu_torch.models.inception_v3 import InceptionV3
from distributed_tensorflow_models_tpu_torch.models.resnet import ResNet
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import TransformerLM
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
from distributed_tensorflow_models_tpu_torch.ops import conv_mxu
from distributed_tensorflow_models_tpu_torch.ops import optim

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K4 have no CPU mode")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _bf16(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.bfloat16, device="cuda")


# Tap shapes K1 sees on ResNet-50's path (3x3, the four phases of a
# stride-2 3x3 conv) plus ragged M, Cin and Cout that take the masked and
# the scalar-load paths.
CORE_CASES = [
    ((2, 10, 10, 64), (3, 3, 64, 48)),
    ((1, 5, 5, 64), (2, 2, 64, 16)),
    ((1, 5, 4, 64), (2, 1, 64, 16)),
    ((1, 4, 5, 64), (1, 2, 64, 16)),
    ((3, 4, 4, 64), (1, 1, 64, 136)),
    ((2, 9, 7, 20), (2, 1, 20, 13)),
    ((1, 7, 7, 72), (5, 3, 72, 40)),
]


# Inception-v3's widths, which pick the N tiles 96, 160, 192, 144 (288),
# 160 (320), 224 (448), and its Cin 80 (a 16-channel tail step).
INCEPTION_CORE_CASES = [
    ((2, 9, 9, 64), (3, 3, 64, 96)),
    ((2, 9, 11, 160), (1, 7, 160, 160)),
    ((2, 11, 9, 192), (7, 1, 192, 192)),
    ((2, 8, 8, 96), (3, 3, 96, 288)),
    ((2, 8, 8, 192), (3, 3, 192, 320)),
    ((2, 8, 8, 384), (3, 1, 384, 448)),
    ((2, 12, 12, 80), (3, 3, 80, 192)),
]


@pytest.mark.parametrize("xshape,kshape", CORE_CASES + INCEPTION_CORE_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, xshape, kshape):
    rng = np.random.default_rng(6)
    x = _bf16(rng, xshape)
    k = _bf16(rng, kshape, 1.0 / math.sqrt(math.prod(kshape[:3])))
    before = conv_mxu.conv_implicit_gemm.launches
    got = conv_mxu.conv_implicit_gemm(x, k)
    torch.cuda.synchronize()
    assert conv_mxu.conv_implicit_gemm.launches == before + 1
    assert got.dtype == torch.bfloat16
    want = conv_mxu._core_reference(x.float(), k.float())
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7,
                               atol=1e-3 * scale)


def test_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 6, 6, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 64, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        conv_mxu.conv_implicit_gemm(x.float(), k.float())
    with pytest.raises(ValueError, match="contiguous"):
        conv_mxu.conv_implicit_gemm(x[:, ::2], k)
    with pytest.raises(ValueError, match="input channels"):
        conv_mxu.conv_implicit_gemm(x, k[:, :, :32])
    with pytest.raises(ValueError, match="CUDA"):
        conv_mxu.conv_implicit_gemm(x.cpu(), k)


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)], ids=["s1", "s2"])
def test_conv2d_mxu_grads_match_patches(cuda, strides):
    rng = np.random.default_rng(7)
    x = _bf16(rng, (2, 12, 12, 64))
    k = _bf16(rng, (3, 3, 64, 32), 1.0 / math.sqrt(9 * 64))
    xb, kb = x.clone().requires_grad_(), k.clone().requires_grad_()
    x32, k32 = x.float().requires_grad_(), k.float().requires_grad_()
    y = conv_mxu.conv2d_mxu(xb, kb, strides, "SAME")
    g = _bf16(rng, tuple(y.shape))
    y.backward(g)
    y32 = convlib.conv2d_patches(x32, k32, strides, "SAME")
    y32.backward(g.float())
    for got, want in ((y.detach(), y32.detach()), (xb.grad, x32.grad),
                      (kb.grad, k32.grad)):
        scale = float(want.abs().max())
        assert float((got.float() - want).abs().max()) <= 2.0 ** -6 * scale


def test_train_step_on_card_runs_k1(cuda):
    """Two bf16 steps of a small ResNet through the mxu route launch K1
    for every routed 3x3 conv, forward and dx, and keep the loss finite."""
    gen = torch.Generator().manual_seed(0)
    model = ResNet(stage_sizes=(1, 1, 1, 1), width=16, num_classes=10,
                   conv_impl="mxu", generator=gen).to(cuda)
    state = TrainState.create(model, optim.tf_momentum(0.01, 0.9))
    step = train_loop.make_train_step(
        train_loop.classification_loss_fn(model, weight_decay=1e-4))
    rng = np.random.default_rng(8)
    before = conv_mxu.conv_implicit_gemm.launches
    for _ in range(2):
        batch = {"image": torch.tensor(rng.standard_normal((4, 32, 32, 3)),
                                       dtype=torch.float32, device=cuda),
                 "label": torch.tensor(rng.integers(0, 10, 4), device=cuda)}
        state, metrics = step(state, batch, 0)
        assert math.isfinite(float(metrics["loss"]))
    # Stages 2 and 3 (cin 64 and 128) each have one stride-2 3x3 conv:
    # four phases forward and four dx per step.
    assert conv_mxu.conv_implicit_gemm.launches - before == 2 * 2 * 8
    assert state.step == 2


# (B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset): the main
# path's head dim 32 and the sweep's 64 and 128, GQA, a window, offsets,
# and lengths that are no multiple of the kernels' 64-row tiles.  Then the
# edges of K2's 128-row tiles and TMA loads: B > 1 with Tq and Tkv no
# multiple of 128 (a tensor map that read the next batch's rows would show
# there), D 128 at T 384, a window narrower than a tile, offsets that put
# a KV tile boundary inside the diagonal, and a GQA group of 4.  Then the
# tiles of K3 and K5 (128 keys by 64 queries; K5's dQ 128 x 128): Tkv no
# multiple of 128, and none of 8 (K5's dS rows then are not 16-byte
# aligned: its stores and loads take the element path), a window that ends
# inside a 128-key tile, GQA with offsets and a window, D 128 causal at T
# 384 with a window and ragged at T 130 x 77.
FLASH_CASES = [
    (2, 256, 256, 4, 4, 32, True, None, 0, 0),
    (2, 256, 256, 4, 4, 64, False, None, 0, 0),
    (1, 200, 136, 4, 2, 64, False, None, 0, 0),
    (2, 256, 256, 8, 2, 32, True, 80, 0, 0),
    (1, 128, 192, 2, 1, 128, True, None, 192, 64),
    (1, 96, 160, 4, 4, 32, True, 100, 200, 100),
    (2, 200, 328, 4, 2, 64, False, None, 0, 0),
    (2, 200, 328, 4, 4, 32, True, None, 128, 0),
    (1, 384, 384, 4, 4, 128, True, None, 0, 0),
    (2, 256, 256, 4, 4, 64, True, 16, 0, 0),
    (1, 256, 384, 4, 4, 32, True, None, 64, 0),
    (2, 320, 320, 8, 2, 64, True, None, 0, 0),
    (1, 100, 100, 2, 2, 64, False, None, 0, 0),
    (1, 384, 384, 4, 4, 64, True, 200, 0, 0),
    (2, 160, 296, 8, 2, 32, True, 96, 136, 0),
    (1, 384, 384, 2, 2, 128, True, 100, 0, 0),
    (1, 130, 77, 2, 1, 128, False, None, 0, 0),
]
FLASH_RTOL, FLASH_ATOL_OF_SCALE, LSE_ATOL = 2.0 ** -6, 1e-2, 1e-4


def _flash_inputs(case, seed):
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko = case
    rng = np.random.default_rng(seed)
    q, do = _bf16(rng, (B, Tq, H, D)), _bf16(rng, (B, Tq, H, D))
    k, v = _bf16(rng, (B, Tkv, Hkv, D)), _bf16(rng, (B, Tkv, Hkv, D))
    kw = dict(scale=D ** -0.5, causal=causal, window=window, q_offset=qo,
              kv_offset=ko)
    valid = attnlib._valid(Tq, Tkv, causal, window, qo, ko, "cuda")
    rows = (torch.ones(Tq, dtype=torch.bool, device="cuda") if valid is None
            else valid.any(-1))
    return q, k, v, do, kw, rows


def _assert_flash_close(got, want, what):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = err > FLASH_ATOL_OF_SCALE * scale + FLASH_RTOL * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {bad.numel()} over tolerance, max abs "
        f"err {float(err.max()):.4g}, scale {scale:.4g}")


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernels_match_plain(cuda, case):
    q, k, v, do, kw, rows = _flash_inputs(case, 11)
    before = (attnlib.flash_forward.launches, attnlib.flash_dkv.launches,
              attnlib.flash_dq.launches)
    out, lse = attnlib.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = attnlib._flash_forward_reference(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_flash_close(out[:, rows], want_out[:, rows], "K2 out")
    torch.testing.assert_close(lse[:, :, rows], want_lse[:, :, rows],
                               rtol=0, atol=LSE_ATOL)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dk, dv = attnlib.flash_dkv(*args, **kw)
    dq = attnlib.flash_dq(*args, **kw)
    torch.cuda.synchronize()
    want_dk, want_dv = attnlib._flash_dkv_reference(*args, **kw)
    want_dq = attnlib._flash_dq_reference(*args, **kw)
    # dK/dV sum over queries: a row with no valid key enters them, so
    # every row must have one here (all cases do, rows.all()).
    assert bool(rows.all())
    _assert_flash_close(dk, want_dk, "K3 dk")
    _assert_flash_close(dv, want_dv, "K3 dv")
    _assert_flash_close(dq, want_dq, "K4 dq")
    assert (attnlib.flash_forward.launches, attnlib.flash_dkv.launches,
            attnlib.flash_dq.launches) == tuple(n + 1 for n in before)


def test_flash_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 64, 2, 32, device=cuda, dtype=torch.bfloat16)
    kw = dict(scale=1.0, causal=True, window=None, q_offset=0, kv_offset=0)
    with pytest.raises(TypeError, match="bfloat16"):
        attnlib.flash_forward(q.float(), q.float(), q.float(), **kw)
    with pytest.raises(ValueError, match="head dim"):
        attnlib.flash_forward(q[..., :16].contiguous(),
                              q[..., :16].contiguous(),
                              q[..., :16].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        attnlib.flash_forward(q.transpose(1, 2), q, q, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        attnlib.flash_forward(q.cpu(), q, q, **kw)


def test_flash_attention_autograd_on_card(cuda):
    """flash_attention on CUDA tensors goes through K2, K3 and K4 (one
    launch each) and its bf16 grads sit within the JAX suite's bf16
    tolerance of the f32 reference's."""
    rng = np.random.default_rng(12)
    shape = (2, 128, 4, 32)
    q32, k32, v32 = (torch.tensor(rng.standard_normal(shape) * 0.5,
                                  dtype=torch.float32, device=cuda)
                     for _ in range(3))
    qb, kb, vb = (t.bfloat16().requires_grad_() for t in (q32, k32, v32))
    q32, k32, v32 = (t.requires_grad_() for t in (q32, k32, v32))
    before = (attnlib.flash_forward.launches, attnlib.flash_dkv.launches,
              attnlib.flash_dq.launches)
    (attnlib.flash_attention(qb, kb, vb, True).float() ** 2).sum().backward()
    assert (attnlib.flash_forward.launches, attnlib.flash_dkv.launches,
            attnlib.flash_dq.launches) == tuple(n + 1 for n in before)
    (attnlib.reference_attention(q32, k32, v32, causal=True) ** 2).sum().backward()
    for got, want in ((qb.grad, q32.grad), (kb.grad, k32.grad),
                      (vb.grad, v32.grad)):
        torch.testing.assert_close(got.float(), want, rtol=0.1, atol=0.15)


def test_lm_train_step_on_card_runs_flash(cuda):
    """Two bf16 steps of a small transformer (head dim 32) with
    attn_impl="flash": K2, K3 and K4 launch once per layer per step and
    the loss stays finite."""
    gen = torch.Generator().manual_seed(0)
    model = TransformerLM(vocab_size=128, num_layers=2, num_heads=2,
                          d_model=64, d_ff=128, max_len=64, dropout_rate=0.1,
                          attn_impl="flash", generator=gen).to(cuda)
    state = TrainState.create(model, optim.chain(
        optim.clip_by_global_norm(1.0), optim.adam(3e-4)))
    step = train_loop.make_train_step(
        train_loop.lm_loss_fn(model, fused_unembed=True))
    rng = np.random.default_rng(13)
    before = (attnlib.flash_forward.launches, attnlib.flash_dkv.launches,
              attnlib.flash_dq.launches)
    for _ in range(2):
        toks = torch.tensor(rng.integers(0, 128, (4, 65)), device=cuda)
        state, metrics = step(state, {"inputs": toks[:, :-1],
                                      "targets": toks[:, 1:]}, 0)
        assert math.isfinite(float(metrics["loss"]))
    assert (attnlib.flash_forward.launches, attnlib.flash_dkv.launches,
            attnlib.flash_dq.launches) == tuple(n + 4 for n in before)


# K6 against K1: K1's cases, Inception-v3's taps (1x7, 7x1, the aux head's
# 5x5, Cin 448), and shapes with more output tiles than K6 has blocks, on
# the vector and the scalar load paths, so that the ring crosses tiles.
K6_CASES = CORE_CASES + [
    ((2, 17, 23, 160), (1, 7, 160, 192)),
    ((2, 23, 17, 192), (7, 1, 192, 160)),
    ((2, 5, 5, 128), (5, 5, 128, 768)),
    ((2, 10, 10, 448), (3, 3, 448, 384)),
    ((32, 35, 35, 288), (3, 3, 288, 384)),
    ((16, 40, 40, 20), (3, 3, 20, 200)),
]


@pytest.mark.parametrize("xshape,kshape", K6_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_pipelined_kernel_equals_k1(cuda, xshape, kshape):
    rng = np.random.default_rng(14)
    x = _bf16(rng, xshape)
    k = _bf16(rng, kshape, 1.0 / math.sqrt(math.prod(kshape[:3])))
    before = (conv_mxu.conv_implicit_gemm.launches,
              conv_mxu.conv_implicit_gemm_pipelined.launches)
    want = conv_mxu.conv_implicit_gemm(x, k)
    got = conv_mxu.conv_implicit_gemm_pipelined(x, k)
    torch.cuda.synchronize()
    assert (conv_mxu.conv_implicit_gemm.launches,
            conv_mxu.conv_implicit_gemm_pipelined.launches) == (
                before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)


def test_pipelined_wrapper_refuses_what_k1_refuses(cuda):
    x = torch.zeros(1, 6, 6, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 64, 8, device=cuda, dtype=torch.bfloat16)
    f = conv_mxu.conv_implicit_gemm_pipelined
    with pytest.raises(TypeError, match="bfloat16"):
        f(x.float(), k.float())
    with pytest.raises(ValueError, match="contiguous"):
        f(x[:, ::2], k)
    with pytest.raises(ValueError, match="input channels"):
        f(x, k[:, :, :32])
    with pytest.raises(ValueError, match="CUDA"):
        f(x.cpu(), k)


def test_pipeline_knob_picks_the_kernel_per_call(cuda, monkeypatch):
    """DTM_CONV_MXU_PIPELINE is read on every call of the core: =1 launches
    only K6, =0 only K1, and the two give the same bits."""
    rng = np.random.default_rng(15)
    x = _bf16(rng, (2, 12, 12, 64))
    k = _bf16(rng, (3, 3, 64, 32), 1.0 / math.sqrt(9 * 64))
    out = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", knob)
        before = (conv_mxu.conv_implicit_gemm.launches,
                  conv_mxu.conv_implicit_gemm_pipelined.launches)
        out[knob] = conv_mxu.conv2d_mxu(x, k, (2, 2), "SAME")
        k1 = conv_mxu.conv_implicit_gemm.launches - before[0]
        k6 = conv_mxu.conv_implicit_gemm_pipelined.launches - before[1]
        assert (k1, k6) == ((0, 4) if knob == "1" else (4, 0))
    assert torch.equal(out["1"], out["0"])
    monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", "on")
    with pytest.raises(ValueError, match="DTM_CONV_MXU_PIPELINE"):
        conv_mxu.conv2d_mxu(x, k, (1, 1), "SAME")


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_staged_matches_pair_and_plain(cuda, case):
    q, k, v, do, kw, rows = _flash_inputs(case, 16)
    out, lse = attnlib.flash_forward(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    B, Tq, H, _ = q.shape
    ds = torch.full((B * H, Tq, k.shape[1]), float("nan"),
                    dtype=torch.bfloat16, device=cuda)
    before = (attnlib.flash_dkv_staged.launches,
              attnlib.flash_dq_staged.launches)
    dk, dv, ds = attnlib.flash_dkv_staged(*args, **kw, ds=ds)
    dq = attnlib.flash_dq_staged(ds, k, **kw)
    pair_dk, pair_dv = attnlib.flash_dkv(*args, **kw)
    pair_dq = attnlib.flash_dq(*args, **kw)
    torch.cuda.synchronize()
    assert (attnlib.flash_dkv_staged.launches,
            attnlib.flash_dq_staged.launches) == tuple(n + 1 for n in before)
    assert torch.equal(dk, pair_dk) and torch.equal(dv, pair_dv)
    assert not bool(torch.isnan(dq).any())
    want_dk, want_dv, want_ds = attnlib._flash_dkv_staged_reference(*args, **kw)
    want_dq = attnlib._flash_dq_staged_reference(want_ds, k, **kw)
    _assert_flash_close(dq, want_dq, "K5 dq")
    # K4 forms dS as K3 does and sums dS K in K5's order: the same bits.
    assert torch.equal(dq, pair_dq), (
        f"K5 dq differs from K4's in {int((dq != pair_dq).sum())} elements")
    # Every valid pair lies in a tile that runs: its staged dS is written.
    valid = attnlib._valid(Tq, k.shape[1], kw["causal"], kw["window"],
                           kw["q_offset"], kw["kv_offset"], "cuda")
    sel = (torch.ones(Tq, k.shape[1], dtype=torch.bool, device=cuda)
           if valid is None else valid)
    got_ds = ds.view(B, H, Tq, -1)[:, :, sel]
    _assert_flash_close(got_ds, want_ds.view(B, H, Tq, -1)[:, :, sel],
                        "K5 ds")


def test_flash_attention_staged_autograd_on_card(cuda, monkeypatch):
    """DTM_FLASH_BWD=staged on CUDA tensors: K2 and both K5 launches once
    each, K3 and K4 not at all, and the gradients the pair gives."""
    rng = np.random.default_rng(17)
    shape = (2, 128, 4, 32)
    base = [torch.tensor(rng.standard_normal(shape) * 0.5,
                         dtype=torch.bfloat16, device=cuda) for _ in range(3)]
    names = ("flash_forward", "flash_dkv", "flash_dq", "flash_dkv_staged",
             "flash_dq_staged")
    grads = {}
    for bwd, want in (("staged", (1, 0, 0, 1, 1)), ("pair", (1, 1, 1, 0, 0))):
        monkeypatch.setenv("DTM_FLASH_BWD", bwd)
        ts = [t.clone().requires_grad_() for t in base]
        before = [getattr(attnlib, n).launches for n in names]
        out = attnlib.attention(*ts, causal=True, impl="flash")
        (out.float() ** 2).sum().backward()
        assert tuple(getattr(attnlib, n).launches - b
                     for n, b in zip(names, before)) == want
        grads[bwd] = [t.grad for t in ts]
    for got, want in zip(grads["staged"][1:], grads["pair"][1:]):
        assert torch.equal(got, want)
    _assert_flash_close(grads["staged"][0], grads["pair"][0], "dq")


def test_modern_lm_train_step_on_card_runs_k5(cuda, monkeypatch):
    """Two bf16 steps of a small rope + GQA + window transformer with the
    staged backward: K2 and both K5 launches once per layer per step."""
    monkeypatch.setenv("DTM_FLASH_BWD", "staged")
    gen = torch.Generator().manual_seed(0)
    model = TransformerLM(vocab_size=128, num_layers=2, num_heads=4,
                          d_model=128, d_ff=256, max_len=128,
                          dropout_rate=0.1, attn_impl="flash",
                          pos_encoding="rope", num_kv_heads=2, attn_window=48,
                          generator=gen).to(cuda)
    state = TrainState.create(model, optim.chain(
        optim.clip_by_global_norm(1.0), optim.adam(3e-4)))
    step = train_loop.make_train_step(
        train_loop.lm_loss_fn(model, fused_unembed=True))
    rng = np.random.default_rng(18)
    names = ("flash_forward", "flash_dkv_staged", "flash_dq_staged",
             "flash_dkv", "flash_dq")
    before = [getattr(attnlib, n).launches for n in names]
    for _ in range(2):
        toks = torch.tensor(rng.integers(0, 128, (4, 129)), device=cuda)
        state, metrics = step(state, {"inputs": toks[:, :-1],
                                      "targets": toks[:, 1:]}, 0)
        assert math.isfinite(float(metrics["loss"]))
    assert [getattr(attnlib, n).launches - b
            for n, b in zip(names, before)] == [4, 4, 4, 0, 0]


def test_inception_train_step_on_card_runs_k6(cuda, monkeypatch):
    """One bf16 step of Inception-v3 (10 classes, batch 2 at 299x299) with
    the mxu convs and DTM_CONV_MXU_PIPELINE=1: every routed conv runs K6,
    none K1, and the loss (aux head, smoothing, EMA) stays finite."""
    monkeypatch.setenv("DTM_CONV_MXU_PIPELINE", "1")
    gen = torch.Generator().manual_seed(0)
    model = InceptionV3(num_classes=10, conv_impl="mxu",
                        generator=gen).to(cuda)
    state = TrainState.create(model, optim.tf_rmsprop(0.045), ema_decay=0.9999)
    step = train_loop.make_train_step(train_loop.classification_loss_fn(
        model, label_smoothing=0.1, weight_decay=4e-5, aux_loss_weight=0.4))
    rng = np.random.default_rng(19)
    batch = {"image": torch.tensor(rng.standard_normal((2, 299, 299, 3)),
                                   dtype=torch.float32, device=cuda),
             "label": torch.tensor(rng.integers(0, 10, 2), device=cuda)}
    before = (conv_mxu.conv_implicit_gemm.launches,
              conv_mxu.conv_implicit_gemm_pipelined.launches)
    state, metrics = step(state, batch, 0)
    assert math.isfinite(float(metrics["loss"]))
    assert conv_mxu.conv_implicit_gemm.launches == before[0]
    assert conv_mxu.conv_implicit_gemm_pipelined.launches > before[1]
    assert train_loop.state_is_finite(state)


# Windows of the unpadded input: negative origins (padding), steps of 2
# (stride phases), origins inside (crops), and outputs written at strides.
WINDOW_CASES = [
    ((2, 9, 8, 64), (3, 3, 64, 64), (-1, -1, 1, 1, 9, 8)),
    ((2, 9, 8, 64), (2, 2, 64, 96), (-1, 0, 2, 2, 4, 4)),
    ((2, 9, 8, 128), (2, 1, 128, 64), (1, -1, 2, 2, 4, 4)),
    ((3, 7, 9, 64), (1, 3, 64, 192), (0, -1, 2, 2, 4, 4)),
    ((2, 17, 17, 160), (1, 7, 160, 192), (0, -3, 1, 1, 17, 17)),
    ((2, 10, 10, 64), (3, 3, 64, 72), (2, 3, 1, 1, 4, 3)),
    ((2, 9, 8, 20), (3, 3, 20, 13), (-1, -1, 2, 1, 5, 8)),
]


@pytest.mark.parametrize("pipelined", [False, True], ids=["k1", "k6"])
@pytest.mark.parametrize("xshape,kshape,win", WINDOW_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_window_entry_matches_materialised_route(cuda, xshape, kshape, win,
                                                 pipelined):
    """The kernels on a window of the unpadded input, written into a
    strided window of a larger buffer, against the same kernel on the
    materialised window (the same bits: the same tiles in the same order)
    and against the plain version; the buffer outside the window is left
    as it was."""
    rng = np.random.default_rng(20)
    x = _bf16(rng, xshape)
    k = _bf16(rng, kshape, 1.0 / math.sqrt(math.prod(kshape[:3])))
    h0, w0, sh, sw, oh, ow = win
    kh, kw = kshape[:2]
    xw = conv_mxu._materialize_window(
        x, (h0, w0, sh, sw, oh + kh - 1, ow + kw - 1)).contiguous()
    f = (conv_mxu.conv_implicit_gemm_pipelined if pipelined
         else conv_mxu.conv_implicit_gemm)
    want = f(xw, k)
    buf = torch.full((xshape[0], 2 * oh + 1, 2 * ow + 1, kshape[3]), 7.0,
                     dtype=torch.bfloat16, device=cuda)
    view = buf[:, 1::2, 1::2]
    before = f.launches
    got = conv_mxu._launch_window(x, k, win, pipelined, out=view)
    torch.cuda.synchronize()
    assert f.launches == before + 1 and got.data_ptr() == view.data_ptr()
    assert torch.equal(view, want)
    mask = torch.ones_like(buf, dtype=torch.bool)
    mask[:, 1::2, 1::2] = False
    assert bool((buf[mask] == 7.0).all())
    ref = conv_mxu._core_reference(xw.float(), k.float())
    scale = float(ref.abs().max())
    torch.testing.assert_close(view.float(), ref, rtol=2.0 ** -7,
                               atol=1e-3 * scale)


@pytest.mark.parametrize("strides,padding", [
    ((1, 1), "SAME"), ((2, 2), "SAME"), ((2, 2), "VALID"),
    ((1, 1), ((2, 0), (1, 3))),
], ids=["s1_same", "s2_same", "s2_valid", "explicit"])
def test_conv2d_mxu_forward_and_dx_copy_no_activation(cuda, strides,
                                                      padding):
    """conv2d_mxu's forward and dx on the card: no pad and no copy of an
    activation-sized tensor (batch 5: no weight copy has a dimension of
    5), only the kernels and the phase sums; y and dx equal the padded
    route's (pad, phase slice, K1, sum) bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    copies = {"constant_pad_nd", "copy_", "clone", "_to_copy", "cat",
              "stack", "slice_scatter", "as_strided_scatter", "index_put_",
              "reflection_pad2d", "replication_pad2d"}

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            res = out if isinstance(out, torch.Tensor) else None
            if name in copies and res is not None and res.dim() == 4 \
                    and res.shape[0] == 5:
                self.ops.append((name, tuple(res.shape)))
            return out

    rng = np.random.default_rng(21)
    x = _bf16(rng, (5, 13, 12, 64))
    k = _bf16(rng, (3, 3, 64, 32), 1.0 / math.sqrt(9 * 64))
    xb = x.clone().requires_grad_()
    before = conv_mxu.conv_implicit_gemm.launches
    with Record() as rec:
        y = conv_mxu.conv2d_mxu(xb, k, strides, padding)
        g = torch.empty_like(y)
    g.copy_(_bf16(rng, tuple(y.shape)))
    with Record() as rec_bwd:
        y.backward(g)
    torch.cuda.synchronize()
    assert rec.ops == [] and rec_bwd.ops == [], (rec.ops, rec_bwd.ops)
    assert conv_mxu.conv_implicit_gemm.launches > before

    # The padded route on the same values: materialised pad and phase
    # slices, K1 on each, the phase outputs summed in the same order; dx
    # through the padded cotangent, scattered back and cropped.
    kh, kw = 3, 3
    sh, sw = strides
    ph, pw = convlib._explicit_padding(padding, kh, kw, sh, sw, 13, 12)
    xp = convlib._pad_nhwc(x, ph, pw)
    _, hp, wp, _ = xp.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    want_y, dxp = None, torch.zeros_like(xp)
    for p in range(min(sh, kh)):
        khp = len(range(p, kh, sh))
        for q in range(min(sw, kw)):
            kwq = len(range(q, kw, sw))
            xs = xp[:, p:p + (oh + khp - 2) * sh + 1:sh,
                    q:q + (ow + kwq - 2) * sw + 1:sw, :].contiguous()
            kp = k[p::sh, q::sw].contiguous()
            yp = conv_mxu.conv_implicit_gemm(xs, kp)
            want_y = yp if want_y is None else want_y + yp
            gp = torch.nn.functional.pad(
                g, (0, 0, kwq - 1, kwq - 1, khp - 1, khp - 1)).contiguous()
            krot = kp.flip(0, 1).permute(0, 1, 3, 2).contiguous()
            dxp[:, p:p + (oh + khp - 2) * sh + 1:sh,
                q:q + (ow + kwq - 2) * sw + 1:sw, :] += \
                conv_mxu.conv_implicit_gemm(gp, krot)
    want_dx = dxp[:, ph[0]:ph[0] + 13, pw[0]:pw[0] + 12]
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(xb.grad, want_dx)


# --- The input pipeline's CUDA path -----------------------------------------
# DevicePrefetcher stages each host batch in page-locked memory and copies
# it on a stream of its own; the consumer's stream waits on the copy's event
# and records the batch's tensors.  These checks read every batch back and
# hold it to its host batch exactly.

# ~10 ms of spinning on an H100 (about 1.7e9 cycles a second).
_SLEEP_CYCLES = 17_000_000


class _HostBatches:
    """``n`` distinct host batches (4 MiB of f32 and a label vector), each
    released to the prefetcher's fill thread only when ``gate`` is given a
    permit (with ``gated``), so a test can queue work on the copy stream
    ahead of that batch's copy."""

    def __init__(self, n, gated=False):
        rng = np.random.default_rng(0)
        self.batches = [{"x": rng.standard_normal((64, 128, 128),
                                                  dtype=np.float32),
                         "y": np.full((64,), i, np.int32)} for i in range(n)]
        self.gate = threading.Semaphore(0) if gated else None
        self.i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        if self.gate is not None:
            self.gate.acquire()
        self.i += 1
        return self.batches[self.i - 1]

    def get_state(self):
        return {"i": self.i}


@pytest.mark.parametrize("delay", ["compute_stream", "copy_stream"])
def test_device_prefetcher_batches_equal_host_batches(cuda, delay):
    """20 batches, each read back on the device right after it is handed
    over and dropped at once, equal their host batches.  ``compute_stream``
    keeps the consumer's stream busy before each read: without
    ``record_stream`` the allocator would hand a dropped batch's memory to
    a later copy before the delayed read ran.  ``copy_stream`` holds the
    copy stream before each batch's copy is issued: without ``wait_event``
    the read would run before the copy landed."""
    src = _HostBatches(20, gated=delay == "copy_stream")
    pf = pipelib.DevicePrefetcher(src, cuda, depth=2)
    reads, states = [], []
    try:
        for _ in range(20):
            if delay == "copy_stream":
                with torch.cuda.stream(pf._copy_stream):
                    torch.cuda._sleep(_SLEEP_CYCLES)
                src.gate.release()
            else:
                torch.cuda._sleep(_SLEEP_CYCLES)
            batch = next(pf)
            reads.append({k: v * 1 for k, v in batch.items()})
            states.append(pf.get_state())
            del batch
        with pytest.raises(StopIteration):
            next(pf)
    finally:
        pf.stop()
    torch.cuda.synchronize()
    assert states == [{"i": i + 1} for i in range(20)]
    assert pf.pinned_bytes == 3 * (64 * 128 * 128 * 4 + 64 * 4)
    for i, (got, want) in enumerate(zip(reads, src.batches)):
        for k in want:
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k],
                                          err_msg=f"batch {i} {k}")


def test_fit_on_card_same_losses_at_1_and_3_workers(cuda):
    """fit on the card through both pipeline stages: the same losses with
    one producer thread and with three workers (cuDNN held to its
    deterministic algorithms for the comparison)."""
    from distributed_tensorflow_models_tpu_torch.harness import config
    from distributed_tensorflow_models_tpu_torch.harness import train

    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        losses = {}
        for workers in (1, 3):
            cfg = config.get_config("resnet50_synthetic_tiny", train_steps=4,
                                    data_workers=workers)
            result = train.fit(cfg, device="cuda")
            assert result.device.startswith("cuda")
            losses[workers] = [row["loss"] for row in result.history]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    assert all(math.isfinite(v) for v in losses[1])
    assert losses[1] == losses[3]
