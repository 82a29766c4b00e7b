"""Tests of the port that need the card: K1-K4 have no CPU mode.

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
"""

import math

import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
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


@pytest.mark.parametrize("xshape,kshape", CORE_CASES,
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
# and lengths that are no multiple of the kernels' 64-row tiles.
FLASH_CASES = [
    (2, 256, 256, 4, 4, 32, True, None, 0, 0),
    (2, 256, 256, 4, 4, 64, False, None, 0, 0),
    (1, 200, 136, 4, 2, 64, False, None, 0, 0),
    (2, 256, 256, 8, 2, 32, True, 80, 0, 0),
    (1, 128, 192, 2, 1, 128, True, None, 192, 64),
    (1, 96, 160, 4, 4, 32, True, 100, 200, 100),
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
