"""Tests of the port that need the card: K1 has no CPU mode.

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
"""

import math

import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.models.resnet import ResNet
from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
from distributed_tensorflow_models_tpu_torch.ops import conv_mxu
from distributed_tensorflow_models_tpu_torch.ops import optim

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
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
