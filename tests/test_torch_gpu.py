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

K1's f32 form (TF32 wgmma, f32 sums and output) is held elementwise to
``conv_mxu.tf32_error_bound``: (2^-9 + 2^-20 + 2K 2^-24) times the plain
version on the operands' magnitudes, K = kh*kw*Cin (each operand keeps 10
mantissa bits as tf32; both sides sum K products in f32).

The K-step call (``core/train_loop.py::MultiStep``): a replayed chunk
against the eager steps (bit for bit where the step has no atomics), the
rate and EMA decay advancing across replays, the launch counters per
replay, ``fit`` replaying every step after the first, and the in-place
optimizers against their per-tensor forms bit for bit.

Checkpoint/resume: a run of cut ResNet-32 killed at step 4 and resumed
from its checkpoint must equal the straight run bit for bit.

Eval (``harness/evaluate.py``) of a checkpoint on the card: cut ResNet-32
on K1's f32 form and cut ``transformer_lm`` on K2, each against the same
eval with every launch replaced by its plain version (the same top-k
counts within one example, xent to 2e-3 and perplexity to 1e-3 relative:
TF32 products and bf16 attention round differently from the plain f32
and bf16 versions).

Data parallel: a world-1 NCCL process group, its collectives captured
and replayed with the step, must leave cut ResNet-32's ``fit`` equal to
the ``fit`` without a group bit for bit.

Pipeline and expert parallelism, one rank's arithmetic: the pipelined
stack's GPipe schedule of n virtual stages (``PipelinedBlocks.emulate``,
K2-K4 in every stage) against its sequential schedule within the K2-K4
tolerance, and the expert layout's per-rank arithmetic (``moe.emulate``)
against ``moe_ffn_reference(num_ranks=E)`` within f32 summation order.

The async-PS and backup emulators (``parallel/async_ps.py``,
``parallel/backup.py``): their gradient and apply programs captured and
replayed against the same events run eagerly (bit for bit where the step
has no atomics, else the LM bound), and ``async_vs_sync`` at one worker
equal to its sync mode (``fit``'s captured step) bit for bit.

R1 (``csrc/row_gemm.cu``, the decode path's row-invariant product): its
tensor-core form (bf16 operands, N > 1) must give each row the same bits
whatever the row count, the row's place in a tile, the groups and the
strides, and lie within the forward-error bound of an f32 sum of K exact
products of its plain version (``K 2^-22 sum_k |a_k b_k|``, and one bf16
ulp more for a bf16 result): the tensor core sums a k16 step inside the
instruction.  Its SIMT form (f32 operands, and ``row_sum``) must equal
its plain version bit for bit (the same f32 additions in the same order,
no fused multiply-add).  The serving engine on the card (its programs
captured), in f32 and in bf16, must give every stream of the six
sampling modes equal to solo ``generate`` on the card, token for token.

K6 (the persistent, ring-pipelined K1) must equal K1 bit for bit, in both
dtypes.  K5's
dK and dV come from K3's own code and must equal K3's bit for bit; its dQ
is held to its plain version at the K2-K4 tolerance, on a dS stage filled
with NaN first so that a tile read but never written shows, and must equal
K4's bit for bit (the JAX package's pair and staged backwards promise the
same dQ).
"""

import contextlib
import itertools
import math
import threading

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

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
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        conv_mxu.conv_implicit_gemm(x.half(), k.half())
    with pytest.raises(TypeError, match="one dtype"):
        conv_mxu.conv_implicit_gemm(x, k.float())
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
    # Wholly masked chunks, as a ring visits them: every key in the
    # queries' future, and a window older than every query.
    (2, 256, 256, 4, 2, 64, True, None, 0, 256),
    (1, 128, 256, 2, 1, 128, True, None, 0, 128),
    (1, 256, 256, 8, 2, 32, True, 256, 1024, 256),
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
    # A wholly masked chunk's rows are all compared: out 0, lse NEG_INF.
    sel = rows if bool(rows.any()) else torch.ones_like(rows)
    _assert_flash_close(out[:, sel], want_out[:, sel], "K2 out")
    torch.testing.assert_close(lse[:, :, sel], want_lse[:, :, sel],
                               rtol=0, atol=LSE_ATOL)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if not bool(rows.any()):
        # A wholly masked chunk: out 0 and lse at NEG_INF, so it weighs
        # nothing in a merge; its gradients 0 also under an LSE cotangent.
        assert bool((out == 0).all())
        assert float(lse.max()) <= attnlib.NEG_INF / 2
        g_lse = torch.randn(lse.shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
        delta = (delta - g_lse).contiguous()
    args = (q, k, v, do, lse, delta)
    dk, dv = attnlib.flash_dkv(*args, **kw)
    dq = attnlib.flash_dq(*args, **kw)
    torch.cuda.synchronize()
    want_dk, want_dv = attnlib._flash_dkv_reference(*args, **kw)
    want_dq = attnlib._flash_dq_reference(*args, **kw)
    # dK/dV sum over queries: a row with no valid key enters them, so
    # every row must have one here, or none (a wholly masked chunk, whose
    # gradients are 0 exactly).
    if not bool(rows.any()):
        for name, g in (("dk", dk), ("dv", dv), ("dq", dq)):
            assert bool((g == 0).all()), f"wholly masked chunk: {name} != 0"
    assert bool(rows.all()) or not bool(rows.any())
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
        optim.clip_by_global_norm(1.0), optim.adam(3e-4, num_steps=2)))
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
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        f(x.double(), k.double())
    with pytest.raises(TypeError, match="one dtype"):
        f(x.float(), k)
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
    # Every valid pair lies in a tile that runs: its staged dS is written
    # (a wholly masked chunk has no valid pair, and no tile runs).
    valid = attnlib._valid(Tq, k.shape[1], kw["causal"], kw["window"],
                           kw["q_offset"], kw["kv_offset"], "cuda")
    sel = (torch.ones(Tq, k.shape[1], dtype=torch.bool, device=cuda)
           if valid is None else valid)
    if not bool(sel.any()):
        assert bool((dq == 0).all()) and bool((dk == 0).all())
        return
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
        optim.clip_by_global_norm(1.0), optim.adam(3e-4, num_steps=2)))
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


# K1's and K6's f32 form (TF32 wgmma).  ResNet-32's routed convs (stage
# 2's 3x3, Cin = Cout = 64 on 8x8 maps, padded to 10x10; the same shape
# serves their dx), at batch 128 and at a ragged M; a Cin of 36 (a 4-channel
# tail of a 32-channel K step) and of 20 (three k8 slices, no full step);
# Cin and Cout not multiples of 4 and Cout under 64 (the plain load path);
# N tiles 96, 144 and 2x144 (Cout 288), and a 5x5 tap.
F32_CORE_CASES = [
    ((128, 10, 10, 64), (3, 3, 64, 64)),
    ((3, 10, 10, 64), (3, 3, 64, 64)),
    ((2, 9, 7, 36), (3, 3, 36, 96)),
    ((2, 9, 9, 20), (3, 3, 20, 144)),
    ((2, 9, 7, 18), (2, 3, 18, 70)),
    ((2, 6, 6, 64), (3, 3, 64, 16)),
    ((2, 12, 12, 160), (5, 5, 160, 288)),
]


def _f32(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("pipelined", [False, True], ids=["k1", "k6"])
@pytest.mark.parametrize("xshape,kshape", F32_CORE_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_kernel_matches_plain(cuda, xshape, kshape, pipelined):
    rng = np.random.default_rng(21)
    x = _f32(rng, xshape)
    k = _f32(rng, kshape, 1.0 / math.sqrt(math.prod(kshape[:3])))
    f = (conv_mxu.conv_implicit_gemm_pipelined if pipelined
         else conv_mxu.conv_implicit_gemm)
    before = (f.launches, f.f32_launches)
    got = f(x, k)
    torch.cuda.synchronize()
    assert (f.launches, f.f32_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32
    want = conv_mxu._core_reference(x, k)
    bound = conv_mxu.tf32_error_bound(x, k)
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())
    # And on the output's scale: under 2^-8 of the largest magnitude.
    assert float(err.max()) < 2.0 ** -8 * float(want.abs().max())


@pytest.mark.parametrize("xshape,kshape", F32_CORE_CASES + [
    ((32, 18, 18, 64), (3, 3, 64, 64)), ((16, 40, 40, 20), (3, 3, 20, 200))],
    ids=lambda s: "x".join(map(str, s)))
def test_f32_pipelined_kernel_equals_k1(cuda, xshape, kshape):
    rng = np.random.default_rng(22)
    x = _f32(rng, xshape)
    k = _f32(rng, kshape, 1.0 / math.sqrt(math.prod(kshape[:3])))
    want = conv_mxu.conv_implicit_gemm(x, k)
    got = conv_mxu.conv_implicit_gemm_pipelined(x, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("pipelined", [False, True], ids=["k1", "k6"])
@pytest.mark.parametrize("xshape,kshape,win", WINDOW_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_window_entry_matches_materialised_route(cuda, xshape, kshape,
                                                     win, pipelined):
    """The f32 form on windows of the unpadded input written at strides:
    the same bits as on the materialised window, within the TF32 bound of
    the plain version, the buffer outside the window untouched."""
    rng = np.random.default_rng(23)
    x = _f32(rng, xshape)
    k = _f32(rng, kshape, 1.0 / math.sqrt(math.prod(kshape[:3])))
    h0, w0, sh, sw, oh, ow = win
    kh, kw = kshape[:2]
    xw = conv_mxu._materialize_window(
        x, (h0, w0, sh, sw, oh + kh - 1, ow + kw - 1)).contiguous()
    f = (conv_mxu.conv_implicit_gemm_pipelined if pipelined
         else conv_mxu.conv_implicit_gemm)
    want = f(xw, k)
    buf = torch.full((xshape[0], 2 * oh + 1, 2 * ow + 1, kshape[3]), 7.0,
                     device=cuda)
    view = buf[:, 1::2, 1::2]
    got = conv_mxu._launch_window(x, k, win, pipelined, out=view)
    torch.cuda.synchronize()
    assert got.data_ptr() == view.data_ptr() and torch.equal(view, want)
    mask = torch.ones_like(buf, dtype=torch.bool)
    mask[:, 1::2, 1::2] = False
    assert bool((buf[mask] == 7.0).all())
    err = (view - conv_mxu._core_reference(xw, k)).abs()
    assert bool((err <= conv_mxu.tf32_error_bound(xw, k)).all())


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)], ids=["s1", "s2"])
def test_f32_conv2d_mxu_grads_match_patches(cuda, strides):
    """conv2d_mxu in f32 (K1's f32 form in the forward and in dx) against
    the patches lowering (f32 matmuls, TF32 off): y and dx within the TF32
    bound on the magnitudes (the patches lowering on |x|, |k| and |g|, a
    stride-2 forward's four phase sums adding their bounds), dw (window
    dots in f32 on both sides) to 1e-5 of its scale."""
    rng = np.random.default_rng(24)
    x = _f32(rng, (4, 12, 12, 64))
    k = _f32(rng, (3, 3, 64, 64), 1.0 / math.sqrt(9 * 64))
    xm, km = x.clone().requires_grad_(), k.clone().requires_grad_()
    xp, kp = x.clone().requires_grad_(), k.clone().requires_grad_()
    before = conv_mxu.conv_implicit_gemm.f32_launches
    y = conv_mxu.conv2d_mxu(xm, km, strides, "SAME")
    g = _f32(rng, tuple(y.shape))
    y.backward(g)
    yp = convlib.conv2d_patches(xp, kp, strides, "SAME")
    yp.backward(g)
    xa = x.abs().requires_grad_()
    ya = convlib.conv2d_patches(xa, k.abs(), strides, "SAME")
    ya.backward(g.abs())
    torch.cuda.synchronize()
    assert conv_mxu.conv_implicit_gemm.f32_launches > before
    rel = 2.0 ** -9 + 2.0 ** -20 + 2 * 9 * 64 * 2.0 ** -24
    for name, got, want, mag in (("y", y, yp, ya), ("dx", xm.grad, xp.grad,
                                                     xa.grad)):
        assert got.dtype == torch.float32, name
        err = (got.detach() - want.detach()).abs()
        assert bool((err <= rel * mag.detach() + 1e-6).all()), name
    torch.testing.assert_close(km.grad, kp.grad, rtol=1e-5,
                               atol=1e-5 * float(kp.grad.abs().max()))


def test_f32_wrappers_raise_on_other_dtypes(cuda):
    """A routed conv in a dtype neither form takes raises on the card; it
    is never cast to reach a kernel."""
    x = torch.zeros(1, 6, 6, 64, device=cuda, dtype=torch.float16)
    k = torch.zeros(3, 3, 64, 64, device=cuda, dtype=torch.float16)
    for f in (conv_mxu.conv_implicit_gemm,
              conv_mxu.conv_implicit_gemm_pipelined):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            f(x, k)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        conv_mxu.conv2d_mxu(x, k, (1, 1), "SAME")


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def _tf32_plain_core(x, kernel, win, out=None, reverse=False):
    """The core as K1's f32 form computes it, in plain PyTorch: the window
    materialised, both operands cut to tf32 (13 low mantissa bits
    dropped), the f32 plain version (TF32 off) on them.  ``reverse`` sums
    the taps in the reverse order (input and kernel flipped in space, the
    output flipped back): the same products in another f32 order."""
    kh, kw = kernel.shape[:2]
    h0, w0, sh, sw, oh, ow = win
    xw = conv_mxu.tf32_cut(conv_mxu._materialize_window(
        x, (h0, w0, sh, sw, oh + kh - 1, ow + kw - 1)))
    kc = conv_mxu.tf32_cut(kernel)
    if reverse:
        y = conv_mxu._core_reference(xw.flip(1, 2), kc.flip(0, 1)).flip(1, 2)
    else:
        y = conv_mxu._core_reference(xw, kc)
    return y if out is None else out.copy_(y)


def _tf32_plain_core_reversed(x, kernel, win, out=None):
    return _tf32_plain_core(x, kernel, win, out, reverse=True)


def test_f32_dx_matches_tf32_plain_at_resnet32_shape(cuda, monkeypatch):
    """A ResNet-32 stage-2 3x3 conv (batch 128, 8x8x64 to 8x8x64, SAME) and
    its dx through K1's f32 form, against the same route with the core
    replaced by the plain version on tf32-cut operands: the same products,
    so each element of y and dx to the f32 summation-order bound
    2K 2^-24 sum|a||b| (K = 576, ``conv_mxu.tf32_order_bound``)."""
    rng = np.random.default_rng(31)
    x, g = (torch.tensor(rng.standard_normal((128, 8, 8, 64)),
                         dtype=torch.float32, device=cuda) for _ in range(2))
    k = torch.tensor(rng.standard_normal((3, 3, 64, 64)) / 24,
                     dtype=torch.float32, device=cuda)

    def run():
        xm = x.clone().requires_grad_()
        y = conv_mxu.conv2d_mxu(xm, k, (1, 1), "SAME")
        y.backward(g)
        torch.cuda.synchronize()
        return y.detach(), xm.grad

    n0 = conv_mxu.conv_implicit_gemm.f32_launches
    got = run()
    assert conv_mxu.conv_implicit_gemm.f32_launches - n0 == 2
    monkeypatch.setattr(conv_mxu, "_core_window", _tf32_plain_core)
    want = run()
    xa = conv_mxu.tf32_cut(x).abs().requires_grad_()
    ya = convlib.conv2d_patches(xa, conv_mxu.tf32_cut(k).abs(), (1, 1),
                                "SAME")
    ya.backward(conv_mxu.tf32_cut(g).abs())
    unit = 9 * 64 * 2.0 ** -24
    for name, a, b, mag in (("y", got[0], want[0], ya.detach()),
                            ("dx", got[1], want[1], xa.grad)):
        err = (a - b).abs()
        units = float((err / (unit * mag)).nan_to_num(0.0).max())
        print(f"f32 K1 vs tf32-cut plain at ResNet-32's shape, {name}: max "
              f"abs {float(err.max()):.3g}, max {units:.3g} K 2^-24 "
              f"sum|a||b|, rel L2 {_rel_l2(a, b):.3g}")
        assert bool((err <= 2 * unit * mag).all()), name


def test_resnet32_step_mxu_matches_patches(cuda, monkeypatch):
    """One ``resnet32_cifar10`` step (its loss, L2 2e-4 and TF momentum
    0.1; f32; the config's batch of 128) through the mxu route, whose 9
    routed convs (stage 2's 3x3 at Cin 64) run K1's f32 form forward and
    in dx (18 launches, TF32 products), against the same step from the
    same seeded weights and batch through (a) the patches lowering (f32
    matmuls, TF32 off), (b) the mxu route with its core replaced by the
    plain version on tf32-cut operands (``_tf32_plain_core``) and (c) (b)
    with the taps summed in reverse order, the control.

    The forward is the same arithmetic as (b) up to the order of the f32
    sums: the loss to 1e-5 relative and the updated BN statistics to 1e-4
    in relative L2.  Against (a) TF32's own effect shows: the loss to 1e-3
    relative, the BN statistics to 1e-2.  The updates of this
    initialization are ill-conditioned (a BN scale's or bias's gradient
    is a sum that cancels): the control (c) alone moves them ~1.4 % in
    relative L2 from (b) (~3 % for the worst tensor) on an H100, so they
    are held, over all parameters and for the worst tensor, at most twice
    (c)'s distance from (b), and at most twice (b)'s from (a).  dx itself
    is held elementwise in
    ``test_f32_dx_matches_tf32_plain_at_resnet32_shape``."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = tconfig.get_config("resnet32_cifar10")
    rng = np.random.default_rng(25)
    batch = {"image": torch.tensor(rng.standard_normal((128, 32, 32, 3)),
                                   dtype=torch.float32, device=cuda),
             "label": torch.tensor(rng.integers(0, 10, 128), device=cuda)}
    k1 = conv_mxu.conv_implicit_gemm
    out = {}
    cores = {"tf32_plain": _tf32_plain_core,
             "tf32_reversed": _tf32_plain_core_reversed}
    for arm, impl in (("patches", "patches"), ("mxu", "mxu"),
                      ("tf32_plain", "mxu"), ("tf32_reversed", "mxu")):
        if arm in cores:
            monkeypatch.setattr(conv_mxu, "_core_window", cores[arm])
        state = trainlib.build_state(
            cfg.replace(model_kwargs={"conv_impl": impl}), cuda)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        step = trainlib.build_step(cfg, state)
        n0 = (k1.launches, k1.f32_launches)
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        out[arm] = (float(metrics["loss"]),
                    {k: state.params[k].detach() - before[k] for k in before},
                    {k: v.detach().clone()
                     for k, v in state.batch_stats.items()},
                    (k1.launches - n0[0], k1.f32_launches - n0[1]))
    assert out["mxu"][3] == (18, 18)
    assert (out["patches"][3] == out["tf32_plain"][3]
            == out["tf32_reversed"][3] == (0, 0))

    def distance(a, b):
        (la, ua, sa, _), (lb, ub, sb, _) = out[a], out[b]
        total = _rel_l2(torch.cat([ua[k].flatten() for k in ua]),
                        torch.cat([ub[k].flatten() for k in ua]))
        return (abs(la - lb) / abs(lb), total,
                max(_rel_l2(ua[k], ub[k]) for k in ua),
                max(_rel_l2(sa[k], sb[k]) for k in sa))

    pairs = (("mxu", "tf32_plain"), ("mxu", "patches"),
             ("tf32_plain", "patches"), ("tf32_reversed", "tf32_plain"))
    got = {pair: distance(*pair) for pair in pairs}
    for (arm, ref), (loss, total, worst, stats) in got.items():
        print(f"resnet32_cifar10 step, {arm} vs {ref}: loss rel {loss:.3g}, "
              f"updates rel L2 {total:.3g} (worst tensor {worst:.3g}), worst "
              f"BN statistic rel L2 {stats:.3g}")
    loss, _, _, stats = got[pairs[0]]
    assert loss <= 1e-5 and stats <= 1e-4
    loss, total, worst, stats = got[pairs[1]]
    _, own_total, own_worst, _ = got[pairs[2]]
    assert loss <= 1e-3 and stats <= 1e-2
    assert total <= 2 * own_total and worst <= 2 * own_worst
    _, total, worst, _ = got[pairs[0]]
    _, order_total, order_worst, _ = got[pairs[3]]
    assert total <= 2 * order_total and worst <= 2 * order_worst


# The K-step call on the card (core/train_loop.py::MultiStep): the first
# step eager, the rest CUDA-graph replays.  Paths at small widths, each
# with its kernels: LeNet (no kernel: its convs route to patches), ResNet-32
# (K1's f32 form on stage 2), the transformer with dropout (K2-K4, head dim
# 32) and the LSTM with its carry and dropout.  Where the step has no
# atomics a replayed chunk equals the eager steps bit for bit.  The LM
# paths' embedding gradient adds rows with atomics (index_add_), so their
# sums run in another order on every run, eager or not: their losses are
# held to 1e-5 relative and each state collection to 1e-4 in relative L2
# (f32 sums reordered differ by a few ulps; a stale rate, stale dropout
# bits or a stale batch move them by 1e-3 or more).
REPLAY_CASES = {
    "lenet_mnist": ("lenet_mnist", dict(
        global_batch_size=8, model_kwargs={"conv_impl": "mxu"}), True),
    "resnet32_cifar10": ("resnet32_cifar10", dict(
        global_batch_size=8, model_kwargs={"conv_impl": "mxu"}), True),
    "transformer_lm": ("transformer_lm", dict(
        global_batch_size=4, num_steps=64, vocab_size=128, attn_impl="flash",
        model_kwargs={"num_layers": 2, "num_heads": 4, "d_model": 128,
                      "d_ff": 256, "max_len": 64, "vocab_size": 128,
                      "dropout_rate": 0.1}), False),
    "ptb_small": ("ptb_small", dict(
        global_batch_size=4, num_steps=10, vocab_size=64,
        model_kwargs={"config": "small", "vocab_size": 64, "hidden_size": 32,
                      "dropout_rate": 0.5}), False),
}


def _state_tensors(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"batch_stats/{k}": v for k, v in state.batch_stats.items()})
    for i, leaf in enumerate(train_loop._leaves(state.opt_state)):
        out[f"opt_state/{i}"] = leaf
    for i, leaf in enumerate(train_loop._leaves((state.ema_params,
                                                 state.carry))):
        out[f"ema_carry/{i}"] = leaf
    out["device_step"] = state.device_step
    return {k: v.detach() for k, v in out.items()}


def _replay_and_eager(cfg, steps, k, device):
    """``steps`` steps of ``cfg`` eagerly and through the K-step call in
    chunks of ``k`` (the last one shorter), from the same seeded state on
    the same batches: (eager state, captured state, eager losses, captured
    losses, the K-step call)."""
    import itertools

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    batches = [{key: torch.from_numpy(v).to(device) for key, v in b.items()}
               for b in itertools.islice(iter(trainlib.build_dataset(cfg)),
                                         steps)]
    eager = trainlib.build_state(cfg, device)
    step = trainlib.build_step(cfg, eager)
    eager_losses = []
    for b in batches:
        eager, metrics = step(eager, b, cfg.seed)
        eager_losses.append(float(metrics["loss"]))
    captured = trainlib.build_state(cfg, device)
    multi = train_loop.MultiStep(trainlib.build_step(cfg, captured),
                                 name=cfg.model)
    losses = []
    for i in range(0, steps, k):
        rows = batches[i:i + k]
        chunk = {key: torch.stack([b[key] for b in rows]) for key in rows[0]}
        captured, metrics = multi(captured, chunk, cfg.seed)
        losses += metrics["loss"].tolist()
    torch.cuda.synchronize()
    return eager, captured, eager_losses, losses, multi


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replayed_chunk_equals_eager_steps(cuda, case):
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig

    name, over, exact = REPLAY_CASES[case]
    cfg = tconfig.get_config(name, train_steps=6, **over)
    eager, captured, want, got, multi = _replay_and_eager(cfg, 6, 4, cuda)
    assert multi.captures == 1 and multi.replays == 5
    assert captured.step == eager.step == 6
    a, b = _state_tensors(captured), _state_tensors(eager)
    assert sorted(a) == sorted(b)
    worst = max(_rel_l2(a[n].float(), b[n].float()) for n in a)
    print(f"{case}: losses replayed {got} eager {want}; worst state "
          f"tensor rel L2 {worst:.3g}")
    if exact:
        assert got == want
        for n in a:
            assert torch.equal(a[n], b[n]), n
    else:
        for x, y in zip(got, want):
            assert abs(x - y) <= 1e-5 * abs(y)
        for group in ("params", "batch_stats", "opt_state", "ema_carry"):
            names = [n for n in a if n.startswith(group)
                     and a[n].is_floating_point()]
            if names:
                assert _rel_l2(
                    torch.cat([a[n].float().flatten() for n in names]),
                    torch.cat([b[n].float().flatten() for n in names])
                ) <= 1e-4, group
        assert int(a["device_step"]) == 6


def test_replays_advance_the_rate_and_the_ema(cuda):
    """LeNet under a rate that falls every step (non-staircase decay at
    one step per transition) with the weight EMA, whose decay warms up
    every step: six steps in one chunk (five replays) equal the eager
    steps bit for bit, so each replay read its own step's rate and
    decay; the device counts say 6."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig

    cfg = tconfig.get_config(
        "lenet_mnist", global_batch_size=8, train_steps=6, ema_decay=0.99,
        model_kwargs={"conv_impl": "mxu"},
        optimizer=tconfig.OptimizerConfig(
            name="momentum", learning_rate=0.1, decay_steps=1,
            decay_rate=0.5, staircase=False))
    eager, captured, want, got, multi = _replay_and_eager(cfg, 6, 6, cuda)
    assert multi.replays == 5 and got == want
    a, b = _state_tensors(captured), _state_tensors(eager)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert int(captured.opt_state["count"]) == 6
    assert int(captured.device_step) == 6


@pytest.mark.parametrize("case", ["resnet32_cifar10", "transformer_lm"])
def test_launch_counters_count_replays(cuda, case):
    """A kernel's counter after a chunk of 4 (one eager step, three
    replays) is 4 x what one eager step launches, and each graph holds
    one step's launches."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.ops import _kernels

    name, over, _ = REPLAY_CASES[case]
    cfg = tconfig.get_config(name, train_steps=5, **over)
    batches = [{key: torch.from_numpy(v).to(cuda) for key, v in b.items()}
               for b in itertools.islice(iter(trainlib.build_dataset(cfg)),
                                         5)]
    state = trainlib.build_state(cfg, cuda)
    step = trainlib.build_step(cfg, state)
    before = _kernels.launch_counts()
    state, _ = step(state, batches[0], cfg.seed)
    one = {key: n - before[key] for key, n in _kernels.launch_counts().items()
           if n != before[key]}
    assert one, "the step launched no kernel"
    multi = train_loop.MultiStep(trainlib.build_step(cfg, state))
    before = _kernels.launch_counts()
    chunk = {key: torch.stack([b[key] for b in batches[1:]])
             for key in batches[0]}
    state, _ = multi(state, chunk, cfg.seed)
    torch.cuda.synchronize()
    got = {key: n - before[key] for key, n in _kernels.launch_counts().items()
           if n != before[key]}
    assert got == {key: 4 * n for key, n in one.items()}
    graph = next(iter(multi._captured.values()))
    assert graph.launches == one


def test_fit_on_card_replays_every_step_after_the_first(cuda):
    """fit on the card with steps_per_loop 3 over 7 steps (chunks 3, 3, 1):
    one capture, six replayed steps, the losses of a serial eager loop on
    the host's batches, and a timed window closed by a device sync."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = tconfig.get_config("lenet_mnist", global_batch_size=8,
                             train_steps=7, steps_per_loop=3,
                             model_kwargs={"conv_impl": "mxu"})
    result = trainlib.fit(cfg, device="cuda")
    assert (result.captures, result.replayed_steps) == (1, 6)
    assert result.window_steps == 4 and result.window_s > 0
    state = trainlib.build_state(cfg, cuda)
    step = trainlib.build_step(cfg, state)
    want = []
    for b in itertools.islice(iter(trainlib.build_dataset(cfg)), 7):
        state, metrics = step(state, {k: torch.from_numpy(v).to(cuda)
                                      for k, v in b.items()}, cfg.seed)
        want.append(float(metrics["loss"]))
    assert [row["loss"] for row in result.history] == want
    snap = result.registry.snapshot()
    assert snap["train/compile/count"] == 1


def test_in_place_optimizers_equal_the_per_tensor_form_on_card(cuda):
    """The in-place optimizers (products and sums by torch._foreach_*,
    the rate and Adam's corrections read from device tables) and the EMA
    against the per-tensor forms they replace, on the card, five steps
    under a schedule: bit for bit."""
    import torch_reference_optim as ref

    for name in ref.CASES:
        ref.check_against_per_tensor_form(name, cuda)


def test_resume_on_card_equals_the_straight_run(cuda, tmp_path):
    """Cut ResNet-32 (K1's f32 form) through ``fit`` with a workdir: a run
    killed at step 4 (its crash-time checkpoint written from the replayed
    state by the asynchronous snapshot) and resumed in a new ``fit`` ends
    equal to the straight run bit for bit, losses of steps 5-8 included;
    each ``fit`` captures the step once."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import hooks as hooklib
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    name, over, _ = REPLAY_CASES["resnet32_cifar10"]
    cfg = tconfig.get_config(name, train_steps=8, steps_per_loop=4,
                             log_every_steps=4, **over)
    straight = trainlib.fit(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="injected"):
        trainlib.fit(cfg, str(tmp_path), device="cuda",
                     extra_hooks=[hooklib.FaultInjectionHook(4)])
    resumed = trainlib.fit(cfg, str(tmp_path), device="cuda")
    assert resumed.restored_from == 4
    assert (straight.captures, resumed.captures) == (1, 1)
    assert [h["loss"] for h in resumed.history] == [
        h["loss"] for h in straight.history[4:]]
    a, b = _state_tensors(resumed.state), _state_tensors(straight.state)
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


class _DropBatches:
    """The dataset without the batches after which its cursor reads one of
    ``after``: the batches a rollback skips."""

    def __init__(self, ds, after):
        self._ds, self._after = ds, after

    def __iter__(self):
        for batch in self._ds:
            if self._ds.get_state() not in self._after:
                yield batch

    def get_state(self):
        return self._ds.get_state()

    def set_state(self, state):
        self._ds.set_state(state)


def test_chaos_on_card_rollback_and_torn_walk_back(cuda, tmp_path,
                                                    monkeypatch):
    """Phase 5e's drills (a) and (b) of ``chip_smoke.py`` at a cut size
    (ResNet-32 cut, K1's f32 form, chunks of 4): ``nan_at_step=6`` writes
    NaN into the replayed chunk's second row; the run rolls back to step 4
    once, skips the chunk of steps 5-8 and ends equal bit for bit to a
    straight run over the stream without those batches, with one capture.
    A 6-step run whose final save is torn (``torn_checkpoint_at_step=6``)
    is resumed to 8: it walks back to step 4 and ends at the straight
    run's state."""
    from distributed_tensorflow_models_tpu_torch import telemetry
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    name, over, _ = REPLAY_CASES["resnet32_cifar10"]
    cfg = tconfig.get_config(name, train_steps=8, steps_per_loop=4,
                             log_every_steps=4, checkpoint_every_secs=None,
                             checkpoint_every_steps=4, **over)
    straight = trainlib.fit(cfg, device="cuda")
    rolled = trainlib.fit(cfg.replace(nan_policy="rollback",
                                      chaos={"nan_at_step": 6}),
                          str(tmp_path / "a"), device="cuda")
    assert (rolled.captures, rolled.rollbacks, rolled.skipped_batches) == (
        1, 1, 4)
    assert rolled.registry.snapshot()[telemetry.CHAOS_ARMED_UNFIRED] == 0.0
    probe = trainlib.build_dataset(cfg)
    it = iter(probe)
    after = []
    for _ in range(8):
        next(it)
        after.append(probe.get_state())
    build = trainlib.build_dataset
    monkeypatch.setattr(trainlib, "build_dataset",
                        lambda c, split="train", mesh=None: _DropBatches(
                            build(c, split, mesh), after[4:8]))
    without = trainlib.fit(cfg, device="cuda")
    monkeypatch.setattr(trainlib, "build_dataset", build)
    assert [h["loss"] for h in rolled.history] == [
        h["loss"] for h in without.history]
    a, b = _state_tensors(rolled.state), _state_tensors(without.state)
    for n in a:
        assert torch.equal(a[n], b[n]), n

    torn = {"torn_checkpoint_at_step": 6}
    trainlib.fit(cfg.replace(train_steps=6, chaos=torn), str(tmp_path / "b"),
                 device="cuda")
    walked = trainlib.fit(cfg.replace(chaos=torn), str(tmp_path / "b"),
                          device="cuda")
    assert (walked.restored_from, walked.captures) == (4, 1)
    a, b = _state_tensors(walked.state), _state_tensors(straight.state)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_nccl_group_of_one_replays_equal_replays_without_a_group(cuda):
    """Cut ResNet-32 (K1's f32 form, every BatchNorm) through ``fit`` in a
    world-1 NCCL process group: every collective of the step (the gradient
    bucket, each BatchNorm's moments and their cotangents, the metric
    vector) is captured with it and replayed, and changes nothing: the
    losses and the state equal a ``fit`` without a group bit for bit.
    The collective counters advance once per step, replays included."""
    import socket

    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm

    name, over, _ = REPLAY_CASES["resnet32_cifar10"]
    cfg = tconfig.get_config(name, train_steps=6, steps_per_loop=3, **over)
    alone = trainlib.fit(cfg, device="cuda", mesh=meshlib.local_mesh("cuda"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    meshlib.initialize_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        assert trainlib.mesh_from_config(cfg).backend == "nccl"
        before = sharding.collective_counts()
        grouped = trainlib.fit(cfg, device="cuda")
        issued = sharding.counts_since(before)
    finally:
        dist.destroy_process_group()
    assert (grouped.captures, grouped.replayed_steps) == (1, 5)
    assert [h["loss"] for h in grouped.history] == [
        h["loss"] for h in alone.history]
    a, b = _state_tensors(grouped.state), _state_tensors(alone.state)
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    bn = sum(isinstance(m, BatchNorm) for m in grouped.state.model.modules())
    steps = cfg.train_steps
    assert {site: n for site, (n, _) in issued.items()} == {
        "replica_check": 2, "grads": steps, "metrics": steps,
        "bn_moments": bn * steps, "bn_moments_grad": bn * steps}
    assert grouped.registry.snapshot()["train/collectives"] == (
        (2 + 2 * bn) * steps)


@contextlib.contextmanager
def _plain_kernels():
    """Every K1/K6 and K2 launch replaced by its plain version on the same
    CUDA tensors; the launch counters do not move."""
    def k1_plain(x, kernel, win, pipelined, out=None):
        kh, kw = kernel.shape[:2]
        h0, w0, sh, sw, oh, ow = win
        y = conv_mxu._core_reference(conv_mxu._materialize_window(
            x, (h0, w0, sh, sw, oh + kh - 1, ow + kw - 1)), kernel)
        return y if out is None else out.copy_(y)

    saved = conv_mxu._launch_window, attnlib.flash_forward
    conv_mxu._launch_window = k1_plain
    attnlib.flash_forward = attnlib._flash_forward_reference
    try:
        yield
    finally:
        conv_mxu._launch_window, attnlib.flash_forward = saved


@pytest.mark.parametrize("case", ["resnet32_cifar10", "transformer_lm"])
def test_eval_on_the_kernels_matches_their_plain_versions(cuda, tmp_path,
                                                          case):
    """ResNet-32 cut to two blocks a stage (its three stage-2 3x3 convs
    with 64 input channels on K1's f32 form: 3 forward launches a batch;
    at full depth the eval-mode BatchNorm of a 4-step checkpoint passes
    the residual stream's growth through 15 blocks, the xent reaches
    ~2.7e5 and TF32's rounding moves it 0.3 %) and cut ``transformer_lm``
    (K2 once a layer a batch) trained 4 steps on the card, then evaluated
    over 3 batches on the kernels and on their plain versions."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import evaluate
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    name, over, _ = REPLAY_CASES[case]
    if case == "resnet32_cifar10":
        over = {**over, "model_kwargs": {"conv_impl": "mxu",
                                         "blocks_per_stage": 2}}
    cfg = tconfig.get_config(name, train_steps=4, steps_per_loop=4,
                             checkpoint_every_secs=1e4, **over)
    trainlib.fit(cfg, str(tmp_path), device="cuda")
    run = (evaluate.evaluate_lm if cfg.task == "lm"
           else evaluate.evaluate_classification)
    k1, k2 = conv_mxu.conv_implicit_gemm, attnlib.flash_forward
    k1.launches = k2.launches = 0
    got = run(cfg, str(tmp_path), device="cuda", max_batches=3)
    launches = (k1.launches, k2.launches)
    with _plain_kernels():
        want = run(cfg, str(tmp_path), device="cuda", max_batches=3)
    assert (k1.launches, k2.launches) == launches
    if cfg.task == "lm":
        assert launches == (0, 2 * 3)
        assert got.metrics["perplexity"] == pytest.approx(
            want.metrics["perplexity"], rel=1e-3)
    else:
        assert launches == (3 * 3, 0)
        assert got.metrics["count"] == want.metrics["count"] == 24
        for k in ("top1", "top5"):
            assert abs(got.metrics[k] - want.metrics[k]) * 24 <= 1
        assert got.metrics["xent"] == pytest.approx(want.metrics["xent"],
                                                    rel=2e-3)


# -- KV-cache decode and the cold start ------------------------------------


def _decode_lm(**kw):
    """A bf16 transformer LM on the card (2 layers, d_model 64, 2 heads of
    32, vocabulary 128, max_len 64) from a seeded init."""
    return TransformerLM(vocab_size=128, num_layers=2, num_heads=2,
                         d_model=64, d_ff=128, max_len=64, dropout_rate=0.0,
                         generator=torch.Generator().manual_seed(3),
                         **kw).cuda()


@pytest.mark.parametrize("kw", [{}, dict(pos_encoding="rope", num_kv_heads=1,
                                         attn_window=8)],
                         ids=["learned", "rope-gqa-window"])
def test_captured_decode_step_equals_eager(cuda, kw):
    """``generate`` with the one-token step captured as a CUDA graph (one
    capture, a replay per later token) against every step eager: tokens
    and every step's logits bit for bit, greedy with an EOS and sampled
    (top-k and top-p, the noise from the graph-registered generator
    re-seeded per token); ``beam_search`` the same, tokens and scores."""
    from distributed_tensorflow_models_tpu_torch.harness import generate

    model = _decode_lm(**kw)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (3, 20))).cuda()
    for opts in (dict(eos_id=7), dict(temperature=0.9, top_k=20, top_p=0.9,
                                      seed=11)):
        caps, reps = generate.captures, generate.replays
        got, got_lg = generate.generate(model, prompt, 24, capture=True,
                                        return_logits=True, **opts)
        assert (generate.captures - caps, generate.replays - reps) == (1, 22)
        want, want_lg = generate.generate(model, prompt, 24, capture=False,
                                          return_logits=True, **opts)
        assert generate.captures - caps == 1
        assert torch.equal(got, want), opts
        assert torch.equal(got_lg, want_lg), opts
    caps = generate.captures
    bt, bs = generate.beam_search(model, prompt[:2], 16, beam_size=4,
                                  capture=True)
    assert generate.captures - caps == 1
    et, es = generate.beam_search(model, prompt[:2], 16, beam_size=4,
                                  capture=False)
    assert torch.equal(bt, et) and torch.equal(bs, es)


def test_captured_rnn_decode_equals_eager(cuda):
    from distributed_tensorflow_models_tpu_torch.harness import generate
    from distributed_tensorflow_models_tpu_torch.models import get_model

    model = get_model("ptb_lstm", config="small", vocab_size=64,
                      hidden_size=32, dropout_rate=0.0,
                      generator=torch.Generator().manual_seed(0)).cuda()
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, (4, 7))).cuda()
    for opts in ({}, dict(temperature=1.0, top_p=0.8, seed=5)):
        caps = generate.captures
        got = generate.generate_rnn(model, prompt, 12, capture=True, **opts)
        assert generate.captures - caps == 1
        want = generate.generate_rnn(model, prompt, 12, capture=False,
                                     **opts)
        assert torch.equal(got, want), opts


def test_kernel_loads_overlap_the_restore(cuda, tmp_path, monkeypatch):
    """Cut ``transformer_lm`` on flash (K2-K4), trained 2 steps with a
    checkpoint, resumed to 4 twice: with the startup thread building the
    flash library afresh (``xla_cache_dir=""``: nvcc into a temporary
    directory) while the restore runs, and without the thread.  The
    thread's build starts before the restore ends, the first chunk waits
    only for what is left of it, and both resumed runs end equal bit for
    bit with one capture each."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import startup
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.ops import _kernels

    name, over, _ = REPLAY_CASES["transformer_lm"]
    cfg = tconfig.get_config(name, train_steps=2, steps_per_loop=2,
                             log_every_steps=2, checkpoint_every_secs=1e4,
                             **over)
    trainlib.fit(cfg, str(tmp_path / "a"), device="cuda")
    import shutil

    shutil.copytree(tmp_path / "a", tmp_path / "b")
    before = _kernels.BUILD_DIR
    # Forget this process's load of the flash library, so that the thread
    # builds it afresh (a new process starts so).
    monkeypatch.setattr(attnlib, "_lib", None)
    monkeypatch.delitem(_kernels._libs, "flash_attention.cu", raising=False)
    try:
        on = trainlib.fit(cfg.replace(train_steps=4, xla_cache_dir=""),
                          str(tmp_path / "a"), device="cuda")
        assert startup.configured_cache_dir() is None
        assert startup.cache_entry_count(str(_kernels.BUILD_DIR)) == 1
    finally:
        startup.apply_compile_cache(None)
        _kernels.set_build_dir(before)
    off = trainlib.fit(cfg.replace(train_steps=4, aot_compile=False),
                       str(tmp_path / "b"), device="cuda")
    assert on.restored_from == off.restored_from == 2
    assert on.captures == off.captures == 1
    ev = {e["name"]: e for e in on.registry.trace.events()}
    load, restore = ev["startup/kernel_load"], ev["fit/restore"]
    assert load["ts_mono"] < restore["ts_mono"] + restore["dur_s"]
    assert (ev["startup/aot_join"]["dur_s"]
            < ev["startup/aot_compile"]["dur_s"])
    assert on.registry.snapshot()["startup/aot_compile_s"] > 0
    assert [h["loss"] for h in on.history] == [h["loss"] for h in off.history]
    a, b = _state_tensors(on.state), _state_tensors(off.state)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# The Switch-MoE transformer and the model knobs on the card.  The LM
# paths' embedding gradient adds rows with atomics (index_add_), so as
# above their losses are held to 1e-5 relative and each state collection
# to 1e-4 in relative L2; ResNet's step has no atomics, so its remat and
# no-remat runs must leave the BN statistics (and the whole state) equal
# bit for bit: a recompute that updated them again would move them by the
# momentum's share.
MOE_LM = dict(
    global_batch_size=4, num_steps=64, vocab_size=128, attn_impl="flash",
    model_kwargs={"num_layers": 2, "num_heads": 4, "d_model": 128,
                  "d_ff": 256, "max_len": 64, "vocab_size": 128,
                  "dropout_rate": 0.1, "num_experts": 4})


def _assert_lm_states_close(a, b, got, want):
    for x, y in zip(got, want):
        assert abs(x - y) <= 1e-5 * abs(y)
    for group in ("params", "opt_state"):
        names = [n for n in a if n.startswith(group)
                 and a[n].is_floating_point()]
        assert _rel_l2(torch.cat([a[n].float().flatten() for n in names]),
                       torch.cat([b[n].float().flatten() for n in names])
                       ) <= 1e-4, group


def test_moe_replayed_chunk_equals_eager_steps(cuda):
    """The cut MoE transformer (experts on block 1, dropout 0.1): six
    steps in a chunk of 4 and a tail against the eager steps, aux loss
    reported by both."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig

    cfg = tconfig.get_config("transformer_lm_moe", train_steps=6, **MOE_LM)
    eager, captured, want, got, multi = _replay_and_eager(cfg, 6, 4, cuda)
    assert multi.captures == 1 and multi.replays == 5
    assert "aux_loss" in next(iter(multi._captured.values())).names
    _assert_lm_states_close(_state_tensors(captured), _state_tensors(eager),
                            got, want)


def test_moe_ffn_on_card_matches_cpu(cuda):
    """``moe_ffn`` at 2048 tokens, d 128, f 256, 4 experts on the card
    against the CPU on the same f32 inputs: at least 99.9 % of the expert
    choices equal (the router runs without TF32 on both), the rows routed
    to the same slot within f32 summation order (1e-4 relative plus 1e-5
    of the scale), aux and the dropped fraction within 1e-4."""
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    rng = np.random.default_rng(31)
    params = moe.init_moe_params(4, 128, 256,
                                 torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((2048, 128), dtype=np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        xd = x.to(dev)
        out = moe.moe_ffn(p, xd, mesh=None, capacity_factor=1.25)
        cap = moe.capacity(1.25, 2048, 4)
        dispatch, _, _, _ = moe._route_local(xd, p["router"], 4, cap)
        res[dev] = (out, dispatch.cpu())
    (a, da), (b, db) = res["cuda"], res["cpu"]
    same_expert = (da.sum(2).argmax(1) == db.sum(2).argmax(1)).float().mean()
    assert float(same_expert) >= 0.999
    rows = (da == db).flatten(1).all(1)
    assert float(rows.float().mean()) >= 0.99
    scale = float(b.out.abs().max())
    torch.testing.assert_close(a.out.cpu()[rows], b.out[rows], rtol=1e-4,
                               atol=1e-5 * scale)
    assert abs(float(a.aux_loss) - float(b.aux_loss)) <= 1e-4
    assert abs(float(a.dropped_fraction) - float(b.dropped_fraction)) <= 1e-4


def test_captured_remat_equals_eager_no_remat(cuda):
    """The cut transformer with dropout 0.1 under remat, captured (the
    recompute's dropout drawing from the twin generators the host seeds
    before each replay), against the eager steps without remat: the same
    losses and state, so the same masks."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    over = dict(REPLAY_CASES["transformer_lm"][1])
    plain = tconfig.get_config("transformer_lm", train_steps=6, **over)
    remat = plain.replace(model_kwargs={**plain.model_kwargs, "remat": True})
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
               for b in itertools.islice(iter(trainlib.build_dataset(plain)),
                                         6)]
    eager = trainlib.build_state(plain, cuda)
    step = trainlib.build_step(plain, eager)
    want = []
    for b in batches:
        eager, metrics = step(eager, b, plain.seed)
        want.append(float(metrics["loss"]))
    captured = trainlib.build_state(remat, cuda)
    multi = train_loop.MultiStep(trainlib.build_step(remat, captured))
    got = []
    for i in range(0, 6, 4):
        rows = batches[i:i + 4]
        chunk = {k: torch.stack([b[k] for b in rows]) for k in rows[0]}
        captured, metrics = multi(captured, chunk, remat.seed)
        got += metrics["loss"].tolist()
    torch.cuda.synchronize()
    assert multi.replays == 5
    cap = next(iter(multi._captured.values()))
    # One twin of the dropout generator per block.
    assert len(cap.twins) == over["model_kwargs"]["num_layers"]
    _assert_lm_states_close(_state_tensors(captured), _state_tensors(eager),
                            got, want)


def test_remat_resnet_on_card_leaves_bn_statistics_bit_for_bit(cuda):
    """``resnet50_synthetic_tiny`` at width 16 (K1 on the 3x3 convs of
    64 channels and more) through ``fit`` with remat on and off: the BN running
    statistics, and the whole state, equal bit for bit; the remat run
    launches K1's forwards again."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.ops import _kernels

    runs = {}
    for remat in (False, True):
        cfg = tconfig.get_config(
            "resnet50_synthetic_tiny", train_steps=5, steps_per_loop=4,
            global_batch_size=8,
            model_kwargs={"width": 16, "conv_impl": "mxu", "remat": remat})
        before = _kernels.launch_counts()
        r = trainlib.fit(cfg, device="cuda")
        runs[remat] = (r, {k: n - before[k] for k, n in
                           _kernels.launch_counts().items() if n != before[k]})
    (a, la), (b, lb) = runs[False], runs[True]
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    for k, v in a.state.batch_stats.items():
        assert torch.equal(v, b.state.batch_stats[k]), k
    sa, sb = _state_tensors(a.state), _state_tensors(b.state)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    k1 = (conv_mxu.conv_implicit_gemm, "launches")
    assert lb[k1] > la[k1] > 0


def test_embed_matmul_grad_on_card_matches_scatter(cuda):
    """The one-hot matmul embedding gradient at ``transformer_lm``'s
    shape (4096 tokens, V 10000, d 256, chunks of 2048) against the
    scatter (atomics): f32 sums in another order, 1e-5 relative plus 1e-6
    of the scale; the bf16 table's once-rounded sums to one bf16 ulp."""
    from distributed_tensorflow_models_tpu_torch.ops import embed

    rng = np.random.default_rng(41)
    tokens = torch.from_numpy(rng.integers(0, 10000, (16, 256))).to(cuda)
    g = torch.from_numpy(rng.standard_normal((16, 256, 256),
                                             dtype=np.float32)).to(cuda)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        grads = {}
        for impl in ("matmul", "scatter"):
            t = torch.zeros(10000, 256, dtype=dtype, device=cuda,
                            requires_grad=True)
            embed.embed_lookup(t, tokens, impl).backward(g.to(dtype))
            grads[impl] = t.grad.float()
        scale = float(grads["scatter"].abs().max())
        torch.testing.assert_close(grads["matmul"], grads["scatter"],
                                   rtol=rtol, atol=1e-6 * scale)


def test_blockwise_q_chunks_on_card_match_unchunked(cuda):
    """Blockwise attention with ``block_q=64`` against the unchunked loop
    at B2 T1024 H4 D64 causal in bf16: the same f32 arithmetic per row
    (products of bf16 values are exact in f32), so the outputs and
    gradients agree to one bf16 ulp (2^-7 relative) plus 1e-3 of the
    scale."""
    rng = np.random.default_rng(43)
    qkv = [torch.from_numpy(rng.standard_normal((2, 1024, 4, 64),
                                                dtype=np.float32)).to(
        cuda).bfloat16().requires_grad_() for _ in range(3)]
    do = torch.from_numpy(rng.standard_normal((2, 1024, 4, 64),
                                              dtype=np.float32)).to(
        cuda).bfloat16()
    outs = {}
    for bq in (None, 64):
        out = attnlib.blockwise_attention(*qkv, causal=True, block_q=bq)
        grads = torch.autograd.grad(out, qkv, do)
        outs[bq] = (out, *grads)
    for a, b in zip(outs[64], outs[None]):
        scale = float(b.detach().float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7,
                                   atol=1e-3 * scale)


# Tensor and sequence parallelism on the card (one GPU holds one rank).
RING_GPU_CASES = [  # B, T, H, Hkv, D, causal, window, n
    (1, 1024, 4, 4, 64, True, None, 2),
    (1, 1024, 4, 2, 32, True, 128, 4),
    # transformer_lm's T at a seq axis of 4: blocks of 64 rows, half of
    # K2's 128-row tile.
    (2, 256, 8, 8, 64, True, None, 4),
]


@pytest.mark.parametrize("case", RING_GPU_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ring_emulation_on_card_matches_full_flash(cuda, case):
    """``parallel/ring.py::emulate`` (``ring_step`` per virtual rank, K2
    forward and K3 + K4 backward per KV block, wholly masked blocks
    included) against one full ``flash_attention``: within the K2-K4
    tolerance, nothing non-finite, K2/K3/K4 n launches per virtual rank.
    The ring's ``auto`` takes the kernels at every block length, one
    shorter than K2's tile too."""
    from distributed_tensorflow_models_tpu_torch.parallel import ring as ringlib

    B, T, H, Hkv, D, causal, window, n = case
    rng = np.random.default_rng(51)
    q, do = _bf16(rng, (B, T, H, D)), _bf16(rng, (B, T, H, D))
    k, v = _bf16(rng, (B, T, Hkv, D)), _bf16(rng, (B, T, Hkv, D))
    assert ringlib.resolve_impl("auto", q[:, :T // n]) == "flash"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    full = attnlib.flash_attention(*leaves, causal, None, None, None, window)
    full.backward(do)
    kernels = (attnlib.flash_forward, attnlib.flash_dkv, attnlib.flash_dq)
    before = [fn.launches for fn in kernels]
    got = ringlib.emulate(q, k, v, n, impl="flash", causal=causal,
                          window=window, dout=do)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(kernels, before)] == [n * n] * 3
    for name, g, want in zip(("out", "dq", "dk", "dv"), got,
                             (full.detach(), *(t.grad for t in leaves))):
        assert bool(torch.isfinite(g).all()), name
        _assert_flash_close(g, want, f"ring {name}")


def test_tp_and_ring_at_axes_of_one_equal_the_plain_fit(cuda):
    """Cut ``transformer_lm`` on flash (dropout 0.1) with its
    ``param_rules="transformer_tp"`` and ``seq_impl="ring"`` at model and
    seq axes of one, captured, against the same fit without them: no
    collective on the axes of one, K2-K4 one launch a layer a step, the
    losses and state within the LM bound (the embedding's atomic sums)."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    base = tconfig.get_config(
        "transformer_lm", attn_impl="flash", train_steps=6, steps_per_loop=4,
        global_batch_size=4, model_kwargs={
            **tconfig.get_config("transformer_lm").model_kwargs,
            "num_layers": 2})
    runs = {}
    for label, cfg in (("tp_ring", base.replace(seq_impl="ring")),
                       ("plain", base.replace(param_rules="",
                                              seq_impl=None))):
        before = sharding.collective_counts()
        k2 = attnlib.flash_forward.launches
        r = trainlib.fit(cfg, device="cuda", mesh=meshlib.local_mesh("cuda"))
        assert sharding.counts_since(before) == {}
        assert attnlib.flash_forward.launches - k2 == 2 * 6
        assert (r.captures, r.replayed_steps) == (1, 5)
        runs[label] = r
    a, b = (_state_tensors(runs[k].state) for k in ("tp_ring", "plain"))
    _assert_lm_states_close(a, b, [h["loss"] for h in runs["tp_ring"].history],
                            [h["loss"] for h in runs["plain"].history])


def test_cnn_tp_split_convolutions_equal_k1_on_all_channels(cuda):
    """K1 on each half of the output channels of ResNet-50's 3x3 launch
    shapes (at batch 8), concatenated, equals K1 on all of them bit for
    bit: each output channel's sum runs in the same order whatever the
    channel tile."""
    rng = np.random.default_rng(52)
    for xs, ks in (((8, 58, 58, 64), (3, 3, 64, 64)),
                   ((8, 30, 30, 128), (3, 3, 128, 128)),
                   ((8, 16, 16, 256), (3, 3, 256, 256)),
                   ((8, 9, 9, 512), (3, 3, 512, 512))):
        x = _bf16(rng, xs)
        w = _bf16(rng, ks, 1.0 / math.sqrt(ks[0] * ks[1] * ks[2]))
        whole = conv_mxu.conv_implicit_gemm(x, w)
        c = ks[3] // 2
        halves = torch.cat([
            conv_mxu.conv_implicit_gemm(x, w[..., :c].contiguous()),
            conv_mxu.conv_implicit_gemm(x, w[..., c:].contiguous())], dim=-1)
        assert torch.equal(halves, whole), (xs, ks)


PIPE_GPU_CASES = [(2, 4), (4, 8)]


@pytest.mark.parametrize("case", PIPE_GPU_CASES,
                         ids=lambda c: f"n{c[0]}-m{c[1]}")
def test_pipeline_emulation_on_card_matches_sequential(cuda, case):
    """The pipelined stack (4 layers, d 128, flash, dropout 0.1) by the
    GPipe tick schedule of n virtual stages (``PipelinedBlocks.emulate``)
    against its sequential schedule on the same weights and dropout bits,
    at m microbatches: the output and every gradient within the K2-K4
    tolerance, K2/K3/K4 one launch a layer a microbatch."""
    n, m = case
    model = TransformerLM(num_layers=4, num_heads=4, d_model=128, d_ff=256,
                          max_len=256, vocab_size=64, dropout_rate=0.1,
                          attn_impl="flash", pipelined=True,
                          pipeline_microbatches=m,
                          generator=torch.Generator().manual_seed(0)).to(cuda)
    stack = model.pipeline
    rng = np.random.default_rng(53)
    x, dy = _bf16(rng, (8, 256, 128)), _bf16(rng, (8, 256, 128))
    params = list(stack.parameters())
    kernels = (attnlib.flash_forward, attnlib.flash_dkv, attnlib.flash_dq)
    runs = []
    for emulated in (False, True):
        xs = x.clone().requires_grad_()
        rngs = {"dropout": torch.Generator(device="cuda").manual_seed(7)}
        before = [fn.launches for fn in kernels]
        y = (stack.emulate(xs, n, True, rngs) if emulated
             else stack(xs, True, rngs))
        grads = torch.autograd.grad(y, [xs, *params], dy)
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(kernels, before)] == (
            [4 * m] * 3)
        runs.append([y.detach(), *grads])
    for what, got, want in zip(["out", "dx", *stack.PARAMS], *runs):
        assert bool(torch.isfinite(got).all()), what
        _assert_flash_close(got, want, f"pipeline {what}")


@pytest.mark.parametrize("ranks", [2, 4])
def test_expert_emulation_on_card_matches_the_reference(cuda, ranks):
    """``moe.emulate`` (the expert layout's per-rank arithmetic: chunk
    routing, the two exchanges as list transposes, each rank's experts)
    at 2048 tokens, d 128, f 256, 4 experts on the card against
    ``moe_ffn_reference(num_ranks=ranks)``: out and the gradients within
    f32 summation order (1e-4 relative plus 1e-5 of the scale), aux and
    the dropped fraction within 1e-4."""
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    params = {k: v.to(cuda) for k, v in moe.init_moe_params(
        4, 128, 256, torch.Generator().manual_seed(4)).items()}
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (2048, 128), dtype=np.float32)).to(cuda)
    runs = []
    for fn in (moe.emulate, moe.moe_ffn_reference):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xs = x.clone().requires_grad_()
        r = fn(p, xs, num_ranks=ranks)
        loss = torch.mean(r.out ** 2) + 0.01 * r.aux_loss
        runs.append((r, torch.autograd.grad(loss, [xs, *p.values()])))
    (a, ga), (b, gb) = runs
    for got, want in zip((a.out, *ga), (b.out, *gb)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-4,
                                   atol=1e-5 * scale)
    assert abs(float(a.aux_loss.detach()) - float(b.aux_loss.detach())) <= 1e-4
    assert abs(float(a.dropped_fraction) - float(b.dropped_fraction)) <= 1e-4


def test_nccl_group_of_one_sums_bf16_unchanged(cuda):
    """F8: in a world-1 NCCL group a sum of a bf16 tensor leaves it as it
    is (NCCL's sum pre-multiplied by 1 gave zeros for bf16 on the card, so
    the port issues bf16 sums as the plain SUM), and the MoE transformer,
    whose token gather's backward sums a bf16 cotangent over the data
    group, trains in the group as without one."""
    import socket

    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = tconfig.get_config("transformer_lm_moe", train_steps=4,
                             steps_per_loop=2, **MOE_LM)
    alone = trainlib.fit(cfg, device="cuda", mesh=meshlib.local_mesh("cuda"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    meshlib.initialize_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = trainlib.mesh_from_config(cfg)
        assert mesh.backend == "nccl"
        base = torch.randn(4096, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = base.to(dtype)
            y = sharding.all_reduce_sum_(x.clone(), mesh, "test", dp=True)
            assert torch.equal(y, x), dtype
        grouped = trainlib.fit(cfg, device="cuda")
    finally:
        dist.destroy_process_group()
    assert [h["loss"] for h in grouped.history] == [
        h["loss"] for h in alone.history]
    _assert_lm_states_close(_state_tensors(grouped.state),
                            _state_tensors(alone.state),
                            [h["loss"] for h in grouped.history],
                            [h["loss"] for h in alone.history])


def _emulator_runs(cfg, device, events, make):
    """``make(state, loss, capture)`` -> an emulator, run on ``events``
    batches of ``cfg`` (``shards`` of each for a backup emulator) from the
    same seeded state, captured and eagerly: [(losses, emulator), ...]."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.harness import experiment
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    batches = experiment.ab_batches(cfg, events, meshlib.local_mesh(device))
    runs = []
    for capture in (True, False):
        state = trainlib.build_state(
            cfg, device, num_steps=max(cfg.train_steps, events))
        emu = make(state, trainlib.build_loss(cfg, state), capture)
        recs = [emu.step(b, cfg.seed) for b in batches]
        runs.append(([float(r["metrics"]["loss"]) for r in recs], emu))
    return runs


@pytest.mark.parametrize("case", ["resnet32_cifar10", "transformer_lm"])
def test_async_emulator_replays_equal_eager_events(cuda, case):
    """The async-PS emulator at K = 4 round robin (staleness 0, 1, 2, 3, 3,
    3: the snapshot copied into the grad graph's parameters) with its
    gradient and apply programs captured, against the same events run
    eagerly: bit for bit where the step has no atomics, else within the LM
    bound; one capture of each program."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.parallel import async_ps

    name, over, exact = REPLAY_CASES[case]
    cfg = tconfig.get_config(name, **over)
    (got, cap), (want, eager) = _emulator_runs(
        cfg, cuda, 6, lambda s, loss, capture: async_ps.AsyncPSEmulator(
            s, loss, async_ps.AsyncConfig(num_workers=4), capture=capture))
    assert cap.programs.captures == 2 and eager.programs.captures == 0
    assert cap.staleness_log == eager.staleness_log == [0, 1, 2, 3, 3, 3]
    a, b = _state_tensors(cap.state), _state_tensors(eager.state)
    if exact:
        assert got == want
        assert all(torch.equal(a[k], b[k]) for k in b)
    else:
        _assert_lm_states_close(a, b, got, want)


def test_backup_emulator_replays_equal_eager_rounds(cuda):
    """The backup emulator (M = 4, N = 3) on cut ResNet-32 with its
    programs captured against the same rounds run eagerly, bit for bit:
    the BN statistics restored between the chosen replicas' replays."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.parallel import backup

    name, over, _ = REPLAY_CASES["resnet32_cifar10"]
    cfg = tconfig.get_config(name, **over)

    class Sharded(backup.SyncBackupEmulator):
        def step(self, batch, seed):
            return super().step(backup.split_into_shards(batch, 4), seed)

    (got, cap), (want, eager) = _emulator_runs(
        cfg, cuda, 3, lambda s, loss, capture: Sharded(
            s, loss, backup.BackupConfig(4, 3), capture=capture))
    assert cap.programs.captures == 2 and cap.discarded == 3
    a, b = _state_tensors(cap.state), _state_tensors(eager.state)
    assert got == want and all(torch.equal(a[k], b[k]) for k in b)


def test_ab_one_worker_equals_sync_on_card(cuda):
    """``async_vs_sync`` on cut ResNet-32 (K1's f32 form) at K = 1: the
    async mode's losses and state equal the sync mode's (``fit``'s
    captured step) bit for bit, K1 launched as often in each."""
    from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
    from distributed_tensorflow_models_tpu_torch.harness import experiment

    name, over, _ = REPLAY_CASES["resnet32_cifar10"]
    cfg = tconfig.get_config(name, **over)
    res = experiment.async_vs_sync(cfg, 4, num_workers=1, device="cuda",
                                   keep_states=True)
    assert res.async_losses == res.sync_losses
    a, b = _state_tensors(res.sync_state), _state_tensors(res.async_state)
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert res.launches["sync"] == res.launches["async"]
    assert res.launches["sync"]


# -- R1 and the serving engine ----------------------------------------------


def _r1_within_bound(got, a4, b4, out_dtype):
    """The tensor-core form against the plain version on the same
    operands: an f32 result within ``K 2^-22 sum_k |a_k b_k|`` (f64,
    from the operands: both are f32 sums of K exact bf16 products, this
    is their forward-error bound with room for the rounding inside a
    k16 step); a bf16 one, each side that f32 sum rounded once, within
    that bound plus one bf16 ulp (at the larger of the two)."""
    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    plain = rowwise._plain_matmul(a4, b4, out_dtype).reshape(got.shape)
    diff = (got.double() - plain.double()).abs()
    mag = torch.matmul(a4.double().abs(), b4.double().abs())
    lim = a4.shape[-1] * 2.0 ** -22 * mag.reshape(got.shape)
    if out_dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.double().abs(),
                                         plain.double().abs()))
        lim = lim + torch.ldexp(torch.ones_like(diff), e - 8)
    assert bool((diff <= lim).all()), float((diff - lim).max())


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_row_gemm_matches_plain_and_is_row_invariant(cuda, dt):
    """R1 (``csrc/row_gemm.cu``).  bf16 operands take the tensor-core
    form: for both result dtypes its rows at M = 1, 2, 7, 8, 9, 17, 63,
    64, 65, 256 and 4096 equal the rows of one 4096-row launch bit for
    bit, and so does each row moved within its 64-row tile by rows put
    before it; G1 x G2 groups (distinct weights, and one weight broadcast
    by zero strides) equal one group at a time; a cache read in place as
    K^T and as V equals its ``.contiguous()`` copy; ragged N (300) and K
    % 16 != 0 (40, 200); every result within ``_r1_within_bound`` of the
    plain version.  f32 operands take the SIMT form: equal to the plain
    version bit for bit, its rows at M = 1, 17, 64, 65 and 256 the rows
    of the 256-row launch.  ``row_sum`` (the column kernel, either dtype)
    equals its plain version bit for bit at 256 and 4096 rows of 192 and
    256 rows of 576.  Each form's launch counter counts."""
    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    rng = np.random.default_rng(5)
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    form = "wgmma_launches" if dt == "bf16" else "simt_launches"

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device="cuda")

    a, b = t(4096, 200), t(200, 300)
    n0, f0 = rowwise.row_matmul.launches, getattr(rowwise.row_matmul, form)
    whole = rowwise.row_matmul(a, b, torch.float32)
    assert rowwise.row_matmul.launches == n0 + 1
    assert getattr(rowwise.row_matmul, form) == f0 + 1
    if dt == "f32":
        a, whole = a[:256], whole[:256]
        assert torch.equal(whole, rowwise._plain_matmul(
            a[None, None], b[None, None], torch.float32)[0, 0])
        for m in (1, 17, 64, 65, 256):
            parts = torch.cat([rowwise.row_matmul(a[i:i + m], b,
                                                  torch.float32)
                               for i in range(0, 256, m)])
            assert torch.equal(parts, whole), m
        assert torch.equal(rowwise.row_matmul(a, b), whole.to(dtype))
    else:
        for odt in (torch.float32, torch.bfloat16):
            ref = rowwise.row_matmul(a, b, odt)
            _r1_within_bound(ref, a[None, None], b[None, None], odt)
            for m in (1, 2, 7, 8, 9, 17, 63, 64, 65, 256, 4096):
                parts = torch.cat([rowwise.row_matmul(a[i:i + m], b, odt)
                                   for i in range(0, 4096, m)])
                assert torch.equal(parts, ref), (odt, m)
            for p in (1, 5, 31, 63):
                moved = rowwise.row_matmul(torch.cat([a[-p:], a[:130]]), b,
                                           odt)
                assert torch.equal(moved[p:], ref[:130]), (odt, p)
        g = t(2, 3, 9, 200)
        for bg in (t(2, 3, 200, 300), b.expand(2, 3, 200, 300)):
            grouped = rowwise.row_matmul(g, bg, torch.float32)
            for i in range(2):
                for j in range(3):
                    one = rowwise.row_matmul(g[i:i + 1, j:j + 1],
                                             bg[i:i + 1, j:j + 1],
                                             torch.float32)
                    assert torch.equal(one[0, 0], grouped[i, j])
            _r1_within_bound(grouped, g, bg, torch.float32)
        # The broadcast weight's groups equal a 2-D launch on that weight.
        assert torch.equal(grouped[0, 0, :2],
                           rowwise.row_matmul(g[0, 0, :2], b, torch.float32))
    cache = t(3, 40, 4, 32)
    q = t(3, 4, 5, 32)
    for view in (cache.permute(0, 2, 3, 1), cache.permute(0, 2, 1, 3)):
        qq = q if view.shape[2] == 32 else t(3, 4, 5, 40)
        got = rowwise.row_matmul(qq, view, torch.float32)
        assert torch.equal(got, rowwise.row_matmul(qq, view.contiguous(),
                                                   torch.float32))
        if dt == "f32":
            assert torch.equal(got, rowwise._plain_matmul(qq, view,
                                                          torch.float32))
        else:
            _r1_within_bound(got, qq, view, torch.float32)
    s0 = rowwise.row_matmul.simt_launches
    x0 = t(256, 192)
    for x in (x0, x0.repeat(16, 1), x0.repeat(1, 3)):
        ones = torch.ones(x.shape[1], 1, dtype=dtype, device="cuda")
        assert torch.equal(rowwise.row_sum(x), rowwise._plain_matmul(
            x[None, None], ones[None, None], torch.float32)[0, 0])
    assert rowwise.row_matmul.simt_launches == s0 + 3
    with pytest.raises(TypeError):
        rowwise.row_matmul(a, b.float() if dt == "bf16" else b.bfloat16())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_serving_engine_on_card_equals_solo_generate(cuda, dt):
    """The engine at ``_small_lm``'s size on the card (programs captured
    as CUDA graphs), the model in f32 (R1's SIMT form) and in bf16 (its
    products on the tensor-core form): every stream of the six sampling
    modes, with mid-flight admission, 2-lane prefill at page 4 and
    speculation, equals solo ``generate`` on the card (captured too),
    token for token; the programs are built once and R1 runs in them, in
    the form the dtype picks."""
    from distributed_tensorflow_models_tpu_torch.harness import generate
    from distributed_tensorflow_models_tpu_torch.ops import rowwise
    from distributed_tensorflow_models_tpu_torch.serving import engine, scheduler
    from distributed_tensorflow_models_tpu_torch.telemetry import registry

    model = TransformerLM(vocab_size=50, num_layers=2, num_heads=2,
                          d_model=32, d_ff=64, max_len=64, dropout_rate=0.0,
                          dtype=torch.float32 if dt == "f32" else
                          torch.bfloat16, attn_impl="reference",
                          generator=torch.Generator().manual_seed(0)).cuda()
    form = "simt_launches" if dt == "f32" else "wgmma_launches"
    modes = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 5, 1.0), (1.0, 0, 0.9),
             (0.7, 8, 0.85), (0.0, 0, 1.0)]
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 50, n).astype(np.int32)
               for n in (3, 7, 8, 12, 5, 9)]
    maxnew = [10, 8, 12, 6, 10, 7]
    solo = {}
    for i, (t, k, p) in enumerate(modes):
        out = generate.generate(
            model, torch.tensor(prompts[i][None], device="cuda",
                                dtype=torch.int64), maxnew[i],
            temperature=t, top_k=k, top_p=p, seed=i if t > 0 else None)
        solo[i] = out[0, len(prompts[i]):].tolist()
    for kw, programs in ((dict(max_slots=4), (1, 1)),
                         (dict(max_slots=3, prefill_lanes=2,
                               kv_page_tokens=4, decode_burst=3), (1, 1)),
                         (dict(max_slots=4, spec_tokens=3), (1, 2))):
        eng = engine.InferenceEngine(model, prefill_chunk=8,
                                     registry=registry.MetricsRegistry(),
                                     **kw)
        sched = scheduler.ContinuousBatchingScheduler(eng,
                                                      max_prefill_tokens=64)
        reqs = [scheduler.Request(i, prompts[i], maxnew[i], temperature=t,
                                  top_k=k, top_p=p,
                                  rng=i if t > 0 else None)
                for i, (t, k, p) in enumerate(modes)]
        n0 = getattr(rowwise.row_matmul, form)
        for r in reqs[:5]:
            sched.submit(r)
        done = list(sched.step()) + list(sched.step())
        sched.submit(reqs[5])
        done += sched.run_until_idle()
        comps = {c.request_id: c.tokens for c in done}
        assert comps == solo, kw
        assert eng.compile_counts() == programs, kw
        assert eng.fsck() == []
        assert getattr(rowwise.row_matmul, form) > n0
