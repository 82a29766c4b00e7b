"""The port's attention against the JAX package's, on numpy-seeded inputs.

On CPU tensors the port's flash path runs the plain versions of K2, K3
and K4 (``ops/attention.py``); the JAX side runs its Pallas kernels in
interpret mode with 64-row blocks, or its reference.  Tolerances are the
JAX suite's own (tests/test_attention.py): forward 2e-5, gradients 1e-4 in
f32, and rtol 0.1 / atol 0.15 for bf16 inputs against the f32 reference.
Rows with no valid key at all are left out of every comparison: their
values depend on which tiles a kernel visits, in the JAX package too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.ops import attention as jattn
from distributed_tensorflow_models_tpu_torch.ops import attention as tattn

jax.config.update("jax_platforms", "cpu")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.1, atol=0.15)


def _qkv(B=2, Tq=256, H=4, D=32, Tkv=None, Hkv=None, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Tq, H, D).astype(np.float32) * 0.5
    kv_shape = (B, Tkv or Tq, Hkv or H, D)
    k = rng.randn(*kv_shape).astype(np.float32) * 0.5
    v = rng.randn(*kv_shape).astype(np.float32) * 0.5
    return q, k, v


def _jax_run(fn, q, k, v):
    """JAX forward and the gradients of sum(out^2), jitted."""

    @jax.jit
    def run(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2.0 * out)

    out, grads = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(fn, q, k, v, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in ts])


def _assert_run_close(got, want, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL):
    np.testing.assert_allclose(got[0], want[0], **fwd_tol)
    for name, g, w in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **grad_tol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_interpret(causal):
    q, k, v = _qkv(Tq=256)
    want = _jax_run(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal, None, 64, 64, True), q, k, v)
    got = _torch_run(lambda q, k, v: tattn.flash_attention(
        q, k, v, causal, None, 64, 64), q, k, v)
    _assert_run_close(got, want)


def test_flash_cross_shapes_match_jax_interpret():
    """Tq != Tkv (non-causal cross-attention)."""
    q, k, v = _qkv(Tq=128, Tkv=256, H=2, seed=3)
    want = _jax_run(lambda q, k, v: jattn.flash_attention(
        q, k, v, False, None, 64, 64, True), q, k, v)
    got = _torch_run(lambda q, k, v: tattn.flash_attention(
        q, k, v, False, None, 64, 64), q, k, v)
    _assert_run_close(got, want)


@pytest.mark.parametrize("hkv,window", [(1, None), (2, None), (2, 80),
                                        (4, 80)],
                         ids=["mqa", "gqa2", "gqa2-window80", "mha-window80"])
def test_flash_gqa_and_window_match_jax_reference(hkv, window):
    q, k, v = _qkv(Tq=256, H=4, Hkv=hkv, seed=4)
    want = _jax_run(lambda q, k, v: jattn.reference_attention(
        q, k, v, causal=True, window=window), q, k, v)
    got = _torch_run(lambda q, k, v: tattn.flash_attention(
        q, k, v, True, None, 64, 64, window), q, k, v)
    _assert_run_close(got, want)


def _chunk_case():
    """Causal chunk with kv_offset 64 > q_offset 0: queries 0..63 see no
    key (they are left out), the rest cross the diagonal.  The loss uses
    out and lse with random weights on the valid rows only."""
    B, T, H, D = 2, 192, 4, 32
    q, k, v = _qkv(B=B, Tq=T, H=H, D=D, Hkv=2, seed=5)
    rng = np.random.RandomState(6)
    w_out = rng.randn(B, T, H, D).astype(np.float32)
    w_lse = rng.randn(B, T, H).astype(np.float32)
    rows = np.arange(T) >= 64
    w_out[:, ~rows] = 0.0
    w_lse[:, ~rows] = 0.0
    return (q, k, v), (w_out, w_lse), rows, dict(q_offset=0, kv_offset=64)


def test_flash_chunk_with_offsets_and_lse_cotangent_matches_jax():
    (q, k, v), (w_out, w_lse), rows, offs = _chunk_case()

    @jax.jit
    def jrun(q, k, v):
        def loss(q, k, v):
            out, lse = jattn.flash_attention_chunk(
                q, k, v, offs["q_offset"], offs["kv_offset"], True, None, 64,
                64, True)
            return jnp.sum(out * w_out) + jnp.sum(lse * w_lse), (out, lse)

        (_, (out, lse)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return out, lse, grads

    jout, jlse, jgrads = jrun(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = tattn.flash_attention_chunk(*ts, offs["q_offset"],
                                           offs["kv_offset"], True, None,
                                           64, 64)
    assert tuple(lse.shape) == (2, 192, 4)
    ((out * torch.tensor(w_out)).sum()
     + (lse * torch.tensor(w_lse)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy()[:, rows],
                               np.asarray(jout)[:, rows], **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy()[:, rows],
                               np.asarray(jlse)[:, rows], **FWD_TOL)
    for name, t, g in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_flash_chunk_lse_merges_to_full_attention():
    """Two KV chunks' (out, lse) merged by their LSEs give attention over
    the whole sequence: the ring-attention use of the chunk API."""
    q, k, v = (torch.tensor(x) for x in _qkv(B=1, Tq=128, H=2, seed=7))
    full = tattn.reference_attention(q, k, v, causal=True)
    parts = [tattn.flash_attention_chunk(q, k[:, lo:lo + 64], v[:, lo:lo + 64],
                                         0, lo, True)
             for lo in (0, 64)]
    (o1, l1), (o2, l2) = parts
    lse = torch.logaddexp(l1, l2)
    merged = (o1 * torch.exp(l1 - lse)[..., None]
              + o2 * torch.exp(l2 - lse)[..., None])
    np.testing.assert_allclose(merged.numpy(), full.numpy(), **FWD_TOL)


def test_flash_bf16_within_jax_bf16_tolerance():
    """bf16 inputs: the port's flash grads sit within the JAX suite's bf16
    tolerance of the f32 JAX reference, as JAX's own flash does."""
    q, k, v = _qkv(Tq=128, D=32)
    want = _jax_run(lambda q, k, v: jattn.reference_attention(
        q, k, v, causal=True), q, k, v)
    got = _torch_run(lambda q, k, v: tattn.flash_attention(
        q, k, v, True, None, 64, 64), q, k, v, dtype=torch.bfloat16)
    _assert_run_close(got, want, BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("case", [
    dict(causal=False), dict(causal=True), dict(causal=True, window=40),
    dict(causal=True, q_offset=30, kv_offset=10),
    dict(causal=False, hkv=2, window=50),
], ids=["full", "causal", "window40", "offsets", "gqa-window"])
def test_reference_matches_jax(case):
    case = dict(case)
    hkv = case.pop("hkv", None)
    q, k, v = _qkv(Tq=96, H=4, Hkv=hkv, seed=8)
    want = _jax_run(functools.partial(jattn.reference_attention, **case),
                    q, k, v)
    got = _torch_run(functools.partial(tattn.reference_attention, **case),
                     q, k, v)
    _assert_run_close(got, want)


@pytest.mark.parametrize("case", [
    dict(causal=False, block_kv=32), dict(causal=True, block_kv=128),
    dict(causal=True, block_kv=64, window=70),
    dict(causal=True, block_kv=48, q_offset=20, kv_offset=5, hkv=2),
], ids=["full-32", "causal-128", "window-64", "offsets-gqa-48"])
def test_blockwise_matches_jax(case):
    """Blockwise at T=100, which no block divides: the JAX side pads and
    masks the last block, the port leaves it short."""
    case = dict(case)
    hkv = case.pop("hkv", None)
    q, k, v = _qkv(Tq=100, H=4, Hkv=hkv, seed=9)
    want = _jax_run(functools.partial(jattn.blockwise_attention, **case),
                    q, k, v)
    got = _torch_run(functools.partial(tattn.blockwise_attention, **case),
                     q, k, v)
    _assert_run_close(got, want)


def test_block_predicates_match_jax():
    """_block_should_run and _block_fully_valid on every combination of
    small tiles, offsets, windows and tile indices (so each boundary
    equality occurs), and on the model-sized tiles."""
    grids = [((2, 3), range(8), range(4), (None, 1, 2, 3, 5)),
             ((32, 64, 128), (0, 17, 63, 64, 300), range(6),
              (None, 1, 64, 80, 256))]
    n = 0
    for sizes, offsets, idx, windows in grids:
        for causal in (False, True):
            for window in windows:
                for bq in sizes:
                    for bkv in sizes:
                        kw = dict(causal=causal, block_q=bq, block_kv=bkv,
                                  window=window)
                        for q_base in offsets:
                            for kv_base in offsets:
                                for i in idx:
                                    for j in idx:
                                        args = (i, j, q_base, kv_base)
                                        for f in ("_block_should_run",
                                                  "_block_fully_valid"):
                                            assert bool(getattr(tattn, f)(
                                                *args, **kw)) == bool(
                                                getattr(jattn, f)(*args, **kw)
                                            ), (f, args, kw)
                                        n += 1
    assert n == 2 * 5 * 4 * 64 * 16 + 2 * 5 * 9 * 25 * 36


def test_kv_row_matches_jax():
    """The query-head -> KV-head row map, over several batches and group
    sizes (the kernels use the same h / group)."""
    for H, Hkv in ((8, 8), (8, 2), (8, 1), (6, 3)):
        g = H // Hkv
        t, j = tattn._kv_row(H, Hkv, g), jattn._kv_row(H, Hkv, g)
        assert [t(b) for b in range(3 * H)] == [j(b) for b in range(3 * H)]


@pytest.mark.parametrize("T", [64, 128, 200, 256, 384, 512])
def test_tile_rules_match_jax(T):
    assert tattn._auto_block(T) == jattn._auto_block(T)
    assert tattn._auto_block_bwd(T) == jattn._auto_block_bwd(T)
    for bq, bkv in ((None, None), (64, 64), (96, 32)):
        try:
            want = jattn._check_blocks(T, 2 * T, bq, bkv)
        except ValueError:
            with pytest.raises(ValueError, match="not divisible"):
                tattn._check_blocks(T, 2 * T, bq, bkv)
        else:
            assert tattn._check_blocks(T, 2 * T, bq, bkv) == want


def test_dispatcher_routes_and_validates_knobs(monkeypatch):
    q, k, v = (torch.tensor(x) for x in _qkv(B=1, Tq=128, H=2, seed=10))
    auto = tattn.attention(q, k, v, causal=True)
    blockwise = tattn.blockwise_attention(q, k, v, causal=True)
    assert torch.equal(auto, blockwise)
    before = tattn.flash_forward.launches
    flash = tattn.attention(q, k, v, causal=True, impl="flash")
    np.testing.assert_allclose(flash.numpy(), auto.numpy(), **FWD_TOL)
    # CPU tensors run the plain versions: no kernel is launched.
    assert tattn.flash_forward.launches == before
    monkeypatch.setenv("DTM_FLASH_TILE", "64")
    tattn.attention(q, k, v, causal=True, impl="flash")
    for bad, match in (("x", "integer"), ("12", "multiple of 8"),
                       ("96", "does not divide")):
        monkeypatch.setenv("DTM_FLASH_TILE", bad)
        with pytest.raises(ValueError, match=match):
            tattn.attention(q, k, v, causal=True, impl="flash")
    monkeypatch.delenv("DTM_FLASH_TILE")
    monkeypatch.setenv("DTM_FLASH_BWD", "staged")
    with pytest.raises(NotImplementedError, match="K5"):
        tattn.attention(q, k, v, causal=True, impl="flash")
    monkeypatch.setenv("DTM_FLASH_BWD", "other")
    with pytest.raises(ValueError, match="DTM_FLASH_BWD"):
        tattn.attention(q, k, v, causal=True, impl="flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="window"):
        tattn.flash_attention(q, k, v, True, window=0)


def test_kernel_wrappers_take_cuda_tensors_only():
    """On the CPU the kernels' wrappers raise: only the autograd path
    picks the plain versions, and only for CPU tensors."""
    q = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    kw = dict(scale=1.0, causal=True, window=None, q_offset=0, kv_offset=0)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_forward(q, q, q, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_dkv(q, q, q, q, lse, lse, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_dq(q, q, q, q, lse, lse, **kw)
