"""The port's attention against the JAX package's, on numpy-seeded inputs.

On CPU tensors the port's flash path runs the plain versions of K2, K3
and K4, or of K5 for the staged backward (``ops/attention.py``); the JAX side runs its Pallas kernels in
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
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

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


QCHUNK_CASES = [
    dict(causal=True, block_kv=32, block_q=20),
    dict(causal=True, block_kv=48, block_q=25, window=40),
    dict(causal=False, block_kv=32, block_q=20, window=30),
    dict(causal=True, block_kv=48, block_q=50, q_offset=20, kv_offset=5,
         hkv=2),
]
QCHUNK_IDS = ["causal", "causal-window-ragged-kv", "window", "offsets-gqa"]


@pytest.mark.parametrize("case", QCHUNK_CASES, ids=QCHUNK_IDS)
def test_blockwise_q_chunks_match_jax(case):
    """``block_q`` chunking at T=100 against JAX's chunked blockwise (with
    the same arguments) and against the port's unchunked loop: each chunk
    skips the blocks its mask rules out, which changes nothing (bit for
    bit against the unchunked loop here)."""
    case = dict(case)
    hkv = case.pop("hkv", None)
    q, k, v = _qkv(Tq=100, H=4, Hkv=hkv, seed=11)
    want = _jax_run(functools.partial(jattn.blockwise_attention, **case),
                    q, k, v)
    got = _torch_run(functools.partial(tattn.blockwise_attention, **case),
                     q, k, v)
    _assert_run_close(got, want)
    case.pop("block_q")
    plain = _torch_run(functools.partial(tattn.blockwise_attention, **case),
                       q, k, v)
    np.testing.assert_array_equal(got[0], plain[0])
    for g, w in zip(got[1], plain[1]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_blockwise_q_chunk_env_knob(monkeypatch, capsys):
    """``DTM_BLOCKWISE_QBLOCK`` sets the chunk when ``block_q`` is not
    given; a chunk past the length is clamped and said so, with JAX's
    words."""
    q, k, v = (torch.tensor(x) for x in _qkv(B=1, Tq=64, H=2, seed=12))
    plain = tattn.blockwise_attention(q, k, v, causal=True, block_kv=16)
    monkeypatch.setenv("DTM_BLOCKWISE_QBLOCK", "16")
    assert tattn._resolve_qblock(None, 64) == 16
    assert torch.equal(tattn.blockwise_attention(q, k, v, causal=True,
                                                  block_kv=16), plain)
    for mod in (jattn, tattn):
        assert mod._resolve_qblock(100, 64) == 64
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]
    assert "block_q=100 clamped to 64" in err[0]


@pytest.mark.parametrize("block_q,env,Tq", [
    (24, None, 100), (1, None, 128), (0, None, 64), (None, "x", 64),
    (None, "24", 100), (None, "-1", 64)],
    ids=["no-divide", "too-many", "zero", "not-int", "env-no-divide",
         "env-negative"])
def test_blockwise_q_chunk_errors_match_jax(monkeypatch, block_q, env, Tq):
    """Every refusal raises JAX's ValueError, naming the knob that set
    the chunk."""
    if env is not None:
        monkeypatch.setenv("DTM_BLOCKWISE_QBLOCK", env)
    with pytest.raises(ValueError) as want:
        jattn._resolve_qblock(block_q, Tq)
    with pytest.raises(ValueError) as got:
        tattn._resolve_qblock(block_q, Tq)
    assert str(got.value) == str(want.value)
    assert ("DTM_BLOCKWISE_QBLOCK" if env is not None else "block_q") in str(
        got.value)
    q, k, v = (torch.tensor(x) for x in _qkv(B=1, Tq=Tq, H=2, seed=13))
    with pytest.raises(ValueError, match=str(want.value)[:20]):
        tattn.blockwise_attention(q, k, v, causal=True, block_q=block_q)


@pytest.mark.parametrize("kw", [dict(causal=False),
                                dict(causal=True, q_offset=0, kv_offset=8),
                                dict(causal=True, window=4, kv_offset=0,
                                     q_offset=80)],
                         ids=["no-mask", "dead-rows", "window-dead-rows"])
def test_blockwise_q_chunk_ignored_with_jax_notice(capsys, kw):
    """With neither mask, or where a row could see no key, the chunk is
    ignored (the unchunked loop's bits) with JAX's stderr line."""
    q, k, v = _qkv(B=1, Tq=64, H=2, seed=14)
    want = _jax_run(functools.partial(jattn.blockwise_attention,
                                      block_kv=16, block_q=16, **kw), q, k, v)
    jerr = capsys.readouterr().err
    ts = [torch.tensor(x) for x in (q, k, v)]
    got = tattn.blockwise_attention(*ts, block_kv=16, block_q=16, **kw)
    terr = capsys.readouterr().err
    assert terr == jerr and "ignored" in terr
    assert torch.equal(got, tattn.blockwise_attention(*ts, block_kv=16, **kw))
    np.testing.assert_allclose(got.numpy(), want[0], **FWD_TOL)


def test_blockwise_q_chunk_ignored_at_tensor_offsets(capsys):
    """A tensor offset (a decode cache's index) is not static: the chunk
    is ignored, as JAX ignores a traced offset."""
    ts = [torch.tensor(x) for x in _qkv(B=1, Tq=32, H=2, seed=15)]
    got = tattn.blockwise_attention(*ts, causal=True, block_kv=8,
                                    block_q=8, q_offset=torch.tensor(0))
    assert "traced offsets" in capsys.readouterr().err
    assert torch.equal(got, tattn.blockwise_attention(*ts, causal=True,
                                                      block_kv=8))


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
    # DTM_FLASH_BWD=staged routes the backward through K5's plain versions:
    # the pair's gradients, bit for bit.
    grads = {}
    for bwd in ("pair", "staged"):
        monkeypatch.setenv("DTM_FLASH_BWD", bwd)
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (tattn.attention(*ts, causal=True, impl="flash") ** 2).sum().backward()
        grads[bwd] = [t.grad for t in ts]
    for a, b in zip(grads["staged"], grads["pair"]):
        assert torch.equal(a, b)
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
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_dkv_staged(q, q, q, q, lse, lse, **kw)
    ds = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_dq_staged(ds, q, **kw)


def _grads(fn, q, k, v, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    (fn(*ts).float() ** 2).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,hkv",
                         [(True, None, None), (True, 64, None),
                          (True, None, 2)], ids=["causal", "window", "gqa"])
def test_flash_bwd_staged_matches_pair_and_jax(causal, window, hkv, dtype):
    """The cases of the JAX suite's test_flash_bwd_staged_matches_pair: the
    staged plain backward gives the pair plain backward's gradients bit
    for bit (in f32 and bf16), and JAX's interpret-mode staged gradients
    within its flash tolerance (in f32)."""
    q, k, v = _qkv(Tq=256, H=4, Hkv=hkv, seed=11)
    tdt = getattr(torch, dtype)
    got = {staged: _grads(lambda q, k, v: tattn.flash_attention(
        q, k, v, causal, None, 128, 128, window, staged), q, k, v, tdt)
           for staged in (False, True)}
    for name, a, b in zip("qkv", got[True], got[False]):
        assert torch.equal(a, b), name
    if dtype == "bfloat16":
        return
    want = _jax_run(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal, None, 128, 128, True, window, True), q, k, v)
    for name, g, w in zip("qkv", got[True], want[1]):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_staged_plain_versions_shapes_and_stage():
    """The dS stage is [B*H, Tq, Tkv] in K's dtype and holds the pair
    backward's dS; the staged dQ from it is the pair's dQ."""
    q, k, v = (torch.tensor(x).bfloat16() for x in _qkv(B=2, Tq=64, H=4,
                                                         Hkv=2, seed=12))
    do = torch.tensor(np.random.RandomState(13).randn(2, 64, 4, 32)
                      ).bfloat16()
    kw = dict(scale=32 ** -0.5, causal=True, window=None, q_offset=0,
              kv_offset=0)
    out, lse = tattn._flash_forward_reference(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, lse, delta)
    dk, dv, ds = tattn._flash_dkv_staged_reference(*args, **kw)
    assert ds.shape == (8, 64, 64) and ds.dtype == torch.bfloat16
    pdk, pdv = tattn._flash_dkv_reference(*args, **kw)
    assert torch.equal(dk, pdk) and torch.equal(dv, pdv)
    dq = tattn._flash_dq_staged_reference(ds, k, **kw)
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    assert torch.equal(dq, tattn._flash_dq_reference(*args, **kw))


# --------------------------------------------------- K2's loop and arithmetic
# K2 (csrc/flash_attention.cu) visits, for each 128-row query tile, only the
# KV tiles in _kv_tile_range; the scan below is the definition it must meet.
_RANGE_LENGTHS = (1, 127, 128, 129, 200, 384, 2048)
_RANGE_OFFSETS = ((0, 0), (384, 256), (200, 100))


@pytest.mark.parametrize("bq,bkv", [(128, 128), (128, 64)],
                         ids=["128x128", "128x64"])
@pytest.mark.parametrize("window", [None, 1, 80, 128, 256],
                         ids=["nowindow", "w1", "w80", "w128", "w256"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_kv_tile_range_is_the_should_run_scan(causal, window, bq, bkv):
    """Every KV tile _block_should_run accepts for query tile i, and no
    other, lies in _kv_tile_range, over ragged lengths and offsets."""
    for Tq in _RANGE_LENGTHS:
        for Tkv in _RANGE_LENGTHS:
            n_kv = -(-Tkv // bkv)
            for q_offset, kv_offset in _RANGE_OFFSETS:
                for i in range(-(-Tq // bq)):
                    lo, hi = tattn._kv_tile_range(i, Tq, Tkv, bq, bkv, causal,
                                                  window, q_offset, kv_offset)
                    want = [j for j in range(n_kv) if tattn._block_should_run(
                        i, j, q_offset, kv_offset, causal=causal, block_q=bq,
                        block_kv=bkv, window=window)]
                    assert list(range(lo, hi)) == want, (Tq, Tkv, q_offset,
                                                         kv_offset, i)


def test_kv_tile_range_refuses_a_tile_past_the_queries():
    with pytest.raises(ValueError, match="query tile"):
        tattn._kv_tile_range(2, 256, 256, 128, 128, True, None, 0, 0)


# ------------------------------------------- K3's and K5's loops and tiles
# K3 and K5's dKV launch visit, for each KV tile of 128 keys, the 64-row
# query tiles in _q_tile_range and write K5's dS stage on all of them; K5's
# dQ launch walks 128-row query blocks over the 128-key tiles of
# _kv_tile_range and runs each 64-row half only where the dKV launch's
# predicate held for it.
DKV_BQ, DKV_BKV, DQS_BQ = 64, 128, 128


@pytest.mark.parametrize("bq,bkv", [(DKV_BQ, DKV_BKV), (64, 64), (128, 64)],
                         ids=["64x128", "64x64", "128x64"])
@pytest.mark.parametrize("window", [None, 1, 80, 128, 256],
                         ids=["nowindow", "w1", "w80", "w128", "w256"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_q_tile_range_is_the_should_run_scan(causal, window, bq, bkv):
    """Every query tile _block_should_run accepts for KV tile j, and no
    other, lies in _q_tile_range, over ragged lengths and offsets."""
    for Tq in _RANGE_LENGTHS:
        for Tkv in _RANGE_LENGTHS:
            n_q = -(-Tq // bq)
            for q_offset, kv_offset in _RANGE_OFFSETS:
                for j in range(-(-Tkv // bkv)):
                    lo, hi = tattn._q_tile_range(j, Tq, Tkv, bq, bkv, causal,
                                                 window, q_offset, kv_offset)
                    want = [i for i in range(n_q) if tattn._block_should_run(
                        i, j, q_offset, kv_offset, causal=causal, block_q=bq,
                        block_kv=bkv, window=window)]
                    assert list(range(lo, hi)) == want, (Tq, Tkv, q_offset,
                                                         kv_offset, j)


def test_q_tile_range_refuses_a_tile_past_the_keys():
    with pytest.raises(ValueError, match="KV tile"):
        tattn._q_tile_range(2, 256, 256, 64, 128, True, None, 0, 0)


def _staged_tiles(Tq, Tkv, causal, window, q_offset, kv_offset):
    """``(written, read)``: [Tq, Tkv] masks of the dS pairs K5's dKV launch
    writes and its dQ launch multiplies, by the kernels' loops."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    written = np.zeros((Tq, Tkv), bool)
    for j in range(-(-Tkv // DKV_BKV)):
        keys = slice(j * DKV_BKV, (j + 1) * DKV_BKV)
        lo, hi = tattn._q_tile_range(j, Tq, Tkv, DKV_BQ, DKV_BKV, **kw)
        written[lo * DKV_BQ:hi * DKV_BQ, keys] = True
    read = np.zeros((Tq, Tkv), bool)
    for blk in range(-(-Tq // DQS_BQ)):
        lo, hi = tattn._kv_tile_range(blk, Tq, Tkv, DQS_BQ, DKV_BKV, **kw)
        for j in range(lo, hi):
            for i in (2 * blk, 2 * blk + 1):
                if i * DKV_BQ < Tq and tattn._block_should_run(
                        i, j, q_offset, kv_offset, causal=causal,
                        block_q=DKV_BQ, block_kv=DKV_BKV, window=window):
                    read[i * DKV_BQ:(i + 1) * DKV_BQ,
                         j * DKV_BKV:(j + 1) * DKV_BKV] = True
    return written, read


@pytest.mark.parametrize("window", [None, 1, 80, 128, 256],
                         ids=["nowindow", "w1", "w80", "w128", "w256"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_staged_dq_reads_only_what_the_dkv_launch_writes(causal, window):
    """Every dS pair K5's dQ launch reads lies in a tile its dKV launch
    wrote (the stage is never read where it was left unwritten), and both
    cover every pair the mask lets through."""
    for Tq in _RANGE_LENGTHS:
        for Tkv in _RANGE_LENGTHS:
            for q_offset, kv_offset in _RANGE_OFFSETS:
                where = (Tq, Tkv, q_offset, kv_offset)
                written, read = _staged_tiles(Tq, Tkv, causal, window,
                                              q_offset, kv_offset)
                assert not (read & ~written).any(), where
                valid = tattn._valid(Tq, Tkv, causal, window, q_offset,
                                     kv_offset, "cpu")
                valid = (np.ones((Tq, Tkv), bool) if valid is None
                         else valid.numpy())
                assert not (valid & ~read).any(), where


# chip_smoke.py's K2 tolerances: two bf16 ulps relative plus 1e-2 of the
# output's largest magnitude, and the f32 LSE to 1e-4.
K2_RTOL, K2_ATOL_OF_SCALE, K2_LSE_ATOL = 2.0 ** -6, 1e-2, 1e-4
K2_TILE = 128


def _k2_emulate(q, k, v, *, scale, causal, window, q_offset, kv_offset):
    """K2's arithmetic in torch on BTHD bf16 inputs: 128 x 128 tiles over
    _kv_tile_range, raw f32 scores (Q K^T), NEG_INF on masked pairs of
    tiles that are not fully valid and -inf past Tkv, the running max/sum
    rescale in base 2 with the scale folded into log2(e) (p = exp2(s*c -
    m*c), each product rounded to f32 first), P rounded to bf16 per tile
    before P V with f32 sums, O rescaled by alpha before the tile's P V is
    added, out = acc / max(l, 1e-30) in bf16 and lse = m*scale +
    log(max(l, 1e-30)).  Returns ``(out, lse [B, H, Tq])``."""
    B, Tq, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    grp = H // Hkv
    qf = q.float().transpose(1, 2)                     # [B, H, Tq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(grp, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(grp, 1)
    out = torch.zeros(B, H, Tq, D)
    lse = torch.zeros(B, H, Tq)
    bt = K2_TILE
    scale = torch.tensor(scale, dtype=torch.float32)
    c = scale * torch.tensor(1.4426950408889634, dtype=torch.float32)
    for i in range(-(-Tq // bt)):
        rows = slice(i * bt, min(Tq, (i + 1) * bt))
        qt = qf[:, :, rows]
        m = torch.full((B, H, qt.shape[2], 1), tattn.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, qt.shape[2], D)
        lo, hi = tattn._kv_tile_range(i, Tq, Tkv, bt, bt, causal, window,
                                      q_offset, kv_offset)
        qpos = q_offset + i * bt + torch.arange(qt.shape[2])[:, None]
        for j in range(lo, hi):
            kv0 = j * bt
            cols = torch.arange(bt)[None, :]
            kt = torch.zeros(B, H, bt, D)
            vt = torch.zeros(B, H, bt, D)
            n = min(bt, Tkv - kv0)
            kt[:, :, :n] = kf[:, :, kv0:kv0 + n]       # TMA's zero rows
            vt[:, :, :n] = vf[:, :, kv0:kv0 + n]
            s = qt @ kt.transpose(-1, -2)
            full = tattn._block_fully_valid(
                i, j, q_offset, kv_offset, causal=causal, block_q=bt,
                block_kv=bt, window=window)
            if not full or kv0 + bt > Tkv:
                d = qpos - (kv_offset + kv0 + cols)
                ok = torch.ones_like(d, dtype=torch.bool)
                if causal:
                    ok &= d >= 0
                if window is not None:
                    ok &= d < window
                s = torch.where(ok, s, torch.full_like(s, tattn.NEG_INF))
                s = torch.where(cols < Tkv - kv0, s,
                                torch.full_like(s, -float("inf")))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            mc = m_new * c
            alpha = torch.exp2(m * c - mc)
            p = torch.exp2(s * c - mc)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + p.bfloat16().float() @ vt
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        out[:, :, rows] = acc / lc
        lse[:, :, rows] = (m * scale + torch.log(lc)).squeeze(-1)
    return out.transpose(1, 2).bfloat16(), lse


def _k2_close(got, want, rows, what):
    got, want = got[:, rows].float(), want[:, rows].float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = err > K2_ATOL_OF_SCALE * scale + K2_RTOL * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {bad.numel()} over tolerance, max abs "
        f"err {float(err.max()):.4g}, scale {scale:.4g}")


# (B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset, jax blocks):
# head dims 32/64/128, GQA, windows narrower and wider than a tile, offsets
# that move the diagonal inside a tile, ragged lengths (no JAX run there:
# its blocks must divide the lengths).
K2_CASES = [
    (2, 256, 256, 4, 4, 32, True, None, 0, 0, 128),
    (1, 128, 256, 2, 2, 64, False, None, 0, 0, 128),
    (1, 256, 256, 2, 2, 128, True, None, 0, 0, 128),
    (1, 256, 256, 4, 2, 32, True, 80, 0, 0, 128),
    (1, 256, 256, 2, 2, 64, True, 16, 0, 0, 64),
    (1, 128, 384, 4, 2, 64, True, None, 384, 256, 128),
    (1, 256, 384, 2, 1, 32, True, None, 64, 0, 128),
    (2, 200, 328, 4, 2, 64, False, None, 0, 0, None),
    (1, 200, 328, 4, 4, 32, True, 150, 128, 0, None),
]


@pytest.mark.parametrize("case", K2_CASES,
                         ids=lambda c: "-".join(map(str, c[:10])))
def test_k2_arithmetic_matches_plain_and_jax_interpret(case):
    """The emulation of K2's tiles and rounding agrees with the plain K2
    (_flash_forward_reference) and with the JAX package's
    flash_attention_chunk in interpret mode, all in bf16, under
    chip_smoke.py's K2 tolerances."""
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, jblock = case
    rng = np.random.RandomState(21)
    q, k, v = (rng.randn(*shape).astype(np.float32) for shape in
               ((B, Tq, H, D), (B, Tkv, Hkv, D), (B, Tkv, Hkv, D)))
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    kw = dict(scale=D ** -0.5, causal=causal, window=window, q_offset=qo,
              kv_offset=ko)
    out, lse = _k2_emulate(tq, tk, tv, **kw)
    valid = tattn._valid(Tq, Tkv, causal, window, qo, ko, "cpu")
    rows = (torch.ones(Tq, dtype=torch.bool) if valid is None
            else valid.any(-1))
    want_out, want_lse = tattn._flash_forward_reference(tq, tk, tv, **kw)
    _k2_close(out, want_out, rows, "K2 emulation vs plain K2")
    torch.testing.assert_close(lse[:, :, rows], want_lse[:, :, rows], rtol=0,
                               atol=K2_LSE_ATOL)
    if jblock is None:
        return
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    jout, jlse = jax.jit(lambda q, k, v: jattn.flash_attention_chunk(
        q, k, v, qo, ko, causal, D ** -0.5, jblock, jblock, True,
        window))(jq, jk, jv)
    jout = torch.tensor(np.asarray(jout.astype(jnp.float32)))
    jlse = torch.tensor(np.asarray(jlse)).transpose(1, 2)
    _k2_close(out, jout, rows, "K2 emulation vs JAX interpret")
    torch.testing.assert_close(lse[:, :, rows], jlse[:, :, rows], rtol=0,
                               atol=K2_LSE_ATOL)


# ------------------------------------------------ K3's and K5's arithmetic
LOG2E = 1.4426950408889634


def _k3_emulate(q, k, v, do, lse, delta, *, scale, causal, window, q_offset,
                kv_offset):
    """K3's arithmetic (and K5's dKV launch's) in torch on BTHD bf16 inputs:
    blocks of 128 keys, each 64-key half over the 64-row query tiles of
    _q_tile_range; raw f32 scores S^T = K Q^T and dP^T = V dO^T; x =
    S^T * c with c = scale * log2(e) and l2 = LSE * log2(e), each product
    rounded to f32; NEG_INF * log2(e) on masked pairs of 64 x 64 parts that
    are not fully valid, -inf on keys past Tkv, l2 = +inf on queries past
    Tq; P = exp2(x - l2), dS = P (dP - delta); P and dS rounded to bf16 per
    tile before dV += P^T dO and dK += dS^T Q in f32; dK * scale and dV in
    bf16.  Returns per-query-head ``(dk, dv)`` ``[B, Tkv, H, D]`` and the dS
    stage ``[B, H, Tq, Tkv]`` in bf16, NaN where no tile wrote it."""
    B, Tq, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    grp = H // Hkv
    qf, dof = (t.float().transpose(1, 2) for t in (q, do))  # [B, H, Tq, D]
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(grp, 1)
              for t in (k, v))
    f32 = torch.float32
    c = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    neg2 = torch.tensor(tattn.NEG_INF, dtype=f32) * torch.tensor(LOG2E,
                                                                dtype=f32)
    l2_all = lse.float() * torch.tensor(LOG2E, dtype=f32)
    dk = torch.zeros(B, H, Tkv, D)
    dv = torch.zeros(B, H, Tkv, D)
    stage = torch.full((B, H, Tq, Tkv), float("nan"))
    kw = dict(causal=causal, window=window)
    for j in range(-(-Tkv // DKV_BKV)):
        lo, hi = tattn._q_tile_range(j, Tq, Tkv, DKV_BQ, DKV_BKV, causal,
                                     window, q_offset, kv_offset)
        for g in (0, 1):
            k0 = j * DKV_BKV + 64 * g
            n = min(64, Tkv - k0)
            if n <= 0:
                continue  # every key past Tkv: nothing is stored
            kt, vt = torch.zeros(B, H, 64, D), torch.zeros(B, H, 64, D)
            kt[:, :, :n] = kf[:, :, k0:k0 + n]              # TMA's zero rows
            vt[:, :, :n] = vf[:, :, k0:k0 + n]
            acc_dk, acc_dv = torch.zeros(B, H, 64, D), torch.zeros(B, H, 64, D)
            for i in range(lo, hi):
                q0 = i * DKV_BQ
                m = min(DKV_BQ, Tq - q0)
                qt, dot = torch.zeros(B, H, 64, D), torch.zeros(B, H, 64, D)
                qt[:, :, :m] = qf[:, :, q0:q0 + m]
                dot[:, :, :m] = dof[:, :, q0:q0 + m]
                l2 = torch.full((B, H, 64), float("inf"))
                dl = torch.zeros(B, H, 64)
                l2[:, :, :m] = l2_all[:, :, q0:q0 + m]
                dl[:, :, :m] = delta[:, :, q0:q0 + m]
                x = (kt @ qt.transpose(-1, -2)) * c        # [.., key, query]
                dpt = vt @ dot.transpose(-1, -2)
                full = tattn._block_fully_valid(
                    i, 2 * j + g, q_offset, kv_offset, block_q=64,
                    block_kv=64, **kw)
                if not full or n < 64:
                    keys = torch.arange(64)[:, None]
                    d = (q_offset + q0 + torch.arange(64)[None, :]
                         - (kv_offset + k0 + keys))
                    ok = torch.ones_like(d, dtype=torch.bool)
                    if causal:
                        ok &= d >= 0
                    if window is not None:
                        ok &= d < window
                    x = torch.where(ok, x, neg2)
                    x = torch.where(keys < n, x, -float("inf"))
                p = torch.exp2(x - l2[:, :, None, :])
                ds = p * (dpt - dl[:, :, None, :])
                pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
                acc_dv += pb @ dot
                acc_dk += dsb @ qt
                stage[:, :, q0:q0 + m, k0:k0 + n] = dsb.transpose(-1, -2)[
                    :, :, :m, :n]
            dk[:, :, k0:k0 + n] = (acc_dk * torch.tensor(scale, dtype=f32))[
                :, :, :n]
            dv[:, :, k0:k0 + n] = acc_dv[:, :, :n]
    return (dk.transpose(1, 2).bfloat16(), dv.transpose(1, 2).bfloat16(),
            stage.bfloat16())


def _k5_dq_emulate(stage, k, *, scale, causal, window, q_offset, kv_offset):
    """K5's dQ launch in torch: 128-row query blocks over the 128-key tiles
    of _kv_tile_range, each 64-row half multiplying only the tiles where
    the dKV launch's predicate held; dQ = (dS K in f32) * scale in bf16."""
    B, H, Tq, Tkv = stage.shape
    grp = H // k.shape[2]
    kf = k.float().transpose(1, 2).repeat_interleave(grp, 1)
    dq = torch.zeros(B, H, Tq, k.shape[3])
    for blk in range(-(-Tq // DQS_BQ)):
        lo, hi = tattn._kv_tile_range(blk, Tq, Tkv, DQS_BQ, DKV_BKV, causal,
                                      window, q_offset, kv_offset)
        for i in (2 * blk, 2 * blk + 1):
            rows = slice(i * DKV_BQ, min(Tq, (i + 1) * DKV_BQ))
            acc = torch.zeros(B, H, rows.stop - rows.start, k.shape[3])
            for j in range(lo, hi):
                if i * DKV_BQ >= Tq or not tattn._block_should_run(
                        i, j, q_offset, kv_offset, causal=causal,
                        block_q=DKV_BQ, block_kv=DKV_BKV, window=window):
                    continue
                keys = slice(j * DKV_BKV, min(Tkv, (j + 1) * DKV_BKV))
                acc += stage[:, :, rows, keys].float() @ kf[:, :, keys]
            dq[:, :, rows] = acc * torch.tensor(scale, dtype=torch.float32)
    return dq.transpose(1, 2).bfloat16()


# (B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset, jax blocks):
# head dims 32/64/128, GQA, a window that ends inside a 128-key tile,
# offsets, ragged lengths (no JAX run there).
K3_CASES = [
    (2, 256, 256, 4, 4, 32, True, None, 0, 0, 128),
    (1, 256, 256, 2, 2, 128, True, None, 0, 0, 128),
    (1, 256, 256, 4, 2, 32, True, 80, 0, 0, 128),
    (1, 128, 384, 4, 2, 64, True, None, 384, 256, 128),
    (2, 200, 328, 4, 2, 64, False, None, 0, 0, None),
    (1, 200, 100, 2, 2, 32, True, 250, 128, 0, None),
]


def _bwd_inputs(case, seed):
    """numpy-seeded inputs of a backward case: the f32 arrays ``(q, k, v,
    do)``, the plain K2's bf16 ``args`` (q, k, v, dO, lse, delta) and the
    keyword arguments."""
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, _ = case
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, Tq, H, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, Tkv, Hkv, D).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.tensor(x).bfloat16() for x in (q, k, v, do))
    kw = dict(scale=D ** -0.5, causal=causal, window=window, q_offset=qo,
              kv_offset=ko)
    out, lse = tattn._flash_forward_reference(tq, tk, tv, **kw)
    delta = (tdo.float() * out.float()).sum(-1).transpose(1, 2)
    return (q, k, v, do), (tq, tk, tv, tdo, lse, delta), kw


def _jax_chunk_grads(case, q, k, v, do):
    """``(dq, dk, dv)`` of the JAX package's flash_attention_chunk backward
    in interpret mode (the LSE cotangent 0) on bf16 inputs, as f32 torch
    tensors."""
    _, _, _, _, _, D, causal, window, qo, ko, jblock = case
    jq, jk, jv, jdo = (jnp.asarray(x, dtype=jnp.bfloat16)
                       for x in (q, k, v, do))

    @jax.jit
    def jgrads(q, k, v, do):
        fn = lambda q, k, v: jattn.flash_attention_chunk(  # noqa: E731
            q, k, v, qo, ko, causal, D ** -0.5, jblock, jblock, True,
            window)
        (_, jlse), vjp = jax.vjp(fn, q, k, v)
        return vjp((do, jnp.zeros_like(jlse)))

    return tuple(torch.tensor(np.asarray(w.astype(jnp.float32)))
                 for w in jgrads(jq, jk, jv, jdo))


@pytest.mark.parametrize("case", K3_CASES,
                         ids=lambda c: "-".join(map(str, c[:10])))
def test_k3_k5_arithmetic_matches_plain_and_jax_interpret(case):
    """The emulations of K3's and K5's tiles and rounding agree with the
    plain K3 and K5 (``_flash_dkv_reference``, the plain stage on every
    valid pair, ``_flash_dq_staged_reference``), K5's dQ reads no pair the
    dKV launch left unwritten (the stage starts as NaN), and the gradients
    agree with the JAX package's flash_attention_chunk backward in
    interpret mode, all in bf16, under chip_smoke.py's tolerances."""
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, jblock = case
    arrays, args, kw = _bwd_inputs(case, 22)
    tk = args[1]
    valid = tattn._valid(Tq, Tkv, causal, window, qo, ko, "cpu")
    assert valid is None or bool(valid.any(-1).all())  # every row has a key
    all_rows = torch.ones(Tq, dtype=torch.bool)
    dk, dv, stage = _k3_emulate(*args, **kw)
    want_dk, want_dv, want_ds = tattn._flash_dkv_staged_reference(*args, **kw)
    _k2_close(dk, want_dk, slice(None), "K3 emulation dk vs plain K3")
    _k2_close(dv, want_dv, slice(None), "K3 emulation dv vs plain K3")
    sel = (torch.ones(Tq, Tkv, dtype=torch.bool) if valid is None else valid)
    _k2_close(stage[:, :, sel], want_ds.view(B, H, Tq, Tkv)[:, :, sel],
              slice(None), "K5 emulation stage vs plain K5")
    dq = _k5_dq_emulate(stage, tk, **kw)
    assert not bool(torch.isnan(dq).any()), "read an unwritten stage pair"
    want_dq = tattn._flash_dq_staged_reference(
        want_ds, tk, **kw)
    _k2_close(dq, want_dq, all_rows, "K5 dq emulation vs plain K5")
    if jblock is None:
        return
    grp = H // Hkv
    dk_kv, dv_kv = (t.float().view(B, Tkv, Hkv, grp, D).sum(3)
                    for t in (dk, dv))
    got = (dq, dk_kv, dv_kv)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          _jax_chunk_grads(case, *arrays)):
        _k2_close(g, w, slice(None), f"K3/K5 emulation {name} vs JAX")


# ---------------------------------------------------------- K4's arithmetic
# K4 walks 128-row query blocks, 64 rows a consumer, over the KV tiles of
# _kv_tile_range: 128 keys, or 64 at D 128.
K4_BQ = 128


def _k4_bkv(D):
    return 64 if D == 128 else 128


def _k4_emulate(q, k, v, do, lse, delta, *, scale, causal, window, q_offset,
                kv_offset):
    """K4's arithmetic in torch on BTHD bf16 inputs: 128-row query blocks
    over the KV tiles of _kv_tile_range in ascending keys, each 64-row half
    skipping the tiles _block_should_run rejects for it; raw f32 scores
    S = Q K^T and dP = dO V^T; K3's rounding points with queries as rows:
    x = S * c with c = scale * log2(e) and l2 = LSE * log2(e), each product
    rounded to f32; NEG_INF * log2(e) on masked pairs of tiles that are not
    fully valid, -inf on keys past Tkv, l2 = +inf and delta = 0 on rows
    past Tq; P = exp2(x - l2), dS = P (dP - delta) rounded to bf16 per
    tile; dQ += dS K in f32, times scale and in bf16 at the end.  Returns
    ``dq [B, Tq, H, D]``."""
    B, Tq, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    grp = H // Hkv
    bkv = _k4_bkv(D)
    qf, dof = (t.float().transpose(1, 2) for t in (q, do))  # [B, H, Tq, D]
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(grp, 1)
              for t in (k, v))
    f32 = torch.float32
    c = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    neg2 = torch.tensor(tattn.NEG_INF, dtype=f32) * torch.tensor(LOG2E,
                                                                dtype=f32)
    l2_all = lse.float() * torch.tensor(LOG2E, dtype=f32)
    dq = torch.zeros(B, H, Tq, D)
    kw = dict(causal=causal, window=window)
    for blk in range(-(-Tq // K4_BQ)):
        lo, hi = tattn._kv_tile_range(blk, Tq, Tkv, K4_BQ, bkv, causal,
                                      window, q_offset, kv_offset)
        for i in (2 * blk, 2 * blk + 1):
            q0 = 64 * i
            m = min(64, Tq - q0)
            if m <= 0:
                continue  # every row past Tq: nothing is stored
            qt, dot = torch.zeros(B, H, 64, D), torch.zeros(B, H, 64, D)
            qt[:, :, :m] = qf[:, :, q0:q0 + m]              # TMA's zero rows
            dot[:, :, :m] = dof[:, :, q0:q0 + m]
            l2 = torch.full((B, H, 64), float("inf"))
            dl = torch.zeros(B, H, 64)
            l2[:, :, :m] = l2_all[:, :, q0:q0 + m]
            dl[:, :, :m] = delta[:, :, q0:q0 + m]
            acc = torch.zeros(B, H, 64, D)
            for j in range(lo, hi):
                if not tattn._block_should_run(
                        i, j, q_offset, kv_offset, block_q=64, block_kv=bkv,
                        **kw):
                    continue
                k0 = j * bkv
                n = min(bkv, Tkv - k0)
                kt, vt = torch.zeros(B, H, bkv, D), torch.zeros(B, H, bkv, D)
                kt[:, :, :n] = kf[:, :, k0:k0 + n]
                vt[:, :, :n] = vf[:, :, k0:k0 + n]
                x = (qt @ kt.transpose(-1, -2)) * c        # [.., query, key]
                dpt = dot @ vt.transpose(-1, -2)
                full = tattn._block_fully_valid(
                    i, j, q_offset, kv_offset, block_q=64, block_kv=bkv,
                    **kw)
                if not full or n < bkv:
                    keys = torch.arange(bkv)[None, :]
                    d = (q_offset + q0 + torch.arange(64)[:, None]
                         - (kv_offset + k0 + keys))
                    ok = torch.ones_like(d, dtype=torch.bool)
                    if causal:
                        ok &= d >= 0
                    if window is not None:
                        ok &= d < window
                    x = torch.where(ok, x, neg2)
                    x = torch.where(keys < n, x, -float("inf"))
                p = torch.exp2(x - l2[..., None])
                ds = p * (dpt - dl[..., None])
                acc += ds.bfloat16().float() @ kt
            dq[:, :, q0:q0 + m] = (acc * torch.tensor(scale, dtype=f32))[
                :, :, :m]
    return dq.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("case", K3_CASES,
                         ids=lambda c: "-".join(map(str, c[:10])))
def test_k4_arithmetic_matches_plain_k5_and_jax_interpret(case):
    """The emulation of K4's tiles and rounding agrees with the plain K4
    (``_flash_dq_reference``), with the emulation of K5's dQ launch on the
    emulated K3's dS stage (the pair and staged backwards give the same
    dQ) and with the JAX package's flash_attention_chunk dq in interpret
    mode, all in bf16, under chip_smoke.py's tolerances."""
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, jblock = case
    arrays, args, kw = _bwd_inputs(case, 23)
    all_rows = torch.ones(Tq, dtype=torch.bool)
    dq = _k4_emulate(*args, **kw)
    _k2_close(dq, tattn._flash_dq_reference(*args, **kw), all_rows,
              "K4 emulation vs plain K4")
    stage = _k3_emulate(*args, **kw)[2]
    _k2_close(dq, _k5_dq_emulate(stage, args[1], **kw), all_rows,
              "K4 emulation vs K5's dq emulation")
    if jblock is None:
        return
    _k2_close(dq, _jax_chunk_grads(case, *arrays)[0], slice(None),
              "K4 emulation dq vs JAX")
