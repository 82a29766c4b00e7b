"""The decode path's row-invariant arithmetic (``ops/rowwise.py``) and the
one sampler (``harness/generate.py::sample_rows``), on the CPU.

``row_matmul``'s plain version (kernel R1's arithmetic: an f32 sum from
0 of the rounded products, ``k`` ascending) must give each output row
the same bits whatever the rows, lanes or groups beside it, and equal an
explicit numpy loop of that arithmetic exactly.  The transformer's decode
forward must then write the same K/V bits and give the same logits bits
whether a 40-token prompt goes in whole or in chunks of 1, 3 and 8, at
d_model 32 and at 256 (PyTorch's own CPU matmul differs between such
chunkings at 256 and at some chunk sizes at 32), and an ``[S, 1]`` step
over per-lane indices must equal S separate batch-1 steps bit for bit.
The sampler must give a row the same token alone and in a batch, in
every mode.  The card's form and tiling (``rowwise._plan``) must be a
function of the dtypes, N and K alone: one plan for every row count and
every stride pattern of the decode path's call sites.  Every comparison
here is exact.
"""

import inspect

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu_torch.harness import generate as gen
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    KVCache,
    TransformerLM,
)
from distributed_tensorflow_models_tpu_torch.ops import _kernels, rowwise


def _np_rows(a, b):
    """R1's arithmetic in numpy f32, one output at a time."""
    M, K = a.shape
    out = np.zeros((M, b.shape[1]), np.float32)
    for k in range(K):
        out = (out + (a[:, k:k + 1] * b[k:k + 1, :]).astype(np.float32)
               ).astype(np.float32)
    return out


@pytest.mark.parametrize("M", [1, 3, 8, 40])
def test_row_matmul_rows_do_not_depend_on_the_row_count(M):
    rs = np.random.RandomState(M)
    a = rs.standard_normal((40, 96)).astype(np.float32)
    b = rs.standard_normal((96, 70)).astype(np.float32)
    whole = rowwise.row_matmul(torch.from_numpy(a), torch.from_numpy(b))
    parts = torch.cat([
        rowwise.row_matmul(torch.from_numpy(a[i:i + M]), torch.from_numpy(b))
        for i in range(0, 40, M)])
    assert torch.equal(whole, parts)
    np.testing.assert_array_equal(whole.numpy(), _np_rows(a, b))


@pytest.mark.parametrize("groups", [1, 8])
def test_row_matmul_groups_and_strided_operands(groups):
    """Per-group products over strided views (a cache read as K^T and V in
    place) equal each group's product alone, and numpy's loop."""
    rs = np.random.RandomState(groups)
    q = torch.from_numpy(rs.standard_normal((2, groups, 5, 16)).astype(
        np.float32))
    cache = torch.from_numpy(rs.standard_normal((2, 24, groups, 16)).astype(
        np.float32))
    kT = cache.permute(0, 2, 3, 1)  # [2, G, 16, 24], a view
    got = rowwise.row_matmul(q, kT)
    assert got.shape == (2, groups, 5, 24) and got.is_contiguous()
    for b in range(2):
        for g in range(groups):
            one = rowwise.row_matmul(q[b:b + 1, g:g + 1, 2:3],
                                     kT[b:b + 1, g:g + 1])
            assert torch.equal(one[0, 0, 0], got[b, g, 2])
            np.testing.assert_array_equal(
                got[b, g].numpy(),
                _np_rows(q[b, g].numpy(), kT[b, g].contiguous().numpy()))


def test_row_matmul_dtypes_and_errors():
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.standard_normal((6, 32)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((32, 9)).astype(np.float32))
    ab, bb = a.bfloat16(), b.bfloat16()
    f32 = rowwise.row_matmul(ab, bb, torch.float32)
    np.testing.assert_array_equal(
        f32.numpy(), _np_rows(ab.float().numpy(), bb.float().numpy()))
    assert torch.equal(rowwise.row_matmul(ab, bb), f32.bfloat16())
    s = rowwise.row_sum(a)
    assert s.shape == (6, 1)
    np.testing.assert_array_equal(s.numpy(), _np_rows(
        a.numpy(), np.ones((32, 1), np.float32)))
    with pytest.raises(TypeError, match="bf16 or f32"):
        rowwise.row_matmul(a, bb)
    with pytest.raises(TypeError, match="bf16 or f32"):
        rowwise.row_matmul(a.double(), b.double())
    with pytest.raises(ValueError, match="inner dims"):
        rowwise.row_matmul(a, b[:5])
    with pytest.raises(ValueError, match="G1, G2"):
        rowwise.row_matmul(a[None], b[None])


def _call_sites(M, dtype):
    """The decode path's operand layouts at ``M`` rows: a Dense product
    (``rowwise.dense``: a contiguous weight, broadcast over the groups),
    attention's scores (a cache read as K^T in place) and P V (the cache
    read as V), and groups of rows on one weight broadcast by zero
    strides."""
    z = torch.zeros
    cache = z(2, 40, 4, 32, dtype=dtype)
    return {
        "dense": (z(M, 256, dtype=dtype), z(256, 1024, dtype=dtype)),
        "scores": (z(2, 4, M, 32, dtype=dtype), cache.permute(0, 2, 3, 1)),
        "pv": (z(2, 4, M, 40, dtype=dtype), cache.permute(0, 2, 1, 3)),
        "grouped": (z(2, 3, M, 256, dtype=dtype),
                    z(256, 1024, dtype=dtype).expand(2, 3, 256, 1024)),
    }


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_plan_depends_on_dtypes_n_and_k_alone(out_dtype):
    """``_plan`` takes no row count and no strides; over every row count
    and every call site's layout it gives one plan per (dtype, N, K)."""
    assert list(inspect.signature(rowwise._plan).parameters) == [
        "dtype", "out_dtype", "N", "K"]
    plans = {}
    for dtype in (torch.bfloat16, torch.float32):
        for M in (1, 2, 7, 8, 9, 17, 63, 64, 65, 256, 4096):
            for a, b in _call_sites(M, dtype).values():
                a4, b4, _ = rowwise._operands(a, b)
                key = (dtype, b4.shape[3], a4.shape[3])
                plans.setdefault(key, set()).add(
                    rowwise._plan(dtype, out_dtype, *key[1:]))
    assert len(plans) == 6  # (N, K): (1024, 256), (40, 32), (32, 40)
    assert all(len(p) == 1 for p in plans.values()), plans


def test_plan_maps_bf16_products_to_the_tensor_core_form():
    """bf16 operands with N > 1 take the tensor-core form (its entry per
    result dtype, a ring of ceil(K / 64) stages, at least 1 and at most
    8); f32 operands,
    and N = 1 in either dtype, the SIMT form.  Both forms' launch
    counters are registered beside ``row_matmul.launches``."""
    bf16, f32 = torch.bfloat16, torch.float32
    for odt in (bf16, f32):
        for N in (2, 16, 32, 300, 10000):
            for K, stages in ((0, 1), (1, 1), (16, 1), (40, 1), (64, 1),
                              (65, 2), (200, 4), (512, 8), (1024, 8)):
                plan = rowwise._plan(bf16, odt, N, K)
                assert plan == ("wgmma", rowwise._TC_ENTRIES[odt],
                                (stages,)), (N, K)
                assert rowwise._plan(f32, odt, N, K) == (
                    "simt", rowwise._ENTRIES[(f32, odt)], ())
        for dtype in (bf16, f32):
            assert rowwise._plan(dtype, odt, 1, 256) == (
                "simt", rowwise._ENTRIES[(dtype, odt)], ())
    counters = {attr for fn, attr in _kernels.launch_counts()
                if fn is rowwise.row_matmul}
    assert counters == {"launches", "wgmma_launches", "simt_launches"}


FORMS = {
    "d32": dict(vocab_size=50, num_layers=2, num_heads=2, d_model=32,
                d_ff=64),
    "d256": dict(vocab_size=128, num_layers=2, num_heads=8, d_model=256,
                 d_ff=1024),
    "d32-rope-gqa-window": dict(vocab_size=50, num_layers=2, num_heads=4,
                                d_model=32, d_ff=64, pos_encoding="rope",
                                num_kv_heads=2, attn_window=6),
}


@pytest.fixture(scope="module", params=sorted(FORMS))
def lm(request):
    g = torch.Generator().manual_seed(0)
    return TransformerLM(**FORMS[request.param], max_len=64,
                         dropout_rate=0.0, dtype=torch.float32,
                         attn_impl="reference", generator=g)


def _prefill(model, tokens, chunk):
    cache = model.init_cache(1)
    with torch.no_grad():
        logits = torch.cat([model(tokens[:, lo:lo + chunk], cache=cache)[0]
                            for lo in range(0, tokens.shape[1], chunk)], 1)
    return logits, cache


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_decode_forward_is_chunking_invariant(lm, chunk):
    """A 40-token prompt whole or in chunks: the same logits and K/V
    bits."""
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 50, (1, 40)))
    whole, cw = _prefill(lm, tokens, 40)
    got, cc = _prefill(lm, tokens, chunk)
    assert torch.equal(got, whole)
    for a, b in zip(cc.keys + cc.values, cw.keys + cw.values):
        assert torch.equal(a, b)
    assert int(cc.index) == 40


def test_lane_step_equals_separate_batch_one_steps(lm):
    """Lanes at lengths 3, 17, 0 and 9 in one ``[S, 1]`` step over a
    per-lane index, and a 3-wide window the same way: each lane's logits
    and cache rows equal a batch-1 run of that lane alone."""
    rs = np.random.RandomState(2)
    lengths = [3, 17, 0, 9]
    prompts = [torch.from_numpy(rs.randint(0, 50, (1, n))) for n in lengths]
    nxt = torch.from_numpy(rs.randint(0, 50, (4, 3)))
    solo = []
    for p, n, t in zip(prompts, lengths, nxt):
        cache = lm.init_cache(1)
        with torch.no_grad():
            if n:
                lm(p, cache=cache)
            one = lm(t[None, :1], cache=cache)[0]
            win = lm(t[None, 1:], cache=cache)[0]
        solo.append((one, win, cache))
    S, L = 4, lm.max_len
    lanes = KVCache(
        [torch.cat([s[2].keys[i] for s in solo]) for i in range(2)],
        [torch.cat([s[2].values[i] for s in solo]) for i in range(2)],
        torch.tensor(lengths))
    # Roll the lanes back to their pre-step state: zero what the steps
    # wrote, then step all lanes together.
    for t in lanes.keys + lanes.values:
        for s, n in enumerate(lengths):
            t[s, n:] = 0
    with torch.no_grad():
        one = lm(nxt[:, :1], cache=lanes)[0]
        win = lm(nxt[:, 1:], cache=lanes)[0]
    assert lanes.index.tolist() == [n + 3 for n in lengths]
    for s in range(S):
        assert torch.equal(one[s:s + 1], solo[s][0])
        assert torch.equal(win[s:s + 1], solo[s][1])
        for i in range(2):
            assert torch.equal(lanes.keys[i][s:s + 1], solo[s][2].keys[i])
            assert torch.equal(lanes.values[i][s:s + 1],
                               solo[s][2].values[i])
    assert L == 64


def test_write_past_max_len_clamps_like_jax(lm):
    """A lane whose window would run past ``max_len`` writes it at
    ``max_len - T`` (JAX's ``dynamic_update_slice``), the others in
    place; nothing raises."""
    cache = lm.init_cache(2)
    cache.index = torch.tensor([lm.max_len - 1, 5])
    with torch.no_grad():
        lm(torch.ones(2, 3, dtype=torch.int64), cache=cache)
    assert cache.index.tolist() == [lm.max_len + 2, 8]
    assert cache.keys[0][0, lm.max_len - 3:].abs().sum() > 0
    assert cache.keys[0][1, 5:8].abs().sum() > 0
    assert not cache.keys[0][1, 8:].any()


MODES = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 5, 1.0), (1.0, 0, 0.9),
         (0.7, 8, 0.85), (1.0, 1, 1.0), (1.0, 500, 0.0)]


def test_sampler_row_alone_equals_row_in_a_batch():
    """Seven rows in seven modes through ``sample_rows`` at once and one at
    a time: the same tokens; and each equals the static filter
    (``_filter_logits`` of the tempered row) plus its noise."""
    rs = np.random.RandomState(4)
    logits = torch.from_numpy(rs.standard_normal((7, 101)).astype(
        np.float32) * 3)
    noise = gen.gumbel(torch.from_numpy(rs.uniform(size=(7, 101)).astype(
        np.float32)))
    t = torch.tensor([m[0] for m in MODES], dtype=torch.float32)
    k = torch.tensor([m[1] for m in MODES])
    p = torch.tensor([m[2] for m in MODES], dtype=torch.float32)
    batch = gen.sample_rows(logits, noise, t, k, p)
    for i, (ti, ki, pi) in enumerate(MODES):
        alone = gen.sample_rows(logits[i:i + 1], noise[i:i + 1], t[i:i + 1],
                                k[i:i + 1], p[i:i + 1])
        assert alone.tolist() == [int(batch[i])]
        if ti > 0:
            ref = torch.argmax(gen._filter_logits(
                logits[i:i + 1] / torch.tensor(ti), ki, pi)
                + noise[i:i + 1], dim=-1)
        else:
            ref = torch.argmax(logits[i:i + 1], dim=-1)
        assert int(batch[i]) == int(ref), MODES[i]
    assert gen.sample_rows(logits, None, t, k, p).tolist() == \
        torch.argmax(logits, dim=-1).tolist()
