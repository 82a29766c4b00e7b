"""The port's KV-cache decode and ``harness/generate.py`` against the JAX
package's, on bridged weights and numpy-seeded prompts.

The transformer is 2 layers, d_model 32, 4 heads, d_ff 64, vocabulary 50,
``max_len`` 32, f32, dropout 0, in two forms: learned positions, and
rotary positions with 2 KV heads for 4 and a 6-token window; the weights
are the JAX model's init, loaded by ``interop.load_flax_variables``.  Both
packages decode through the same reference attention over the cache.
Decode logits agree with JAX's to 1e-5 (f32 round-off; the JAX package's
own decode test holds its decode to its full forward at 1e-4, and the
port's to its own full forward is held at 1e-5 here too).  Greedy tokens,
``generate_rnn``'s tokens (the PTB LSTM at hidden 16) and
``_filter_logits``' masks must be identical.  Sampled streams are held
port-internally: torch's generators are not JAX's threefry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.harness import generate as jgen
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import generate as tgen
from distributed_tensorflow_models_tpu_torch.models import get_model
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    KVCache,
    TransformerLM,
)

jax.config.update("jax_platforms", "cpu")

SMALL = dict(vocab_size=50, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_len=32, dropout_rate=0.0)
FORMS = {"learned": {},
         "rope-gqa-window": dict(pos_encoding="rope", num_kv_heads=2,
                                 attn_window=6)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_model(**kw):
    return jget_model("transformer_lm", **{**SMALL, "dtype": jnp.float32,
                                           "attn_impl": "reference", **kw})


@pytest.fixture(scope="module", params=sorted(FORMS))
def lm(request):
    """``(jax model, numpy params, port model)`` of one form."""
    kw = FORMS[request.param]
    jm = _jax_model(**kw)
    params = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]))
    tm = TransformerLM(**SMALL, **kw, dtype=torch.float32,
                       attn_impl="reference")
    interop.load_flax_variables(tm, {"params": params})
    return jm, params, tm


@pytest.fixture(scope="module")
def learned():
    jm = _jax_model()
    params = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]))
    tm = TransformerLM(**SMALL, dtype=torch.float32, attn_impl="reference")
    interop.load_flax_variables(tm, {"params": params})
    return jm, params, tm


def _prompt(seed, shape=(2, 5), vocab=50):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _jax_decode(jm, params, tokens, cache=None):
    """JAX decode of ``tokens`` from ``cache`` (a fresh one when None):
    ``(logits, new cache)``."""
    variables = {"params": params}
    if cache is not None:
        variables["cache"] = cache
    (lg, _), mut = jm.clone(decode=True).apply(
        variables, jnp.asarray(tokens), train=False, mutable=["cache"])
    return np.asarray(lg), jax.tree.map(np.asarray, dict(mut["cache"]))


def test_decode_logits_match_full_forward(lm):
    """Token by token through the cache, and a prompt chunk then steps,
    the port's decode logits equal its full forward's."""
    _, _, tm = lm
    toks = torch.from_numpy(_prompt(0, (2, 10)).astype(np.int64))
    with torch.no_grad():
        full, _ = tm(toks)
        cache = tm.init_cache(2)
        steps = torch.cat([tm(toks[:, t:t + 1], cache=cache)[0]
                           for t in range(10)], dim=1)
        assert int(cache.index) == 10
        cache = tm.init_cache(2)
        chunk = torch.cat([tm(toks[:, :6], cache=cache)[0],
                           tm(toks[:, 6:7], cache=cache)[0],
                           tm(toks[:, 7:], cache=cache)[0]], dim=1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), **TOL)
    np.testing.assert_allclose(chunk.numpy(), full.numpy(), **TOL)


def test_decode_logits_match_jax(lm):
    """A 7-token prompt pass, then five one-token steps: every logit
    against the JAX decode model's at 1e-5, and the caches (keys after
    rotation, values, index) after each call."""
    jm, params, tm = lm
    toks = _prompt(1, (2, 12))
    cache = tm.init_cache(2)
    jcache = None
    with torch.no_grad():
        for lo, hi in [(0, 7)] + [(t, t + 1) for t in range(7, 12)]:
            want, jcache = _jax_decode(jm, params, toks[:, lo:hi], jcache)
            got, _ = tm(torch.from_numpy(toks[:, lo:hi]), cache=cache)
            np.testing.assert_allclose(got.numpy(), want,
                                       err_msg=f"tokens {lo}:{hi}", **TOL)
            back = interop.cache_to_flax(cache)
            assert back["pos_index"] == jcache["pos_index"] == hi
            for b in ("blocks_0", "blocks_1"):
                for leaf in ("cached_key", "cached_value"):
                    np.testing.assert_allclose(back[b]["attn"][leaf],
                                               jcache[b]["attn"][leaf],
                                               err_msg=leaf, **TOL)
                assert back[b]["attn"]["cache_index"] == hi


def test_prompt_chunk_then_steps_from_a_carried_cache(lm):
    """The JAX package decodes a 5-token prompt; its cache, carried across
    by ``interop``, starts the port's one-token steps, whose logits match
    the JAX steps' from the same cache.  The cache converts back exactly."""
    jm, params, tm = lm
    toks = _prompt(2, (2, 9))
    _, jcache = _jax_decode(jm, params, toks[:, :5])
    cache = interop.cache_from_flax(jcache)
    assert isinstance(cache, KVCache) and int(cache.index) == 5
    back = interop.cache_to_flax(cache)
    for b in ("blocks_0", "blocks_1"):
        for leaf in ("cached_key", "cached_value", "cache_index"):
            np.testing.assert_array_equal(back[b]["attn"][leaf],
                                          jcache[b]["attn"][leaf])
    with torch.no_grad():
        for t in range(5, 9):
            want, jcache = _jax_decode(jm, params, toks[:, t:t + 1], jcache)
            got, _ = tm(torch.from_numpy(toks[:, t:t + 1]), cache=cache)
            np.testing.assert_allclose(got.numpy(), want, err_msg=str(t),
                                       **TOL)


def test_cache_from_flax_rejects_disagreeing_indices(learned):
    jm, params, _ = learned
    _, jcache = _jax_decode(jm, params, _prompt(3, (1, 3)))
    jcache["pos_index"] = np.asarray(2, np.int32)
    with pytest.raises(ValueError, match="disagree"):
        interop.cache_from_flax(jcache)


def test_gqa_cache_holds_the_kv_heads():
    tm = TransformerLM(**SMALL, num_kv_heads=2, dtype=torch.float32)
    cache = tm.init_cache(3)
    assert [tuple(k.shape) for k in cache.keys] == [(3, 32, 2, 8)] * 2
    assert cache.keys[0].dtype == torch.float32
    assert cache.index.dtype == torch.int64 and int(cache.index) == 0
    bf16 = TransformerLM(**SMALL).init_cache(1)
    assert bf16.values[1].dtype == torch.bfloat16


def test_decode_mode_needs_a_cache_and_the_dense_stack():
    tm = TransformerLM(**SMALL, decode=True, dtype=torch.float32)
    with pytest.raises(ValueError, match="KVCache"):
        tm(torch.zeros(1, 3, dtype=torch.int64))
    for kw in (dict(pipelined=True), dict(num_experts=4)):
        with pytest.raises(ValueError, match="dense non-pipelined"):
            TransformerLM(**SMALL, decode=True, **kw)


def test_cache_reorder_gathers_rows_in_place():
    tm = TransformerLM(**SMALL, dtype=torch.float32)
    cache = tm.init_cache(3)
    with torch.no_grad():
        tm(torch.from_numpy(_prompt(4, (3, 4)).astype(np.int64)), cache=cache)
    keys = [k.clone() for k in cache.keys]
    storage = [k.data_ptr() for k in cache.keys]
    cache.reorder(torch.tensor([2, 2, 0]))
    assert [k.data_ptr() for k in cache.keys] == storage
    for old, new in zip(keys, cache.keys):
        assert torch.equal(new, old[[2, 2, 0]])


@pytest.mark.parametrize("eos", [None, 1], ids=["no-eos", "eos"])
def test_greedy_generate_matches_jax(lm, eos):
    jm, params, tm = lm
    prompt = _prompt(5, (3, 4))
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), 14,
                                    eos_id=eos))
    got = tgen.generate(tm, torch.from_numpy(prompt), 14, eos_id=eos)
    assert got.dtype == torch.int32 and got.shape == (3, 18)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_naive_greedy(learned):
    """generate (cache) == recompute-the-whole-prefix greedy, port-internal."""
    _, _, tm = learned
    prompt = torch.from_numpy(_prompt(6, (2, 4)).astype(np.int64))
    out = tgen.generate(tm, prompt, 6)
    toks = prompt
    with torch.no_grad():
        for _ in range(6):
            nxt = torch.argmax(tm(toks)[0][:, -1], dim=-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    assert torch.equal(out, toks)


def test_return_logits_are_the_full_forwards(learned):
    """The logits each token was chosen from equal the full forward's at
    the position before it."""
    _, _, tm = learned
    prompt = torch.from_numpy(_prompt(7, (2, 5)).astype(np.int64))
    out, logits = tgen.generate(tm, prompt, 8, return_logits=True)
    assert logits.shape == (2, 8, 50)
    with torch.no_grad():
        full, _ = tm(out[:, :-1])
    np.testing.assert_allclose(logits.numpy(), full[:, 4:].numpy(), **TOL)
    assert torch.equal(out[:, 5:], torch.argmax(logits, dim=-1))


def test_generate_rnn_matches_jax():
    """The PTB LSTM (hidden 16, 2 layers, vocabulary 40): the port's greedy
    carry-threaded decode equals the JAX package's token for token, and a
    recompute-the-prefix greedy loop."""
    kw = dict(config="small", vocab_size=40, hidden_size=16,
              dropout_rate=0.0)
    jm = jget_model("ptb_lstm", **kw)
    prompt = _prompt(8, (2, 5), vocab=40)
    variables = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.key(0), jnp.asarray(prompt), jm.initial_carry(2))))
    tm = get_model("ptb_lstm", **kw)
    interop.load_flax_variables(tm, variables)
    want = np.asarray(jgen.generate_rnn(jm, variables["params"],
                                        jnp.asarray(prompt), 9))
    got = tgen.generate_rnn(tm, torch.from_numpy(prompt), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    toks = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(9):
            logits, _ = tm(toks)
            toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], 1)
    assert torch.equal(got.long(), toks)


def test_generate_eos_freeze(learned):
    """A row that emits ``eos_id`` emits it to the end; eos is the model's
    own first greedy token, so the freeze fires."""
    _, _, tm = learned
    prompt = torch.zeros(1, 2, dtype=torch.int64)
    with torch.no_grad():
        eos = int(torch.argmax(tm(prompt)[0][0, -1]))
    gen = tgen.generate(tm, prompt, 8, eos_id=eos)[0, 2:]
    assert (gen == eos).all(), gen
    sampled = tgen.generate(tm, torch.zeros(2, 3, dtype=torch.int64), 5,
                            temperature=1.0, seed=3)
    assert sampled.shape == (2, 8)
    assert bool((sampled >= 0).all() and (sampled < 50).all())


def test_generate_rejects_overflow_and_bad_lengths(learned):
    _, _, tm = learned
    prompt = torch.zeros(1, 30, dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tgen.generate(tm, prompt, 3)
    with pytest.raises(ValueError, match=">= 0"):
        tgen.generate(tm, prompt[:, :4], -1)
    assert tgen.generate(tm, prompt[:, :4], 0) is not None
    assert torch.equal(tgen.generate(tm, prompt[:, :4], 0), prompt[:, :4])
    with pytest.raises(ValueError, match="needs a seed"):
        tgen.generate(tm, prompt[:, :4], 2, temperature=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tgen.generate(tm, prompt[:, :4], 2, capture=True)


# (top_k, top_p) pairs: top-k alone (1, 2, 7, the vocabulary, past it),
# nucleus alone, both, and the degenerate knobs (off, top_p 0 and <= 0).
FILTERS = [(1, 1.0), (2, 1.0), (7, 1.0), (101, 1.0), (500, 1.0), (0, 0.6),
           (0, 0.9), (0, 0.999), (3, 0.5), (20, 0.8), (0, 1.0), (0, 0.0),
           (0, -0.5), (5, 0.0)]


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_filter_logits_match_jax(top_k, top_p):
    """The same numpy logits (3 rows of 101, and a row with ties at the
    k-th value): the masks equal JAX's, the kept values unchanged."""
    rng = np.random.RandomState(FILTERS.index((top_k, top_p)))
    rows = [rng.standard_normal((3, 101)).astype(np.float32) * 4,
            np.asarray([[1.0, 2.0, 2.0, 2.0, 0.5, 3.0]], np.float32)]
    for logits in rows:
        want = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k,
                                              top_p))
        got = tgen._filter_logits(torch.from_numpy(logits), top_k,
                                  top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got, want)


def _sort_filter(logits, top_k, top_p):
    """The sort path for every setting (no ``torch.topk`` fast path)."""
    if top_k <= 0 and top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if top_k > 0:
        kth = sorted_logits[..., min(top_k, logits.shape[-1]) - 1:][..., :1]
        logits = logits.masked_fill(logits < kth, -np.inf)
        sorted_logits = sorted_logits.masked_fill(sorted_logits < kth,
                                                  -np.inf)
    if top_p < 1.0:
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits, np.inf).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -np.inf)
    return logits


def test_filter_logits_top_k_fast_path_matches_sort():
    rng = np.random.RandomState(0)
    for trial in range(5):
        logits = torch.from_numpy(
            rng.standard_normal((3, 101)).astype(np.float32) * 4)
        for top_k in (1, 2, 3, 50, 101, 500):
            assert torch.equal(tgen._filter_logits(logits, top_k, 1.0),
                               _sort_filter(logits, top_k, 1.0)), (trial,
                                                                   top_k)
    tied = torch.tensor([[1.0, 2.0, 2.0, 2.0, 0.5, 3.0]])
    for top_k in (1, 2, 3, 4, 5):
        assert torch.equal(tgen._filter_logits(tied, top_k, 1.0),
                           _sort_filter(tied, top_k, 1.0)), top_k


def test_top_k_sampling_pinned_to_the_sort_path(learned, monkeypatch):
    """A top-k sampled stream is the same with the sort path in place of
    the fast path."""
    _, _, tm = learned
    prompt = torch.zeros(2, 3, dtype=torch.int64)
    fast = tgen.generate(tm, prompt, 8, temperature=0.8, top_k=5, seed=17)
    monkeypatch.setattr(tgen, "_filter_logits", _sort_filter)
    slow = tgen.generate(tm, prompt, 8, temperature=0.8, top_k=5, seed=17)
    assert torch.equal(fast, slow)


def test_top_k_one_equals_greedy(learned):
    _, _, tm = learned
    prompt = torch.zeros(2, 3, dtype=torch.int64)
    greedy = tgen.generate(tm, prompt, 5)
    sampled = tgen.generate(tm, prompt, 5, temperature=1.0, top_k=1, seed=9)
    assert torch.equal(greedy, sampled)


def test_same_seed_same_stream(learned):
    """Sampling is a function of the seed alone: the same seed gives the
    same stream, another seed another one; the schedule is per token."""
    _, _, tm = learned
    prompt = torch.from_numpy(_prompt(9, (3, 3)).astype(np.int64))
    kw = dict(temperature=1.0, top_p=0.95)
    a = tgen.generate(tm, prompt, 12, seed=5, **kw)
    b = tgen.generate(tm, prompt, 12, seed=5, **kw)
    c = tgen.generate(tm, prompt, 12, seed=6, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    sched = tgen.key_schedule(5, 12)
    assert sched == tgen.key_schedule(5, 12) and len(set(sched)) == 12
    assert tgen.key_schedule(5, 4) == sched[:4]


def test_cli_train_then_generate(tmp_path, capsys):
    """The user surface on the CPU: ``train`` a tiny transformer LM
    checkpoint, then ``generate`` from it: greedy tokens equal the port's
    ``generate`` on the restored model."""
    wd = str(tmp_path / "wd")
    assert cli.main(["train", "--config", "transformer_lm_tiny", "--workdir",
                     wd, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["generate", "--config", "transformer_lm_tiny",
                     "--workdir", wd, "--prompt", "5,6,7",
                     "--max-new-tokens", "4", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 2 and line["prompt"] == [5, 6, 7]
    assert len(line["tokens"]) == 7 and line["tokens"][:3] == [5, 6, 7]
    assert cli.main(["generate", "--config", "transformer_lm_tiny",
                     "--workdir", wd, "--prompt", "5,6,7",
                     "--max-new-tokens", "4", "--temperature", "1.0",
                     "--seed", "3", "--device", "cpu"]) == 0
    sampled = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(sampled["tokens"]) == 7


def test_cli_generate_rejects_non_lm_and_a_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="transformer_lm config"):
        cli.main(["generate", "--config", "lenet_mnist", "--workdir",
                  str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="transformer_lm config"):
        cli.main(["generate", "--config", "ptb_small", "--workdir",
                  str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["generate", "--config", "transformer_lm_tiny",
                  "--workdir", str(tmp_path / "empty"), "--device", "cpu"])


@pytest.mark.parametrize("window", [None, 3], ids=["causal", "window"])
def test_reference_attention_takes_a_tensor_offset(window):
    """The decode step's mask: ``q_offset`` as a 0-d int64 tensor gives
    the same bits as the int, and RoPE takes ``index + arange(T)``."""
    from distributed_tensorflow_models_tpu_torch.ops import attention, rotary

    rng = np.random.RandomState(11)
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 9, 2, 8)).astype(np.float32))
    want = attention.reference_attention(q, k, v, causal=True, q_offset=5,
                                         window=window)
    index = torch.tensor(5, dtype=torch.int64)
    got = attention.reference_attention(q, k, v, causal=True, q_offset=index,
                                        window=window)
    assert torch.equal(got, want)
    assert torch.equal(rotary.apply_rope(q, index + torch.arange(3)),
                       rotary.apply_rope(q, torch.arange(5, 8)))
