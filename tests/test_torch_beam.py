"""The port's ``beam_search`` against exhaustive search, greedy decoding
and the JAX package's ``beam_search``.

Models: a one-layer transformer with a 3-token vocabulary (d_model 16, 2
heads, ``max_len`` 16), so a beam of 27 is exhaustive over 3 steps, and
the 2-layer, vocabulary-50 model of ``test_torch_generate.py`` (learned
positions, and rotary with 2 KV heads and a 6-token window) for the
comparison with JAX; f32, dropout 0, weights from the JAX model's init
through ``interop.load_flax_variables``.  Tokens must be identical; scores
(sums of f32 log-probs) agree to 1e-5, as do brute force's.  Ties among
the K*V candidates go to the lower flat index in both packages.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.harness import generate as jgen
from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.harness import generate as tgen
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    TransformerLM,
)

jax.config.update("jax_platforms", "cpu")

TINY = dict(vocab_size=3, num_layers=1, num_heads=2, d_model=16, d_ff=32,
            max_len=16, dropout_rate=0.0)
SMALL = dict(vocab_size=50, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_len=32, dropout_rate=0.0)
FORMS = {"learned": {},
         "rope-gqa-window": dict(pos_encoding="rope", num_kv_heads=2,
                                 attn_window=6)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _bridged(shape, **kw):
    jm = jget_model("transformer_lm", **shape, **kw, dtype=jnp.float32,
                    attn_impl="reference")
    params = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.key(0), jnp.zeros((1, 2), jnp.int32))["params"]))
    tm = TransformerLM(**shape, **kw, dtype=torch.float32,
                       attn_impl="reference")
    interop.load_flax_variables(tm, {"params": params})
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _bridged(TINY)


@pytest.fixture(scope="module", params=sorted(FORMS))
def small(request):
    return _bridged(SMALL, **FORMS[request.param])


def _brute_force_best(tm, prompt, steps):
    """Every ``V ** steps`` continuation scored by full forwards; the best
    ``(continuation, log-prob)``."""
    best_lp, best = -np.inf, None
    with torch.no_grad():
        for cont in itertools.product(range(tm.embedding.embedding.shape[0]),
                                      repeat=steps):
            toks, lp = prompt, 0.0
            for t in cont:
                logits, _ = tm(toks)
                lp += float(torch.log_softmax(logits[0, -1].float(), -1)[t])
                toks = torch.cat([toks, torch.tensor([[t]])], dim=1)
            if lp > best_lp:
                best_lp, best = lp, cont
    return best, best_lp


def test_beam_matches_exhaustive_search(tiny):
    """K = V ** steps makes the search exhaustive: its best sequence and
    score equal brute force's."""
    _, _, tm = tiny
    prompt = torch.tensor([[1, 2]])
    out, score = tgen.beam_search(tm, prompt, 3, beam_size=27)
    seq, lp = _brute_force_best(tm, prompt, 3)
    assert tuple(out[0, 2:].tolist()) == seq
    np.testing.assert_allclose(float(score[0]), lp, **TOL)


def test_beam_one_equals_greedy(tiny):
    _, _, tm = tiny
    prompt = torch.tensor([[0, 1], [2, 0]])
    greedy = tgen.generate(tm, prompt, 5)
    beam, _ = tgen.beam_search(tm, prompt, 5, beam_size=1)
    assert torch.equal(greedy, beam)


@pytest.mark.parametrize("k", [1, 2, 4, 9])
def test_exhaustive_beam_dominates_narrower(tiny, k):
    """The exhaustive beam's best score bounds a narrower beam's from
    above (wider-but-not-exhaustive beams promise nothing)."""
    _, _, tm = tiny
    prompt = torch.tensor([[1, 0]])
    _, narrow = tgen.beam_search(tm, prompt, 3, beam_size=k)
    _, wide = tgen.beam_search(tm, prompt, 3, beam_size=27)
    assert float(wide[0]) >= float(narrow[0]) - 1e-5


def test_beam_shapes_and_bounds(tiny):
    _, _, tm = tiny
    prompt = torch.zeros(3, 2, dtype=torch.int32)
    out, score = tgen.beam_search(tm, prompt, 4, beam_size=2)
    assert out.shape == (3, 6) and out.dtype == torch.int32
    assert score.shape == (3,) and score.dtype == torch.float32
    assert bool((out >= 0).all() and (out < 3).all())
    assert bool((score <= 0).all())
    with pytest.raises(ValueError, match="max_new_tokens >= 1"):
        tgen.beam_search(tm, prompt, 0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tgen.beam_search(tm, prompt, 99)
    with pytest.raises(ValueError, match="CUDA"):
        tgen.beam_search(tm, prompt, 3, capture=True)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_beam_matches_jax(small, k):
    """Tokens identical and scores to 1e-5 against JAX ``beam_search``,
    over a batch of three numpy prompts and 8 steps."""
    jm, params, tm = small
    prompt = np.random.RandomState(k).randint(0, 50, (3, 4)).astype(np.int32)
    jt, js = jgen.beam_search(jm, params, jnp.asarray(prompt), 8,
                              beam_size=k)
    tt, ts = tgen.beam_search(tm, torch.from_numpy(prompt), 8, beam_size=k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_beam_matches_jax_on_the_exhaustive_tiny_model(tiny):
    """K larger than the vocabulary: dead beams (score -inf) tie, and the
    lower flat index wins in both packages."""
    jm, params, tm = tiny
    prompt = np.asarray([[1, 2], [0, 0]], np.int32)
    for k in (5, 27):
        jt, js = jgen.beam_search(jm, params, jnp.asarray(prompt), 3,
                                  beam_size=k)
        tt, ts = tgen.beam_search(tm, torch.from_numpy(prompt), 3,
                                  beam_size=k)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_top_k_stable_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf]])
    values, idx = tgen._top_k_stable(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist()
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
