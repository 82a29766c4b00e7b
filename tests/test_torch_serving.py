"""The port's serving engine and scheduler (``serving/``) against solo
``generate`` and against the JAX package's engine.

The model is ``tests/test_serving.py``'s ``_small_lm``: vocabulary 50, 2
layers, 2 heads, d_model 32, d_ff 64, ``max_len`` 64, f32, the JAX
model's init bridged by ``interop.load_flax_variables``.  The engine runs
on the CPU (``device="cpu"``), where its two programs run eagerly.

The contract, as in the JAX suite: every stream equals the port's solo
``generate`` at batch 1 token for token, for all six sampling modes, at
any batch composition, burst, page size, prefix-cache warmth and
speculative acceptance; ``compile_counts()`` is (1, 1), (1, 2) with
speculation; ``fsck()`` is empty.  Sampled requests carry the int seed
``generate(seed=)`` takes.  Against the JAX engine on the same greedy
traffic: the streams, and every piece of host state (admission results,
block tables, lengths, prefix-cache hits, misses and evictions, the
drafter's proposals and the rolled-back lengths they lead to, the
scheduler's admitted and retired sets after each step, the ``serve/*``
registry keys and counts) are equal exactly.  Tokens and host state are
compared exactly; no logits are compared here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.serving import drafter as jdrafter
from distributed_tensorflow_models_tpu.serving import engine as jengine
from distributed_tensorflow_models_tpu.serving import kv_slots as jkv
from distributed_tensorflow_models_tpu.serving import prefix_cache as jpc
from distributed_tensorflow_models_tpu.serving import scheduler as jsched
from distributed_tensorflow_models_tpu.telemetry import registry as jreg
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.harness.generate import generate
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    TransformerLM,
)
from distributed_tensorflow_models_tpu_torch.serving import kv_slots
from distributed_tensorflow_models_tpu_torch.serving import (
    scheduler as schedlib,
)
from distributed_tensorflow_models_tpu_torch.serving.drafter import (
    NO_DRAFT,
    NgramDrafter,
)
from distributed_tensorflow_models_tpu_torch.serving.engine import (
    InferenceEngine,
)
from distributed_tensorflow_models_tpu_torch.serving.kv_slots import (
    BlockPool,
    SlotManager,
)
from distributed_tensorflow_models_tpu_torch.serving.prefix_cache import (
    RadixPrefixCache,
    prompt_pages,
)
from distributed_tensorflow_models_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

jax.config.update("jax_platforms", "cpu")

SMALL = dict(vocab_size=50, num_layers=2, num_heads=2, d_model=32, d_ff=64,
             max_len=64, dropout_rate=0.0)


def _jax_model():
    return jget_model("transformer_lm", **SMALL, dtype=jnp.float32,
                      attn_impl="reference")


def _params(seed):
    return jax.tree.map(np.asarray, dict(_jax_model().init(
        jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"]))


def _port_model(params):
    tm = TransformerLM(**SMALL, dtype=torch.float32, attn_impl="reference")
    interop.load_flax_variables(tm, {"params": params})
    return tm


@pytest.fixture(scope="module")
def small_lm():
    """``(port model, numpy params)``: ``_small_lm``'s init at key 0."""
    params = _params(0)
    return _port_model(params), params


def _engine(model, **kw):
    kw.setdefault("registry", reglib.MetricsRegistry())
    return InferenceEngine(model, device="cpu", **kw)


def _solo(model, prompt, max_new, t=0.0, k=0, p=1.0, seed=None):
    out = generate(model, torch.as_tensor(np.asarray(prompt, np.int64))[None],
                   max_new, temperature=t, top_k=k, top_p=p, seed=seed)
    return out[0, len(prompt):].tolist()


# -- slot manager ----------------------------------------------------------


def test_slot_manager_alloc_free_bookkeeping():
    sm = SlotManager(3)
    assert sm.free_count == 3 and sm.active_count == 0
    assert sm.alloc(10) == 0  # lowest-free-first
    assert sm.alloc(11) == 1
    assert sm.alloc(12) == 2
    assert sm.alloc(13) is None  # full
    assert sm.occupancy == 1.0
    assert sm.free(1) == 11
    assert sm.owner(1) is None and sm.owner(0) == 10
    assert sm.alloc(14) == 1  # recycled: lowest free again
    assert sm.active_slots() == [0, 1, 2]
    with pytest.raises(KeyError):
        sm.free(3)
    sm.free(1)
    with pytest.raises(KeyError):
        sm.free(1)  # double free
    with pytest.raises(ValueError):
        SlotManager(0)


# -- the flagship: batching invariance -------------------------------------

# Every sampling mode, deliberately mixed in one batch: greedy rides
# beside temperature, top-k beside nucleus beside combined.
CONFIGS = [
    (0.0, 0, 1.0),   # greedy
    (1.0, 0, 1.0),   # pure temperature
    (0.8, 5, 1.0),   # top-k
    (1.0, 0, 0.9),   # nucleus
    (0.7, 8, 0.85),  # combined
    (0.0, 0, 1.0),   # second greedy (recycled-slot occupant)
]
PLENS = [3, 7, 8, 12, 5, 9]
MAXNEW = [10, 8, 12, 6, 10, 7]


def _mk_requests(seed):
    rs = np.random.RandomState(seed)
    reqs = []
    for i, ((t, k, p), plen, mn) in enumerate(zip(CONFIGS, PLENS, MAXNEW)):
        prompt = rs.randint(0, 50, plen).astype(np.int32)
        reqs.append(Request(request_id=i, prompt=prompt, max_new_tokens=mn,
                            temperature=t, top_k=k, top_p=p,
                            rng=seed * 100 + i if t > 0 else None))
    return reqs


def _solo_streams(model, reqs):
    return {r.request_id: _solo(model, r.prompt, r.max_new_tokens,
                                r.temperature, r.top_k, r.top_p, r.rng)
            for r in reqs}


def test_batched_decode_bit_identical_to_solo_generate(small_lm):
    """6 mixed-mode requests through 4 slots: the last two are admitted
    MID-FLIGHT into recycled slots, and every request's stream must be
    byte-equal to its solo ``generate()``."""
    model, _ = small_lm
    eng = _engine(model, max_slots=4, prefill_chunk=8)
    reqs = _mk_requests(7)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    for r in reqs[:5]:
        sched.submit(r)
    done = list(sched.step())  # admits 4 (slots full), decodes once
    assert sched.active_count == 4 and sched.waiting_count == 1
    done.extend(sched.step())
    done.extend(sched.step())
    sched.submit(reqs[5])  # late arrival: joins a half-advanced batch
    done.extend(sched.run_until_idle())
    comps = {c.request_id: c for c in done}
    assert sorted(comps) == list(range(6))
    solo = _solo_streams(model, reqs)
    for i in range(6):
        assert comps[i].tokens == solo[i], (
            f"request {i} mode {CONFIGS[i]}: batched stream diverged")
        assert comps[i].finish_reason == "length"
        assert comps[i].ttft_s >= 0
    assert eng.compile_counts() == (1, 1)
    assert eng.fsck() == []


def test_decode_burst_bit_identical_and_single_program(small_lm):
    """``decode_burst=4`` through 3 slots with mid-flight admissions:
    lanes finish inside a burst (their overrun discarded) and one stops
    on EOS mid-burst; streams still equal solo ``generate()``."""
    model, _ = small_lm
    eng = _engine(model, max_slots=3, prefill_chunk=8, decode_burst=4)
    reqs = _mk_requests(7)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    for r in reqs[:4]:
        sched.submit(r)
    done = list(sched.step())
    assert sched.active_count == 3 and sched.waiting_count == 1
    sched.submit(reqs[4])
    done.extend(sched.step())
    sched.submit(reqs[5])  # late arrival at a burst boundary
    done.extend(sched.run_until_idle())
    comps = {c.request_id: c for c in done}
    solo = _solo_streams(model, reqs)
    for i in range(6):
        assert comps[i].tokens == solo[i], f"request {i}: burst diverged"
        assert len(comps[i].tokens) == MAXNEW[i]
    prompt = np.asarray([1, 2, 3], np.int32)
    ref = _solo(model, prompt, 8)
    eos = ref[2]
    sched.submit(Request(request_id=9, prompt=prompt, max_new_tokens=8,
                         eos_id=eos))
    (comp,) = sched.run_until_idle()
    assert comp.finish_reason == "eos"
    assert comp.tokens == ref[: ref.index(eos) + 1]
    assert eng.compile_counts() == (1, 1)


def test_eos_retirement_matches_solo(small_lm):
    model, _ = small_lm
    eng = _engine(model, max_slots=4, prefill_chunk=8)
    prompt = np.asarray([1, 2, 3], np.int32)
    ref = _solo(model, prompt, 8)
    eos = ref[2]
    sched = ContinuousBatchingScheduler(eng)
    sched.submit(Request(request_id=0, prompt=prompt, max_new_tokens=8,
                         eos_id=eos))
    (comp,) = sched.run_until_idle()
    assert comp.finish_reason == "eos"
    assert comp.tokens == ref[: ref.index(eos) + 1]
    assert eng.slots.active_count == 0


def test_admission_budget_bounds_prefill_per_step(small_lm):
    model, _ = small_lm
    eng = _engine(model, max_slots=4, prefill_chunk=8)
    sched = ContinuousBatchingScheduler(
        eng, max_prefill_tokens=eng.prefill_chunk)
    for i in range(3):
        sched.submit(Request(request_id=i, prompt=np.arange(
            eng.prefill_chunk, dtype=np.int32), max_new_tokens=4))
    sched.step()
    assert sched.active_count == 1 and sched.waiting_count == 2
    sched.step()
    assert sched.active_count == 2 and sched.waiting_count == 1
    sched.run_until_idle()
    assert not sched.has_work


def test_submit_rejects_impossible_requests(small_lm):
    model, _ = small_lm
    eng = _engine(model, max_slots=2, prefill_chunk=8)
    sched = ContinuousBatchingScheduler(eng)
    ok = np.asarray([1, 2, 3], np.int32)
    with pytest.raises(ValueError):  # empty prompt
        sched.submit(Request(0, np.zeros((0,), np.int32), 4))
    with pytest.raises(ValueError):  # max_new < 1
        sched.submit(Request(0, ok, 0))
    with pytest.raises(ValueError):  # total exceeds max_len
        sched.submit(Request(0, ok, eng.max_len))
    with pytest.raises(ValueError):  # sampling without a seed
        sched.submit(Request(0, ok, 4, temperature=0.5))
    assert not sched.has_work
    eng2 = _engine(model, max_slots=2, prefill_chunk=12)
    eng2.check_fits(55, 5)  # padded 60 <= 64: fine
    with pytest.raises(ValueError, match="padded"):
        eng2.check_fits(61, 1)  # total 62 fits, padded 72 does not


def test_engine_runs_on_the_card_unless_asked(small_lm, monkeypatch):
    """The default device is the card: with none, construction raises
    (no fallback to the CPU).  The shipping seam (ported with
    ``serving/shipping.py``) refuses a slot with no prompt, pages missing
    a pool leaf, and a fleet index without the prefix cache; a decode
    scheduler's shipped intake reaches it and raises the same."""
    model, _ = small_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, registry=reglib.MetricsRegistry())
    eng = _engine(model, max_slots=2, prefill_chunk=8)
    with pytest.raises(ValueError, match="no prefilled tokens"):
        eng.export_slot(0)
    with pytest.raises(ValueError, match="missing pool leaf"):
        eng.admit_shipped(0, 3, 4, {})
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(model, prefix_cache=False, fleet_cache=object())
    sched = ContinuousBatchingScheduler(eng, role="decode")
    sched.submit_shipped(
        Request(0, np.asarray([1, 2, 3], np.int32), 4), pages={},
        keydata=np.zeros(4, np.int64), first_token=1, t_submit=0.0,
        queue_s=0.0, prefill_s=0.0)
    with pytest.raises(ValueError, match="missing pool leaf"):
        sched.step()


def test_serving_telemetry_surface_and_waterfall(small_lm):
    """The registry holds the serving key set after a workload, and with
    lifecycle tracing on every request leaves queue -> prefill -> decode
    -> done events whose queue + prefill equals its TTFT exactly;
    tracing changes no tokens."""
    from distributed_tensorflow_models_tpu_torch.telemetry import (
        trace as tracelib,
    )

    model, _ = small_lm
    eng = _engine(model, max_slots=4, prefill_chunk=8)
    tracer = tracelib.Tracer(512)
    eng.registry.trace = tracer
    reqs = _mk_requests(7)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    for r in reqs:
        sched.submit(r)
    comps = {c.request_id: c for c in sched.run_until_idle()}
    solo = _solo_streams(model, reqs)
    for i in range(6):
        assert comps[i].tokens == solo[i]
    snap = eng.registry.snapshot()
    assert snap[reglib.SERVE_REQUESTS] == 6
    assert snap[reglib.SERVE_TOKENS] == sum(MAXNEW)
    for key in (reglib.SERVE_TTFT, reglib.SERVE_TPOT, reglib.SERVE_PREFILL,
                reglib.SERVE_DECODE, reglib.SERVE_QUEUE_DEPTH,
                reglib.SERVE_SLOT_OCCUPANCY):
        assert snap[f"{key}/count"] > 0, key
    assert 0.0 <= snap[f"{reglib.SERVE_SLOT_OCCUPANCY}/max_s"] <= 1.0
    by_rid: dict = {}
    for e in tracer.events():
        rid = (e.get("args") or {}).get("rid")
        if rid is not None:
            by_rid.setdefault(rid, {}).setdefault(e["name"], []).append(e)
    for i in range(6):
        spans = by_rid[i]
        (q,) = spans[schedlib.REQ_QUEUE]
        (p,) = spans[schedlib.REQ_PREFILL]
        assert schedlib.REQ_DONE in spans
        assert q["dur_s"] + p["dur_s"] == pytest.approx(comps[i].ttft_s,
                                                        abs=1e-9)
        assert q["ts_mono"] + q["dur_s"] == pytest.approx(p["ts_mono"],
                                                          abs=1e-9)
        decodes = spans.get(schedlib.REQ_DECODE, [])
        assert sum(d["args"]["n"] for d in decodes) == len(
            comps[i].tokens) - 1


# -- paged KV arena + radix prefix cache ------------------------------------


def test_block_pool_and_prefix_cache_lifecycle():
    pool = BlockPool(6)
    assert pool.free_count == 5 and pool.used_count == 0
    blocks = pool.alloc(2)
    assert blocks == [1, 2]
    cache = RadixPrefixCache(pool, page_tokens=2)
    pages = [(0, 1), (2, 3)]
    assert cache.insert(pages, blocks) == 2
    assert pool.refcount(1) == 2 and cache.resident_count == 2
    assert pool.release(blocks) == []
    assert cache.peek(pages + [(9, 9)]) == 2
    assert cache.match(pages + [(9, 9)]) == [1, 2]
    assert (cache.hits, cache.misses) == (2, 1)
    assert cache.insert(pages, blocks) == 0
    assert pool.alloc(3) == [3, 4, 5]
    assert pool.alloc(1) is None and pool.free_count == 0
    assert cache.evict(want_freed=1) == 1
    assert cache.evictions == 1 and cache.resident_count == 1
    assert cache.match(pages) == [1]
    pool.retain([1])
    assert cache.evict(want_freed=1) == 0
    assert pool.refcount(1) == 1
    assert pool.release([1]) == [1]
    with pytest.raises(KeyError):
        pool.release([1])
    with pytest.raises(ValueError):
        BlockPool(1)
    with pytest.raises(ValueError):
        RadixPrefixCache(pool, 2, max_blocks=0)
    with pytest.raises(ValueError):
        cache.insert(pages, [2])
    assert prompt_pages([1, 2, 3, 4, 5], 2) == [(1, 2), (3, 4)]


def test_host_logic_equals_jax_on_random_traffic():
    """The block pool, the prefix trie, the drafter and
    ``rollback_length`` against the JAX package's on the same seeded
    operation stream: every return value and counter equal."""
    rs = np.random.RandomState(3)
    a, b = BlockPool(40), jkv.BlockPool(40)
    ca, cb = RadixPrefixCache(a, 2, max_blocks=12), jpc.RadixPrefixCache(
        b, 2, max_blocks=12)
    held = []
    for _ in range(300):
        op = rs.randint(4)
        if op == 0:
            n = int(rs.randint(0, 5))
            got, want = a.alloc(n), b.alloc(n)
            assert got == want
            if got:
                held.append(got)
        elif op == 1 and held:
            blocks = held.pop(int(rs.randint(len(held))))
            assert a.release(blocks) == b.release(blocks)
        elif op == 2 and held:
            blocks = held[int(rs.randint(len(held)))]
            pages = [tuple(rs.randint(0, 3, 2).tolist())
                     for _ in range(len(blocks))]
            assert ca.insert(pages, blocks) == cb.insert(pages, blocks)
        else:
            pages = [tuple(rs.randint(0, 3, 2).tolist()) for _ in range(3)]
            assert ca.peek(pages) == cb.peek(pages)
            assert ca.match(pages) == cb.match(pages)
        assert (a.free_count, ca.hits, ca.misses, ca.evictions,
                sorted(ca.resident_blocks())) == (
            b.free_count, cb.hits, cb.misses, cb.evictions,
            sorted(cb.resident_blocks()))
    for length, written, kept in [(0, 1, 1), (5, 4, 2), (9, 4, 4)]:
        assert kv_slots.rollback_length(length, written, kept) == \
            jkv.rollback_length(length, written, kept)
    with pytest.raises(ValueError):
        kv_slots.rollback_length(3, 2, 3)
    for trial in range(20):
        hist = rs.randint(0, 4, int(rs.randint(1, 30))).tolist()
        kw = dict(spec_tokens=int(rs.randint(1, 6)),
                  ngram_order=int(rs.randint(2, 5)), min_match=1)
        da, db = NgramDrafter(hist[:3], **kw), jdrafter.NgramDrafter(
            hist[:3], **kw)
        for tok in hist[3:]:
            np.testing.assert_array_equal(da.propose(), db.propose())
            da.append(tok)
            db.append(tok)
        np.testing.assert_array_equal(da.propose(), db.propose())
    d = NgramDrafter([4, 4, 4, 4], spec_tokens=5, ngram_order=3)
    assert d.propose().tolist() == [4, 4, 4, 4, 4]
    assert NgramDrafter([9], spec_tokens=2, min_match=2,
                        ngram_order=3).propose().tolist() == [NO_DRAFT] * 2


def test_kv_slots_gather_scatter_roundtrip(small_lm):
    """The pool's device half: a gather through a table is the pages in
    table order; scatter writes them back; adoption copies only the
    flagged lanes."""
    model, _ = small_lm
    pool = kv_slots.make_pool(model, 9, 8)
    assert tuple(pool.keys[0].shape) == (9, 8, 2, 16)
    for i, t in enumerate(pool.tensors()):
        t.copy_(torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape) + i)
    table = torch.tensor([3, 1, 0, 0, 0, 0, 0, 0])
    view = kv_slots.gather_cache(pool, table)
    assert tuple(view.keys[0].shape) == (1, 64, 2, 16)
    assert torch.equal(view.keys[0][0, :8], pool.keys[0][3])
    assert torch.equal(view.values[1][0, 8:16], pool.values[1][1])
    pages = kv_slots.cache_pages(view, 8)
    for t in pages.tensors():
        t.add_(1000)
    kv_slots.scatter_pages(pool, pages, torch.tensor([5, 6, 0, 0, 0, 0, 0,
                                                      0]))
    assert torch.equal(pool.keys[0][5], pool.keys[0][3] + 1000)
    views = kv_slots.make_views(model, 3, 64)
    tables = np.zeros((3, 8), np.int64)
    tables[2, :2] = [5, 6]
    kv_slots.adopt_lanes(views, pool, tables, [2])
    assert torch.equal(views.keys[0][2, :8], pool.keys[0][5])
    assert not views.keys[0][:2].any()


@pytest.mark.parametrize("page", [1, 4, 16])
def test_paged_identity_cold_warm_and_cow(small_lm, page):
    """Cold admission, warm re-admission, and two concurrent sharers whose
    divergent tails copy-on-write into private blocks, under batched
    2-lane prefill at page sizes {1, 4, 16}: every stream equals solo
    ``generate()``, and the resident prefix survives every sharer."""
    model, _ = small_lm
    eng = _engine(model, max_slots=2, prefill_chunk=8, prefill_lanes=2,
                  kv_page_tokens=page)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    rs = np.random.RandomState(11)
    base = rs.randint(0, 50, 16).astype(np.int32)
    prompt_a = np.concatenate([base, rs.randint(0, 50, 4).astype(np.int32)])
    prompt_b = np.concatenate([base, rs.randint(0, 50, 4).astype(np.int32)])
    solo_a = _solo(model, prompt_a, 6, 0.8, 5, 1.0, 1)
    solo_b = _solo(model, prompt_b, 6)

    def req(rid, prompt, sampled):
        return Request(rid, prompt, 6, temperature=0.8 if sampled else 0.0,
                       top_k=5 if sampled else 0, rng=1 if sampled else None)

    sched.submit(req(0, prompt_a, True))
    comps = {c.request_id: c for c in sched.run_until_idle()}
    assert eng.registry.counter(reglib.SERVE_PREFIX_CACHE_HITS).value == 0
    assert comps[0].tokens == solo_a, f"page={page}: cold stream diverged"
    sched.submit(req(1, prompt_a, True))
    sched.submit(req(2, prompt_b, False))
    comps = {c.request_id: c for c in sched.run_until_idle()}
    hits = eng.registry.counter(reglib.SERVE_PREFIX_CACHE_HITS).value
    assert hits >= 16 // page
    assert comps[1].tokens == solo_a, f"page={page}: warm stream diverged"
    assert comps[2].tokens == solo_b, f"page={page}: COW stream diverged"
    sched.submit(req(3, prompt_a, True))
    comps = {c.request_id: c for c in sched.run_until_idle()}
    assert comps[3].tokens == solo_a, f"page={page}: resident prefix moved"
    assert eng.compile_counts() == (1, 1)
    assert eng.slots.active_count == 0
    assert eng.blocks.used_count == eng.blocks_resident
    assert eng.fsck() == []


def test_arena_exhaustion_admission_backpressure(small_lm):
    model, _ = small_lm
    eng = _engine(model, max_slots=4, prefill_chunk=8, kv_page_tokens=8,
                  kv_pool_blocks=9, prefix_cache=False)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 50, 8).astype(np.int32) for _ in range(4)]
    for i, p in enumerate(prompts):
        sched.submit(Request(i, p, 16))
    sched.step()
    assert sched.active_count == 2 and sched.waiting_count == 2
    assert eng.slots.free_count == 2 and eng.blocks_free == 2
    comps = {c.request_id: c for c in sched.run_until_idle()}
    assert sorted(comps) == [0, 1, 2, 3]
    for i, p in enumerate(prompts):
        assert comps[i].tokens == _solo(model, p, 16)
    assert eng.blocks_free == 8 and eng.slots.active_count == 0
    assert eng.compile_counts() == (1, 1)


def test_prefix_cache_eviction_under_block_bound(small_lm):
    model, _ = small_lm
    eng = _engine(model, max_slots=2, prefill_chunk=4, kv_page_tokens=4,
                  prefix_cache_blocks=2)
    sched = ContinuousBatchingScheduler(eng)
    rs = np.random.RandomState(5)
    p1, p2 = (rs.randint(0, 50, 12).astype(np.int32) for _ in range(2))
    solo1 = _solo(model, p1, 4)
    sched.submit(Request(0, p1, 4))
    assert sched.run_until_idle()[0].tokens == solo1
    assert eng.blocks_resident == 2
    sched.submit(Request(1, p2, 4))
    sched.run_until_idle()
    assert eng.blocks_resident <= 2
    assert eng.registry.counter(
        reglib.SERVE_PREFIX_CACHE_EVICTIONS).value >= 2
    sched.submit(Request(2, p1, 4))
    assert sched.run_until_idle()[0].tokens == solo1
    assert eng.compile_counts() == (1, 1)


# -- speculative decoding ---------------------------------------------------


class _ScriptedDrafter:
    """Proposes a fixed token script (the solo stream for the oracle, its
    complement for the adversary), shifted by the tokens emitted."""

    def __init__(self, script, spec_tokens):
        self._script = [int(t) for t in script]
        self._n = 0
        self.spec_tokens = int(spec_tokens)

    def append(self, token):
        self._n += 1

    def propose(self):
        out = np.full((self.spec_tokens,), NO_DRAFT, np.int32)
        cont = self._script[self._n: self._n + self.spec_tokens]
        out[: len(cont)] = cont
        return out


def test_spec_decode_bit_identical_all_modes(small_lm):
    """The real n-gram drafter at spec_tokens=3 over the mixed-mode
    workload with mid-flight admission: every stream equals solo, the
    fsck is clean at every iteration, and the decode programs are the
    burst and the verify: (1, 2)."""
    model, _ = small_lm
    eng = _engine(model, max_slots=4, prefill_chunk=8, spec_tokens=3)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    reqs = _mk_requests(7)
    for r in reqs[:5]:
        sched.submit(r)
    done = list(sched.step())
    assert eng.fsck() == []
    done.extend(sched.step())
    sched.submit(reqs[5])
    while sched.has_work:
        done.extend(sched.step())
        assert eng.fsck() == []
    comps = {c.request_id: c for c in done}
    solo = _solo_streams(model, reqs)
    for i in range(6):
        assert comps[i].tokens == solo[i], f"request {i}: spec diverged"
    snap = eng.registry.snapshot()
    assert snap[reglib.SERVE_SPEC_ACCEPTED] <= snap[reglib.SERVE_SPEC_DRAFTED]
    assert eng.compile_counts() == (1, 2)


@pytest.mark.parametrize("mode", ["oracle", "adversary", "mixed"])
def test_spec_acceptance_extremes_still_identical(small_lm, mode):
    """Full acceptance (an oracle drafter fed the solo stream: every
    draft accepted, dispatches collapse), zero acceptance (its
    complement: one token a verify), and both lanes in one dispatch:
    every stream equals solo, one lane greedy and one sampled."""
    model, _ = small_lm
    spec = 3
    eng = _engine(model, max_slots=2, prefill_chunk=8, spec_tokens=spec)
    rs = np.random.RandomState(22)
    reqs = [Request(i, rs.randint(0, 50, 6 + i).astype(np.int32), 12,
                    temperature=0.9 if i else 0.0, top_k=7 if i else 0,
                    rng=5 if i else None) for i in range(2)]
    solo = _solo_streams(model, reqs)

    def factory(req):
        oracle = mode == "oracle" or (mode == "mixed"
                                      and req.request_id == 0)
        script = solo[req.request_id]
        return _ScriptedDrafter(
            script if oracle else [(t + 1) % 50 for t in script], spec)

    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64,
                                        drafter_factory=factory)
    for r in reqs:
        sched.submit(r)
    comps = {c.request_id: c for c in sched.run_until_idle()}
    for i in range(2):
        assert comps[i].tokens == solo[i], f"{mode} stream {i} diverged"
    snap = eng.registry.snapshot()
    drafted, accepted = (snap[reglib.SERVE_SPEC_DRAFTED],
                         snap[reglib.SERVE_SPEC_ACCEPTED])
    assert drafted > 0
    if mode == "oracle":
        assert accepted == drafted
        assert snap[f"{reglib.SERVE_DECODE}/count"] <= 3
    elif mode == "adversary":
        assert accepted == 0
    else:
        assert 0 < accepted < drafted
    assert eng.fsck() == []
    # Under the oracle every dispatch verifies (its drafts run out only
    # with the budget), so the burst program is never built: programs
    # are built at first use, as JAX traces its instances.
    assert eng.compile_counts() == (1, 1 if mode == "oracle" else 2)


def test_spec_rollback_arena_consistency(small_lm):
    """After the prefill wave the POOL bytes are frozen through every
    verify dispatch (rejected K/V lands only in the lanes' private
    views), and the fsck stays clean at every iteration."""
    model, _ = small_lm
    eng = _engine(model, max_slots=2, prefill_chunk=8, spec_tokens=3)
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64)
    rs = np.random.RandomState(31)
    for i in range(2):
        sched.submit(Request(i, rs.randint(0, 50, 9).astype(np.int32), 10))
    sched.step()
    pool0 = [t.clone() for t in eng.pool.tensors()]
    while sched.has_work:
        sched.step()
        assert eng.fsck() == []
        for a, b in zip(pool0, eng.pool.tensors()):
            assert torch.equal(a, b), "decode dispatch wrote the pool"
    assert eng.slots.active_count == 0
    assert eng.blocks.used_count == eng.blocks_resident


def test_spec_budget_and_eos_overrun_discard(small_lm):
    model, _ = small_lm
    spec = 3
    eng = _engine(model, max_slots=2, prefill_chunk=8, spec_tokens=spec)
    prompt = np.asarray([1, 2, 3], np.int32)
    ref = _solo(model, prompt, 8)
    sched = ContinuousBatchingScheduler(
        eng, drafter_factory=lambda req: _ScriptedDrafter(ref, spec))
    sched.submit(Request(request_id=0, prompt=prompt, max_new_tokens=5))
    (comp,) = sched.run_until_idle()
    assert comp.tokens == ref[:5] and comp.finish_reason == "length"
    eos = ref[2]
    sched.submit(Request(request_id=1, prompt=prompt, max_new_tokens=8,
                         eos_id=eos))
    (comp,) = sched.run_until_idle()
    assert comp.finish_reason == "eos"
    assert comp.tokens == ref[: ref.index(eos) + 1]
    assert eng.fsck() == []


def test_spec_off_surface_and_constructor_validation(small_lm):
    model, _ = small_lm
    eng = _engine(model, max_slots=2, prefill_chunk=8)
    sched = ContinuousBatchingScheduler(eng)
    sched.submit(Request(0, np.asarray([1, 2, 3], np.int32), 6))
    (comp,) = sched.run_until_idle()
    assert len(comp.tokens) == 6
    assert not [k for k in eng.registry.snapshot()
                if k.startswith("serve/spec_")]
    assert eng.compile_counts() == (1, 1)
    with pytest.raises(ValueError, match="spec_tokens"):
        _engine(model, max_slots=2, spec_tokens=-1)
    with pytest.raises(ValueError, match="spec_min_match"):
        _engine(model, max_slots=2, spec_tokens=2, spec_min_match=0)
    with pytest.raises(ValueError, match="spec_ngram_order"):
        _engine(model, max_slots=2, spec_tokens=2, spec_ngram_order=1,
                spec_min_match=2)
    eng = _engine(model, max_slots=2, prefill_chunk=8, spec_tokens=4)
    with pytest.raises(ValueError, match="headroom"):
        eng.check_fits(40, eng.max_len - 40)


# -- weight versions ---------------------------------------------------------


class _Deploy:
    """The scheduler's continuous-deployment surface: routes the ids in
    ``canary`` to ``vid``, the rest to the primary."""

    def __init__(self, eng, canary_ids):
        self.eng, self.canary_ids = eng, set(canary_ids)

    def route(self, rid):
        if int(rid) in self.canary_ids and self.eng.canary_version:
            return self.eng.canary_version
        return self.eng.version

    def observe_sample(self, *args):
        pass


def test_version_pinning_across_install_promote_rollback(small_lm):
    """Lanes admitted on the canary equal solo ``generate`` on the
    canary's weights, the others on the primary's, while a canary is
    installed, promoted and another rolled back mid-flight; the programs
    are built once."""
    model_a, _ = small_lm
    params_b = _params(1)
    model_b = _port_model(params_b)
    params = dict(model_b.named_parameters())
    eng = _engine(model_a, max_slots=5, prefill_chunk=8)
    deploy = _Deploy(eng, canary_ids=[1, 3])
    sched = ContinuousBatchingScheduler(eng, max_prefill_tokens=64,
                                        deploy=deploy)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 50, 5 + i).astype(np.int32) for i in range(5)]
    knobs = [(0.0, 0, 1.0, None), (0.8, 5, 1.0, 3), (1.0, 0, 0.9, 4),
             (0.0, 0, 1.0, None), (0.7, 8, 0.85, 6)]

    def req(i):
        t, k, p, seed = knobs[i]
        return Request(i, prompts[i], 10, temperature=t, top_k=k, top_p=p,
                       rng=seed)

    sched.submit(req(0))
    done = list(sched.step())
    sched.step()
    eng.install_canary(7, params)
    sched.submit(req(1))  # canary
    sched.submit(req(2))  # primary (v0)
    done.extend(sched.step())
    done.extend(sched.step())
    eng.promote_canary()  # v7 primary now; r1 r2 keep their pins
    assert eng.version == 7
    eng.install_canary(8, dict(model_a.named_parameters()))
    sched.submit(req(3))  # canary v8 = model_a's weights
    done.extend(sched.step())
    eng.rollback_canary()
    sched.submit(req(4))  # primary v7
    done.extend(sched.run_until_idle())
    comps = {c.request_id: c for c in done}
    want_version = {0: 0, 1: 7, 2: 0, 3: 8, 4: 7}
    for i in range(5):
        assert comps[i].version == want_version[i]
        ref = model_b if want_version[i] == 7 else model_a
        t, k, p, seed = knobs[i]
        assert comps[i].tokens == _solo(ref, prompts[i], 10, t, k, p,
                                        seed), f"request {i}"
    assert eng.compile_counts() == (1, 1)
    assert eng.live_versions() == (7,)
    with pytest.raises(ValueError):
        eng.install_canary(7, params)
    bad = dict(params)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="names"):
        eng.install_canary(9, bad)


# -- against the JAX engine ---------------------------------------------------

# Greedy traffic (sampled bits are torch's, not threefry's): a shared
# 16-token prefix, repeated phrases (the drafter finds matches), an EOS.
def _traffic():
    rs = np.random.RandomState(13)
    base = rs.randint(0, 50, 16).astype(np.int32)
    rep = np.tile(rs.randint(0, 50, 3).astype(np.int32), 4)
    prompts = [np.concatenate([base, rs.randint(0, 50, 3).astype(np.int32)]),
               rep, rs.randint(0, 50, 9).astype(np.int32),
               np.concatenate([base, rs.randint(0, 50, 6).astype(np.int32)]),
               np.concatenate([base[:8], rep]),
               rs.randint(0, 50, 5).astype(np.int32)]
    maxnew = [9, 12, 7, 10, 8, 11]
    return prompts, maxnew


ENGINE_KW = {
    "spec": dict(max_slots=3, prefill_chunk=8, prefill_lanes=2,
                 kv_page_tokens=4, spec_tokens=3),
    "burst-evict": dict(max_slots=2, prefill_chunk=4, kv_page_tokens=4,
                        decode_burst=2, prefix_cache_blocks=3,
                        kv_pool_blocks=17),
}


@pytest.mark.parametrize("kind", sorted(ENGINE_KW))
def test_streams_and_host_state_equal_the_jax_engine(small_lm, kind):
    """The same greedy traffic through the JAX engine and the port's,
    step by step: completions (ids, tokens, reasons), the active slots,
    block tables, lengths, free blocks, prefix-cache counters, the
    registry's ``serve/*`` keys and counts; every stream also equals the
    port's solo ``generate``."""
    model, params = small_lm
    kw = ENGINE_KW[kind]
    jeng = jengine.InferenceEngine(_jax_model(), params,
                                   registry=jreg.MetricsRegistry(), **kw)
    teng = _engine(model, **kw)
    js = jsched.ContinuousBatchingScheduler(jeng, max_prefill_tokens=24)
    ts = ContinuousBatchingScheduler(teng, max_prefill_tokens=24)
    prompts, maxnew = _traffic()
    first = _solo(model, prompts[5], 11)
    eos = {5: first[4]}
    arrivals = {0: [0, 1, 2], 2: [3], 3: [4, 5]}
    jdone, tdone = [], []
    step = 0
    while step < 200 and (step <= max(arrivals) or js.has_work
                          or ts.has_work):
        for i in arrivals.get(step, []):
            js.submit(jsched.Request(i, prompts[i], maxnew[i],
                                     eos_id=eos.get(i)))
            ts.submit(Request(i, prompts[i], maxnew[i], eos_id=eos.get(i)))
        jd, td = js.step(), ts.step()
        assert [(c.request_id, list(c.tokens), c.finish_reason)
                for c in jd] == [(c.request_id, c.tokens, c.finish_reason)
                                 for c in td], f"step {step}"
        jdone += jd
        tdone += td
        assert sorted((s, f.req.request_id) for s, f in js._active.items()) \
            == sorted((s, f.req.request_id) for s, f in ts._active.items())
        np.testing.assert_array_equal(np.asarray(jeng._tables),
                                      teng._tables)
        np.testing.assert_array_equal(np.asarray(jeng._lengths),
                                      teng._lengths)
        assert jeng.blocks_free == teng.blocks_free
        assert jeng.blocks_resident == teng.blocks_resident
        assert teng.fsck() == []
        step += 1
    assert len(tdone) == 6
    for c in tdone:
        assert c.tokens == _solo(model, prompts[c.request_id],
                                 maxnew[c.request_id])[:len(c.tokens)]
    assert [c.finish_reason for c in tdone if c.request_id == 5] == ["eos"]
    jsnap, tsnap = jeng.registry.snapshot(), teng.registry.snapshot()
    assert sorted(k for k in jsnap if k.startswith("serve/")) == sorted(
        k for k in tsnap if k.startswith("serve/"))
    for key in jsnap:
        if key.startswith("serve/") and not key.endswith("_s"):
            assert jsnap[key] == tsnap[key], key
        elif key.endswith("/count"):
            assert jsnap[key] == tsnap[key], key
    assert jeng.compile_counts() == teng.compile_counts()
