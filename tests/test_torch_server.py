"""The port's serving server (``serving/server.py``) and the engine's
shipping seam, against solo ``generate`` and against the JAX package's
server (``tests/test_serving.py``'s server cases).

- Lifecycle and drain: every optional family attached (speculation, an
  SLO, the time-series writer, admission, a backpressure gate, a
  fleet-size file, a checkpoint follower that canaries and promotes a
  step written by the port's ``CheckpointManager``); each stream equals
  solo ``generate`` under its admitted weights token for token (sampled
  ones at ``request_seed(seed, request_id)``); the drain artifacts pass
  the schema lint, and the stats report covers every declared ``serve/``
  key but the disaggregation family, which the prefill report covers.
- Against the JAX package on bridged weights (its ``_small_lm``: vocab
  50, 2 layers, 2 heads, d_model 32, d_ff 64, f32): ``export_slot``'s
  pages leaf by leaf within 1e-5 (rtol and atol, the port's decode-cache
  parity; the JAX suite's own decode parity allows 1e-4), and greedy
  streams through the port's server, monolithic and disaggregated, equal
  to the JAX ``LMServer``'s token for token.
- Disaggregation: role pins (1, 0) / (0, 1), shipped sampled streams
  equal to monolithic and solo ones (the int64 seed schedule crosses the
  wire exactly), the fleet prefix index serving a second prefill engine.
- The file-queue replica (``python -m ...serving.server --device cpu``):
  answers its claims exactly once and drains on SIGTERM with exit 0.

The engines run on the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)
import torch_serving_run as runlib

from distributed_tensorflow_models_tpu.models import get_model as jget_model
from distributed_tensorflow_models_tpu.serving import engine as jengine
from distributed_tensorflow_models_tpu.serving import server as jserver
from distributed_tensorflow_models_tpu.telemetry import registry as jreg
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.harness.generate import generate
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    TransformerLM,
)
from distributed_tensorflow_models_tpu_torch.serving import server as srvlib
from distributed_tensorflow_models_tpu_torch.serving import shipping as shiplib
from distributed_tensorflow_models_tpu_torch.serving.engine import (
    InferenceEngine,
)
from distributed_tensorflow_models_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA_LINT = os.path.join(REPO, "scripts", "check_metrics_schema.py")
REGISTRY_PY = os.path.join(REPO, "distributed_tensorflow_models_tpu_torch",
                           "telemetry", "registry.py")
SMALL = dict(vocab_size=50, num_layers=2, num_heads=2, d_model=32, d_ff=64,
             max_len=64, dropout_rate=0.0)
# The export tolerance (rtol and atol): the port's decode-cache parity
# with the JAX decode model (tests/test_torch_generate.py).
PAGE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
           [10, 11, 12, 13, 14, 15, 16, 17, 18]]


def _lint(*args):
    return subprocess.run([sys.executable, SCHEMA_LINT, *map(str, args)],
                          capture_output=True, text=True)


def _solo(model, prompt, max_new, t=0.0, k=0, p=1.0, seed=None):
    out = generate(model, torch.as_tensor(np.asarray(prompt, np.int64))[None],
                   max_new, temperature=t, top_k=k, top_p=p, seed=seed)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("seed,rid", [(0, 0), (0, 1), (3, 7), (2**40, 5)])
def test_request_seed_is_deterministic_and_in_range(seed, rid):
    got = srvlib.request_seed(seed, rid)
    assert got == srvlib.request_seed(seed, rid)
    assert 0 <= got < 2**62
    assert got != srvlib.request_seed(seed, rid + 1)
    assert got != srvlib.request_seed(seed + 1, rid)


# -- lifecycle -------------------------------------------------------------


def test_server_lifecycle_and_drain_artifacts(tmp_path):
    run = runlib.serve_all_features(str(tmp_path))
    srv, done = run["server"], run["completions"]
    models = {0: run["model"], 3: run["candidate"]}
    assert {c.version for c in done.values()} <= {0, 3}
    for rid, comp in done.items():
        s = run["specs"][rid]
        seed = srvlib.request_seed(s["seed"], rid) if s["t"] else None
        assert comp.tokens == _solo(models[comp.version], s["prompt"],
                                    s["max_new"], s["t"], s["k"], seed=seed)
    with pytest.raises(srvlib.ServerDraining):
        srv.submit([1], 1)
    assert srv._engine.compile_counts() == (1, 2)  # speculation on
    stats = json.load(open(run["stats"]))
    m = stats["metrics"]
    assert m[reglib.SERVE_REQUESTS] == m[reglib.SERVE_COMPLETED] == 6.0
    assert m[f"{reglib.SERVE_SLO_BREACH}/ttft_s_p99"] == 0.0
    assert m[reglib.SERVE_SPEC_DRAFTED] > 0
    assert (m[reglib.SERVE_COMPILED_PREFILL],
            m[reglib.SERVE_COMPILED_DECODE]) == (1.0, 2.0)
    assert m[reglib.SERVE_DEPLOY_SWAPS] == 1.0
    assert m[reglib.SERVE_VERSION_ACTIVE] == 3.0
    assert stats["fsck_errors"] == []
    record = json.load(open(tmp_path / "flight_recorder_p0.json"))
    assert record["reason"] == "serve_drain"
    assert {"serve/prefill", "serve/decode", "serve/drain", "serve/req/queue",
            "serve/req/done"} <= {e["name"] for e in record["events"]}
    rows = [json.loads(line) for line in open(tmp_path / "deploy_events.jsonl")]
    assert [r["event"] for r in rows] == ["canary_start", "promote"]
    for name, flag in (("serving_stats_p0.json", "--serving-report"),
                       ("flight_recorder_p0.json", "--flight-recorder"),
                       ("timeseries_p0.jsonl", "--timeseries")):
        proc = _lint(tmp_path / name, flag)
        assert proc.returncode == 0, proc.stderr + proc.stdout
    proc = _lint(run["stats"], "--declared-coverage", REGISTRY_PY,
                 "--only-prefix", "serve/", "--allow-missing", "serve/ship",
                 "--allow-missing", "serve/fleet_prefix_")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "scoped to serve/" in proc.stdout


def test_bad_request_fails_its_handle_not_the_server(tmp_path):
    srv = srvlib.LMServer(runlib.drill_factory(), workdir=str(tmp_path))
    with pytest.raises(RuntimeError):
        srv.submit([1, 2], 2)  # not started
    srv.start()
    bad = srv.submit([5] * 100, 50)
    with pytest.raises(ValueError):
        bad.result(timeout=120)
    assert len(srv.submit([1], 3).result(timeout=120).tokens) == 3
    srv.drain()
    stats = json.load(open(tmp_path / "serving_stats_p0.json"))
    assert stats["metrics"][reglib.SERVE_COMPLETED] == 1.0


MODES = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 5, 1.0), (1.0, 0, 0.9),
         (0.7, 8, 0.85)]


@pytest.mark.parametrize("mode", MODES)
def test_sampled_streams_equal_solo_generate(tmp_path, mode):
    """By ``seed`` (the worker derives ``request_seed(seed, rid)``) and by
    an explicit ``rng``: each stream = ``generate(seed=...)``."""
    t, k, p = mode
    model = srvlib.drill_model(64)
    srv = srvlib.LMServer(runlib.drill_factory(), workdir=str(tmp_path))
    srv.start()
    by_seed = [srv.submit(pr, 7, temperature=t, top_k=k, top_p=p, seed=11)
               for pr in PROMPTS[:3]]
    by_rng = srv.submit(PROMPTS[3], 7, temperature=t, top_k=k, top_p=p,
                        rng=12345)
    for h, pr in zip(by_seed, PROMPTS):
        seed = srvlib.request_seed(11, h.request_id) if t else None
        assert h.result(timeout=120).tokens == _solo(model, pr, 7, t, k, p,
                                                     seed)
    assert by_rng.result(timeout=120).tokens == _solo(
        model, PROMPTS[3], 7, t, k, p, 12345 if t else None)
    srv.drain()


# -- against the JAX package on bridged weights ----------------------------


@pytest.fixture(scope="module")
def bridged():
    """``(jax model, numpy params, port model)``: ``_small_lm`` at key 0."""
    jm = jget_model("transformer_lm", **SMALL, dtype=jnp.float32,
                    attn_impl="reference")
    params = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]))
    tm = TransformerLM(**SMALL, dtype=torch.float32, attn_impl="reference")
    interop.load_flax_variables(tm, {"params": params})
    return jm, params, tm


def test_export_slot_pages_match_the_jax_engine(bridged):
    jm, params, tm = bridged
    prompt = np.asarray(PROMPTS[2], np.int32)
    kw = dict(max_slots=2, prefill_chunk=8, kv_page_tokens=4)
    jeng = jengine.InferenceEngine(jm, params, registry=jreg.MetricsRegistry(),
                                   **kw)
    eng = InferenceEngine(tm, device="cpu", registry=reglib.MetricsRegistry(),
                          **kw)
    jslot, _ = jeng.admit(0, prompt, 4)
    jfirst = jeng.prefill_batch(
        [(jslot, prompt, jeng.zero_keys(4)[0], 0.0, 0, 1.0)])[jslot]
    slot, _ = eng.admit(0, prompt, 4)
    first = eng.prefill_batch([(slot, prompt, 0, 0.0, 0, 1.0)])[slot]
    assert first == jfirst
    (jplen, jpages), (plen, pages) = jeng.export_slot(jslot), eng.export_slot(
        slot)
    assert plen == jplen == len(prompt)
    assert sorted(pages) == sorted(jpages)
    assert len(pages) == 2 * SMALL["num_layers"]
    for path, want in jpages.items():
        assert pages[path].shape == want.shape == (3, 4, 2, 16)
        assert pages[path].dtype == want.dtype
        np.testing.assert_allclose(pages[path], want, err_msg=path,
                                   **PAGE_TOL)
    # The engine's own round trip: pages shipped back into a fresh engine
    # are the exported bytes exactly.
    eng2 = InferenceEngine(tm, device="cpu", registry=reglib.MetricsRegistry(),
                           **kw)
    s2 = eng2.admit_shipped(1, plen, 4, pages)
    _, again = eng2.export_slot(s2)
    for path in pages:
        assert np.array_equal(again[path], pages[path])
    assert eng2.compile_counts() == (0, 0)


def _jax_greedy(jm, params, requests):
    srv = jserver.LMServer(
        lambda: jengine.InferenceEngine(jm, params, max_slots=4,
                                        prefill_chunk=8))
    srv.start()
    handles = [srv.submit(r["prompt"], r["max_new"], request_id=r["rid"])
               for r in requests]
    out = {h.request_id: list(h.result(timeout=300).tokens) for h in handles}
    srv.drain()
    return out


def test_greedy_streams_equal_the_jax_server(tmp_path, bridged):
    jm, params, tm = bridged
    requests = [dict(rid=i, prompt=pr, max_new=6 + i, t=0.0, k=0, seed=None)
                for i, pr in enumerate(PROMPTS)]
    want = _jax_greedy(jm, params, requests)
    mono = srvlib.LMServer(runlib.engine_factory(tm, max_slots=4,
                                                 prefill_chunk=8))
    mono.start()
    handles = [mono.submit(r["prompt"], r["max_new"], request_id=r["rid"])
               for r in requests]
    assert {h.request_id: h.result(timeout=120).tokens
            for h in handles} == want
    mono.drain()

    def factory(role):
        return runlib.engine_factory(tm, max_slots=4, prefill_chunk=8)

    run = runlib.serve_disaggregated(str(tmp_path), requests,
                                     factory=factory)
    assert {rid: c.tokens for rid, c in run["completions"].items()} == want


# -- disaggregation --------------------------------------------------------

REQUESTS = [dict(rid=i, prompt=pr, max_new=8, t=t, k=k, seed=i + 3)
            for i, (pr, (t, k, _)) in enumerate(zip(PROMPTS * 2, MODES * 2))]


def test_disaggregated_streams_pins_and_ship_keys(tmp_path):
    """Sampled and greedy streams shipped from a prefill replica to a
    decode one equal solo ``generate`` (the seed schedule rode the wire
    as uint32 halves); per-role pins (1, 0) / (0, 1); the ship family on
    both roles; the prefill report covers the disaggregation keys."""
    run = runlib.serve_disaggregated(str(tmp_path), REQUESTS)
    model = srvlib.drill_model(64)
    assert sorted(run["completions"]) == [r["rid"] for r in REQUESTS]
    for r in REQUESTS:
        seed = srvlib.request_seed(r["seed"], r["rid"]) if r["t"] else None
        assert run["completions"][r["rid"]].tokens == _solo(
            model, r["prompt"], r["max_new"], r["t"], r["k"], seed=seed)
    assert run["prefill"]._engine.compile_counts() == (1, 0)
    assert run["decode"]._engine.compile_counts() == (0, 1)
    pre = json.load(open(tmp_path / "serving_stats_p0.json"))
    dec = json.load(open(tmp_path / "serving_stats_p1.json"))
    assert pre["role"] == "prefill" and dec["role"] == "decode"
    assert pre["fsck_errors"] == dec["fsck_errors"] == []
    for stats in (pre, dec):
        assert stats["metrics"][reglib.SERVE_SHIP_REQUESTS] == len(REQUESTS)
        proc_args = [tmp_path / f"serving_stats_p{stats['process_index']}.json",
                     "--serving-report"]
        proc = _lint(*proc_args)
        assert proc.returncode == 0, proc.stderr + proc.stdout
    assert pre["metrics"][reglib.SERVE_SHIP_BYTES] == sum(
        run["sizes"].values()) == dec["metrics"][reglib.SERVE_SHIP_BYTES]
    proc = _lint(tmp_path / "serving_stats_p0.json", "--declared-coverage",
                 REGISTRY_PY, "--only-prefix", "serve/ship",
                 "--only-prefix", "serve/fleet_prefix_")
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_shipped_bundle_carries_the_seed_schedule_exactly(tmp_path):
    """The prefill side's bundle: ``__keydata__`` is uint32 ``[max_new,
    2]`` and rebuilds ``key_schedule``'s int64 seeds bit for bit."""
    from distributed_tensorflow_models_tpu_torch.harness.generate import (
        key_schedule,
    )

    handoff = str(tmp_path / "handoff")
    pre = srvlib.LMServer(runlib.drill_factory("prefill"), role="prefill",
                          handoff_dir=handoff, workdir=str(tmp_path))
    pre.start()
    h = pre.submit(PROMPTS[0], 9, temperature=0.9, seed=4, request_id=21)
    assert h.result(timeout=120).finish_reason == "shipped"
    pre.drain()
    _, meta, leaves = shiplib.claim_bundle(handoff, 1)
    kd = leaves["__keydata__"]
    assert kd.dtype == np.uint32 and kd.shape == (9, 2)
    assert shiplib.seeds_from_wire(kd).tolist() == key_schedule(
        srvlib.request_seed(4, 21), 9)
    assert meta["request_id"] == 21 and meta["prompt_len"] == 5


def test_fleet_prefix_index_serves_a_second_prefill_engine(tmp_path):
    """Engine A prefills a prompt and advertises its full pages; engine B
    (another replica's) adopts them from the index: fleet hits counted,
    the adopted pages equal A's bit for bit, and B's stream equals solo
    ``generate``."""
    model = srvlib.drill_model(64)
    fleet = str(tmp_path / "fleet")
    shared = list(range(1, 17))
    engines = []
    for name in ("a", "b"):
        idx = shiplib.FleetPrefixIndex(fleet, 4)
        engines.append(InferenceEngine(
            model, device="cpu", max_slots=2, prefill_chunk=8,
            kv_page_tokens=4, fleet_cache=idx,
            registry=reglib.MetricsRegistry()))
    a, b = engines
    sched = ContinuousBatchingScheduler(a, registry=a.registry)
    sched.submit(Request(0, np.asarray(shared + [20, 21], np.int32), 4))
    while sched.has_work:
        sched.step()
    assert shiplib.FleetPrefixIndex(fleet, 4).entry_count() == 4
    prompt = shared + [30, 31, 32]
    sched = ContinuousBatchingScheduler(b, registry=b.registry)
    sched.submit(Request(1, np.asarray(prompt, np.int32), 6))
    done = []
    while sched.has_work:
        done += sched.step()
    snap = b.registry.snapshot()
    assert snap[reglib.SERVE_FLEET_PREFIX_HITS] == 4
    assert snap[reglib.SERVE_PREFIX_CACHE_HITS] == 4
    assert done[0].tokens == _solo(model, prompt, 6)
    with pytest.raises(ValueError, match="prefix_cache"):
        InferenceEngine(model, device="cpu", prefix_cache=False,
                        fleet_cache=shiplib.FleetPrefixIndex(fleet, 4))


def test_admit_shipped_rejects_pages_of_the_wrong_shape_or_dtype():
    model = srvlib.drill_model(64)
    eng = InferenceEngine(model, device="cpu", max_slots=2, prefill_chunk=8,
                          registry=reglib.MetricsRegistry())
    good = {f"blocks_{i}/attn/cached_{kv}": np.zeros((1, 8, 2, 16),
                                                     np.float32)
            for i in range(2) for kv in ("key", "value")}
    with pytest.raises(ValueError, match="does not cover"):
        eng.admit_shipped(0, 9, 4, good)
    half = {k: v.astype(np.float16) for k, v in good.items()}
    with pytest.raises(ValueError, match="pool holds float32"):
        eng.admit_shipped(0, 5, 4, half)
    assert eng.blocks_free == eng.num_blocks - 1  # nothing leaked
    with pytest.raises(ValueError, match="missing pool leaf"):
        eng.admit_shipped(0, 5, 4, {"blocks_0/attn/cached_key":
                                    good["blocks_0/attn/cached_key"]})


# -- the file-queue replica ------------------------------------------------


def test_file_queue_replica_answers_once_and_drains_on_sigterm(tmp_path):
    """One replica (``--max-slots 1``: at most two claims outstanding)
    self-delivers SIGTERM after two answers: it answers what it claimed,
    exits 0, and leaves the rest on the queue; every answer equals solo
    ``generate``."""
    from distributed_tensorflow_models_tpu_torch.serving import (
        replay as replaylib,
    )

    queue = tmp_path / "queue"
    queue.mkdir()
    reqs = replaylib.mixed_mix(6, seed=3, sample_every=2, long_len=20)
    for r in reqs:
        replaylib.write_request(str(queue), r)
    (queue / "DONE").write_text("")
    env = {**os.environ, "PYTHONPATH": REPO, "DTM_PROCESS_ID": "0"}
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_models_tpu_torch.serving.server",
         "--queue-dir", str(queue), "--workdir", str(tmp_path / "wd"),
         "--device", "cpu", "--max-slots", "1", "--self-sigterm-after", "2",
         "--sigterm-replica", "0", "--timeout", "120"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "self-delivering SIGTERM" in proc.stderr
    answered = sorted(int(n[4:-5]) for n in os.listdir(queue / "resp"))
    left = sorted(int(n[4:-5]) for n in os.listdir(queue)
                  if n.startswith("req-"))
    claimed = sorted(int(n.split(".")[0][4:])
                     for n in os.listdir(queue / "claimed"))
    assert answered == claimed and 2 <= len(answered) < len(reqs)
    assert sorted(answered + left) == [r.request_id for r in reqs]
    model = srvlib.drill_model(64)
    for r in reqs:
        if r.request_id not in answered:
            continue
        resp = json.load(open(queue / "resp" / f"req-{r.request_id}.json"))
        seed = (srvlib.request_seed(r.seed, r.request_id)
                if r.temperature > 0 else None)
        assert resp["tokens"] == _solo(model, r.prompt, r.max_new_tokens,
                                       r.temperature, r.top_k, r.top_p,
                                       seed)
        assert resp["replica"] == 0 and resp["version"] == 0
    record = json.load(open(tmp_path / "wd" / "flight_recorder_p0.json"))
    assert record["reason"] == "serve_drain"
