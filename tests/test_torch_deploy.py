"""The port's continuous deployment (``serving/deploy.py``) against the
JAX package's, on checkpoints the port's ``CheckpointManager`` writes.

- The canary controller's verdicts, the rid-hash routing, tree signatures
  and their diffs, the finiteness check and the journal equal the JAX
  module's on the same inputs (exact: host logic).
- The gate reads the port's checkpoint layout (``<step>/state.pt``'s
  ``params/<name>`` tensors, ``resilience/fsck.py``): a torn step and a
  step missing fleet sidecars are structural rejects, NaN weights and a
  signature drift are final rejects, a good step returns the ``{name:
  tensor}`` mapping ``engine.install_canary`` takes, bit for bit the
  saved weights.
- A weight swap at a burst boundary keeps an in-flight stream equal to a
  solo run under its admitted weights and builds no program:
  ``compile_counts()`` is unchanged across install, promote and rollback
  (the JAX pin "restored params do not retrace").
- Resident prefix pages serve only requests of the weight version that
  computed them (the JAX engine shares them across versions: F9).
- ``CheckpointFollower`` end to end: promote, rollback, NaN reject, torn
  step retried then rejected, with the JAX suite's journal rows and
  counters.

The engine runs on the CPU; streams are compared token for token.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)
import torch_serving_run as runlib

from distributed_tensorflow_models_tpu.serving import deploy as jdeploy
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    TransformerLM,
)
from distributed_tensorflow_models_tpu_torch.serving import deploy as deploylib
from distributed_tensorflow_models_tpu_torch.serving import (
    scheduler as schedlib,
)
from distributed_tensorflow_models_tpu_torch.serving.engine import (
    InferenceEngine,
)
from distributed_tensorflow_models_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

DEPLOY_LM = dict(vocab_size=32, num_layers=1, num_heads=2, d_model=16,
                 d_ff=32, max_len=32, dropout_rate=0.0)
PROMPT = np.asarray([5, 9, 2, 11, 3], np.int32)


def _model(seed, **kw):
    return TransformerLM(**{**DEPLOY_LM, **kw}, dtype=torch.float32,
                         attn_impl="reference",
                         generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def deploy_lm():
    """Two models of one shape: weights from seeds 0 and 1."""
    return _model(0), _model(1)


# -- CanaryController ------------------------------------------------------

CONTROLLER = {
    "promote_after_warmup": (dict(warmup=3, promote_after=2,
                                  rollback_after=2),
                             [(0, False), (2, False), (3, False),
                              (5, False)]),
    "breach_in_warmup": (dict(warmup=100, promote_after=2, rollback_after=2),
                         [(1, True), (2, True)]),
    "no_flap": (dict(warmup=0, promote_after=2, rollback_after=2),
                [(50, False), (50, True)] * 10),
    "promote_latches": (dict(warmup=0, promote_after=1, rollback_after=1),
                        [(1, False), (99, True), (99, False), (99, True)]),
    "rollback_latches": (dict(warmup=0, promote_after=1, rollback_after=1),
                         [(1, True), (99, False)]),
}


@pytest.mark.parametrize("name", sorted(CONTROLLER))
def test_canary_controller_equals_the_jax_controller(name):
    kw, script = CONTROLLER[name]
    traces = []
    for lib in (deploylib, jdeploy):
        ctl = lib.CanaryController(**kw)
        traces.append([(ctl.observe(samples=s, breached=b), ctl.state)
                       for s, b in script])
    assert traces[0] == traces[1]
    verdicts = [v for v, _ in traces[0] if v]
    assert verdicts == {"promote_after_warmup": ["promote"],
                        "breach_in_warmup": ["rollback"], "no_flap": [],
                        "promote_latches": ["promote"],
                        "rollback_latches": ["rollback"]}[name]


@pytest.mark.parametrize("kw", [dict(warmup=-1), dict(promote_after=0),
                                dict(rollback_after=0)])
def test_canary_controller_ctor_validation(kw):
    for lib in (deploylib, jdeploy):
        with pytest.raises(ValueError):
            lib.CanaryController(**kw)


# -- routing ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_rid_routing_equals_the_jax_router(seed):
    rids = [str(i) for i in range(4000)]
    fracs = [deploylib.rid_fraction(seed, r) for r in rids]
    assert fracs == [jdeploy.rid_fraction(seed, r) for r in rids]
    assert fracs != [deploylib.rid_fraction(seed + 1, r) for r in rids]
    routed = [deploylib.route_version(seed, r, 0.25, 10, 20) for r in rids]
    assert routed == [jdeploy.route_version(seed, r, 0.25, 10, 20)
                      for r in rids]
    assert abs(routed.count(20) / len(rids) - 0.25) < 0.03


def test_route_version_edges():
    assert deploylib.route_version(0, "r", 1.0, 10, None) == 10
    for rid in ("a", "b", "c"):
        assert deploylib.route_version(0, rid, 0.0, 10, 20) == 10
        assert deploylib.route_version(0, rid, 1.0, 10, 20) == 20


# -- signatures, finiteness, journal ---------------------------------------


def test_tree_signature_and_diff_equal_the_jax_module():
    a = {"w": np.zeros((2, 3), np.float32), "b": {"v": np.ones(4, np.int32)}}
    drift = {"w": np.zeros((2, 4), np.float32),
             "b": {"v": np.ones(4, np.int32)}}
    for tree in (a, drift, {"w": np.zeros((2, 3), np.float32)}):
        assert deploylib.tree_signature(tree) == jdeploy.tree_signature(tree)
    sig = deploylib.tree_signature(a)
    for other in (drift, {"w": np.zeros((2, 3), np.float32)}, a):
        got = deploylib.signature_diff(sig, deploylib.tree_signature(other))
        assert got == jdeploy.signature_diff(sig,
                                             jdeploy.tree_signature(other))
    assert any("(2, 3)" in m and "(2, 4)" in m for m in
               deploylib.signature_diff(sig,
                                        deploylib.tree_signature(drift)))


def test_tree_signature_of_a_checkpoint_equals_the_engines(tmp_path,
                                                           deploy_lm):
    model, other = deploy_lm
    eng = InferenceEngine(model, device="cpu",
                          registry=reglib.MetricsRegistry())
    ckpt = runlib.write_step(str(tmp_path), other, 2)
    params = deploylib.load_candidate_params(os.path.join(ckpt, "2"))
    sig = deploylib.tree_signature(params)
    assert sig == deploylib.tree_signature(eng.params)
    assert ("/head.kernel", (16, 32), "torch.float32") in sig
    wide = deploylib.tree_signature(dict(_model(0, d_ff=64)
                                         .named_parameters()))
    assert deploylib.signature_diff(sig, wide)


def test_check_finite_flags_nan_and_inf_paths():
    bad = {"a": np.array([1.0, np.nan], np.float32),
           "b": {"c": np.array([np.inf], np.float32)}, "n": np.arange(3)}
    assert deploylib.check_finite(bad) == jdeploy.check_finite(bad)
    assert len(deploylib.check_finite(bad)) == 2
    tensors = {"w": torch.ones(2, 2), "x": torch.tensor([1.0, float("inf")]),
               "h": torch.tensor([float("nan")], dtype=torch.bfloat16),
               "i": torch.arange(3)}
    assert deploylib.check_finite(tensors) == ["/h", "/x"]
    assert deploylib.check_finite({"w": torch.ones(3)}) == []


def test_deploy_events_roundtrip_across_packages(tmp_path):
    wd = str(tmp_path)
    deploylib.append_deploy_event(
        wd, {"ts_wall": 1.0, "proc": 0, "event": "canary_start", "step": 4})
    jdeploy.append_deploy_event(
        wd, {"ts_wall": 2.0, "proc": 1, "event": "promote", "step": 4})
    with open(deploylib.deploy_events_path(wd), "a") as f:
        f.write(json.dumps({"note": "not a deploy event"}) + "\n")
        f.write('{"ts_wall": 3.0, "event": "rollb')
    rows = deploylib.load_deploy_events(wd)
    assert rows == jdeploy.load_deploy_events(wd)
    assert [r["event"] for r in rows] == ["canary_start", "promote"]
    assert deploylib.load_deploy_events(str(tmp_path / "nowhere")) == []


# -- the gate on the port's checkpoints ------------------------------------


def test_gate_candidate_rejects_a_torn_step_as_structural(tmp_path,
                                                          deploy_lm):
    ckpt = runlib.write_step(str(tmp_path), deploy_lm[1], 3)
    state = os.path.join(ckpt, "3", "state.pt")
    with open(state, "r+b") as f:
        f.truncate(os.path.getsize(state) // 2)
    params, reasons, structural = deploylib.gate_candidate(ckpt, 3)
    assert params is None and structural
    assert any(r.startswith("fsck:") and "state.pt" in r for r in reasons)
    params, reasons, structural = deploylib.gate_candidate(ckpt, 99)
    assert params is None and structural
    assert any("missing step directory" in r for r in reasons)


def test_gate_candidate_rejects_incomplete_fleet_sidecars(tmp_path,
                                                          deploy_lm):
    ckpt = runlib.write_step(str(tmp_path), deploy_lm[1], 5)
    side = os.path.join(ckpt, "dataset_states", "5")
    os.makedirs(side)
    with open(os.path.join(side, "p0.json"), "w") as f:
        json.dump({"nproc": 2, "state": {}}, f)
    params, reasons, structural = deploylib.gate_candidate(
        ckpt, 5, process_count=2)
    assert params is None and structural
    assert any("not fleet-valid" in r for r in reasons)
    # One process leaves no sidecars: the step passes by itself.
    params, reasons, _ = deploylib.gate_candidate(ckpt, 5, process_count=1)
    assert reasons == [] and params is not None


def test_gate_candidate_semantic_rejects_and_accepts(tmp_path, deploy_lm):
    model, other = deploy_lm
    expected = deploylib.tree_signature(dict(model.named_parameters()))
    ckpt = runlib.write_step(str(tmp_path), other, 2)
    params, reasons, structural = deploylib.gate_candidate(
        ckpt, 2, expected_signature=expected)
    assert reasons == [] and not structural
    assert deploylib.tree_signature(params) == expected
    for name, t in other.named_parameters():
        assert torch.equal(params[name], t.detach())
    runlib.write_step(str(tmp_path), other, 4, poison=True)
    params, reasons, structural = deploylib.gate_candidate(
        ckpt, 4, expected_signature=expected)
    assert params is None and not structural
    assert any(r.startswith("non-finite leaves:") for r in reasons)
    runlib.write_step(str(tmp_path), _model(3, d_ff=64), 6)
    params, reasons, structural = deploylib.gate_candidate(
        ckpt, 6, expected_signature=expected)
    assert params is None and not structural
    assert any(r.startswith("avals:") for r in reasons)


# -- the swap at a burst boundary ------------------------------------------


def _engine(model):
    return InferenceEngine(model, device="cpu", max_slots=2, prefill_chunk=8,
                           registry=reglib.MetricsRegistry())


def _drain(sched):
    out = {}
    while sched.has_work:
        for comp in sched.step():
            out[comp.request_id] = comp
    return out


def _solo(model):
    sched = ContinuousBatchingScheduler(_engine(model))
    sched.submit(Request(request_id=0, prompt=PROMPT, max_new_tokens=10))
    return _drain(sched)[0].tokens


def test_hot_swap_mid_stream_byte_identity_and_capture_pins(deploy_lm):
    model, other = deploy_lm
    ref_a, ref_b = _solo(model), _solo(other)
    assert list(ref_a) != list(ref_b)
    eng = _engine(model)
    sched = ContinuousBatchingScheduler(eng, registry=eng.registry)
    sched.submit(Request(request_id=1, prompt=PROMPT, max_new_tokens=10))
    for _ in range(4):
        sched.step()
    pins = eng.compile_counts()
    assert pins == (1, 1)
    eng.install_canary(7, other)
    eng.promote_canary()
    assert eng.version == 7 and eng.canary_version is None
    sched.submit(Request(request_id=2, prompt=PROMPT, max_new_tokens=10))
    done = _drain(sched)
    assert done[1].version == 0 and done[2].version == 7
    assert list(done[1].tokens) == list(ref_a)
    assert list(done[2].tokens) == list(ref_b)
    assert eng.compile_counts() == pins
    with pytest.raises(ValueError):
        eng.install_canary(7, other)
    eng.install_canary(8, other)
    with pytest.raises(ValueError):
        eng.install_canary(9, model)
    eng.rollback_canary()
    assert eng.version == 7 and eng.compile_counts() == pins


def test_install_canary_from_a_checkpoint_keeps_capture_counts(tmp_path,
                                                               deploy_lm):
    model, other = deploy_lm
    ckpt = runlib.write_step(str(tmp_path), other, 2)
    restored, reasons, _ = deploylib.gate_candidate(
        ckpt, 2, expected_signature=deploylib.tree_signature(
            dict(model.named_parameters())))
    assert reasons == []
    eng = _engine(model)
    sched = ContinuousBatchingScheduler(eng, registry=eng.registry)
    sched.submit(Request(request_id=0, prompt=PROMPT, max_new_tokens=6))
    _drain(sched)
    pins = eng.compile_counts()
    eng.install_canary(2, restored)
    eng.promote_canary()
    sched.submit(Request(request_id=1, prompt=PROMPT, max_new_tokens=10))
    done = _drain(sched)
    assert done[1].version == 2
    assert list(done[1].tokens) == list(_solo(other))
    assert eng.compile_counts() == pins


def test_prefix_pages_are_not_shared_across_weight_versions(deploy_lm):
    """A 13-token prompt (3 full pages of 4) served under v0, then again
    under v7 after a promotion: the port reuses no v0 page for the v7
    request, whose stream equals solo under v7.  The JAX engine reuses
    all three pages and serves another stream (ROADMAP §3, F9): its
    request under v7 is not solo under v7."""
    import jax.numpy as jnp

    from distributed_tensorflow_models_tpu import models as jmodels
    from distributed_tensorflow_models_tpu.serving import engine as jengine
    from distributed_tensorflow_models_tpu.serving import scheduler as jsched
    from distributed_tensorflow_models_tpu.telemetry import registry as jreg
    from distributed_tensorflow_models_tpu_torch import interop

    model, other = deploy_lm
    prompt = np.asarray([5, 9, 2, 11, 3, 7, 1, 4, 6, 8, 10, 12, 13], np.int32)

    def run(eng, sched_mod, request, install):
        sched = sched_mod.ContinuousBatchingScheduler(eng,
                                                      registry=eng.registry)
        sched.submit(request(1, prompt, 8))
        _drain(sched)
        install(eng)
        sched.submit(request(2, prompt, 8))
        done = _drain(sched)[2]
        hits = eng.registry.snapshot().get(reglib.SERVE_PREFIX_CACHE_HITS, 0)
        return done.version, list(done.tokens), hits

    def solo(m):
        e = InferenceEngine(m, device="cpu", max_slots=2, prefill_chunk=8,
                            kv_page_tokens=4, registry=reglib.MetricsRegistry())
        s = ContinuousBatchingScheduler(e, registry=e.registry)
        s.submit(Request(0, prompt, 8))
        return list(_drain(s)[0].tokens)

    def install(params):
        def go(eng):
            eng.install_canary(7, params)
            eng.promote_canary()
        return go

    eng = InferenceEngine(model, device="cpu", max_slots=2, prefill_chunk=8,
                          kv_page_tokens=4, registry=reglib.MetricsRegistry())
    version, tokens, hits = run(eng, schedlib, Request, install(other))
    assert version == 7 and hits == 0
    assert tokens == solo(other) != solo(model)
    jm = jmodels.get_model("transformer_lm", **DEPLOY_LM, dtype=jnp.float32,
                           attn_impl="reference")
    pa, pb = (interop.to_flax_variables(m)["params"] for m in (model, other))
    jeng = jengine.InferenceEngine(jm, pa, max_slots=2, prefill_chunk=8,
                                   kv_page_tokens=4,
                                   registry=jreg.MetricsRegistry())
    jversion, jtokens, jhits = run(jeng, jsched, jsched.Request,
                                   install(pb))
    assert jversion == 7 and jhits == 3
    assert jtokens != tokens


# -- CheckpointFollower ----------------------------------------------------


def _follower(tmp_path, model, **kw):
    eng = _engine(model)
    wd = str(tmp_path / "serve")
    os.makedirs(wd)
    reg = reglib.MetricsRegistry()
    kw.setdefault("poll_interval_s", 0.0)
    fol = deploylib.CheckpointFollower(
        str(tmp_path / "trainer" / "checkpoints"), eng, workdir=wd,
        registry=reg, **kw)
    return eng, fol, reg, wd


def test_follower_promotes_healthy_candidate(tmp_path, deploy_lm):
    model, other = deploy_lm
    eng, fol, reg, wd = _follower(
        tmp_path, model, canary_fraction=0.5, canary_warmup=1,
        promote_after=1, rollback_after=1,
        slo_specs=["serve/ttft_s:p50<1.0@60s"])
    assert fol.poll(1.0, 100.0) == []
    runlib.write_step(str(tmp_path / "trainer"), other, 3)
    rows = fol.poll(2.0, 101.0)
    assert [r["event"] for r in rows] == ["canary_start"]
    assert fol.canary_vid == 3 and eng.canary_version == 3
    assert reg.gauge(reglib.SERVE_VERSION_CANARY).value == 3
    assert {fol.route(str(i)) for i in range(64)} == {0, 3}
    fol.observe_sample(3, reglib.SERVE_TTFT, 0.05, 2.5)
    rows = fol.poll(3.0, 102.0)
    assert [r["event"] for r in rows] == ["promote"]
    assert eng.version == 3 and eng.canary_version is None
    assert reg.counter(reglib.SERVE_DEPLOY_SWAPS).value == 1
    assert reg.gauge(reglib.SERVE_VERSION_ACTIVE).value == 3
    assert reg.gauge(reglib.SERVE_VERSION_CANARY).value == (
        deploylib.NO_CANARY)
    events = deploylib.load_deploy_events(wd)
    assert [e["event"] for e in events] == ["canary_start", "promote"]
    assert events[1]["step"] == 3 and events[1]["from_version"] == 0
    for name, t in other.named_parameters():
        assert torch.equal(eng.params[name], t.detach())


def test_follower_rolls_back_breaching_candidate_and_rejects_nan(
        tmp_path, deploy_lm):
    model, other = deploy_lm
    eng, fol, reg, wd = _follower(
        tmp_path, model, canary_warmup=1, promote_after=1, rollback_after=1,
        reject_after_polls=2, slo_specs=["serve/ttft_s:p50<0.1@60s"])
    runlib.write_step(str(tmp_path / "trainer"), model, 2, poison=True)
    rows = fol.poll(1.0, 100.0)
    assert [r["event"] for r in rows] == ["reject"] and rows[0]["step"] == 2
    assert any("non-finite" in r for r in rows[0]["reasons"])
    assert eng.canary_version is None and eng.version == 0
    assert reg.counter(reglib.SERVE_DEPLOY_REJECTED).value == 1
    assert [f for f in os.listdir(wd) if f.startswith("flight_deploy_")]
    runlib.write_step(str(tmp_path / "trainer"), other, 5)
    rows = fol.poll(2.0, 101.0)
    assert [r["event"] for r in rows] == ["canary_start"]
    fol.observe_sample(5, reglib.SERVE_TTFT, 3.0, 2.5)
    rows = fol.poll(3.0, 102.0)
    assert [r["event"] for r in rows] == ["rollback"]
    assert rows[0]["keep_version"] == 0 and rows[0]["breached"]
    assert eng.version == 0 and eng.canary_version is None
    assert reg.counter(reglib.SERVE_DEPLOY_ROLLBACKS).value == 1
    assert fol.poll(4.0, 103.0) == []
    assert [e["event"] for e in deploylib.load_deploy_events(wd)] == [
        "reject", "canary_start", "rollback"]


def test_follower_retries_torn_step_then_rejects(tmp_path, deploy_lm):
    eng, fol, _, _ = _follower(tmp_path, deploy_lm[0], reject_after_polls=3)
    ckpt = runlib.write_step(str(tmp_path / "trainer"), deploy_lm[1], 4)
    os.remove(os.path.join(ckpt, "4", "COMMITTED"))
    assert fol.poll(1.0, 100.0) == []
    assert fol.poll(2.0, 101.0) == []
    rows = fol.poll(3.0, 102.0)
    assert [r["event"] for r in rows] == ["reject"]
    assert any(r.startswith("fsck:") for r in rows[0]["reasons"])
    assert eng.canary_version is None
    assert fol.poll(4.0, 103.0) == []
