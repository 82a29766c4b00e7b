"""Served traffic through the port's server on the CPU, for the port's
tests.

- :func:`drill_args` / :func:`drill_factory` — the replica's engine
  (``serving/server.py::_drill_engine_factory``: the drill model, seed-0
  weights) with the command line's defaults, on the CPU.
- :func:`write_step` — a step of a model's weights (perturbed from a seed,
  or poisoned with NaN) written by the port's ``CheckpointManager``: what
  a trainer leaves for ``serving/deploy.py``'s follower.
- :func:`serve_all_features` — a monolithic ``LMServer`` with every
  optional family attached (speculation, an SLO, the time-series writer,
  admission, a backpressure gate, a fleet-size file and a checkpoint
  follower that canaries a step): its stats report carries every
  ``serve/`` key but the disaggregation family.
- :func:`serve_disaggregated` — a prefill-role and a decode-role server
  exchanging handoff bundles: the prefill report carries that family.

Each call runs its own servers: no test reads another's artifacts.
"""

from __future__ import annotations

import copy
import os
import types

import torch

from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.harness.checkpoint import (
    CheckpointManager,
)
from distributed_tensorflow_models_tpu_torch.ops import optim
from distributed_tensorflow_models_tpu_torch.serving import admission as admlib
from distributed_tensorflow_models_tpu_torch.serving import server as srvlib
from distributed_tensorflow_models_tpu_torch.serving import shipping as shiplib
from distributed_tensorflow_models_tpu_torch.serving.engine import (
    InferenceEngine,
)
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

# The replica command line's engine defaults (serving/server.py::main).
DRILL_DEFAULTS = dict(
    max_slots=4, prefill_chunk=8, decode_burst=1, prefill_lanes=1,
    kv_page_tokens=None, kv_pool_blocks=None, prefix_cache="on",
    prefix_cache_blocks=None, spec_tokens=0, spec_ngram_order=3,
    spec_min_match=1, max_len=64, fleet_cache_dir=None,
    fleet_cache_entries=None, stall_prefill_ms=0.0, stall_version=None,
    stall_canary_ms=0.0, device="cpu",
)
# Repetitive prompts: the n-gram drafter proposes on them.
REPETITIVE = [[5, 6, 5, 6, 5, 6, 5], [9, 9, 9, 9, 9, 9], [3, 4, 7, 3, 4, 7, 3]]


def drill_args(**kw) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{**DRILL_DEFAULTS, **kw})


def drill_factory(role: str = "monolithic", **kw):
    return srvlib._drill_engine_factory(drill_args(**kw), role)


def engine_factory(model, **kw):
    """An ``LMServer`` factory of an engine over ``model`` on the CPU."""
    return lambda: InferenceEngine(model, device="cpu", **kw)


def perturbed(model, seed: int, scale: float = 0.05):
    """A copy of ``model`` whose parameters moved by ``scale`` x normal
    noise drawn from ``seed`` on the CPU."""
    out = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen).to(p.dtype))
    return out


def write_step(workdir: str, model, step: int, *, poison: bool = False) -> str:
    """Write ``model``'s parameters (NaN everywhere with ``poison``) as
    step ``step`` of ``<workdir>/checkpoints`` through the port's
    ``CheckpointManager``; returns that checkpoint directory."""
    m = copy.deepcopy(model)
    if poison:
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(float("nan"))
    state = TrainState.create(m, optim.sgd(0.1)).replace(step=step)
    mgr = CheckpointManager(workdir, keep=10,
                            registry=reglib.MetricsRegistry())
    mgr.save(state)
    mgr.wait()
    return os.path.join(workdir, "checkpoints")


def serve_all_features(workdir: str, n_requests: int = 6) -> dict:
    """A monolithic server on the drill engine with speculation (2 draft
    tokens), an SLO, the time-series writer, admission, a backpressure
    gate out of reach, a fleet-size file and a follower of a checkpoint
    directory holding step 3 (perturbed weights), canaried on half the
    traffic and promoted after two clean evaluations.  Returns the
    server (drained), its completions by request id, the request specs,
    the checkpointed model and the paths."""
    model = srvlib.drill_model(64)
    ckpt = write_step(os.path.join(workdir, "trainer"),
                      perturbed(model, 1), 3)
    fleet_file = os.path.join(workdir, "fleet_size.json")
    with open(fleet_file, "w") as f:
        f.write('{"size": 1}')
    srv = srvlib.LMServer(
        drill_factory(spec_tokens=2), workdir=workdir, process_index=0,
        slo_specs=["serve/ttft_s:p99<60@60s"], timeseries_interval_s=0.01,
        admission=admlib.AdmissionPolicy(),
        backpressure=admlib.BackpressureGate(
            engage_queue_depth=10_000, release_queue_depth=100),
        fleet_file=fleet_file, follow_checkpoints=ckpt, follow_poll_s=0.0,
        canary_fraction=0.5, canary_warmup=0, promote_after=2,
    )
    srv.start()
    srv.poll_fleet()
    specs = []
    for i in range(n_requests):
        prompt = REPETITIVE[i % len(REPETITIVE)] + [1 + i]
        t = 0.7 if i % 2 else 0.0
        specs.append(dict(prompt=prompt, max_new=8, t=t, k=5 if t else 0,
                          seed=i))
    handles = [srv.submit(s["prompt"], s["max_new"], temperature=s["t"],
                          top_k=s["k"], seed=s["seed"]) for s in specs]
    done = {h.request_id: h.result(timeout=300) for h in handles}
    srv.drain()
    return dict(server=srv, completions=done,
                specs=dict(zip([h.request_id for h in handles], specs)),
                candidate=perturbed(model, 1), model=model, ckpt=ckpt,
                stats=os.path.join(workdir, "serving_stats_p0.json"))


def serve_disaggregated(workdir: str, requests: list, *, factory=None,
                        fleet_cache_dir=None) -> dict:
    """``requests`` (``dict(prompt, max_new, t, k, seed, rid)``) through a
    prefill-role server (process 0) whose bundles a decode-role server
    (process 1) claims from ``<workdir>/handoff``.  ``factory(role)``
    builds each engine (default: the drill engine).  Returns ``{rid:
    completion}`` from the decode side, both servers and the bundles'
    byte sizes."""
    handoff = os.path.join(workdir, "handoff")
    if factory is None:
        def factory(role):
            return drill_factory(role, fleet_cache_dir=fleet_cache_dir)
    pre = srvlib.LMServer(factory("prefill"), role="prefill",
                          handoff_dir=handoff, workdir=workdir,
                          process_index=0)
    dec = srvlib.LMServer(factory("decode"), role="decode", workdir=workdir,
                          process_index=1)
    pre.start()
    dec.start()
    shipped = [pre.submit(r["prompt"], r["max_new"], temperature=r["t"],
                          top_k=r["k"], seed=r["seed"],
                          request_id=r["rid"]) for r in requests]
    for h in shipped:
        assert h.result(timeout=300).finish_reason == "shipped"
    handles, sizes = [], {}
    while True:
        got = shiplib.claim_bundle(handoff, 1)
        if got is None:
            break
        name, meta, leaves = got
        meta["wire_bytes"] = sizes[meta["request_id"]] = os.path.getsize(
            os.path.join(handoff, shiplib.CLAIMED_DIR, f"{name}.p1"))
        handles.append(dec.submit_shipped(meta, leaves))
    done = {h.request_id: h.result(timeout=300) for h in handles}
    pre.drain()
    dec.drain()
    return dict(completions=done, prefill=pre, decode=dec, sizes=sizes)
