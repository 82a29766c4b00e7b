"""Deterministic open-loop request replayer for serving drills and benches.

Lifts the request mixes that ``bench.py`` previously built inline
(mixed long-prefill/short-decode traffic, shared-prefix traffic with a
common system prompt, and a uniform control mix) into one reusable
module, and adds the piece the disaggregated drill needs: **open-loop
arrivals**.  A closed-loop driver (write every request up front, let
replicas drain the queue) hides interference — prefill of a long
prompt stalls decode steps only when the two actually overlap, which
requires requests to *arrive over time*.  The replayer assigns each
request a deterministic arrival offset (seeded exponential
inter-arrival gaps) and paces emission against ``time.perf_counter``.

The overload tier builds on the same machinery:

- :data:`TRACE_PRESETS` / :func:`preset_trace` name the canonical
  request mixes (shared-prefix, long-context, interference, uniform)
  with ONE parameterization shared by ``bench.py`` and the drills;
- :func:`bursty_arrivals` (spike/lull phase switching) and
  :func:`diurnal_arrivals` (compressed day curve) generate the
  non-stationary arrival processes the admission/autoscale tier is
  tested against — still seeded, still exponential within a phase;
- :func:`replay` returns a :class:`ReplayReport` with the
  offered-vs-achieved pacing error, so an overloaded generator can't
  silently under-offer and pass a load test it never ran.

Determinism contract (this module is in the dtm-lint determinism
scope, and the drill parent imports it without torch):

- every token of every prompt and every arrival offset is derived from
  an explicit seed through ``random.Random`` instances — replaying the
  same (mix, seed) yields byte-identical request specs and offsets;
- the replay-critical path never reads a wall clock: pacing uses
  ``time.perf_counter`` (the allowlisted monotonic timer) only, and
  the emitted specs carry no timestamps — timing enters the system
  when the serving replica *admits* the request, not here;
- module-level imports are stdlib-only, so the drill/bench parent
  stays torch-free.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from random import Random
from typing import Callable, Iterable, List, Optional

__all__ = [
    "ReplayRequest",
    "ReplayReport",
    "uniform_mix",
    "mixed_mix",
    "shared_prefix_mix",
    "TRACE_PRESETS",
    "preset_params",
    "preset_trace",
    "open_loop_arrivals",
    "bursty_arrivals",
    "diurnal_arrivals",
    "assign_arrivals",
    "stamp_arrivals",
    "write_request",
    "replay",
]


@dataclasses.dataclass
class ReplayRequest:
    """One request of a replay trace.

    ``arrival_s`` is the offset from trace start (seconds) at which
    the replayer emits the request; 0.0 until ``assign_arrivals``.
    ``priority`` names an admission class (empty = server default;
    see ``serving/admission.py``) and ``deadline_s`` is a TTFT
    deadline relative to admission intake — past it the scheduler
    sheds the request with ``finish_reason="shed"`` instead of
    serving a worthless answer.
    """

    request_id: int
    prompt: list
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0
    arrival_s: float = 0.0
    priority: str = ""
    deadline_s: Optional[float] = None

    def spec(self) -> dict:
        """The file-queue request spec (what ``req-<id>.json`` holds).
        Priority/deadline ride along only when set, so traces that
        predate admission control serialize byte-identically."""
        out = {
            "request_id": self.request_id,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "seed": self.seed,
        }
        if self.eos_id is not None:
            out["eos_id"] = self.eos_id
        if self.priority:
            out["priority"] = self.priority
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
        return out


@dataclasses.dataclass
class ReplayReport:
    """Offered-vs-achieved pacing accounting for one :func:`replay`.

    An overloaded generator (emit callback blocking, host too slow to
    pace the trace) silently *under-offers*: the fleet then looks
    healthy at a load it never actually saw.  The report makes that
    visible — ``lag`` is how far behind schedule each emission ran,
    and ``pacing_error`` is the relative stretch of the whole trace
    (0.0 = perfectly paced; 0.5 = the "10 QPS" trace was really 6.7).
    """

    emitted: int
    offered_duration_s: float  # last scheduled offset (speedup applied)
    achieved_duration_s: float  # wall time from start to last emission
    max_lag_s: float  # worst single emission behind its schedule
    mean_lag_s: float

    @property
    def offered_qps(self) -> float:
        return self.emitted / max(self.offered_duration_s, 1e-9)

    @property
    def achieved_qps(self) -> float:
        return self.emitted / max(self.achieved_duration_s, 1e-9)

    @property
    def pacing_error(self) -> float:
        """Relative trace stretch: achieved/offered duration − 1."""
        if self.offered_duration_s <= 0:
            return 0.0
        return self.achieved_duration_s / self.offered_duration_s - 1.0


def _tokens(rng: Random, n: int, vocab: int) -> list:
    return [rng.randrange(vocab) for _ in range(n)]


def _mode(rid: int, sample_every: int, seed: int) -> dict:
    """Sampling mode for request ``rid``: greedy by default, seeded
    temperature/top-k/top-p every ``sample_every``-th request so a
    trace exercises every decode path (0 disables sampling)."""
    if not sample_every or rid % sample_every:
        return {}
    kind = (rid // sample_every) % 3
    if kind == 0:
        return {"temperature": 0.7, "seed": seed + rid}
    if kind == 1:
        return {"temperature": 1.0, "top_k": 5, "seed": seed + rid}
    return {"temperature": 1.0, "top_p": 0.9, "seed": seed + rid}


def uniform_mix(n: int, *, seed: int, vocab: int = 64, prompt_len: int = 8,
                new_tokens: int = 8, sample_every: int = 0,
                first_id: int = 0) -> list:
    """Control mix: ``n`` distinct prompts of one length, one decode
    budget.  Disaggregation should not help here (nothing to
    interfere), which is exactly what the bench's >=0.9x floor checks.
    """
    rng = Random(seed)
    reqs = []
    for i in range(n):
        rid = first_id + i
        reqs.append(ReplayRequest(
            request_id=rid,
            prompt=_tokens(rng, prompt_len, vocab),
            max_new_tokens=new_tokens,
            **_mode(rid, sample_every, seed),
        ))
    return reqs


def mixed_mix(n: int, *, seed: int, vocab: int = 64, long_len: int = 48,
              long_new: int = 2, short_len: int = 4, short_new: int = 12,
              long_every: int = 3, sample_every: int = 0,
              first_id: int = 0) -> list:
    """The interference mix: every ``long_every``-th request is
    prefill-heavy (long prompt, tiny decode), the rest are
    decode-heavy (tiny prompt, long decode).  In a monolithic replica
    the long prefills stall in-flight decode steps and blow up TPOT
    tails; a decode-only replica never runs prefill, so its TPOT is
    flat.  This is the trace the disagg bench arm measures."""
    rng = Random(seed)
    reqs = []
    for i in range(n):
        rid = first_id + i
        heavy = long_every and i % long_every == 0
        reqs.append(ReplayRequest(
            request_id=rid,
            prompt=_tokens(rng, long_len if heavy else short_len, vocab),
            max_new_tokens=long_new if heavy else short_new,
            **_mode(rid, sample_every, seed),
        ))
    return reqs


def shared_prefix_mix(n: int, *, seed: int, vocab: int = 64,
                      shared_len: int = 8, tail_len: int = 2,
                      new_tokens: int = 4, copies: int = 1,
                      sample_every: int = 0, first_id: int = 0) -> list:
    """Shared-system-prompt mix: every prompt starts with one common
    ``shared_len``-token block followed by a unique tail.  With
    ``copies`` > 1 each (prompt, decode-budget) spec is emitted that
    many times under distinct request_ids — consecutive copies, so a
    round-robin fleet lands them on different replicas and the
    fleet-wide prefix cache (not the local trie) has to supply the
    shared block."""
    rng = Random(seed)
    shared = _tokens(rng, shared_len, vocab)
    reqs = []
    rid = first_id
    for i in range(n):
        tail = _tokens(rng, tail_len, vocab)
        for _ in range(max(1, copies)):
            reqs.append(ReplayRequest(
                request_id=rid,
                prompt=shared + tail,
                max_new_tokens=new_tokens,
                **_mode(rid, sample_every, seed),
            ))
            rid += 1
    return reqs


# --------------------------------------------------------------------------
# Named trace presets — the ONE parameterization of the canonical
# request mixes.  bench.py's serving arms and the serve_drill/load arms
# both read these (previously bench.py hardcoded the same numbers
# inline), so a bench headline and a drill always describe the same
# traffic.  Each preset carries its full-size shape plus a "smoke"
# override (seconds-scale CPU validation); lengths are page-aligned
# against ``page_tokens`` so warm shared-prefix admissions resume
# exactly at a cached page boundary.
TRACE_PRESETS = {
    # Long common system prompt + short unique tails: the radix
    # prefix-cache / fleet-cache showcase.
    "shared_prefix": {
        "shared_len": 96, "tail_len": 16, "new_tokens": 32,
        "page_tokens": 16, "requests": 8, "slots": 8,
        "smoke": {
            "shared_len": 8, "tail_len": 2, "new_tokens": 4,
            "page_tokens": 2, "requests": 4, "slots": 4,
        },
    },
    # Distinct long prompts: the batched-prefill (lanes) showcase.
    "long_context": {
        "prompt_len": 112, "new_tokens": 32, "page_tokens": 16,
        "requests": 8, "slots": 8,
        "smoke": {
            "prompt_len": 8, "new_tokens": 4, "page_tokens": 2,
            "requests": 4, "slots": 4,
        },
    },
    # Prefill-heavy every long_every-th request, decode-heavy rest:
    # the disaggregation interference mix (mixed_mix's defaults).
    "interference": {
        "long_len": 48, "long_new": 2, "short_len": 4, "short_new": 12,
        "long_every": 3,
        "smoke": {
            "long_len": 12, "long_new": 2, "short_len": 4,
            "short_new": 6, "long_every": 3,
        },
    },
    # One prompt length, one decode budget: the control mix.
    "uniform": {
        "prompt_len": 8, "new_tokens": 8,
        "smoke": {"prompt_len": 8, "new_tokens": 8},
    },
}


def preset_params(name: str, *, smoke: bool = False) -> dict:
    """The shape parameters of preset ``name`` (smoke or full size),
    without the nested smoke override — callers destructure these."""
    try:
        preset = TRACE_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown trace preset {name!r} (have {sorted(TRACE_PRESETS)})"
        ) from None
    params = {k: v for k, v in preset.items() if k != "smoke"}
    if smoke:
        params.update(preset["smoke"])
    return params


def preset_trace(name: str, n: Optional[int] = None, *, seed: int,
                 vocab: int = 64, smoke: bool = True,
                 sample_every: int = 0, first_id: int = 0) -> list:
    """Build the request list of preset ``name`` (``n`` overrides the
    preset's request count where it has one)."""
    p = preset_params(name, smoke=smoke)
    if name == "shared_prefix":
        return shared_prefix_mix(
            n if n is not None else p["requests"], seed=seed, vocab=vocab,
            shared_len=p["shared_len"], tail_len=p["tail_len"],
            new_tokens=p["new_tokens"], sample_every=sample_every,
            first_id=first_id,
        )
    if name == "long_context":
        return uniform_mix(
            n if n is not None else p["requests"], seed=seed, vocab=vocab,
            prompt_len=p["prompt_len"], new_tokens=p["new_tokens"],
            sample_every=sample_every, first_id=first_id,
        )
    if name == "interference":
        if n is None:
            raise ValueError(f"preset {name!r} needs an explicit n")
        return mixed_mix(
            n, seed=seed, vocab=vocab, long_len=p["long_len"],
            long_new=p["long_new"], short_len=p["short_len"],
            short_new=p["short_new"], long_every=p["long_every"],
            sample_every=sample_every, first_id=first_id,
        )
    if name == "uniform":
        if n is None:
            raise ValueError(f"preset {name!r} needs an explicit n")
        return uniform_mix(
            n, seed=seed, vocab=vocab, prompt_len=p["prompt_len"],
            new_tokens=p["new_tokens"], sample_every=sample_every,
            first_id=first_id,
        )
    raise ValueError(f"preset {name!r} has no trace builder")


def open_loop_arrivals(n: int, *, seed: int, mean_gap_s: float) -> list:
    """``n`` cumulative arrival offsets with exponential inter-arrival
    gaps of mean ``mean_gap_s`` — the standard open-loop (Poisson)
    arrival process, fully determined by ``seed``."""
    rng = Random(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += rng.expovariate(1.0 / mean_gap_s) if mean_gap_s > 0 else 0.0
        out.append(t)
    return out


def bursty_arrivals(n: int, *, seed: int, lull_gap_s: float,
                    spike_gap_s: float, lull_s: float,
                    spike_s: float) -> list:
    """Open-loop arrivals under a two-phase (lull → spike → lull → …)
    rate process: inter-arrival gaps stay exponential, but their mean
    switches between ``lull_gap_s`` and ``spike_gap_s`` depending on
    which phase the current offset falls in.  This is the autoscale
    drill's traffic — a spike dense enough to recruit a replica, a
    lull long enough to drain one — fully determined by ``seed``."""
    if spike_gap_s >= lull_gap_s:
        raise ValueError(
            f"spike_gap_s ({spike_gap_s}) must be below lull_gap_s "
            f"({lull_gap_s}) — otherwise the spike is the lull"
        )
    if lull_s <= 0 or spike_s <= 0:
        raise ValueError("phase lengths must be positive")
    rng = Random(seed)
    period = lull_s + spike_s
    out: List[float] = []
    t = 0.0
    for _ in range(n):
        in_lull = (t % period) < lull_s
        mean = lull_gap_s if in_lull else spike_gap_s
        t += rng.expovariate(1.0 / mean)
        out.append(t)
    return out


def diurnal_arrivals(n: int, *, seed: int, mean_gap_s: float,
                     period_s: float, peak_to_trough: float = 4.0) -> list:
    """Open-loop arrivals under a smooth diurnal rate cycle: the mean
    gap oscillates cosinusoidally between ``mean_gap_s`` (peak rate, at
    offset 0) and ``mean_gap_s * peak_to_trough`` (trough), period
    ``period_s``.  The compressed day curve for soak-style drills."""
    if peak_to_trough < 1.0:
        raise ValueError(
            f"peak_to_trough must be >= 1, got {peak_to_trough}"
        )
    if period_s <= 0:
        raise ValueError(f"period_s must be positive: {period_s}")
    rng = Random(seed)
    out: List[float] = []
    t = 0.0
    mid = (1.0 + peak_to_trough) / 2.0
    amp = (peak_to_trough - 1.0) / 2.0
    for _ in range(n):
        mult = mid - amp * math.cos(2.0 * math.pi * t / period_s)
        t += rng.expovariate(1.0 / (mean_gap_s * mult))
        out.append(t)
    return out


def assign_arrivals(requests: list, *, seed: int, mean_gap_s: float) -> list:
    """Stamp each request's ``arrival_s`` in submission order."""
    return stamp_arrivals(
        requests,
        open_loop_arrivals(len(requests), seed=seed, mean_gap_s=mean_gap_s),
    )


def stamp_arrivals(requests: list, offsets: Iterable[float]) -> list:
    """Stamp precomputed arrival offsets (from any arrival process)
    onto ``requests`` in submission order."""
    for req, t in zip(requests, offsets):
        req.arrival_s = t
    return requests


def write_request(queue_dir: str, req: ReplayRequest) -> str:
    """Atomically publish one request file into the shared queue
    (tmp + rename, same protocol the replicas claim against)."""
    path = os.path.join(queue_dir, f"req-{req.request_id}.json")
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(req.spec(), f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def replay(requests: Iterable[ReplayRequest],
           emit: Callable[[ReplayRequest], object], *,
           speedup: float = 1.0) -> ReplayReport:
    """Emit each request at its arrival offset (open loop: pacing
    never waits on completions).  ``speedup`` > 1 compresses the
    trace.  Pacing reads ``time.perf_counter`` only — no wall clock —
    and sleeps are capped so SIGINT/teardown stay responsive.  Returns
    a :class:`ReplayReport` so the caller can check the trace was
    actually offered at the intended rate (a blocking ``emit`` makes a
    replayer fall behind schedule; the drill rejects a run whose
    pacing error hides the load it claims to measure)."""
    t0 = time.perf_counter()
    n = 0
    offered_end = 0.0
    lag_total = 0.0
    lag_max = 0.0
    t_done = t0
    for req in sorted(requests, key=lambda r: (r.arrival_s, r.request_id)):
        target = t0 + req.arrival_s / max(speedup, 1e-9)
        offered_end = max(offered_end, target - t0)
        while True:
            delay = target - time.perf_counter()
            if delay <= 0:
                break
            time.sleep(min(delay, 0.05))
        emit(req)
        t_done = time.perf_counter()
        lag = max(0.0, t_done - target)
        lag_total += lag
        lag_max = max(lag_max, lag)
        n += 1
    return ReplayReport(
        emitted=n,
        offered_duration_s=offered_end,
        achieved_duration_s=t_done - t0,
        max_lag_s=lag_max,
        mean_lag_s=lag_total / n if n else 0.0,
    )
