"""Two-replica serving fleet drill: drain-on-SIGTERM, exactly-once.

The port's counterpart of the repository's ``scripts/serve_drill.py``.
Spawns a real 2-replica serving fleet (``launch.launch_local`` over
``python -m distributed_tensorflow_models_tpu_torch.serving.server``, the
replicas on ``--device``: the card unless ``--device cpu``) against one
shared file queue of requests, SIGTERMs replica 1 mid-traffic (the
replica self-delivers the signal after its 3rd response, so the timing
is deterministic-ish and the parent needs no child PIDs), and verifies
the serving drain contract:

- **no dropped responses** — every request file gets exactly one
  response; the victim answers everything it claimed before exiting 0
  (drain, not abort), and hands back anything caught between claim and
  submit for the survivor to serve;
- **no duplicated responses** — the atomic-rename claim protocol means
  a request is served by exactly one replica (asserted from the
  ``claimed/`` audit trail);
- **the port's serving contract** — every answered stream equals the
  port's solo ``generate`` of the replicas' drill model
  (``server.drill_model``) on their device, a sampled request drawn at
  ``server.request_seed(seed, request_id)``; so the duplicate-spec
  greedy pairs the queue carries are equal whichever replica served
  each member;
- **forensics** — both replicas leave a schema-clean flight record
  (reason ``serve_drain``, with the ``serve/drain`` instant marking
  when the drain began) and a schema-clean ``serving_stats_p<i>.json``
  (both validated by ``scripts/check_metrics_schema.py``), the victim
  actually served traffic before dying, and each replica reports R1's
  launches at exit (``r1_launches_p<i>.json``): on the card every replica
  must have launched it.

A second arm repeats the drill with speculative decoding on
(``--spec-tokens``, default 3): same checks, plus every request's token
stream must be equal to the spec-off arm's — speculation is a
throughput knob, never a token knob, even under drain and failover.

Disaggregated arms (``--no-disagg`` skips) certify the prefill/decode
role split end to end under OPEN-LOOP paced arrivals (the
``serving.replay`` module's seeded trace, emitted by a parent thread
while the fleet runs):

- **D1** — 1 prefill + 1 decode, clean: every stream equal to a
  monolithic fleet serving the SAME trace, ship spans present in every
  attributed waterfall with queue + prefill + ship ≡ TTFT, roles
  labelled in the report, per-role program pins (prefill captures no
  decode program and vice versa);
- **D2** — 2 prefill + 1 decode, prefill-role victim (self-SIGTERM
  mid-traffic) with the fleet-wide prefix cache on and duplicate
  prompts re-arriving later: drain-to-zero on the prefill role, fleet
  cache hits observed, greedy duplicates equal;
- **D3** — 1 prefill + 2 decode, decode-role victim: claim/unclaim
  drain correctness on the decode role, zero dropped or duplicated
  responses, streams equal to D1's.

Overload arms (``--no-overload`` skips) certify admission control
under deliberate overload (a prefill stall behind an unmeetable
queue-depth SLO): every shed request must still be ANSWERED — a real
``finish_reason="shed"`` response, never a silent drop — sheds must
take the lowest priority class first, and the TTFT SLO the shedding
protects must verdict PASS in the very report whose queue-depth SLO
reads FAIL.  A backpressure arm re-runs the burst with the queue-depth
gate on instead: intake must PAUSE (engage episodes counted in the
stats) and every request is still served in full, exactly once.

The autoscale arm (``--no-autoscale`` skips) drives a 1-replica fleet
through a bursty spike-then-trickle trace under a closed-loop
:class:`~distributed_tensorflow_models_tpu_torch.launch.FleetAutoscaler`:
the spike must recruit a replica, the lull must drain one mid-stream
(SIGTERM → drain → exit 0), every scale decision leaves a
``scale_events.jsonl`` row plus a ``flight_autoscale_<k>.json`` dump,
the replicas mirror the fleet-size transitions into their own stats,
and every surviving stream is equal to an unresized reference run of
the same trace — scaling is a capacity knob, never a token knob.

The deploy arm (``--no-deploy`` skips) certifies continuous deployment
end to end: a staged "trainer" publishes ``CheckpointManager`` steps at
cadence while a 1-replica fleet runs with ``--follow-checkpoints`` — two
good steps hot-swap in live (canary → promote, ZERO recaptures: the
program counters must not move), a NaN-poisoned step and a torn step
are rejected BEFORE touching the engine (each with a flight record), a
good-weights-but-slow step (per-version prefill stall) canaries,
breaches its TTFT SLO and rolls back — all with zero dropped or
duplicated responses, and every response equal to the port's engine
serving it alone under the weights of the version it was ADMITTED to
(the version stamp each response carries).

Every arm's streams are held to solo ``generate`` except the deploy
arm's, which are held to their versions' solo engine runs.  The parent
imports torch only for that reference and the device check; the
replicas and the deploy arm's helpers are processes of their own.  The
repository's ``scripts/serving_report.py`` and
``scripts/check_metrics_schema.py`` read the artifacts as subprocesses.
Exit 0 when every check passes; each arm's seconds are printed.

Usage::

    python -m distributed_tensorflow_models_tpu_torch.scripts.serve_drill \\
        [--device cuda|cpu] [--requests 24] [--keep]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from distributed_tensorflow_models_tpu_torch import launch
from distributed_tensorflow_models_tpu_torch.serving import admission as admlib
from distributed_tensorflow_models_tpu_torch.serving import deploy as deploylib
from distributed_tensorflow_models_tpu_torch.serving import replay as replaylib
from distributed_tensorflow_models_tpu_torch.serving import server as serverlib

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SCRIPTS = os.path.join(_REPO, "scripts")
SERVER = "distributed_tensorflow_models_tpu_torch.serving.server"
DRILL = "distributed_tensorflow_models_tpu_torch.scripts.serve_drill"

SIGTERM_AFTER = 3  # victim self-SIGTERMs after this many responses
VICTIM = 1

# Request mix: every sampling mode, EVEN ids duplicated by their
# successor (same spec, different request_id) for the cross-replica
# determinism check.  Vocab is 64 (the replica's built-in tiny model).
MODES = [
    dict(temperature=0.0, top_k=0, top_p=1.0),
    dict(temperature=1.0, top_k=0, top_p=1.0, seed=11),
    dict(temperature=0.8, top_k=5, top_p=1.0, seed=12),
    dict(temperature=1.0, top_k=0, top_p=0.9, seed=13),
]


def _write_requests(queue_dir: str, n: int) -> dict[int, dict]:
    """Emit ``n`` request files; returns {request_id: spec}.  Pairs
    (2i, 2i+1) share prompt + mode; the cross-replica determinism check
    compares the GREEDY pairs byte-for-byte (seeded modes legitimately
    diverge within a pair, because the replica folds the sampling key
    with the request_id — per-request keys are part of the contract)."""
    specs = {}
    for rid in range(n):
        mode = MODES[(rid // 2) % len(MODES)]
        pair = rid // 2  # both members of a pair share everything below
        prompt = [(3 + 7 * pair + j) % 64 for j in range(3 + pair % 5)]
        spec = {
            "request_id": rid,
            "prompt": prompt,
            "max_new_tokens": 6 + pair % 4,
            **mode,
        }
        specs[rid] = spec
        path = os.path.join(queue_dir, f"req-{rid}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(spec, f)
        os.replace(path + ".tmp", path)
    return specs


def require_device(device: str) -> None:
    """Raise unless the replicas' ``device`` is there: the CPU only when
    asked for, else a CUDA device.  No CPU fallback."""
    if device == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"serve drill: the replicas run on {device!r} and no CUDA "
            "device is available; pass --device cpu to drill on the CPU")


class SoloReference:
    """Solo ``generate`` of the replicas' drill model
    (``server.drill_model``, weights from seed 0) on ``device``, one
    request at a time at batch 1, memoised by spec: what the port's
    serving contract says every answered stream equals."""

    def __init__(self, device: str):
        self.device = device
        self._model = None
        self._memo: dict[str, list[int]] = {}

    def stream(self, spec: dict) -> list[int]:
        key = json.dumps(spec, sort_keys=True)
        if key not in self._memo:
            self._memo[key] = self._generate(spec)
        return self._memo[key]

    def _generate(self, spec: dict) -> list[int]:
        import torch

        from distributed_tensorflow_models_tpu_torch.harness import (
            generate as genlib,
        )

        if self._model is None:
            self._model = serverlib.drill_model(64).to(self.device).eval()
        temperature = float(spec.get("temperature", 0.0))
        # The replica's own rule (server.LMServer._admit): a sampled
        # request is drawn at request_seed(seed or 0, request_id).
        seed = (serverlib.request_seed(spec.get("seed") or 0,
                                       spec["request_id"])
                if temperature > 0 else None)
        prompt = torch.tensor([spec["prompt"]], dtype=torch.int64,
                              device=self.device)
        out = genlib.generate(
            self._model, prompt, int(spec["max_new_tokens"]),
            temperature=temperature, top_k=int(spec.get("top_k", 0)),
            top_p=float(spec.get("top_p", 1.0)), seed=seed)
        return out[0, len(spec["prompt"]):].tolist()

    def check(self, responses: dict[int, dict], specs: dict[int, dict],
              errors: list[str], label: str) -> None:
        """Every answered (not shed) stream = its solo ``generate``."""
        bad = [rid for rid, resp in sorted(responses.items())
               if rid in specs and resp.get("finish_reason") != "shed"
               and resp["tokens"] != self.stream(specs[rid])]
        if bad:
            errors.append(
                f"{label}: requests {bad} differ from solo generate of the "
                f"drill model on {self.device}, e.g. {bad[0]}: "
                f"{responses[bad[0]]['tokens']} vs "
                f"{self.stream(specs[bad[0]])}")


def _fleet_env() -> dict[str, str]:
    return {
        "PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }


def _server_argv(queue_dir: str, workdir: str, device: str,
                 *extra: str) -> list[str]:
    """One replica's command: the drill's engine settings on ``device``."""
    return [
        sys.executable, "-m", SERVER,
        "--queue-dir", queue_dir, "--workdir", workdir, "--device", device,
        "--max-slots", "4", "--prefill-chunk", "8",
        "--drain-grace-s", "60", "--timeout", "240", *extra,
    ]


def _launch(n: int, argv: list[str], scale_controller=None) -> list[int]:
    return launch.launch_local(n, argv, timeout=420.0, extra_env=_fleet_env(),
                               scale_controller=scale_controller)


def _schema_check(path: str, flag: str, errors: list[str]) -> None:
    lint = os.path.join(_SCRIPTS, "check_metrics_schema.py")
    proc = subprocess.run(
        [sys.executable, lint, path, flag], capture_output=True, text=True
    )
    if proc.returncode != 0:
        errors.append(f"{flag} lint failed for {path}: {proc.stderr}")


_ARTIFACTS = {
    "--flight-recorder": "flight_recorder_p{}.json",
    "--serving-report": "serving_stats_p{}.json",
    "--timeseries": "timeseries_p{}.jsonl",
}


def _lint_artifacts(workdir: str, proc: int, flags: tuple[str, ...],
                    errors: list[str], label: str) -> None:
    """Replica ``proc``'s artifacts of ``flags`` exist and pass the
    repository's schema lint."""
    for flag in flags:
        path = os.path.join(workdir, _ARTIFACTS[flag].format(proc))
        if not os.path.exists(path):
            errors.append(f"{label}: missing artifact {path}")
        else:
            _schema_check(path, flag, errors)


def _serving_report(workdir: str, errors: list[str],
                    label: str) -> Optional[dict]:
    """``scripts/serving_report.py <workdir> --json``, or None (an error
    recorded) when it fails."""
    proc = subprocess.run(
        [sys.executable, os.path.join(_SCRIPTS, "serving_report.py"),
         workdir, "--json"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        errors.append(f"{label}: serving_report failed: {proc.stderr}")
        return None
    return json.loads(proc.stdout)


def r1_launches(workdir: str, procs, device: str, errors: list[str],
                label: str) -> dict[int, dict]:
    """``{replica: {form: launches}}`` from each replica's exit report;
    on the card every replica must have launched R1."""
    out: dict[int, dict] = {}
    for i in procs:
        path = serverlib.r1_launches_path(workdir, i)
        if not os.path.exists(path):
            errors.append(f"{label}: replica {i} left no R1 report {path}")
            continue
        with open(path) as f:
            out[i] = json.load(f)["r1_launches"]
        if device != "cpu" and not sum(out[i].values()):
            errors.append(f"{label}: replica {i} on {device} launched R1 "
                          f"no time ({out[i]})")
    return out


def run_drill(scratch: str, n_requests: int, *, device: str,
              solo: SoloReference, spec_tokens: int = 0,
              extra_argv: tuple[str, ...] = (),
              ) -> tuple[list[str], dict[int, dict]]:
    require_device(device)
    errors: list[str] = []
    queue_dir = os.path.join(scratch, "queue")
    workdir = os.path.join(scratch, "wd")
    os.makedirs(queue_dir, exist_ok=True)
    os.makedirs(workdir, exist_ok=True)
    specs = _write_requests(queue_dir, n_requests)
    # DONE is pre-written: replicas exit once the queue is drained and
    # their own in-flight work is resolved.
    with open(os.path.join(queue_dir, "DONE"), "w") as f:
        f.write("done\n")

    extra = [
        "--self-sigterm-after", str(SIGTERM_AFTER),
        "--sigterm-replica", str(VICTIM),
    ]
    if spec_tokens:
        extra += ["--spec-tokens", str(spec_tokens)]
    codes = _launch(
        2, _server_argv(queue_dir, workdir, device, *extra, *extra_argv))
    agg = launch.aggregate_exit_codes(codes)
    if agg != 0:
        errors.append(f"fleet exit codes {codes} (victim must DRAIN to 0)")

    # -- exactly-once bookkeeping, then every token ------------------------
    responses = _audit_exactly_once(queue_dir, specs, errors, "drill")
    for rid, resp in sorted(responses.items()):
        want = specs[rid]["max_new_tokens"]
        if len(resp["tokens"]) != want:
            errors.append(
                f"request {rid}: {len(resp['tokens'])} tokens, "
                f"expected {want}"
            )
    solo.check(responses, specs, errors, "drill")

    by_replica: dict[int, int] = {}
    for resp in responses.values():
        by_replica[resp["replica"]] = by_replica.get(resp["replica"], 0) + 1
    print(f"  responses by replica: {by_replica}")
    if by_replica.get(VICTIM, 0) < SIGTERM_AFTER:
        errors.append(
            f"victim served {by_replica.get(VICTIM, 0)} < {SIGTERM_AFTER} "
            "responses — SIGTERM fired before real traffic"
        )
    if by_replica.get(1 - VICTIM, 0) == 0:
        errors.append("survivor served nothing — no failover happened")

    # -- cross-replica determinism ----------------------------------------
    # Greedy pairs (identical spec, no sampling key involved) must be
    # equal regardless of which replica served each member.
    for pair in range(len(specs) // 2):
        a, b = responses.get(2 * pair), responses.get(2 * pair + 1)
        if a is None or b is None:
            continue
        if specs[2 * pair]["temperature"] == 0.0:
            if a["tokens"] != b["tokens"]:
                errors.append(
                    f"greedy pair ({2 * pair}, {2 * pair + 1}) diverged "
                    f"(replicas {a['replica']}/{b['replica']}): "
                    f"{a['tokens']} vs {b['tokens']}"
                )

    # -- forensics ---------------------------------------------------------
    for proc_index in (0, 1):
        _lint_artifacts(workdir, proc_index,
                        ("--flight-recorder", "--serving-report"), errors,
                        "drill")
        record_path = os.path.join(
            workdir, f"flight_recorder_p{proc_index}.json"
        )
        if os.path.exists(record_path):
            with open(record_path) as f:
                record = json.load(f)
            if record.get("reason") != "serve_drain":
                errors.append(
                    f"p{proc_index} flight record reason "
                    f"{record.get('reason')!r}, expected 'serve_drain'"
                )
            names = {e.get("name") for e in record.get("events", [])}
            if "serve/drain" not in names:
                errors.append(
                    f"p{proc_index} flight record has no serve/drain "
                    f"instant (events: {sorted(x for x in names if x)})"
                )
        stats_path = os.path.join(
            workdir, f"serving_stats_p{proc_index}.json"
        )
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                snap = json.load(f)["metrics"]
            print(
                f"  p{proc_index}: {int(snap['serve/requests'])} requests, "
                f"{int(snap['serve/tokens'])} tokens, "
                f"ttft p99 {snap['serve/ttft_s/p99_s'] * 1e3:.1f}ms, "
                f"tpot p99 {snap['serve/tpot_s/p99_s'] * 1e3:.1f}ms"
            )
            has_spec = any(k.startswith("serve/spec_") for k in snap)
            if spec_tokens and not has_spec:
                errors.append(
                    f"p{proc_index}: spec-on stats carry no "
                    "serve/spec_* keys"
                )
            if not spec_tokens and has_spec:
                errors.append(
                    f"p{proc_index}: spec-off stats leak serve/spec_* "
                    f"keys: "
                    f"{sorted(k for k in snap if k.startswith('serve/spec_'))}"
                )
    r1 = r1_launches(workdir, (0, 1), device, errors, "drill")
    print(f"  R1 launches by replica: {r1}")
    return errors, responses


# -- SLO arm ---------------------------------------------------------------
# Threshold sits between steady-state TTFT (tens of ms on the tiny
# model) and the injected stall; warmup is 2*max_slots — exactly the
# requests a replica claims before its first wave retires, i.e. every
# TTFT sample contaminated by first-dispatch build and capture time.
SLO_THRESHOLD_S = 1.5
SLO_STALL_MS = 3000.0
SLO_WARMUP = 8  # 2 * --max-slots
SLO_SPEC = f"ttft=serve/ttft_s:p99<{SLO_THRESHOLD_S}@30s"
SLO_ARGV = (
    "--slo", SLO_SPEC,
    "--slo-warmup", str(SLO_WARMUP),
    "--slo-breach-after", "1",
    "--timeseries-interval-s", "0.5",
)


def check_slo_arm(workdir: str, *, expect_breach: bool) -> list[str]:
    """SLO-arm forensics: breach instants in the flight records, breach
    counters in the stats, the report's verdict table, waterfall
    attribution (queue + prefill + decode must sum to measured TTFT),
    and schema-clean time-series files."""
    errors: list[str] = []
    label = "stall" if expect_breach else "clean"
    instants = {0: 0, 1: 0}
    counters = {0: 0.0, 1: 0.0}
    for proc_index in (0, 1):
        record_path = os.path.join(
            workdir, f"flight_recorder_p{proc_index}.json"
        )
        if os.path.exists(record_path):
            with open(record_path) as f:
                record = json.load(f)
            instants[proc_index] = sum(
                1 for e in record.get("events", [])
                if e.get("name") == "serve/slo_breach"
            )
        stats_path = os.path.join(
            workdir, f"serving_stats_p{proc_index}.json"
        )
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                snap = json.load(f)["metrics"]
            counters[proc_index] = sum(
                v for k, v in snap.items()
                if k.startswith("serve/slo_breach/")
            )
        ts_path = os.path.join(workdir, f"timeseries_p{proc_index}.jsonl")
        if not os.path.exists(ts_path):
            errors.append(f"slo-{label}: missing time-series {ts_path}")
        else:
            _schema_check(ts_path, "--timeseries", errors)

    report = _serving_report(workdir, errors, f"slo-{label}")
    if report is None:
        return errors
    att = report["attribution"]
    if att["attributed"] == 0:
        errors.append(f"slo-{label}: no attributed waterfalls in report")
    if att["sum_bad"]:
        bad = [
            w for w in report["waterfalls"]
            if w["attributed"] and not w["sum_ok"]
        ]
        errors.append(
            f"slo-{label}: {att['sum_bad']} waterfall(s) do not sum to "
            "TTFT: " + ", ".join(
                f"p{w['proc']}/r{w['rid']} "
                f"err={w['attribution_err_s']:.4f}s"
                for w in bad[:5]
            )
        )
    verdicts = {
        (row["proc"], row["slo"]): row["verdict"] for row in report["slo"]
    }
    if not verdicts:
        errors.append(f"slo-{label}: report has no SLO verdict rows")
    if expect_breach:
        if not any(instants.values()):
            errors.append(
                "slo-stall: no serve/slo_breach instant in any flight "
                "record — the injected stall never tripped the monitor"
            )
        if not any(counters.values()):
            errors.append("slo-stall: serve/slo_breach counters all zero")
        if not any(v == "FAIL" for v in verdicts.values()):
            errors.append(
                f"slo-stall: no FAIL verdict in the report ({verdicts})"
            )
    else:
        if any(instants.values()) or any(counters.values()):
            errors.append(
                f"slo-clean: unexpected breach(es): instants {instants}, "
                f"counters {counters}"
            )
        bad_verdicts = {
            f"p{k[0]}:{k[1]}": v for k, v in verdicts.items() if v != "PASS"
        }
        if bad_verdicts:
            errors.append(f"slo-clean: non-PASS verdicts: {bad_verdicts}")
    print(
        f"  slo-{label}: breach instants {instants}, waterfalls "
        f"{att['sum_ok']}/{att['attributed']} sum to TTFT"
    )
    return errors


# -- disaggregated arms ----------------------------------------------------
# The victim threshold counts HANDLED requests (responded + shipped), so
# a prefill victim's SIGTERM is as deterministic-ish as the monolithic
# one's.  The ring is sized to hold every request's spans: the report
# check below demands a ship span in EVERY attributed waterfall, and an
# evicted event would read as a missing span.
DISAGG_RING = 8192


def _disagg_trace(n: int) -> list:
    """D1/D3 trace: the interference mix (every 3rd request
    prefill-heavy), every 5th request on a seeded sampling mode, paced
    by seeded exponential inter-arrival gaps."""
    reqs = replaylib.mixed_mix(n, seed=17, sample_every=5)
    return replaylib.assign_arrivals(reqs, seed=170, mean_gap_s=0.05)


def _fleet_trace(n_pairs: int) -> list[list]:
    """D2 trace, two phases: shared-prefix prompts with page-aligned
    unique tails (shared 8 = one page, tail 9 so a second FULL page per
    prompt is matchable and advertised), then byte-identical duplicates
    under fresh request_ids.  The pacer gates phase 2 on phase 1's
    responses (compile time is seconds on a cold replica, so a fixed
    delay races the advertises), guaranteeing every original's tail
    page is advertised in the fleet index before its duplicate arrives;
    a duplicate claimed by a replica that did not prefill its original
    must then pull the tail page from the fleet, not its local trie."""
    first = replaylib.assign_arrivals(
        replaylib.shared_prefix_mix(
            n_pairs, seed=21, shared_len=8, tail_len=9, new_tokens=4
        ),
        seed=210, mean_gap_s=0.08,
    )
    dup = replaylib.assign_arrivals(
        replaylib.shared_prefix_mix(
            n_pairs, seed=21, shared_len=8, tail_len=9, new_tokens=4,
            first_id=n_pairs,
        ),
        seed=211, mean_gap_s=0.08,
    )
    return [first, dup]


def _pace(queue_dir: str, phases: list[list],
          reports: list | None = None) -> None:
    """Parent-thread replayer: emit each phase open-loop while
    launch_local blocks on the fleet, waiting for the previous phase's
    responses between phases, then publish DONE.  Each phase's
    :class:`~...serving.replay.ReplayReport` lands in ``reports`` (when
    given) so the arm can surface offered-vs-achieved pacing."""
    resp_dir = os.path.join(queue_dir, "resp")
    for i, phase in enumerate(phases):
        if i:
            want = {r.request_id for r in phases[i - 1]}
            deadline = time.perf_counter() + 120.0
            while time.perf_counter() < deadline:
                have = {
                    int(n.split("-")[1].split(".")[0])
                    for n in os.listdir(resp_dir)
                    if n.endswith(".json")
                } if os.path.isdir(resp_dir) else set()
                if want <= have:
                    break
                time.sleep(0.05)
        rep = replaylib.replay(
            phase, lambda r: replaylib.write_request(queue_dir, r)
        )
        if reports is not None:
            reports.append(rep)
    done = os.path.join(queue_dir, "DONE")
    with open(done + ".tmp", "w") as f:
        f.write("done\n")
    os.replace(done + ".tmp", done)


def _claims_by_replica(queue_dir: str) -> dict[int, int]:
    """Request files each replica claimed (``claimed/req-<id>.json.p<i>``)."""
    claimed_dir = os.path.join(queue_dir, "claimed")
    out: dict[int, int] = {}
    for name in (
        os.listdir(claimed_dir) if os.path.isdir(claimed_dir) else []
    ):
        rep = int(name.rsplit(".p", 1)[1])
        out[rep] = out.get(rep, 0) + 1
    return out


def run_disagg_drill(
    scratch: str, reqs: list, *, device: str, solo: SoloReference,
    role_map: str = "", victim: int | None = None,
    sigterm_after: int = SIGTERM_AFTER, fleet_cache: bool = False,
    phases: list[list] | None = None,
) -> tuple[list[str], dict[int, dict]]:
    """One paced fleet run.  ``role_map`` "" means a 2-replica
    monolithic fleet (the reference for the same trace); otherwise one
    replica per role entry.  ``phases`` overrides the single-phase
    pacing (see :func:`_pace`).  Returns (errors,
    responses-by-request-id)."""
    require_device(device)
    errors: list[str] = []
    disagg = bool(role_map)
    roles = role_map.split(",") if disagg else ["monolithic"] * 2
    label = f"disagg {role_map or 'monolithic'}"
    queue_dir = os.path.join(scratch, "queue")
    workdir = os.path.join(scratch, "wd")
    os.makedirs(queue_dir, exist_ok=True)
    os.makedirs(workdir, exist_ok=True)
    specs = {r.request_id: r.spec() for r in reqs}

    pacer = threading.Thread(
        target=_pace, args=(queue_dir, phases or [list(reqs)]),
        daemon=True,
    )
    pacer.start()
    extra = [
        "--trace-ring-events", str(DISAGG_RING),
        "--self-sigterm-after",
        str(sigterm_after if victim is not None else 0),
        "--sigterm-replica", str(victim if victim is not None else 0),
    ]
    if disagg:
        extra += ["--role-map", role_map]
    if fleet_cache:
        extra += ["--fleet-cache-dir", os.path.join(scratch, "fleet")]
    try:
        codes = _launch(len(roles),
                        _server_argv(queue_dir, workdir, device, *extra))
    finally:
        pacer.join(timeout=60)
    if pacer.is_alive():
        errors.append("replayer thread still pacing after fleet exit")
    if launch.aggregate_exit_codes(codes) != 0:
        errors.append(
            f"fleet exit codes {codes} (victim must DRAIN to 0)"
        )

    # -- request queue: exactly-once; only prefill replicas claim ----------
    responses = _audit_exactly_once(queue_dir, specs, errors, label)
    claims_by_replica = _claims_by_replica(queue_dir)
    if disagg:
        non_prefill = [
            rep for rep in claims_by_replica
            if roles[rep] != "prefill"
        ]
        if non_prefill:
            errors.append(
                f"non-prefill replicas claimed request files: "
                f"{sorted(non_prefill)}"
            )

    # -- handoff dir: every request shipped exactly once -------------------
    if disagg:
        handoff = os.path.join(queue_dir, "handoff")
        ship_claims: dict[int, list[str]] = {}
        for name in (
            os.listdir(os.path.join(handoff, "claimed"))
            if os.path.isdir(os.path.join(handoff, "claimed")) else []
        ):
            rid = int(name.split("-")[1].split(".")[0])
            ship_claims.setdefault(rid, []).append(name)
        for rid, names in sorted(ship_claims.items()):
            if len(names) > 1:
                errors.append(f"bundle {rid} claimed twice: {names}")
        if set(ship_claims) != set(specs):
            errors.append(
                "shipped-bundle set != request set: missing "
                f"{sorted(set(specs) - set(ship_claims))}, extra "
                f"{sorted(set(ship_claims) - set(specs))}"
            )
        leftovers = [
            n for n in os.listdir(handoff) if n.endswith(".kvh")
        ] if os.path.isdir(handoff) else []
        if leftovers:
            errors.append(f"unclaimed bundles left: {sorted(leftovers)}")
        n_prefill = sum(1 for r in roles if r == "prefill")
        n_done = sum(
            1 for n in os.listdir(handoff)
            if n.startswith("PREFILL_DONE.p")
        ) if os.path.isdir(handoff) else 0
        if n_done != n_prefill:
            errors.append(
                f"{n_done} PREFILL_DONE markers, expected {n_prefill}"
            )

    # -- responses: every token, decode-written, = solo generate -----------
    by_replica: dict[int, int] = {}
    for rid, resp in sorted(responses.items()):
        want = specs[rid]["max_new_tokens"]
        if len(resp["tokens"]) != want:
            errors.append(
                f"request {rid}: {len(resp['tokens'])} tokens, "
                f"expected {want}"
            )
        by_replica[resp["replica"]] = by_replica.get(resp["replica"], 0) + 1
        if disagg and roles[resp["replica"]] != "decode":
            errors.append(
                f"request {rid} answered by replica {resp['replica']} "
                f"({roles[resp['replica']]}) — only decode replicas "
                "stream multi-token responses in a disagg fleet"
            )
    solo.check(responses, specs, errors, label)
    print(f"  responses by replica: {by_replica}, "
          f"request claims by replica: {claims_by_replica}")

    # -- victim drained, survivor of the same role took over ---------------
    if victim is not None:
        vrole = roles[victim]
        served = (
            claims_by_replica.get(victim, 0) if vrole == "prefill"
            else by_replica.get(victim, 0)
        )
        if served < sigterm_after:
            errors.append(
                f"{vrole} victim handled {served} < {sigterm_after} "
                "requests — SIGTERM fired before real traffic"
            )
        survivors = sum(
            (claims_by_replica if vrole == "prefill" else by_replica)
            .get(i, 0)
            for i, r in enumerate(roles) if r == vrole and i != victim
        )
        if survivors == 0:
            errors.append(
                f"no surviving {vrole} replica served anything — "
                "no failover happened"
            )

    # -- forensics: schema, roles, per-role capture pins, fleet hits -------
    fleet_hits = 0.0
    for i, role in enumerate(roles):
        _lint_artifacts(workdir, i, ("--flight-recorder", "--serving-report"),
                        errors, label)
        stats_path = os.path.join(workdir, f"serving_stats_p{i}.json")
        if not os.path.exists(stats_path):
            continue
        with open(stats_path) as f:
            snap = json.load(f)
        metrics = snap.get("metrics", {})
        if disagg:
            if snap.get("role") != role:
                errors.append(
                    f"p{i}: stats role {snap.get('role')!r}, expected "
                    f"{role!r}"
                )
            want = (1.0, 0.0) if role == "prefill" else (0.0, 1.0)
            got = (
                metrics.get("serve/compiled_prefill"),
                metrics.get("serve/compiled_decode"),
            )
            if got != want:
                errors.append(
                    f"p{i} ({role}): captured (prefill, decode) "
                    f"programs {got}, expected {want} — the role pin "
                    "failed"
                )
            if role == "prefill":
                fleet_hits += metrics.get("serve/fleet_prefix_hits", 0.0)
        fsck = snap.get("fsck_errors")
        if fsck:
            errors.append(f"p{i} ({role}): fsck errors {fsck}")
    if fleet_cache and fleet_hits < 1:
        errors.append(
            "fleet prefix cache never hit: duplicates re-prefilled "
            "instead of adopting advertised pages"
        )
    r1_launches(workdir, range(len(roles)), device, errors, label)
    return errors, responses


def check_disagg_report(
    workdir: str, roles: list[str], n_requests: int
) -> list[str]:
    """Role-aware report forensics: replicas labelled, every request's
    decode-side waterfall attributed WITH a ship span, and
    queue + prefill + ship summing to measured TTFT; the prefill-side
    hand-off markers (finish_reason ``shipped``) counted, not
    attributed."""
    errors: list[str] = []
    report = _serving_report(workdir, errors, "disagg")
    if report is None:
        return errors
    want_roles = {str(i): role for i, role in enumerate(roles)}
    if report.get("roles") != want_roles:
        errors.append(
            f"disagg: report roles {report.get('roles')}, expected "
            f"{want_roles}"
        )
    att = report["attribution"]
    if att["shipped_out"] != n_requests:
        errors.append(
            f"disagg: {att['shipped_out']} shipped hand-off markers, "
            f"expected {n_requests}"
        )
    if att["attributed"] != n_requests:
        errors.append(
            f"disagg: {att['attributed']}/{n_requests} requests have an "
            "attributed decode-side waterfall"
        )
    if att["sum_bad"]:
        bad = [
            w for w in report["waterfalls"]
            if w["attributed"] and not w["sum_ok"]
        ]
        errors.append(
            f"disagg: {att['sum_bad']} waterfall(s) do not sum "
            "queue+prefill+ship to TTFT: " + ", ".join(
                f"p{w['proc']}/r{w['rid']} "
                f"err={w['attribution_err_s']:.4f}s"
                for w in bad[:5]
            )
        )
    no_ship = [
        w for w in report["waterfalls"]
        if w["attributed"] and w.get("ship_s") is None
    ]
    if no_ship:
        errors.append(
            "disagg: attributed waterfalls missing the ship span: "
            + ", ".join(f"p{w['proc']}/r{w['rid']}" for w in no_ship[:5])
        )
    print(
        f"  disagg report: roles {report.get('roles')}, "
        f"{att['sum_ok']}/{att['attributed']} waterfalls sum to TTFT, "
        f"{att['shipped_out']} shipped markers"
    )
    return errors


# -- overload / backpressure / autoscale arms ------------------------------
# The overload arm's shed driver is a deliberately unmeetable
# queue-depth SLO: the claim-ahead window (2 * max-slots) keeps ~4
# waiters queued behind 1s prefill-stall waves, so depth-p50 sits well
# above 1 and the breach latches early and for the whole run.  The
# TTFT SLO is the one shedding PROTECTS — generous enough that every
# ADMITTED request meets it even on the stalled replica — so the same
# report must show qdepth FAIL and ttft PASS.  Warmup 4 skips exactly
# the first prefill wave's samples on both keys (build and capture).
OVERLOAD_CLASSES = ("batch", "standard", "interactive")
OVERLOAD_STALL_MS = 1000.0
OVERLOAD_DEADLINES = 4  # trailing batch requests carry a 10ms deadline
OVERLOAD_ARGV = (
    "--stall-prefill-ms", str(OVERLOAD_STALL_MS),
    "--priority-classes", ",".join(OVERLOAD_CLASSES),
    "--shed-on-slo", "qdepth",
    "--max-shed-per-step", "1",
    "--slo", "qdepth=serve/queue_depth:p50<1@60s",
    "--slo", "ttft=serve/ttft_s:p99<30@60s",
    "--slo-warmup", "4",
    "--slo-breach-after", "1",
    "--timeseries-interval-s", "0.5",
)
BACKPRESSURE_ARGV = (
    "--stall-prefill-ms", "300",
    "--priority-classes", ",".join(OVERLOAD_CLASSES),
    "--backpressure-engage-queue", "3",
    "--backpressure-release-queue", "1",
)
AUTOSCALE_SPIKE = 20
AUTOSCALE_TRICKLE = 10


def _audit_exactly_once(
    queue_dir: str, specs: dict[int, dict], errors: list[str], label: str
) -> dict[int, dict]:
    """Shared claim/response ledger: every request claimed exactly once
    and answered exactly once.  Returns responses by request_id."""
    claimed_dir = os.path.join(queue_dir, "claimed")
    claims: dict[int, list[str]] = {}
    for name in (
        os.listdir(claimed_dir) if os.path.isdir(claimed_dir) else []
    ):
        rid = int(name.split("-")[1].split(".")[0])
        claims.setdefault(rid, []).append(name)
    for rid, names in sorted(claims.items()):
        if len(names) > 1:
            errors.append(f"{label}: request {rid} claimed twice: {names}")
    unclaimed = [
        n for n in os.listdir(queue_dir)
        if n.startswith("req-") and n.endswith(".json")
    ]
    if unclaimed:
        errors.append(
            f"{label}: requests never claimed: {sorted(unclaimed)}"
        )
    resp_dir = os.path.join(queue_dir, "resp")
    responses: dict[int, dict] = {}
    for name in os.listdir(resp_dir) if os.path.isdir(resp_dir) else []:
        if name.endswith(".json"):
            with open(os.path.join(resp_dir, name)) as f:
                responses[int(name.split("-")[1].split(".")[0])] = (
                    json.load(f)
                )
    missing = sorted(set(specs) - set(responses))
    extra = sorted(set(responses) - set(specs))
    if missing:
        errors.append(
            f"{label}: dropped responses (work lost): {missing}"
        )
    if extra:
        errors.append(f"{label}: responses for unknown requests: {extra}")
    return responses


def _overload_trace(n: int) -> list:
    """Pre-queued burst with a lowest-class-heavy mix: classes cycle
    batch, standard, batch, interactive — half the offered load is
    sheddable before anything standard-class is touched.  The LAST
    ``OVERLOAD_DEADLINES`` batch requests carry a 10ms TTFT deadline:
    claimed mid-run behind the stall waves, they are guaranteed
    deadline sheds riding alongside the SLO-driven ones."""
    cycle = ("batch", "standard", "batch", "interactive")
    reqs = replaylib.preset_trace("uniform", n, seed=23)
    for i, r in enumerate(reqs):
        r.priority = cycle[i % len(cycle)]
    left = OVERLOAD_DEADLINES
    for r in reversed(reqs):
        if left and r.priority == "batch":
            r.deadline_s = 0.01
            left -= 1
    return reqs


def _queue_burst(queue_dir: str, trace: list) -> dict[int, dict]:
    """Pre-queue ``trace`` and DONE; returns its specs by request_id."""
    for r in trace:
        replaylib.write_request(queue_dir, r)
    with open(os.path.join(queue_dir, "DONE"), "w") as f:
        f.write("done\n")
    return {r.request_id: r.spec() for r in trace}


def run_overload_arm(scratch: str, n: int, *, device: str,
                     solo: SoloReference) -> list[str]:
    """Deliberate overload against a 1-replica admission-enabled fleet:
    every shed request still gets a response, sheds take the lowest
    class first, per-class counters balance the response-side ledger,
    the protected TTFT SLO verdicts PASS while the shed-driving
    queue-depth SLO verdicts FAIL, and every served stream = solo
    ``generate``."""
    require_device(device)
    errors: list[str] = []
    queue_dir = os.path.join(scratch, "queue")
    workdir = os.path.join(scratch, "wd")
    os.makedirs(queue_dir, exist_ok=True)
    os.makedirs(workdir, exist_ok=True)
    specs = _queue_burst(queue_dir, _overload_trace(n))
    codes = _launch(1, _server_argv(queue_dir, workdir, device,
                                    *OVERLOAD_ARGV))
    if launch.aggregate_exit_codes(codes) != 0:
        errors.append(f"overload: fleet exit codes {codes}")

    responses = _audit_exactly_once(queue_dir, specs, errors, "overload")
    shed = {
        rid: r for rid, r in responses.items()
        if r.get("finish_reason") == "shed"
    }
    served = {rid: r for rid, r in responses.items() if rid not in shed}
    for rid, resp in sorted(shed.items()):
        if resp["tokens"]:
            errors.append(
                f"overload: shed request {rid} carries tokens "
                f"{resp['tokens']} — a shed response is an empty stream"
            )
    for rid, resp in sorted(served.items()):
        want = specs[rid]["max_new_tokens"]
        if len(resp["tokens"]) != want:
            errors.append(
                f"overload: request {rid}: {len(resp['tokens'])} tokens, "
                f"expected {want}"
            )
    solo.check(served, specs, errors, "overload")
    if not shed:
        errors.append(
            "overload: nothing shed — the arm never actually overloaded"
        )
    if not served:
        errors.append(
            "overload: everything shed — no admitted traffic to protect"
        )

    shed_by_class: dict[str, int] = {}
    for rid in shed:
        cls = specs[rid].get("priority") or "standard"
        shed_by_class[cls] = shed_by_class.get(cls, 0) + 1
    class_totals: dict[str, int] = {}
    for spec in specs.values():
        cls = spec.get("priority") or "standard"
        class_totals[cls] = class_totals.get(cls, 0) + 1
    print(
        f"  overload: {len(shed)} shed / {len(served)} served, "
        f"sheds by class {shed_by_class}"
    )
    if shed_by_class.get("batch", 0) < 1:
        errors.append(
            "overload: no batch-class shed — the lowest class sheds first"
        )
    if shed_by_class.get("interactive", 0) > shed_by_class.get("batch", 0):
        errors.append(
            f"overload: interactive shed more than batch "
            f"({shed_by_class}) — priority order inverted"
        )

    _lint_artifacts(workdir, 0, tuple(_ARTIFACTS), errors, "overload")
    stats_path = os.path.join(workdir, "serving_stats_p0.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            snap = json.load(f)["metrics"]
        # Counters mirror the response-side ledger exactly: shed +
        # served == answered, per class.
        for cls in OVERLOAD_CLASSES:
            got = snap.get(f"serve/shed/{cls}", 0.0)
            if int(got) != shed_by_class.get(cls, 0):
                errors.append(
                    f"overload: serve/shed/{cls} counter {got:g} != "
                    f"{shed_by_class.get(cls, 0)} shed responses"
                )
            got = snap.get(f"serve/submitted/{cls}", 0.0)
            if int(got) != class_totals.get(cls, 0):
                errors.append(
                    f"overload: serve/submitted/{cls} counter {got:g} != "
                    f"{class_totals.get(cls, 0)} requests of that class"
                )
    r1_launches(workdir, (0,), device, errors, "overload")

    report = _serving_report(workdir, errors, "overload")
    if report is None:
        return errors
    verdicts = {row["slo"]: row["verdict"] for row in report["slo"]}
    if verdicts.get("qdepth") != "FAIL":
        errors.append(
            f"overload: queue-depth SLO verdict "
            f"{verdicts.get('qdepth')!r}, expected FAIL (the shed driver)"
        )
    if verdicts.get("ttft") != "PASS":
        errors.append(
            f"overload: TTFT SLO verdict {verdicts.get('ttft')!r}, "
            "expected PASS — shedding failed to protect admitted traffic"
        )
    rows = {
        r["class"]: r
        for r in report.get("admission", {}).get("classes", [])
        if int(r["proc"]) == 0
    }
    if set(rows) != set(OVERLOAD_CLASSES):
        errors.append(
            f"overload: report admission table has classes "
            f"{sorted(rows)}, expected {sorted(OVERLOAD_CLASSES)}"
        )
    return errors


def run_backpressure_arm(scratch: str, n: int, *, device: str,
                         solo: SoloReference) -> list[str]:
    """The same style of burst with the queue-depth backpressure gate
    on and NO shed policy: intake must pause (engage episodes counted)
    instead of shedding, and every request is still answered in full,
    exactly once, each stream = solo ``generate`` — backpressure defers
    work, it never discards it."""
    require_device(device)
    errors: list[str] = []
    queue_dir = os.path.join(scratch, "queue")
    workdir = os.path.join(scratch, "wd")
    os.makedirs(queue_dir, exist_ok=True)
    os.makedirs(workdir, exist_ok=True)
    specs = _queue_burst(queue_dir,
                         replaylib.preset_trace("uniform", n, seed=27))
    codes = _launch(1, _server_argv(queue_dir, workdir, device,
                                    *BACKPRESSURE_ARGV))
    if launch.aggregate_exit_codes(codes) != 0:
        errors.append(f"backpressure: fleet exit codes {codes}")

    responses = _audit_exactly_once(
        queue_dir, specs, errors, "backpressure"
    )
    for rid, resp in sorted(responses.items()):
        want = specs[rid]["max_new_tokens"]
        if resp.get("finish_reason") == "shed":
            errors.append(
                f"backpressure: request {rid} shed — the gate must "
                "defer intake, never shed (no shed policy configured)"
            )
        elif len(resp["tokens"]) != want:
            errors.append(
                f"backpressure: request {rid}: {len(resp['tokens'])} "
                f"tokens, expected {want}"
            )
    solo.check(responses, specs, errors, "backpressure")
    r1_launches(workdir, (0,), device, errors, "backpressure")

    stats_path = os.path.join(workdir, "serving_stats_p0.json")
    if not os.path.exists(stats_path):
        errors.append(f"backpressure: missing artifact {stats_path}")
        return errors
    _schema_check(stats_path, "--serving-report", errors)
    with open(stats_path) as f:
        snap = json.load(f)["metrics"]
    episodes = snap.get("serve/backpressure_engaged", 0.0)
    print(f"  backpressure: {episodes:g} engage episode(s)")
    if episodes < 1:
        errors.append(
            "backpressure: gate never engaged — the burst should have "
            "crossed the depth-3 engage threshold"
        )
    if snap.get("serve/backpressure") != 0.0:
        errors.append(
            f"backpressure: gauge {snap.get('serve/backpressure')!r} at "
            "drain, expected 0.0 (released once the queue emptied)"
        )
    shed_total = sum(
        v for k, v in snap.items() if k.startswith("serve/shed/")
    )
    if shed_total:
        errors.append(
            f"backpressure: {shed_total:g} sheds counted with no shed "
            "policy configured"
        )
    return errors


def _autoscale_phases() -> list[list]:
    """Bursty two-phase autoscale trace: a dense spike (backlog far
    above the policy's up threshold, recruiting a replica) then a
    sparse trickle long enough for the down-streak to drain one
    mid-stream.  The pacer gates the trickle on the spike's responses,
    so the lull the controller sees is a real lull."""
    spike = replaylib.preset_trace("uniform", AUTOSCALE_SPIKE, seed=29)
    replaylib.stamp_arrivals(spike, replaylib.bursty_arrivals(
        AUTOSCALE_SPIKE, seed=290, lull_gap_s=0.4, spike_gap_s=0.015,
        lull_s=0.5, spike_s=60.0,
    ))
    trickle = replaylib.preset_trace(
        "uniform", AUTOSCALE_TRICKLE, seed=31, first_id=AUTOSCALE_SPIKE
    )
    replaylib.stamp_arrivals(trickle, replaylib.open_loop_arrivals(
        AUTOSCALE_TRICKLE, seed=310, mean_gap_s=1.0,
    ))
    return [spike, trickle]


def run_autoscale_arm(
    scratch: str, *, device: str, solo: SoloReference, controller_on: bool
) -> tuple[list[str], dict[int, dict]]:
    """One paced spike + trickle run.  With ``controller_on`` a
    FleetAutoscaler resizes the fleet mid-stream (scale-up AND
    scale-down asserted, each with its forensic trail); without it the
    run is the unresized reference.  Every stream = solo ``generate``
    either way."""
    require_device(device)
    errors: list[str] = []
    label = "autoscale" if controller_on else "autoscale-ref"
    queue_dir = os.path.join(scratch, "queue")
    workdir = os.path.join(scratch, "wd")
    os.makedirs(queue_dir, exist_ok=True)
    os.makedirs(workdir, exist_ok=True)
    phases = _autoscale_phases()
    reqs = [r for phase in phases for r in phase]
    specs = {r.request_id: r.spec() for r in reqs}

    reports: list = []
    pacer = threading.Thread(
        target=_pace, args=(queue_dir, phases, reports), daemon=True
    )
    pacer.start()
    extra = ["--timeseries-interval-s", "0.25"]
    controller = None
    if controller_on:
        extra += ["--fleet-file", os.path.join(workdir, "fleet_size.json")]
        controller = launch.FleetAutoscaler(
            workdir, queue_dir=queue_dir, poll_interval_s=0.3,
            policy=admlib.AutoscalePolicy(
                min_replicas=1, max_replicas=2,
                up_backlog=3.0, down_backlog=1.0,
                up_after=2, down_after=4, cooldown=8,
            ),
        )
    try:
        codes = _launch(1, _server_argv(queue_dir, workdir, device, *extra),
                        scale_controller=controller)
    finally:
        pacer.join(timeout=60)
    if pacer.is_alive():
        errors.append(f"{label}: replayer still pacing after fleet exit")
    if launch.aggregate_exit_codes(codes) != 0:
        errors.append(
            f"{label}: fleet exit codes {codes} (a drained victim must "
            "exit 0)"
        )

    responses = _audit_exactly_once(queue_dir, specs, errors, label)
    for rid, resp in sorted(responses.items()):
        want = specs[rid]["max_new_tokens"]
        if len(resp["tokens"]) != want:
            errors.append(
                f"{label}: request {rid}: {len(resp['tokens'])} tokens, "
                f"expected {want}"
            )
    solo.check(responses, specs, errors, label)
    r1_launches(workdir, range(len(codes)), device, errors, label)
    for rep in reports:
        print(
            f"  {label} pacing: offered {rep.offered_qps:.1f} qps, "
            f"achieved {rep.achieved_qps:.1f} qps, "
            f"error {rep.pacing_error * 100:+.1f}%"
        )
    if not controller_on:
        return errors, responses

    # -- scale-event forensics ---------------------------------------------
    events: list[dict] = []
    ev_path = os.path.join(workdir, "scale_events.jsonl")
    if os.path.exists(ev_path):
        with open(ev_path) as f:
            for line in f:
                if line.strip():
                    events.append(json.loads(line))
    ups = [e for e in events if e["event"] == "scale_up"]
    downs = [e for e in events if e["event"] == "scale_down"]
    by_replica: dict[int, int] = {}
    for resp in responses.values():
        by_replica[resp["replica"]] = by_replica.get(resp["replica"], 0) + 1
    print(
        f"  autoscale: {len(ups)} scale_up / {len(downs)} scale_down, "
        f"responses by replica {by_replica}"
    )
    if not ups:
        errors.append(
            "autoscale: the spike never recruited a replica "
            "(no scale_up event)"
        )
    if not downs:
        errors.append(
            "autoscale: the lull never drained a replica "
            "(no scale_down event)"
        )
    if controller.events != len(events):
        errors.append(
            f"autoscale: controller counted {controller.events} events, "
            f"the journal has {len(events)}"
        )
    for k in range(len(events)):
        path = os.path.join(workdir, f"flight_autoscale_{k}.json")
        if not os.path.exists(path):
            errors.append(
                f"autoscale: scale event {k} left no flight record"
            )
        else:
            _schema_check(path, "--flight-recorder", errors)
    if ups and not any(i >= 1 and n > 0 for i, n in by_replica.items()):
        errors.append(
            "autoscale: the recruited replica served nothing — the "
            "scale-up added no capacity"
        )

    # Every replica ever spawned (initial + one per scale_up) drained
    # cleanly enough to leave schema-valid artifacts.
    for i in range(1 + len(ups)):
        _lint_artifacts(workdir, i, tuple(_ARTIFACTS), errors, "autoscale")

    # Replica 0 outlives both membership changes and must have mirrored
    # them off the fleet file into its own registry.
    stats_path = os.path.join(workdir, "serving_stats_p0.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            snap = json.load(f)["metrics"]
        if snap.get("serve/scale_up", 0.0) < 1:
            errors.append(
                "autoscale: replica 0 never mirrored the scale-up "
                "(serve/scale_up counter is zero)"
            )
        if snap.get("serve/scale_down", 0.0) < 1:
            errors.append(
                "autoscale: replica 0 never mirrored the scale-down "
                "(serve/scale_down counter is zero)"
            )
        if snap.get("serve/fleet_size") != 1.0:
            errors.append(
                f"autoscale: serve/fleet_size gauge "
                f"{snap.get('serve/fleet_size')!r} at drain, expected "
                "1.0 after the lull's scale-down"
            )

    # The report renders the scale timeline against throughput.
    report = _serving_report(workdir, errors, "autoscale")
    if report is None:
        return errors, responses
    timeline = report.get("scale_events", [])
    if len(timeline) != len(events):
        errors.append(
            f"autoscale: report timeline has {len(timeline)} scale "
            f"events, the journal has {len(events)}"
        )
    if any("t_rel_s" not in e for e in timeline):
        errors.append(
            "autoscale: report scale events missing the t_rel_s "
            "throughput correlation stamp"
        )
    return errors, responses


# -- deploy arm ------------------------------------------------------------
# The staged timeline: (step, expected terminal event, reason marker).
# Steps 2 and 4 are good weights (promote); 6 is NaN-poisoned (final
# semantic reject); 7 is a torn layout (structural reject after the
# retry polls); 9 restores clean but its canary traffic is stalled
# via --stall-version, breaching the deploy SLO (rollback).
DEPLOY_TIMELINE = (
    (2, "promote", None),
    (4, "promote", None),
    (6, "reject", "non-finite"),
    (7, "reject", "fsck"),
    (9, "rollback", None),
)
DEPLOY_FRACTION = 0.5
DEPLOY_SEED = 0
DEPLOY_WARMUP = 2
DEPLOY_STALL_MS = 2500.0
DEPLOY_SLO = f"cttft=serve/ttft_s:p99<{SLO_THRESHOLD_S}@30s"
DEPLOY_PHASE = 8  # requests per timeline phase (extended per routing)


def _deploy_helper_main(mode: str, spec_path: str) -> int:
    """Child-process entry of the deploy arm.

    ``build-staging`` plays the trainer: one port ``CheckpointManager``
    step per timeline step into a staging checkpoint directory (the
    parent publishes them at cadence by atomic rename), the candidate's
    weights ``server.drill_model`` from a generator seeded by the step,
    so every version decodes differently; a poisoned step's weights are
    multiplied by NaN.  ``solo-ref`` computes the references: for each
    version, its weights (the replica's boot weights for version 0, the
    checkpoint's ``params/*`` otherwise) in a fresh engine and scheduler
    on the replica's device, serving every request that version
    answered."""
    with open(spec_path) as f:
        spec = json.load(f)
    import torch

    if mode == "build-staging":
        from distributed_tensorflow_models_tpu_torch.core.train_state import (
            TrainState,
        )
        from distributed_tensorflow_models_tpu_torch.harness.checkpoint import (
            CheckpointManager,
        )
        from distributed_tensorflow_models_tpu_torch.ops import optim
        from distributed_tensorflow_models_tpu_torch.telemetry import registry

        mgr = CheckpointManager(spec["staging"], keep=len(spec["steps"]),
                                registry=registry.MetricsRegistry())
        for entry in spec["steps"]:
            step = int(entry["step"])
            model = serverlib.drill_model(64, seed=step)
            if entry.get("poison"):
                with torch.no_grad():
                    for p in model.parameters():
                        p.mul_(float("nan"))
            mgr.save(TrainState.create(model, optim.sgd(0.1))
                     .replace(step=step))
            mgr.wait()
        return 0
    if mode == "solo-ref":
        import numpy as np

        from distributed_tensorflow_models_tpu_torch.serving.engine import (
            InferenceEngine,
        )
        from distributed_tensorflow_models_tpu_torch.serving.scheduler import (
            ContinuousBatchingScheduler,
            Request,
        )

        out: dict[str, list[int]] = {}
        for ver, reqs in sorted(spec["versions"].items()):
            vid = int(ver)
            params = None if vid == 0 else deploylib.load_candidate_params(
                os.path.join(spec["ckpt_dir"], str(vid)))
            eng = InferenceEngine(
                serverlib.drill_model(64), params, device=spec["device"],
                max_slots=4, prefill_chunk=8,
            )
            sched = ContinuousBatchingScheduler(eng)
            for r in reqs:
                sched.submit(Request(
                    request_id=int(r["request_id"]),
                    prompt=np.asarray(r["prompt"], np.int32),
                    max_new_tokens=int(r["max_new_tokens"]),
                ))
            while sched.has_work:
                for comp in sched.step():
                    out[str(comp.request_id)] = [
                        int(t) for t in comp.tokens
                    ]
        with open(spec["out"], "w") as f:
            json.dump(out, f)
        return 0
    print(f"unknown --deploy-helper mode {mode!r}", file=sys.stderr)
    return 2


def _deploy_helper(mode: str, spec: dict, spec_path: str) -> Optional[str]:
    """Run :func:`_deploy_helper_main` in a process of its own; its
    stderr when it fails, else None."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    proc = subprocess.run(
        [sys.executable, "-m", DRILL, "--deploy-helper", mode,
         "--helper-spec", spec_path],
        capture_output=True, text=True,
        env={**os.environ, **_fleet_env()},
    )
    return proc.stderr if proc.returncode != 0 else None


def _deploy_phase_reqs(first_id: int, *, min_canary: int) -> list[dict]:
    """One phase of greedy requests (greedy so solo references need no
    sampling-key bookkeeping).  Routing is a pure rid-hash, so the
    parent PRE-COMPUTES the canary share and extends the phase until at
    least ``min_canary`` rids would route to a canary — warmup can then
    never starve deterministically."""
    specs: list[dict] = []
    canary = 0
    rid = first_id
    while len(specs) < DEPLOY_PHASE or canary < min_canary:
        if deploylib.rid_fraction(DEPLOY_SEED, str(rid)) < DEPLOY_FRACTION:
            canary += 1
        prompt = [(5 + 3 * rid + j) % 64 for j in range(4 + rid % 4)]
        specs.append({
            "request_id": rid, "prompt": prompt,
            "max_new_tokens": 5 + rid % 3,
            "temperature": 0.0, "top_k": 0, "top_p": 1.0,
        })
        rid += 1
    return specs


def _emit_paced(queue_dir: str, specs: list[dict],
                gap_s: float = 0.04) -> None:
    for spec in specs:
        path = os.path.join(queue_dir, f"req-{spec['request_id']}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(spec, f)
        os.replace(path + ".tmp", path)
        time.sleep(gap_s)


def _wait_responses(queue_dir: str, want: set[int],
                    timeout_s: float) -> bool:
    resp_dir = os.path.join(queue_dir, "resp")
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        have = {
            int(n.split("-")[1].split(".")[0])
            for n in os.listdir(resp_dir) if n.endswith(".json")
        } if os.path.isdir(resp_dir) else set()
        if want <= have:
            return True
        time.sleep(0.05)
    return False


def _wait_deploy_event(workdir: str, event: str, step: int,
                       timeout_s: float) -> bool:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        for row in deploylib.load_deploy_events(workdir):
            if row.get("event") == event and row.get("step") == step:
                return True
        time.sleep(0.05)
    return False


def _publish_step(staging: str, ckpt_dir: str, step: int) -> None:
    """Atomic-rename a staged step (sidecars FIRST, so the step is
    fleet-valid from the instant the follower can see it)."""
    side_src = os.path.join(staging, "dataset_states", str(step))
    if os.path.isdir(side_src):
        dst_base = os.path.join(ckpt_dir, "dataset_states")
        os.makedirs(dst_base, exist_ok=True)
        os.replace(side_src, os.path.join(dst_base, str(step)))
    os.replace(
        os.path.join(staging, str(step)), os.path.join(ckpt_dir, str(step))
    )


def _deploy_trainer(queue_dir: str, workdir: str, ckpt_dir: str,
                    staging: str, phases: list[list[dict]],
                    errors: list[str]) -> None:
    """Parent-thread trainer-and-pacer: warm the fleet (first-dispatch
    build and capture time must not contaminate canary TTFT windows),
    then walk the timeline — publish a step, let its canary (if any)
    start, offer a phase of traffic, and wait for the step's terminal
    verdict — publishing DONE at the end."""
    _emit_paced(queue_dir, phases[0])
    if not _wait_responses(
        queue_dir, {s["request_id"] for s in phases[0]}, 180.0
    ):
        errors.append("deploy: warmup phase never fully answered")
    for (step, event, _), phase in zip(DEPLOY_TIMELINE, phases[1:]):
        _publish_step(staging, ckpt_dir, step)
        if event in ("promote", "rollback"):
            # Gate traffic on the canary actually existing, so every
            # phase rid routes against it (pure-hash determinism).
            if not _wait_deploy_event(workdir, "canary_start", step, 60.0):
                errors.append(f"deploy: step {step} canary never started")
                break
        _emit_paced(queue_dir, phase)
        if not _wait_deploy_event(workdir, event, step, 120.0):
            errors.append(
                f"deploy: no {event} for step {step} within 120s"
            )
            break
    done = os.path.join(queue_dir, "DONE")
    with open(done + ".tmp", "w") as f:
        f.write("done\n")
    os.replace(done + ".tmp", done)


def run_deploy_arm(scratch: str, *, device: str) -> list[str]:
    """Continuous-deployment drill: live hot-swaps, pre-swap rejects,
    and an SLO-gated rollback against one followed checkpoint dir."""
    require_device(device)
    errors: list[str] = []
    queue_dir = os.path.join(scratch, "queue")
    workdir = os.path.join(scratch, "wd")
    ckpt_dir = os.path.join(scratch, "ckpts")
    staging_root = os.path.join(scratch, "staging")
    # CheckpointManager(root) writes its steps under root/checkpoints.
    staging = os.path.join(staging_root, "checkpoints")
    for d in (queue_dir, workdir, ckpt_dir, staging_root):
        os.makedirs(d, exist_ok=True)

    # Stage every candidate in a child; step 7's torn layout needs no
    # weights — fabricate it here.
    failed = _deploy_helper("build-staging", {
        "staging": staging_root,
        "steps": [
            {"step": step, "poison": reason == "non-finite"}
            for step, _, reason in DEPLOY_TIMELINE
            if reason != "fsck"
        ],
    }, os.path.join(scratch, "staging_spec.json"))
    if failed is not None:
        errors.append(f"deploy: staging builder failed: {failed}")
        return errors
    torn_dir = os.path.join(staging, "7")
    os.makedirs(torn_dir, exist_ok=True)
    # A torn tensor file and no COMMITTED marker or manifest: the port's
    # torn-write signature (resilience/fsck.py).
    open(os.path.join(torn_dir, "state.pt"), "wb").close()

    # Phases: warmup + one per timeline step.  Promote/rollback phases
    # are extended until the rid-hash guarantees enough canary traffic.
    phases: list[list[dict]] = []
    next_id = 0
    phases.append(_deploy_phase_reqs(next_id, min_canary=0))  # warmup
    next_id += len(phases[-1])
    for _, event, _reason in DEPLOY_TIMELINE:
        need = DEPLOY_WARMUP + 1 if event in ("promote", "rollback") else 0
        phases.append(_deploy_phase_reqs(next_id, min_canary=need))
        next_id += len(phases[-1])
    specs = {s["request_id"]: s for phase in phases for s in phase}

    trainer = threading.Thread(
        target=_deploy_trainer,
        args=(queue_dir, workdir, ckpt_dir, staging, phases, errors),
        daemon=True,
    )
    trainer.start()
    argv = _server_argv(
        queue_dir, workdir, device,
        "--follow-checkpoints", ckpt_dir,
        "--follow-poll-s", "0.1",
        "--canary-fraction", str(DEPLOY_FRACTION),
        "--canary-warmup", str(DEPLOY_WARMUP),
        "--promote-after", "2",
        "--rollback-after", "1",
        "--deploy-seed", str(DEPLOY_SEED),
        "--deploy-slo", DEPLOY_SLO,
        "--stall-version", "9",
        "--stall-canary-ms", str(DEPLOY_STALL_MS),
        "--timeseries-interval-s", "0.5",
    )
    try:
        codes = _launch(1, argv)
    finally:
        trainer.join(timeout=60)
    if trainer.is_alive():
        errors.append("deploy: trainer thread still running after exit")
    if launch.aggregate_exit_codes(codes) != 0:
        errors.append(f"deploy: fleet exit codes {codes}")

    responses = _audit_exactly_once(queue_dir, specs, errors, "deploy")
    for rid, resp in sorted(responses.items()):
        want = specs[rid]["max_new_tokens"]
        if len(resp["tokens"]) != want:
            errors.append(
                f"deploy: request {rid}: {len(resp['tokens'])} tokens, "
                f"expected {want}"
            )
        if "version" not in resp:
            errors.append(f"deploy: request {rid} has no version stamp")

    # -- deploy journal: the exact staged timeline -------------------------
    events = deploylib.load_deploy_events(workdir)
    by_kind: dict[str, list[dict]] = {}
    for row in events:
        by_kind.setdefault(row["event"], []).append(row)
    promoted = [r["step"] for r in by_kind.get("promote", [])]
    if promoted != [2, 4]:
        errors.append(f"deploy: promotes {promoted}, expected [2, 4]")
    rolled = [r["step"] for r in by_kind.get("rollback", [])]
    if rolled != [9]:
        errors.append(f"deploy: rollbacks {rolled}, expected [9]")
    started = [r["step"] for r in by_kind.get("canary_start", [])]
    if started != [2, 4, 9]:
        errors.append(f"deploy: canary starts {started}, expected [2,4,9]")
    rejects = {r["step"]: r for r in by_kind.get("reject", [])}
    if sorted(rejects) != [6, 7]:
        errors.append(
            f"deploy: rejects {sorted(rejects)}, expected [6, 7]"
        )
    for step, _, marker in DEPLOY_TIMELINE:
        if marker and step in rejects and not any(
            marker in reason for reason in rejects[step].get("reasons", [])
        ):
            errors.append(
                f"deploy: step {step} reject reasons "
                f"{rejects[step].get('reasons')} carry no {marker!r}"
            )
    for row in by_kind.get("rollback", []):
        if not row.get("breached"):
            errors.append(
                "deploy: rollback row records no breached SLOs — the "
                "rollback must be SLO-evidenced, not spurious"
            )

    # -- stats: swap/reject counters, version gauges, capture pins ---------
    _lint_artifacts(workdir, 0, tuple(_ARTIFACTS), errors, "deploy")
    r1_launches(workdir, (0,), device, errors, "deploy")
    stats_path = os.path.join(workdir, "serving_stats_p0.json")
    vids_served: set[int] = set()
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            snap = json.load(f)["metrics"]
        for key, want in (
            ("serve/deploy_swaps", 2.0),
            ("serve/deploy_rollbacks", 1.0),
            ("serve/deploy_rejected_candidates", 2.0),
            ("serve/version/active", 4.0),
            ("serve/version/canary", -1.0),
        ):
            if snap.get(key) != want:
                errors.append(
                    f"deploy: {key} = {snap.get(key)!r}, expected {want}"
                )
        # ZERO recaptures across two hot-swaps and a rollback: still
        # exactly one prefill and one decode program.
        pins = (
            snap.get("serve/compiled_prefill"),
            snap.get("serve/compiled_decode"),
        )
        if pins != (1.0, 1.0):
            errors.append(
                f"deploy: captured (prefill, decode) programs {pins}, "
                "expected (1.0, 1.0) — a hot-swap recaptured"
            )
        vids_stats = {
            int(k.rsplit("/", 1)[1]) for k in snap
            if k.startswith("serve/version/requests/")
        }
        vids_served = {int(r["version"]) for r in responses.values()
                       if "version" in r}
        if vids_stats != vids_served:
            errors.append(
                f"deploy: per-version stats families {sorted(vids_stats)}"
                f" != versions in responses {sorted(vids_served)}"
            )
        if not {0, 2, 4} <= vids_served:
            errors.append(
                f"deploy: responses span versions {sorted(vids_served)} — "
                "expected v0, v2 and v4 traffic across the two swaps"
            )

    # -- per-event flight records ------------------------------------------
    n_flights = sum(
        len(by_kind.get(k, []))
        for k in ("canary_start", "promote", "rollback", "reject")
    )
    for k in range(n_flights):
        path = os.path.join(workdir, f"flight_deploy_p0_{k}.json")
        if not os.path.exists(path):
            errors.append(f"deploy: event {k} left no flight record")
        else:
            _schema_check(path, "--flight-recorder", errors)

    # -- report: deploy timeline + per-version table -----------------------
    report = _serving_report(workdir, errors, "deploy")
    if report is not None:
        dep = report.get("deploy") or {}
        if len(dep.get("events", [])) != len(events):
            errors.append(
                f"deploy: report timeline has "
                f"{len(dep.get('events', []))} events, journal has "
                f"{len(events)}"
            )
        table_vids = {int(r["version"]) for r in dep.get("versions", [])}
        if not vids_served <= table_vids:
            errors.append(
                f"deploy: report version table covers {sorted(table_vids)}"
                f", responses saw {sorted(vids_served)}"
            )

    # -- every response vs its version's solo engine run -------------------
    by_version: dict[str, list[dict]] = {}
    for rid, resp in responses.items():
        if "version" in resp:
            by_version.setdefault(str(resp["version"]), []).append(
                specs[rid]
            )
    ref_out = os.path.join(scratch, "solo_ref.json")
    failed = _deploy_helper("solo-ref", {
        "ckpt_dir": ckpt_dir, "out": ref_out, "device": device,
        "versions": by_version,
    }, os.path.join(scratch, "solo_spec.json"))
    if failed is not None:
        errors.append(f"deploy: solo-ref helper failed: {failed}")
        return errors
    with open(ref_out) as f:
        refs = json.load(f)
    diverged = 0
    for rid, resp in sorted(responses.items()):
        ref = refs.get(str(rid))
        if ref is None:
            errors.append(f"deploy: no solo reference for request {rid}")
        elif resp["tokens"] != ref:
            diverged += 1
            if diverged <= 5:
                errors.append(
                    f"deploy: request {rid} (v{resp.get('version')}) "
                    f"diverged from its version's solo run: "
                    f"{resp['tokens']} vs {ref}"
                )
    by_vid_count = {
        v: len(rs) for v, rs in sorted(by_version.items(), key=lambda kv:
                                       int(kv[0]))
    }
    print(
        f"  deploy: {len(responses)} responses by version {by_vid_count}, "
        f"{len(promoted)} promotes, {len(rolled)} rollback, "
        f"{len(rejects)} rejects, {n_flights} flight records"
    )
    return errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="the replicas' device: the card (default; raises where no "
        "CUDA device is found) or the CPU",
    )
    p.add_argument("--requests", type=int, default=24)
    p.add_argument(
        "--scratch", default=None,
        help="working directory (default: a fresh temp dir)",
    )
    p.add_argument(
        "--keep", action="store_true",
        help="keep the scratch dir (queue, responses, flight records)",
    )
    p.add_argument(
        "--spec-tokens", type=int, default=3,
        help="draft depth of the speculative arm (0 skips that arm)",
    )
    p.add_argument(
        "--no-slo", action="store_true",
        help="skip the SLO observability arms (clean + injected stall)",
    )
    p.add_argument(
        "--no-disagg", action="store_true",
        help="skip the disaggregated prefill/decode arms (D1-D3)",
    )
    p.add_argument(
        "--no-overload", action="store_true",
        help="skip the overload arms (priority shedding + backpressure)",
    )
    p.add_argument(
        "--no-autoscale", action="store_true",
        help="skip the closed-loop autoscale arm and its unresized "
        "reference run",
    )
    p.add_argument(
        "--no-deploy", action="store_true",
        help="skip the continuous-deployment arm (hot-swap / canary / "
        "SLO-gated promote-rollback against a followed checkpoint dir)",
    )
    # Child-process plumbing for the deploy arm (staging saves and the
    # solo references run in processes of their own).
    p.add_argument("--deploy-helper", default=None, help=argparse.SUPPRESS)
    p.add_argument("--helper-spec", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.deploy_helper:
        return _deploy_helper_main(args.deploy_helper, args.helper_spec)
    require_device(args.device)

    scratch = args.scratch or tempfile.mkdtemp(prefix="dtm-serve-drill-")
    os.makedirs(scratch, exist_ok=True)
    device = args.device
    solo = SoloReference(device)
    seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def arm(name: str):
        t0 = time.perf_counter()
        yield
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"  {name} arm: {seconds[name]} s")

    failed = False
    try:
        print(f"serve drill in {scratch}: {args.requests} requests, "
              f"2 replicas on {device}, SIGTERM replica {VICTIM} after "
              f"{SIGTERM_AFTER} responses")
        errors = []
        with arm("base"):
            base_errors, base_resp = run_drill(
                os.path.join(scratch, "base"), args.requests, device=device,
                solo=solo,
            )
        errors += base_errors
        if args.spec_tokens:
            # Speculative arm: identical request mix through a spec-on
            # fleet.  Exactly-once and drain checks run inside
            # run_drill; on top, every request's stream (all modes are
            # per-request-seeded, hence deterministic) must be equal to
            # the spec-off arm's — speculation is a throughput knob,
            # never a token knob, even across drains and failovers.
            print(f"  speculative arm: spec_tokens={args.spec_tokens}")
            with arm("speculative"):
                spec_errors, spec_resp = run_drill(
                    os.path.join(scratch, "spec"), args.requests,
                    device=device, solo=solo, spec_tokens=args.spec_tokens,
                )
            errors += spec_errors
            for rid in sorted(set(base_resp) & set(spec_resp)):
                if base_resp[rid]["tokens"] != spec_resp[rid]["tokens"]:
                    errors.append(
                        f"request {rid}: spec-on stream diverged from "
                        f"spec-off: {spec_resp[rid]['tokens']} vs "
                        f"{base_resp[rid]['tokens']}"
                    )
        if not args.no_slo:
            # SLO observability arms: a clean fleet under a TTFT SLO must
            # report zero breaches and all-PASS verdicts; the same fleet
            # with an injected prefill stall must provably trip a breach
            # instant and a FAIL verdict.  Both arms double as the
            # end-to-end check of waterfall attribution (queue + prefill
            # + decode == TTFT) and of the time-series schema; streams
            # stay equal to solo generate (tracing is a read-only tap).
            print(f"  slo clean arm: {SLO_SPEC}")
            clean_dir = os.path.join(scratch, "slo-clean")
            with arm("slo-clean"):
                clean_errors, _ = run_drill(
                    clean_dir, args.requests, device=device, solo=solo,
                    extra_argv=SLO_ARGV,
                )
                errors += clean_errors
                errors += check_slo_arm(
                    os.path.join(clean_dir, "wd"), expect_breach=False
                )
            print(f"  slo stall arm: {SLO_STALL_MS:.0f}ms prefill stall")
            stall_dir = os.path.join(scratch, "slo-stall")
            with arm("slo-stall"):
                stall_errors, _ = run_drill(
                    stall_dir, args.requests, device=device, solo=solo,
                    extra_argv=SLO_ARGV + (
                        "--stall-prefill-ms", str(SLO_STALL_MS),
                    ),
                )
                errors += stall_errors
                errors += check_slo_arm(
                    os.path.join(stall_dir, "wd"), expect_breach=True
                )
        if not args.no_disagg:
            # D1: 1 prefill + 1 decode under the paced interference
            # trace, vs a monolithic fleet on the SAME trace — every
            # stream (greedy AND seeded sampling modes: the replica
            # derives the seed from request_id, so same-rid streams are
            # comparable across topologies) must be equal, and equal to
            # solo generate.
            trace = _disagg_trace(args.requests)
            print(
                f"  disagg arm D1: 1 prefill + 1 decode, "
                f"{len(trace)} paced requests"
            )
            d1_dir = os.path.join(scratch, "disagg")
            with arm("disagg-D1"):
                d1_errors, d1_resp = run_disagg_drill(
                    d1_dir, trace, device=device, solo=solo,
                    role_map="prefill,decode",
                )
                errors += d1_errors
                errors += check_disagg_report(
                    os.path.join(d1_dir, "wd"), ["prefill", "decode"],
                    len(trace),
                )
            print("  disagg reference: monolithic fleet, same trace")
            with arm("disagg-reference"):
                ref_errors, ref_resp = run_disagg_drill(
                    os.path.join(scratch, "disagg-ref"), trace,
                    device=device, solo=solo,
                )
            errors += ref_errors
            for rid in sorted(set(d1_resp) & set(ref_resp)):
                if d1_resp[rid]["tokens"] != ref_resp[rid]["tokens"]:
                    errors.append(
                        f"request {rid}: disagg stream diverged from "
                        f"monolithic: {d1_resp[rid]['tokens']} vs "
                        f"{ref_resp[rid]['tokens']}"
                    )
            # D2: prefill-role victim + fleet-wide prefix cache.  The
            # victim is replica 0 — the replica that claims the
            # originals — so the duplicates are served by the survivor
            # off the victim's advertised pages.
            fphases = _fleet_trace(8)
            ftrace = [r for phase in fphases for r in phase]
            print(
                "  disagg arm D2: 2 prefill + 1 decode, prefill victim, "
                f"fleet cache, {len(ftrace)} requests"
            )
            d2_dir = os.path.join(scratch, "disagg-fleet")
            with arm("disagg-D2"):
                d2_errors, d2_resp = run_disagg_drill(
                    d2_dir, ftrace, device=device, solo=solo,
                    role_map="prefill,prefill,decode", victim=0,
                    fleet_cache=True, phases=fphases,
                )
                errors += d2_errors
                errors += check_disagg_report(
                    os.path.join(d2_dir, "wd"),
                    ["prefill", "prefill", "decode"], len(ftrace),
                )
            # Duplicate pairs are greedy and identical specs: streams
            # must match even when the duplicate's KV pages came off the
            # fleet index instead of a local prefill.
            for j in range(len(ftrace) // 2):
                a, b = d2_resp.get(j), d2_resp.get(j + len(ftrace) // 2)
                if a is not None and b is not None \
                        and a["tokens"] != b["tokens"]:
                    errors.append(
                        f"fleet duplicate pair ({j}, "
                        f"{j + len(ftrace) // 2}) diverged: "
                        f"{a['tokens']} vs {b['tokens']}"
                    )
            # D3: decode-role victim on the D1 trace; streams must
            # match D1's (and hence the monolithic reference's).
            print("  disagg arm D3: 1 prefill + 2 decode, decode victim")
            d3_dir = os.path.join(scratch, "disagg-dvic")
            with arm("disagg-D3"):
                d3_errors, d3_resp = run_disagg_drill(
                    d3_dir, trace, device=device, solo=solo,
                    role_map="prefill,decode,decode", victim=2,
                )
                errors += d3_errors
                errors += check_disagg_report(
                    os.path.join(d3_dir, "wd"),
                    ["prefill", "decode", "decode"], len(trace),
                )
            for rid in sorted(set(d1_resp) & set(d3_resp)):
                if d1_resp[rid]["tokens"] != d3_resp[rid]["tokens"]:
                    errors.append(
                        f"request {rid}: stream changed under decode "
                        f"failover: {d3_resp[rid]['tokens']} vs "
                        f"{d1_resp[rid]['tokens']}"
                    )
        if not args.no_overload:
            # Overload arm: deliberate overload (stall + unmeetable
            # queue-depth SLO) must shed lowest-class requests as REAL
            # responses while the protected TTFT SLO stays PASS;
            # the backpressure arm must instead pause intake and still
            # answer everything in full.
            print(
                f"  overload arm: {OVERLOAD_STALL_MS:.0f}ms stall, "
                f"classes {','.join(OVERLOAD_CLASSES)}, shed on qdepth"
            )
            with arm("overload"):
                errors += run_overload_arm(
                    os.path.join(scratch, "overload"), args.requests,
                    device=device, solo=solo,
                )
            print("  backpressure arm: queue gate engage 3 / release 1")
            with arm("backpressure"):
                errors += run_backpressure_arm(
                    os.path.join(scratch, "backpressure"), 16,
                    device=device, solo=solo,
                )
        if not args.no_autoscale:
            # Autoscale arm: the spike must recruit a replica and the
            # lull must drain one mid-stream, with full forensics and
            # zero dropped/duplicated responses; every stream must be
            # equal to the unresized reference run's.
            print(
                f"  autoscale arm: {AUTOSCALE_SPIKE}-request spike + "
                f"{AUTOSCALE_TRICKLE}-request trickle, fleet 1 <-> 2"
            )
            with arm("autoscale"):
                auto_errors, auto_resp = run_autoscale_arm(
                    os.path.join(scratch, "autoscale"), device=device,
                    solo=solo, controller_on=True,
                )
            errors += auto_errors
            print(
                "  autoscale reference: unresized 1-replica fleet, "
                "same trace"
            )
            with arm("autoscale-reference"):
                ref_errors, ref_resp = run_autoscale_arm(
                    os.path.join(scratch, "autoscale-ref"), device=device,
                    solo=solo, controller_on=False,
                )
            errors += ref_errors
            for rid in sorted(set(auto_resp) & set(ref_resp)):
                if auto_resp[rid]["tokens"] != ref_resp[rid]["tokens"]:
                    errors.append(
                        f"request {rid}: stream changed across the "
                        f"resize: {auto_resp[rid]['tokens']} vs "
                        f"{ref_resp[rid]['tokens']}"
                    )
        if not args.no_deploy:
            # Deploy arm: a staged trainer publishes checkpoints while
            # the fleet follows them — two live hot-swaps (zero
            # recaptures), NaN + torn candidates rejected pre-swap,
            # one SLO-breach rollback, every stream equal to its
            # admitted version's solo run.
            print(
                "  deploy arm: follow-checkpoints timeline "
                f"{[s for s, _, _ in DEPLOY_TIMELINE]}, canary "
                f"fraction {DEPLOY_FRACTION}"
            )
            with arm("deploy"):
                errors += run_deploy_arm(
                    os.path.join(scratch, "deploy"), device=device
                )
        print(f"arm seconds on {device}: {json.dumps(seconds)}")
        failed = bool(errors)
        if errors:
            print("DRILL serve: FAIL", file=sys.stderr)
            for e in errors:
                print(f"  - {e}", file=sys.stderr)
        else:
            print("DRILL serve: PASS")
        return 1 if failed else 0
    finally:
        if not args.keep and not failed and args.scratch is None:
            shutil.rmtree(scratch, ignore_errors=True)
        elif failed:
            print(f"artifacts kept in {scratch}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
