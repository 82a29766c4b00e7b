"""Two-process fleet chaos drills, runnable outside pytest.

The port's counterpart of the repository's ``scripts/fleet_drill.py``.
Each drill spawns a real 2-process localhost cluster
(``launch.launch_local``: one device a process, gloo on the CPU and NCCL
on the card) of the port's ``fit`` on the tiny LeNet config, injects one
cross-host fault, and verifies the recovery contract:

- ``baseline``  — fault-free reference run; both hosts must already
  agree bit-identically on the final params/opt_state.
- ``skew``      — train 3 steps, then resume to 6 with the newest
  checkpoint HIDDEN from host 1's listings
  (``hide_newest_ckpt=1,chaos_host=1``): the chief-decided restore must
  put both hosts on the chief's step and the end state must be
  bit-identical to the no-skew baseline.
- ``kill``      — host 1 SIGKILLs itself after step 3
  (``kill_at_step=3``): the supervisor must tear the fleet down within
  the grace window (no collective-timeout hang), relaunch it
  (``supervise_local``), and the recovered run must be bit-identical to
  the baseline.
- ``straggler`` — host 1 sleeps 40 ms per step
  (``straggler_delay_ms=40``): slower, never different — end state
  bit-identical to the baseline.
- ``nan``       — host 1's batch for step 3 is NaN-poisoned under
  ``nan_policy=rollback``: BOTH hosts must roll back together (the
  fleet-agreed divergence), complete with exactly 1 rollback and
  exactly 1 skipped batch each, and agree bit-identically on the end
  state.
- ``resize``    — elastic fleet resize: train 2-process to the crossing
  checkpoint, then resume the same workdir at 1 and at 4 processes.
  The cross-topology restore must re-split the dataset cursor to the
  fleet-minimum position (zero skipped batches, proven from the chief's
  ``resize_ledger.json``), keep the loss trajectory tolerance-equal to
  the unresized baseline, leave a ``resize_restore`` flight record on
  every new host, and pass fsck's stamped-topology checks at the
  crossing point.

Every worker (both hosts, not just the chief) writes a
``result-p<i>.json`` with sha256 digests of its final params and
opt_state (every tensor's bytes under its stable name, sorted), so
cross-host agreement is itself part of every drill's verdict.  The
repository's ``scripts/fleet_report.py`` merges each drill's forensics
as a subprocess.  Exit status: 0 when every requested drill passes, 1
otherwise.

The workers train on ``--device``: the card unless ``--device cpu``.
One card holds one NCCL rank, so on the card every drill needs as many
cards as its largest fleet (4 with ``resize``); with fewer the drill
raises before spawning anything.

Usage::

    python -m distributed_tensorflow_models_tpu_torch.scripts.fleet_drill \\
        [--device cuda|cpu] [--drills skew,kill,nan] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

from distributed_tensorflow_models_tpu_torch import launch
from distributed_tensorflow_models_tpu_torch.resilience import fsck as fscklib

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FLEET_REPORT = os.path.join(_REPO, "scripts", "fleet_report.py")

STEPS = 6
CKPT_EVERY = 2

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import hashlib, json, os
    from distributed_tensorflow_models_tpu_torch import launch
    assert launch.initialize_from_env(device={device!r}), "cluster env missing"
    import torch
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    cfg = get_config("lenet_mnist", **json.loads({overrides_json!r}))
    res = trainlib.fit(cfg, {workdir!r}, device={device!r})

    def leaves(tree, path):
        if isinstance(tree, torch.Tensor):
            yield path, tree
        elif isinstance(tree, dict):
            for key, value in tree.items():
                yield from leaves(value, f"{{path}}/{{key}}")
        elif isinstance(tree, (list, tuple)):
            for i, value in enumerate(tree):
                yield from leaves(value, f"{{path}}/{{i}}")
        else:
            yield path, tree

    def tree_sha(tree):
        h = hashlib.sha256()
        for path, leaf in sorted(leaves(tree, ""), key=lambda kv: kv[0]):
            h.update(path.encode())
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().contiguous().reshape(-1)
                h.update(str(leaf.dtype).encode())
                h.update(leaf.view(torch.uint8).numpy().tobytes())
            else:
                h.update(repr(leaf).encode())
        return h.hexdigest()

    out = {{
        "step": int(res.state.step),
        "loss": float(res.final_metrics.get("loss", float("nan"))),
        "params_sha": tree_sha(res.state.params),
        "opt_sha": tree_sha(res.state.opt_state),
        "rollbacks": res.rollbacks,
        "skipped_batches": res.skipped_batches,
        "preempted": res.preempted,
    }}
    path = os.path.join(
        {outdir!r}, "result-p%d.json" % torch.distributed.get_rank()
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, path)
    torch.distributed.destroy_process_group()
    sys.exit(launch.RESUMABLE_EXIT_CODE if res.preempted else 0)
    """
)


def _base_overrides(**extra) -> dict:
    out = dict(
        train_steps=STEPS,
        global_batch_size=32,
        log_every_steps=2,
        checkpoint_every_secs=1e9,  # deterministic step cadence only
        checkpoint_every_steps=CKPT_EVERY,
        preempt_poll_steps=2,
        # Forensics on for every drill: flight recorders on abnormal
        # exits (default anyway) + Chrome-trace exports, so
        # fleet_report.py can reconstruct each drill's timeline and the
        # verdicts below can quote per-host timing evidence.
        trace_export=True,
    )
    out.update(extra)
    return out


def require_devices(device: str, n: int) -> None:
    """Raise unless ``n`` processes can each hold a device of ``device``
    kind: always on the CPU (gloo), else ``n`` CUDA devices (NCCL puts
    one rank on a card).  No CPU fallback."""
    if device == "cpu":
        return
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"fleet drill: its largest fleet is {n} processes, one card "
            f"each, and {have} CUDA device(s) are available; pass "
            "--device cpu to drill over gloo on the CPU")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fleet_report(workdir: str) -> dict:
    """``scripts/fleet_report.py <workdir> --json``: the merged forensics
    of every host (its ``incidents`` carry each flight record's reason
    and evidence)."""
    out = os.path.join(workdir, "fleet_report.json")
    proc = subprocess.run(
        [sys.executable, _FLEET_REPORT, workdir, "--json", out],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"fleet_report failed on {workdir}: "
                           f"{proc.stderr}")
    with open(out) as f:
        return json.load(f)


def _flight_records(report: dict) -> dict[int, dict]:
    """{process index: its flight record's incident} of a fleet report."""
    return {int(e["proc"]): e for e in report["incidents"]}


def _print_evidence(name: str, report: dict) -> None:
    """Per-host timing evidence from the flight recorders: the drill's
    verdict is bit-identity; this is the *how it recovered* record
    (fence totals, time-to-first-step, rollback span)."""
    for proc, rec in sorted(_flight_records(report).items()):
        ev = rec.get("evidence") or {}
        bits = [
            f"reason={rec.get('reason')}",
            f"step={rec.get('step')}",
            f"fence_total_s={ev.get('checkpoint_fence_total_s') or 0.0:.3f}",
            "time_to_first_step_s="
            f"{ev.get('startup_time_to_first_step_s') or 0.0:.3f}",
        ]
        if "last_rollback" in ev:
            bits.append(f"rollback={ev['last_rollback']}")
        print(f"  evidence[{name}] p{proc}: " + ", ".join(bits))


def run_fleet(
    scratch: str,
    name: str,
    overrides: dict,
    workdir: str,
    *,
    device: str,
    nproc: int = 2,
    supervised: bool = False,
    max_restarts: int = 0,
    timeout: float = 420.0,
):
    """One ``nproc``-process phase (default 2) on ``device``.  Returns
    ``(aggregate_code, results)`` where results[i] is host i's result
    dict (None if it never finished)."""
    require_devices(device, nproc)
    outdir = os.path.join(scratch, f"{name}-out")
    os.makedirs(outdir, exist_ok=True)
    script = os.path.join(scratch, f"{name}-worker.py")
    with open(script, "w") as f:
        f.write(
            WORKER.format(
                repo=_REPO,
                device=device,
                overrides_json=json.dumps(overrides),
                workdir=workdir,
                outdir=outdir,
            )
        )
    argv = [sys.executable, script]
    kwargs = dict(port=_free_port(), timeout=timeout, term_grace_s=8.0)
    if supervised:
        agg = launch.supervise_local(
            nproc, argv, max_restarts=max_restarts, backoff_base_s=0.0,
            **kwargs,
        )
    else:
        agg = launch.aggregate_exit_codes(
            launch.launch_local(nproc, argv, **kwargs)
        )
    results = []
    for i in range(nproc):
        path = os.path.join(outdir, f"result-p{i}.json")
        results.append(json.load(open(path)) if os.path.exists(path) else None)
    return agg, results


def _check(cond: bool, what: str, errors: list[str]) -> None:
    if not cond:
        errors.append(what)


def _check_host_agreement(results, errors: list[str]) -> None:
    _check(
        all(r is not None for r in results),
        f"missing per-host results: {results}",
        errors,
    )
    if not all(r is not None for r in results):
        return
    for key in ("step", "params_sha", "opt_sha", "rollbacks",
                "skipped_batches"):
        vals = [r[key] for r in results]
        _check(
            all(v == vals[0] for v in vals),
            f"hosts disagree on {key}: {vals!r}",
            errors,
        )


def drill_baseline(scratch: str, *, device: str) -> tuple[list[str], dict]:
    errors: list[str] = []
    agg, results = run_fleet(
        scratch, "baseline", _base_overrides(),
        os.path.join(scratch, "baseline-wd"), device=device,
    )
    _check(agg == 0, f"baseline fleet exit {agg}", errors)
    _check_host_agreement(results, errors)
    ref = results[0] or {}
    _check(ref.get("step") == STEPS, f"baseline ended at {ref}", errors)
    return errors, ref


def _compare_to_baseline(results, ref: dict, errors: list[str]) -> None:
    _check_host_agreement(results, errors)
    if results[0] is None:
        return
    for key in ("step", "params_sha", "opt_sha"):
        _check(
            results[0][key] == ref.get(key),
            f"{key} differs from the fault-free baseline: "
            f"{results[0][key]!r} vs {ref.get(key)!r}",
            errors,
        )


def drill_skew(scratch: str, ref: dict, *, device: str) -> list[str]:
    errors: list[str] = []
    workdir = os.path.join(scratch, "skew-wd")
    agg, _ = run_fleet(
        scratch, "skew-phase1", _base_overrides(train_steps=3),
        workdir, device=device,
    )
    _check(agg == 0, f"skew phase-1 fleet exit {agg}", errors)
    agg, results = run_fleet(
        scratch, "skew-phase2",
        _base_overrides(
            chaos={"hide_newest_ckpt": 1, "chaos_host": 1}
        ),
        workdir, device=device,
    )
    _check(agg == 0, f"skew phase-2 fleet exit {agg}", errors)
    _compare_to_baseline(results, ref, errors)
    return errors


def drill_kill(scratch: str, ref: dict, *, device: str) -> list[str]:
    errors: list[str] = []
    workdir = os.path.join(scratch, "kill-wd")
    agg, results = run_fleet(
        scratch, "kill",
        _base_overrides(chaos={"kill_at_step": 3, "chaos_host": 1}),
        workdir, device=device, supervised=True, max_restarts=2,
    )
    _check(agg == 0, f"kill drill supervisor exit {agg}", errors)
    _compare_to_baseline(results, ref, errors)
    # Forensics contract: the incident must leave a flight-recorder dump
    # on EVERY host — the victim dumps before its own SIGKILL, the
    # survivor dumps at SIGTERM arrival (flight watcher) even while
    # wedged in the dead peer's collective — and the merged
    # fleet_report timeline must name the killed host and its relaunch.
    report = fleet_report(workdir)
    records = _flight_records(report)
    for proc in (0, 1):
        _check(
            proc in records,
            f"no flight-recorder dump for host {proc} "
            f"(have {sorted(records)})",
            errors,
        )
    if 1 in records:
        _check(
            records[1].get("reason") == "chaos_kill",
            "host 1's flight recorder reason is "
            f"{records[1].get('reason')!r}, expected 'chaos_kill'",
            errors,
        )
    killed = [
        e for e in report["incidents"]
        if e["proc"] == 1 and e["reason"] == "chaos_kill"
    ]
    _check(
        bool(killed),
        f"fleet_report does not name host 1 as killed: "
        f"{report['incidents']}",
        errors,
    )
    _check(
        bool(killed) and killed[0]["relaunched"],
        "fleet_report does not show host 1's relaunch "
        "(flight-record os pid vs trace-export os pid)",
        errors,
    )
    _print_evidence("kill", report)
    return errors


def drill_straggler(scratch: str, ref: dict, *, device: str) -> list[str]:
    errors: list[str] = []
    agg, results = run_fleet(
        scratch, "straggler",
        _base_overrides(
            chaos={"straggler_delay_ms": 40, "chaos_host": 1}
        ),
        os.path.join(scratch, "straggler-wd"), device=device,
    )
    _check(agg == 0, f"straggler fleet exit {agg}", errors)
    _compare_to_baseline(results, ref, errors)
    return errors


def drill_nan(scratch: str, ref: dict, *, device: str) -> list[str]:
    errors: list[str] = []
    workdir = os.path.join(scratch, "nan-wd")
    agg, results = run_fleet(
        scratch, "nan",
        _base_overrides(
            nan_policy="rollback",
            rollback_budget=2,
            chaos={"nan_at_step": 3, "chaos_host": 1},
        ),
        workdir, device=device,
    )
    _check(agg == 0, f"nan drill fleet exit {agg}", errors)
    _check_host_agreement(results, errors)
    # Both hosts roll back together (fleet-agreed divergence), so both
    # must leave rollback forensics naming the restored step.
    report = fleet_report(workdir)
    records = _flight_records(report)
    for proc in (0, 1):
        rec = records.get(proc)
        _check(
            rec is not None and rec.get("reason") == "rollback",
            f"host {proc}: expected a 'rollback' flight-recorder dump, "
            f"got {None if rec is None else rec.get('reason')!r}",
            errors,
        )
        if rec is not None:
            _check(
                "last_rollback" in (rec.get("evidence") or {}),
                f"host {proc}: flight recorder has no train/rollback "
                "event",
                errors,
            )
    _print_evidence("nan", report)
    if all(r is not None for r in results):
        for i, r in enumerate(results):
            _check(
                r["rollbacks"] == 1,
                f"host {i}: expected exactly 1 rollback, got "
                f"{r['rollbacks']}",
                errors,
            )
            _check(
                r["skipped_batches"] == 1,
                f"host {i}: expected exactly 1 skipped batch, got "
                f"{r['skipped_batches']}",
                errors,
            )
            _check(r["step"] == STEPS, f"host {i} ended at {r['step']}", errors)
    return errors


def _metric_losses(workdir: str) -> dict:
    """{step: loss} from a run's ``metrics.jsonl`` (chief-written)."""
    path = os.path.join(workdir, "metrics.jsonl")
    rows: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if "loss" in row and "step" in row:
                    rows[int(row["step"])] = float(row["loss"])
    return rows


# Post-resize losses are trajectory-equivalent, not bit-identical: the
# global batch sequence is unchanged (global dataset cursor), but the
# gradient all-reduce runs over a different device count, so summation
# order — and nothing else — differs.  Tolerance, not equality.
RESIZE_LOSS_RTOL = 5e-3


def drill_resize(scratch: str, ref: dict, *, device: str) -> list[str]:
    """Elastic resize: train 2-process to the crossing, resume the SAME
    workdir at 1 and at 4 processes, and hold the resumed run to the
    unresized baseline: same final step, loss trajectory within
    RESIZE_LOSS_RTOL, zero skipped batches proven from the chief's
    resize ledger, a ``resize_restore`` flight record on every new host,
    trace exports archived from both sides of the crossing, and fsck
    naming the crossing step a cross-topology candidate."""
    errors: list[str] = []
    base_losses = _metric_losses(os.path.join(scratch, "baseline-wd"))
    for target in (1, 4):
        tag = f"resize{target}"
        workdir = os.path.join(scratch, f"{tag}-wd")
        ckpt_dir = os.path.join(workdir, "checkpoints")
        agg, _ = run_fleet(
            scratch, f"{tag}-phase1", _base_overrides(train_steps=3),
            workdir, device=device,
        )
        _check(agg == 0, f"{tag} phase-1 fleet exit {agg}", errors)

        # fsck at the crossing point: the step phase 2 will restore must
        # be fleet-valid for the WRITING topology (2 proc) and stamped
        # as such — that stamp is what makes it a resize candidate.
        report = fscklib.fsck_checkpoints(ckpt_dir, process_count=2)
        crossing = report["newest_fleet_valid_step"]
        _check(
            crossing is not None and crossing == report["latest_step"],
            f"{tag}: crossing step is not fleet-valid for the writing "
            f"topology (fleet-valid {crossing}, latest "
            f"{report['latest_step']})",
            errors,
        )
        by_step = {e["step"]: e for e in report["steps"]}
        _check(
            crossing in by_step
            and by_step[crossing]["complete_for_nproc"] == 2,
            f"{tag}: crossing step {crossing} is not stamped complete "
            f"for 2 processes: "
            f"{by_step.get(crossing, {}).get('complete_for_nproc')!r}",
            errors,
        )
        if crossing is None:
            continue  # nothing to resume across

        # Phase 2 overwrites trace_p<i>.json in the shared workdir;
        # archive phase 1's so the drill keeps timelines from BOTH
        # sides of the crossing.
        archive = os.path.join(scratch, f"{tag}-phase1-traces")
        os.makedirs(archive, exist_ok=True)
        archived = []
        for name in os.listdir(workdir):
            if name.startswith("trace_p") and name.endswith(".json"):
                shutil.copy2(
                    os.path.join(workdir, name), os.path.join(archive, name)
                )
                archived.append(name)
        _check(
            sorted(archived) == ["trace_p0.json", "trace_p1.json"],
            f"{tag}: pre-crossing trace exports missing: {archived}",
            errors,
        )

        agg, results = run_fleet(
            scratch, f"{tag}-phase2", _base_overrides(),
            workdir, device=device, nproc=target,
        )
        _check(agg == 0, f"{tag} phase-2 fleet exit {agg}", errors)
        _check_host_agreement(results, errors)
        if all(r is not None for r in results):
            _check(
                results[0]["step"] == STEPS,
                f"{tag}: resumed fleet ended at step {results[0]['step']}",
                errors,
            )
            for i, r in enumerate(results):
                _check(
                    r["skipped_batches"] == 0,
                    f"{tag}: host {i} skipped {r['skipped_batches']} "
                    "batch(es) across the resize",
                    errors,
                )
            # Loss-trajectory agreement with the unresized baseline on
            # every post-crossing logged step, plus the final loss.
            losses = _metric_losses(workdir)
            for step, base in sorted(base_losses.items()):
                if step <= crossing:
                    continue
                got = losses.get(step)
                _check(
                    got is not None
                    and abs(got - base) <= RESIZE_LOSS_RTOL * abs(base),
                    f"{tag}: loss at step {step} diverged from baseline: "
                    f"{got!r} vs {base!r}",
                    errors,
                )
            _check(
                abs(results[0]["loss"] - ref.get("loss", float("nan")))
                <= RESIZE_LOSS_RTOL * abs(ref.get("loss", 1.0)),
                f"{tag}: final loss {results[0]['loss']!r} diverged from "
                f"baseline {ref.get('loss')!r}",
                errors,
            )

        # The chief's resize ledger is the zero-skip proof: the adopted
        # cursor position must be <= every saved position.
        ledger_path = os.path.join(
            ckpt_dir, "dataset_states", str(crossing), "resize_ledger.json"
        )
        _check(
            os.path.exists(ledger_path),
            f"{tag}: no resize ledger at {ledger_path}",
            errors,
        )
        if os.path.exists(ledger_path):
            ledger = json.load(open(ledger_path))
            _check(
                ledger.get("from_nproc") == 2
                and ledger.get("to_nproc") == target,
                f"{tag}: ledger topology wrong: {ledger}",
                errors,
            )
            adopted = ledger.get("adopted_position")
            positions = [
                p for p in ledger.get("positions", {}).values()
                if p is not None
            ]
            _check(
                adopted is not None
                and bool(positions)
                and all(adopted <= p for p in positions),
                f"{tag}: adopted position {adopted} is not the fleet "
                f"minimum of {positions} — batches may have been skipped",
                errors,
            )

        # Every post-crossing host dumps a resize_restore flight record
        # (train.py marks the crossing incident-grade).
        report = fleet_report(workdir)
        records = _flight_records(report)
        for proc in range(target):
            rec = records.get(proc)
            _check(
                rec is not None and rec.get("reason") == "resize_restore",
                f"{tag}: host {proc}: expected a 'resize_restore' flight "
                f"record, got "
                f"{None if rec is None else rec.get('reason')!r}",
                errors,
            )

        # And the resumed fleet must leave a restorable tail at ITS
        # topology: the newest step valid (fleet-valid when sidecars
        # exist, i.e. target > 1) for the new process count.
        post = fscklib.fsck_checkpoints(
            ckpt_dir, process_count=target if target > 1 else None
        )
        post_best = (
            post["newest_fleet_valid_step"]
            if target > 1
            else post["newest_valid_step"]
        )
        _check(
            post_best == STEPS,
            f"{tag}: post-resize newest restorable step is {post_best}, "
            f"expected {STEPS}",
            errors,
        )
        _print_evidence(tag, report)
    return errors


DRILLS = ("skew", "kill", "straggler", "nan", "resize")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="the workers' device: one card a process (default; raises "
        "where the largest fleet finds too few) or the CPU over gloo",
    )
    p.add_argument(
        "--drills", default=",".join(DRILLS),
        help=f"comma-separated subset of {DRILLS} (baseline always runs)",
    )
    p.add_argument(
        "--scratch", default=None,
        help="working directory (default: a fresh temp dir)",
    )
    p.add_argument(
        "--keep", action="store_true",
        help="keep the scratch dir (checkpoints, logs, results)",
    )
    args = p.parse_args(argv)
    wanted = [d.strip() for d in args.drills.split(",") if d.strip()]
    unknown = set(wanted) - set(DRILLS)
    if unknown:
        p.error(f"unknown drills {sorted(unknown)}; have {DRILLS}")
    require_devices(args.device, 4 if "resize" in wanted else 2)

    scratch = args.scratch or tempfile.mkdtemp(prefix="dtm-fleet-drill-")
    os.makedirs(scratch, exist_ok=True)
    failed = False
    seconds: dict[str, float] = {}
    try:
        print(f"fleet drills in {scratch} on {args.device}: baseline + "
              f"{wanted}")
        t0 = time.perf_counter()
        errors, ref = drill_baseline(scratch, device=args.device)
        seconds["baseline"] = round(time.perf_counter() - t0, 1)
        _report("baseline", errors, seconds["baseline"])
        failed |= bool(errors)
        if errors:
            print("baseline failed; dependent drills skipped", file=sys.stderr)
            return 1
        for name in wanted:
            fn = {
                "skew": drill_skew,
                "kill": drill_kill,
                "straggler": drill_straggler,
                "nan": drill_nan,
                "resize": drill_resize,
            }[name]
            t0 = time.perf_counter()
            errors = fn(scratch, ref, device=args.device)
            seconds[name] = round(time.perf_counter() - t0, 1)
            _report(name, errors, seconds[name])
            failed |= bool(errors)
        print(f"drill seconds on {args.device}: {json.dumps(seconds)}")
        return 1 if failed else 0
    finally:
        if not args.keep and not failed and args.scratch is None:
            shutil.rmtree(scratch, ignore_errors=True)
        elif failed:
            print(f"artifacts kept in {scratch}", file=sys.stderr)


def _report(name: str, errors: list[str], seconds: float) -> None:
    if errors:
        print(f"DRILL {name}: FAIL ({seconds} s)", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
    else:
        print(f"DRILL {name}: PASS ({seconds} s)")


if __name__ == "__main__":
    sys.exit(main())
