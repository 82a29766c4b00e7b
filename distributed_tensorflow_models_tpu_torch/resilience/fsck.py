"""Checkpoint crash-consistency validation (restore hardening + fsck).

The port's counterpart of ``distributed_tensorflow_models_tpu/resilience/
fsck.py``, pinned to the port's checkpoint layout
(``harness/checkpoint.py``)::

    <step>/state.pt          torch.save of the state's tensors (the chief's)
    <step>/data.json         the chief's dataset state and topology stamp
    <step>/manifest.json     step, process count, every file's bytes and
                             every tensor's shape, dtype and bytes
    <step>/COMMITTED         written last
    dataset_states/<step>/p<pid>.json        per-process dataset state
    dataset_states/<step>/p<pid>.carry.pt    per-process carry rows

A step is written whole under ``<step>.tmp-*``, fsynced and renamed, so a
cleanly interrupted save never appears as ``<step>``.  What renaming
cannot protect against is damage *after* it — a torn copy, a truncated
disk, a partial ``rm`` — which this module finds by structure alone (no
``torch.load``): the marker and the manifest must be there, and every file
the manifest names must be there with the manifest's byte count.

``validate_step_dir`` returns the *fatal* issues (step unusable — the
restore walk-back skips it); ``sidecar_issues`` returns the *degraded*
ones (per-process dataset sidecars unreadable or from a different
topology — restore still works, falling back to the primary's position).
``fsck_checkpoints`` sweeps a whole checkpoint root, and :func:`main` is
its command line::

    python -m distributed_tensorflow_models_tpu_torch.resilience.fsck \\
        <workdir> [--process-count N] [--repair] [--json]

Exit 0 when the newest step is valid, 1 when a restore would walk back
(or nothing is restorable), 2 on usage errors.  ``--repair`` deletes torn
step directories (and their sidecar directories) so the next run's newest
step is a valid one again.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Optional

STATE_FILE = "state.pt"
DATA_FILE = "data.json"
MANIFEST = "manifest.json"
COMMITTED = "COMMITTED"
SIDECARS = "dataset_states"


def read_manifest(step_dir: str) -> Optional[dict]:
    """The step's manifest, or None when it is missing or unreadable."""
    try:
        with open(os.path.join(step_dir, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def validate_step_dir(step_dir: str) -> list[str]:
    """Fatal structural issues of one step directory ([] = valid).

    Purely structural — no ``torch.load`` — so it is safe to run against
    a live training run's checkpoints and cheap enough to run on every
    restore."""
    if not os.path.isdir(step_dir):
        return [f"missing step directory {step_dir}"]
    issues: list[str] = []
    if not os.path.exists(os.path.join(step_dir, COMMITTED)):
        issues.append(f"missing {COMMITTED} (unfinalized or torn write)")
    manifest = read_manifest(step_dir)
    if manifest is None or not isinstance(manifest.get("files"), dict):
        issues.append(f"missing or unreadable {MANIFEST} (torn write)")
        return issues
    for name, nbytes in sorted(manifest["files"].items()):
        path = os.path.join(step_dir, name)
        if not os.path.exists(path):
            issues.append(f"missing {name} (torn write)")
        elif os.path.getsize(path) != nbytes:
            issues.append(f"{name} holds {os.path.getsize(path)} bytes, the "
                          f"manifest says {nbytes} (torn write)")
    return issues


def _sidecar_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, SIDECARS, str(step))


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def sidecar_issues(
    ckpt_dir: str, step: int, process_count: Optional[int] = None
) -> list[str]:
    """Degraded (non-fatal) issues with a step's per-process dataset
    sidecars: unparseable JSON, a carry file a sidecar names that is
    missing or of another size, a topology stamp that disagrees with
    ``process_count`` (when given), or — also only when
    ``process_count`` is given — a missing peer sidecar (the step is then
    not *fleet-valid*: some process would resume from the primary's
    approximate position).  All make resume approximate, not
    impossible."""
    issues: list[str] = []
    base = _sidecar_dir(ckpt_dir, step)
    if not os.path.isdir(base):
        if process_count is not None and process_count > 1:
            issues.append(
                f"no {SIDECARS}/{step}/ sidecar directory for a "
                f"{process_count}-process topology (approximate resume)"
            )
        return issues  # single-process runs write no sidecars: fine
    present: set[int] = set()
    for name in sorted(os.listdir(base)):
        if not name.endswith(".json"):  # skips .json.tmp in-flight writes
            continue
        path = os.path.join(base, name)
        try:
            wrapped = _read_json(path)
        except (OSError, ValueError) as e:
            issues.append(f"sidecar {name}: unreadable ({e})")
            continue
        if name.startswith("p"):
            try:
                present.add(int(name[1:-5]))
            except ValueError:
                pass
        if not isinstance(wrapped, dict):
            continue
        carry = wrapped.get("carry")
        if isinstance(carry, dict):
            cpath = os.path.join(base, str(carry.get("file")))
            if not os.path.exists(cpath):
                issues.append(f"sidecar {name}: carry file {carry.get('file')}"
                              " is missing")
            elif os.path.getsize(cpath) != carry.get("bytes"):
                issues.append(f"sidecar {name}: carry file "
                              f"{carry.get('file')} is torn")
        stamp = wrapped.get("nproc")
        if (
            stamp is not None
            and process_count is not None
            and stamp != process_count
        ):
            issues.append(
                f"sidecar {name}: topology stamp nproc={stamp} != "
                f"{process_count} (approximate resume)"
            )
    if process_count is not None:
        missing = [p for p in range(process_count) if p not in present]
        if missing:
            stamped = stamped_topology(ckpt_dir, step)
            if stamped is not None and stamped != process_count:
                issues.append(
                    f"sidecar set is complete for a {stamped}-process "
                    f"topology, not {process_count} (cross-topology "
                    "resume candidate: restore re-splits the dataset "
                    "cursor)"
                )
            else:
                issues.append(
                    "missing peer sidecar(s) for process(es) "
                    f"{missing} (step is not fleet-valid)"
                )
    return issues


def _parsed_sidecars(ckpt_dir: str, step: int) -> dict:
    """``{pid: parsed sidecar}`` for every *parseable* ``p<pid>.json``."""
    base = _sidecar_dir(ckpt_dir, step)
    if not os.path.isdir(base):
        return {}
    out: dict = {}
    for name in os.listdir(base):
        if not (name.startswith("p") and name.endswith(".json")):
            continue
        try:
            pid = int(name[1:-5])
        except ValueError:
            continue
        try:
            out[pid] = _read_json(os.path.join(base, name))
        except (OSError, ValueError):
            continue
    return out


def sidecar_stamps(ckpt_dir: str, step: int) -> dict:
    """``{pid: topology stamp}`` for every *parseable* sidecar at
    ``step``.  The stamp is the ``nproc`` the writing fleet recorded
    (None for a sidecar without one)."""
    return {
        pid: (wrapped.get("nproc") if isinstance(wrapped, dict) else None)
        for pid, wrapped in _parsed_sidecars(ckpt_dir, step).items()
    }


def stamped_topology(ckpt_dir: str, step: int) -> Optional[int]:
    """The process count N the step's sidecar set was written by, when
    that is unambiguous: all parseable sidecars carry the same ``nproc``
    stamp N and every pid in ``range(N)`` is present.  Returns None for
    unstamped, mixed-stamp, or incomplete sets.

    This is how an elastic resume picks restore candidates: a step whose
    sidecar set is complete *for its stamped topology* has every old
    process's cursor on disk, so the fleet-minimum re-split can map it
    onto any new process count without skipping a batch."""
    stamps = sidecar_stamps(ckpt_dir, step)
    values = set(stamps.values())
    if len(values) != 1:
        return None
    (n,) = values
    if not isinstance(n, int) or n < 1:
        return None
    if not all(p in stamps for p in range(n)):
        return None
    return n


def sidecar_presence(ckpt_dir: str, step: int) -> list[int]:
    """Process ids with a *parseable* dataset sidecar at ``step``
    (ascending).  A present-but-unreadable sidecar does not count — it
    degrades to the primary's position at restore time exactly like a
    missing one."""
    return sorted(_parsed_sidecars(ckpt_dir, step))


def fleet_sidecars_complete(
    ckpt_dir: str, step: int, process_count: int
) -> bool:
    """True when every process id in ``range(process_count)`` has a
    parseable sidecar at ``step`` — the *fleet-valid* bar the multi-process
    restore walk prefers."""
    present = set(sidecar_presence(ckpt_dir, step))
    return all(p in present for p in range(process_count))


def list_steps(ckpt_dir: str) -> list[int]:
    """Ascending steps with a (renamed, so finalized or damaged) step
    directory under ``ckpt_dir``; ``<step>.tmp-*`` writes in flight and
    the sidecar root are not steps."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name) for name in os.listdir(ckpt_dir)
        if name.isdigit() and os.path.isdir(os.path.join(ckpt_dir, name))
    )


def fsck_checkpoints(
    ckpt_dir: str, process_count: Optional[int] = None
) -> dict:
    """Sweep every step under a checkpoint root.

    Returns ``{"steps": [{"step", "valid", "issues", "sidecar_issues",
    "sidecar_procs", "sidecar_nproc", "complete_for_nproc",
    "fleet_valid"}, ...] (ascending), "latest_step",
    "newest_valid_step", "newest_fleet_valid_step"}``, as the JAX
    package's sweep: ``newest_valid_step`` is what a single-process
    restore would pick (it differs from ``latest_step`` exactly when the
    restore would walk back); ``fleet_valid`` additionally requires,
    when ``process_count`` is given, every peer's sidecar."""
    report: dict = {
        "steps": [],
        "latest_step": None,
        "newest_valid_step": None,
        "newest_fleet_valid_step": None,
    }
    for step in list_steps(ckpt_dir):
        issues = validate_step_dir(os.path.join(ckpt_dir, str(step)))
        side = sidecar_issues(ckpt_dir, step, process_count)
        stamps = sidecar_stamps(ckpt_dir, step)
        procs = sorted(stamps)
        fleet_valid = not issues and (
            process_count is None
            or all(p in procs for p in range(process_count))
        )
        report["steps"].append(
            {
                "step": step,
                "valid": not issues,
                "issues": issues,
                "sidecar_issues": side,
                "sidecar_procs": procs,
                "sidecar_nproc": {str(p): stamps[p] for p in procs},
                "complete_for_nproc": stamped_topology(ckpt_dir, step),
                "fleet_valid": fleet_valid,
            }
        )
        report["latest_step"] = step
        if not issues:
            report["newest_valid_step"] = step
        if fleet_valid:
            report["newest_fleet_valid_step"] = step
    return report


def repair(ckpt_dir: str, report: dict) -> list[int]:
    """Delete every torn step directory of ``report`` and its sidecar
    directory; returns the steps removed."""
    removed = []
    for entry in report["steps"]:
        if entry["valid"]:
            continue
        step = entry["step"]
        shutil.rmtree(os.path.join(ckpt_dir, str(step)), ignore_errors=True)
        shutil.rmtree(_sidecar_dir(ckpt_dir, step), ignore_errors=True)
        removed.append(step)
    return removed


def _print_report(report: dict, process_count: Optional[int]) -> None:
    for entry in report["steps"]:
        if not entry["valid"]:
            status = "TORN"
        elif entry["sidecar_issues"]:
            status = "DEGRADED"
        else:
            status = "OK"
        procs = entry["sidecar_procs"]
        stamped = entry["complete_for_nproc"]
        detail = ""
        if process_count is not None:
            detail = (
                f"  sidecars {len(procs)}/{process_count}"
                f"{'' if entry['fleet_valid'] else '  NOT FLEET-VALID'}"
            )
            if stamped is not None and stamped != process_count:
                detail += f"  COMPLETE FOR {stamped}-PROC (resize candidate)"
        elif procs:
            detail = f"  sidecars {procs}"
            if stamped is not None:
                detail += f"  stamped nproc={stamped}"
        print(f"step {entry['step']:>10d}  {status}{detail}")
        for issue in entry["issues"]:
            print(f"    {issue}")
        for issue in entry["sidecar_issues"]:
            print(f"    (sidecar) {issue}")
    if report.get("repaired_steps"):
        print(f"repaired: removed torn steps {report['repaired_steps']}")
    if report["newest_valid_step"] is None:
        print("no restorable checkpoint")
    elif report["newest_valid_step"] != report["latest_step"]:
        print(
            f"restore would WALK BACK: newest step {report['latest_step']} "
            f"is torn; newest valid is {report['newest_valid_step']}"
        )
    else:
        print(f"restore target: step {report['newest_valid_step']}")
    if (
        process_count is not None
        and report["newest_fleet_valid_step"] != report["newest_valid_step"]
    ):
        print(
            "multi-process restore would PREFER step "
            f"{report['newest_fleet_valid_step']} (newest with every "
            "process's dataset sidecar)"
        )


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_tensorflow_models_tpu_torch.resilience.fsck",
        description="check (and with --repair, clear) a run's checkpoints")
    p.add_argument("path", help="run workdir (containing checkpoints/) or a "
                   "checkpoints dir")
    p.add_argument("--process-count", type=int, default=None,
                   help="expected topology: flag sidecars stamped with "
                   "another process count and steps missing a peer's "
                   "sidecar")
    p.add_argument("--repair", action="store_true",
                   help="delete torn step directories (and their "
                   "dataset_states/) so the newest step is a valid one")
    p.add_argument("--json", action="store_true", help="print the report "
                   "as JSON")
    args = p.parse_args(argv)
    ckpt_dir = args.path
    nested = os.path.join(args.path, "checkpoints")
    if os.path.isdir(nested):
        ckpt_dir = nested
    if not os.path.isdir(ckpt_dir):
        print(f"error: no checkpoint directory at {ckpt_dir}",
              file=sys.stderr)
        return 2
    report = fsck_checkpoints(ckpt_dir, args.process_count)
    if args.repair:
        removed = repair(ckpt_dir, report)
        if removed:
            report = fsck_checkpoints(ckpt_dir, args.process_count)
        report["repaired_steps"] = removed
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        _print_report(report, args.process_count)
    ok = (
        report["newest_valid_step"] is not None
        and report["newest_valid_step"] == report["latest_step"]
    ) or (args.repair and not report["steps"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
