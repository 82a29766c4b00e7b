"""The port's fleet drills (``distributed_tensorflow_models_tpu_torch/
scripts/{serve_drill,fleet_drill}.py``) against the repository's
``scripts/serve_drill.py`` and ``scripts/fleet_drill.py``.

- Their pure parts equal the JAX drills' exactly (loaded by path, as
  ``tests/test_zz_fleet_drills.py`` loads them): request specs, traces,
  phases, pacing, ``_deploy_phase_reqs``, the arms' flag sets and
  timelines; each checker (``_audit_exactly_once``, ``check_slo_arm``,
  ``check_disagg_report``, the fleet drill's host agreement and baseline
  comparison) gives the same verdicts on the same fabricated artifacts,
  the report tools' subprocesses replaced by the same fabricated
  reports.
- Each drill's entry raises where no card is found and ``--device cpu``
  was not given, before it spawns anything (the fleet drill also where
  its largest fleet finds too few cards).
- End to end on the CPU (``two_proc``): the serve drill's base arm (two
  replicas, one SIGTERM victim, every stream = solo ``generate``) and the
  fleet drill's baseline and skew drills.  The other arms are ``slow``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from importlib import util as importutil
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu_torch.scripts import fleet_drill
from distributed_tensorflow_models_tpu_torch.scripts import serve_drill

ROOT = Path(__file__).resolve().parents[1]


def _load_script(name):
    spec = importutil.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importutil.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jserve():
    return _load_script("serve_drill")


@pytest.fixture(scope="module")
def jfleet():
    return _load_script("fleet_drill")


def _reqs(trace):
    return [dataclasses.asdict(r) for r in trace]


def _tree(path: Path) -> dict:
    return {p.relative_to(path).as_posix(): p.read_text()
            for p in sorted(path.rglob("*")) if p.is_file()}


# -- the pure parts --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 12, 24])
def test_request_files_equal_the_jax_drills(jserve, tmp_path, n):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    assert serve_drill.MODES == jserve.MODES
    assert serve_drill._write_requests(str(b), n) == \
        jserve._write_requests(str(a), n)
    assert _tree(b) == _tree(a)


@pytest.mark.parametrize("which", ["disagg", "fleet", "overload",
                                   "autoscale"])
def test_traces_equal_the_jax_drills(jserve, which):
    if which == "disagg":
        got, want = serve_drill._disagg_trace(24), jserve._disagg_trace(24)
        got, want = [got], [want]
    elif which == "fleet":
        got, want = serve_drill._fleet_trace(8), jserve._fleet_trace(8)
    elif which == "overload":
        got, want = [serve_drill._overload_trace(24)], [
            jserve._overload_trace(24)]
    else:
        got, want = serve_drill._autoscale_phases(), jserve._autoscale_phases()
    assert [_reqs(p) for p in got] == [_reqs(p) for p in want]
    assert sum(len(p) for p in got) > 0


@pytest.mark.parametrize("first_id,min_canary",
                         [(0, 0), (8, 3), (17, 3), (40, 0), (41, 5)])
def test_deploy_phases_equal_the_jax_drills(jserve, first_id, min_canary):
    assert serve_drill._deploy_phase_reqs(first_id, min_canary=min_canary) \
        == jserve._deploy_phase_reqs(first_id, min_canary=min_canary)


def test_arm_settings_equal_the_jax_drills(jserve):
    for name in ("SIGTERM_AFTER", "VICTIM", "SLO_THRESHOLD_S",
                 "SLO_STALL_MS", "SLO_WARMUP", "SLO_SPEC", "SLO_ARGV",
                 "DISAGG_RING", "OVERLOAD_CLASSES", "OVERLOAD_STALL_MS",
                 "OVERLOAD_DEADLINES", "OVERLOAD_ARGV", "BACKPRESSURE_ARGV",
                 "AUTOSCALE_SPIKE", "AUTOSCALE_TRICKLE", "DEPLOY_TIMELINE",
                 "DEPLOY_FRACTION", "DEPLOY_SEED", "DEPLOY_WARMUP",
                 "DEPLOY_STALL_MS", "DEPLOY_SLO", "DEPLOY_PHASE"):
        assert getattr(serve_drill, name) == getattr(jserve, name), name


def test_pacing_and_waits_equal_the_jax_drills(jserve, tmp_path):
    """``_pace`` (two phases, the second gated on the first's responses),
    ``_emit_paced`` and ``_wait_responses`` write and read the same
    files."""
    for mod, name in ((jserve, "jax"), (serve_drill, "port")):
        phases = [mod._disagg_trace(3), mod._disagg_trace(3)[1:]]
        q = tmp_path / name / "queue"
        (q / "resp").mkdir(parents=True)
        for r in phases[0]:
            (q / "resp" / f"req-{r.request_id}.json").write_text("{}")
        mod._pace(str(q), phases)
        mod._emit_paced(str(q), serve_drill._deploy_phase_reqs(
            30, min_canary=0)[:3], gap_s=0.0)
        assert mod._wait_responses(str(q), {0, 1}, 1.0)
        assert not mod._wait_responses(str(q), {0, 99}, 0.1)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def _queue(path: Path, claimed=(), queued=(), answered=()) -> str:
    (path / "claimed").mkdir(parents=True)
    (path / "resp").mkdir()
    for name in claimed:
        (path / "claimed" / name).write_text("{}")
    for rid in queued:
        (path / f"req-{rid}.json").write_text("{}")
    for rid in answered:
        (path / "resp" / f"req-{rid}.json").write_text(json.dumps(
            {"request_id": rid, "tokens": [rid], "replica": 0}))
    return str(path)


AUDITS = {
    "clean": dict(claimed=("req-0.json.p0", "req-1.json.p1"),
                  answered=(0, 1)),
    "claimed_twice": dict(claimed=("req-0.json.p0", "req-0.json.p1",
                                   "req-1.json.p1"), answered=(0, 1)),
    "unclaimed": dict(claimed=("req-0.json.p0",), queued=(1,),
                      answered=(0,)),
    "dropped_and_unknown": dict(claimed=("req-0.json.p0", "req-1.json.p0"),
                                answered=(0, 7)),
}


@pytest.mark.parametrize("case", sorted(AUDITS))
def test_exactly_once_audit_agrees_with_the_jax_drills(jserve, tmp_path,
                                                       case):
    specs = {0: {}, 1: {}}
    verdicts = []
    for mod, name in ((jserve, "jax"), (serve_drill, "port")):
        errors = []
        responses = mod._audit_exactly_once(
            _queue(tmp_path / name, **AUDITS[case]), specs, errors, "arm")
        verdicts.append((errors, responses))
    assert verdicts[0] == verdicts[1]
    assert bool(verdicts[1][0]) == (case != "clean")


@pytest.fixture
def fake_tools(monkeypatch):
    """``subprocess.run`` of both drills: ``serving_report.py`` prints the
    report set in ``state["report"]`` (or fails where it is None); the
    schema lint fails for a file that starts with ``bad``."""
    state = {"report": None}
    real = subprocess.run

    def run(argv, *a, **kw):
        argv = [str(x) for x in argv]
        if argv[1].endswith("serving_report.py"):
            if state["report"] is None:
                return subprocess.CompletedProcess(argv, 1, "", "boom")
            return subprocess.CompletedProcess(
                argv, 0, json.dumps(state["report"]), "")
        if argv[1].endswith("check_metrics_schema.py"):
            bad = Path(argv[2]).read_text().startswith("bad")
            return subprocess.CompletedProcess(argv, int(bad), "",
                                               "lint" if bad else "")
        return real(argv, *a, **kw)

    monkeypatch.setattr(subprocess, "run", run)
    return state


def _slo_workdir(path: Path, *, breaches, timeseries=(0, 1), bad_ts=()):
    path.mkdir(parents=True)
    for i in (0, 1):
        events = [{"name": "serve/slo_breach"}] * breaches[i] + [
            {"name": "serve/drain"}]
        (path / f"flight_recorder_p{i}.json").write_text(
            json.dumps({"events": events}))
        (path / f"serving_stats_p{i}.json").write_text(json.dumps(
            {"metrics": {"serve/slo_breach/ttft": float(breaches[i]),
                         "serve/requests": 3.0}}))
        if i in timeseries:
            (path / f"timeseries_p{i}.jsonl").write_text(
                "bad\n" if i in bad_ts else "{}\n")
    return str(path)


def _slo_report(verdicts, attributed=24, sum_bad=0):
    return {
        "attribution": {"attributed": attributed, "sum_bad": sum_bad,
                        "sum_ok": attributed - sum_bad},
        "waterfalls": [{"attributed": True, "sum_ok": i >= sum_bad,
                        "proc": 0, "rid": i, "attribution_err_s": 0.5}
                       for i in range(attributed)],
        "slo": [{"proc": p, "slo": "ttft", "verdict": v}
                for p, v in enumerate(verdicts)],
    }


SLO_CASES = {
    "clean_pass": (False, (0, 0), _slo_report(["PASS", "PASS"]), {}),
    "stall_fail": (True, (1, 2), _slo_report(["FAIL", "PASS"]), {}),
    "clean_but_breached": (False, (1, 0), _slo_report(["FAIL", "PASS"]),
                           {}),
    "stall_never_tripped": (True, (0, 0), _slo_report(["PASS", "PASS"]),
                            {}),
    "unattributed": (False, (0, 0), _slo_report(["PASS"], attributed=0),
                     {}),
    "sums_off": (False, (0, 0), _slo_report(["PASS"], sum_bad=2), {}),
    "no_verdicts": (True, (1, 1), _slo_report([]), {}),
    "no_timeseries": (False, (0, 0), _slo_report(["PASS"]),
                      {"timeseries": (0,)}),
    "timeseries_lint_fails": (False, (0, 0), _slo_report(["PASS"]),
                              {"bad_ts": (1,)}),
    "report_fails": (False, (0, 0), None, {}),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_checker_agrees_with_the_jax_drills(jserve, fake_tools,
                                                tmp_path, case):
    expect_breach, breaches, report, kw = SLO_CASES[case]
    fake_tools["report"] = report
    got = []
    for mod, name in ((jserve, "jax"), (serve_drill, "port")):
        wd = _slo_workdir(tmp_path / name, breaches=breaches, **kw)
        got.append([e.replace(str(tmp_path / name), "<wd>") for e in
                    mod.check_slo_arm(wd, expect_breach=expect_breach)])
    assert got[0] == got[1]
    assert bool(got[1]) == (case not in ("clean_pass", "stall_fail"))


def _disagg_report(roles, n, *, shipped=None, attributed=None, sum_bad=0,
                   no_ship=0):
    shipped = n if shipped is None else shipped
    attributed = n if attributed is None else attributed
    return {
        "roles": {str(i): r for i, r in enumerate(roles)},
        "attribution": {"shipped_out": shipped, "attributed": attributed,
                        "sum_bad": sum_bad, "sum_ok": attributed - sum_bad},
        "waterfalls": [{"attributed": True, "sum_ok": i >= sum_bad,
                        "ship_s": None if i < no_ship else 0.01,
                        "proc": len(roles) - 1, "rid": i,
                        "attribution_err_s": 0.2}
                       for i in range(attributed)],
    }


ROLES = ["prefill", "decode"]
DISAGG_CASES = {
    "good": _disagg_report(ROLES, 8),
    "roles_wrong": _disagg_report(["prefill", "prefill"], 8),
    "markers_short": _disagg_report(ROLES, 8, shipped=7),
    "unattributed": _disagg_report(ROLES, 8, attributed=6),
    "sums_off": _disagg_report(ROLES, 8, sum_bad=3),
    "no_ship_span": _disagg_report(ROLES, 8, no_ship=2),
    "report_fails": None,
}


@pytest.mark.parametrize("case", sorted(DISAGG_CASES))
def test_disagg_checker_agrees_with_the_jax_drills(jserve, fake_tools,
                                                   tmp_path, case):
    fake_tools["report"] = DISAGG_CASES[case]
    got = [mod.check_disagg_report(str(tmp_path), ROLES, 8)
           for mod in (jserve, serve_drill)]
    assert got[0] == got[1]
    assert bool(got[1]) == (case != "good")


def _result(sha="a", opt="b", step=6, rollbacks=0, skipped=0):
    return {"step": step, "params_sha": sha, "opt_sha": opt,
            "rollbacks": rollbacks, "skipped_batches": skipped,
            "loss": 2.3, "preempted": False}


HOSTS = {
    "agree": [_result(), _result()],
    "params_differ": [_result(), _result(sha="z")],
    "opt_differs": [_result(), _result(opt="z")],
    "steps_differ": [_result(), _result(step=5)],
    "rollbacks_differ": [_result(rollbacks=1), _result()],
    "skips_differ": [_result(skipped=1), _result()],
    "host_missing": [_result(), None],
    "baseline_differs": [_result(sha="y"), _result(sha="y")],
}


@pytest.mark.parametrize("case", sorted(HOSTS))
def test_fleet_checkers_agree_with_the_jax_drills(jfleet, case):
    ref = _result()
    got = []
    for mod in (jfleet, fleet_drill):
        agree, base = [], []
        mod._check_host_agreement(HOSTS[case], agree)
        mod._compare_to_baseline(HOSTS[case], ref, base)
        got.append((agree, base))
    assert got[0] == got[1]
    assert bool(got[1][1]) == (case != "agree")
    assert fleet_drill._base_overrides(chaos={"x": 1}) == \
        jfleet._base_overrides(chaos={"x": 1})
    assert (fleet_drill.STEPS, fleet_drill.CKPT_EVERY, fleet_drill.DRILLS,
            fleet_drill.RESIZE_LOSS_RTOL) == (
        jfleet.STEPS, jfleet.CKPT_EVERY, jfleet.DRILLS,
        jfleet.RESIZE_LOSS_RTOL)


# -- no card, no drill -----------------------------------------------------

def _no_card(monkeypatch, count=0):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


ENTRIES = {
    "serve_main": lambda s: serve_drill.main(["--scratch", s]),
    "serve_run_drill": lambda s: serve_drill.run_drill(
        s, 4, device="cuda", solo=serve_drill.SoloReference("cuda")),
    "serve_disagg": lambda s: serve_drill.run_disagg_drill(
        s, serve_drill._disagg_trace(4), device="cuda",
        solo=serve_drill.SoloReference("cuda")),
    "serve_overload": lambda s: serve_drill.run_overload_arm(
        s, 4, device="cuda", solo=serve_drill.SoloReference("cuda")),
    "serve_deploy": lambda s: serve_drill.run_deploy_arm(s, device="cuda"),
    "fleet_main": lambda s: fleet_drill.main(["--scratch", s]),
    "fleet_run": lambda s: fleet_drill.run_fleet(
        s, "baseline", fleet_drill._base_overrides(), s, device="cuda"),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_drills_raise_without_a_card(monkeypatch, tmp_path, entry):
    """No card and no ``--device cpu``: the entry raises, naming the
    flag, and has spawned nothing (no scratch, queue or worker script)."""
    _no_card(monkeypatch)
    scratch = tmp_path / "s"
    with pytest.raises(RuntimeError, match="--device cpu"):
        ENTRIES[entry](str(scratch))
    assert not scratch.exists()


def test_fleet_drill_raises_where_its_largest_fleet_finds_too_few_cards(
        monkeypatch, tmp_path):
    """One card a rank: two cards hold the two-process drills but not
    the resize drill's four processes."""
    _no_card(monkeypatch, count=2)
    with pytest.raises(RuntimeError, match="4 processes"):
        fleet_drill.main(["--drills", "skew,resize", "--scratch",
                          str(tmp_path / "s")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        fleet_drill.run_fleet(str(tmp_path), "p", {}, str(tmp_path),
                              device="cuda", nproc=4)
    assert not (tmp_path / "s").exists()
    assert not list(tmp_path.iterdir())


def test_fit_dumps_a_resize_restore_record_on_crossing_a_resize(tmp_path):
    """Crossing a fleet resize is incident-grade, as in the JAX ``fit``:
    a step written by two processes (their sidecars written here in one
    process) restored by one leaves ``flight_recorder_p0.json`` with
    reason ``resize_restore`` and the ``fit/resize_restore`` instant (the
    fleet drill's resize arm reads both)."""
    from distributed_tensorflow_models_tpu_torch import telemetry
    from distributed_tensorflow_models_tpu_torch.harness import (
        checkpoint as ckptlib,
    )
    from distributed_tensorflow_models_tpu_torch.harness import config
    from distributed_tensorflow_models_tpu_torch.harness import (
        train as trainlib,
    )

    cfg = config.get_config("lenet_mnist", train_steps=2,
                            global_batch_size=8, log_every_steps=1,
                            checkpoint_every_steps=2,
                            checkpoint_every_secs=1e9)
    first = trainlib.fit(cfg, str(tmp_path / "one"), device="cpu")
    data = json.loads((tmp_path / "one" / "checkpoints" / "2" / "data.json")
                      .read_text())
    data.pop("__fleet__", None)
    for pid in (1, 0):
        mgr = ckptlib.CheckpointManager(
            str(tmp_path / "two"), process_index=pid, process_count=2,
            registry=telemetry.MetricsRegistry())
        assert mgr.save(first.state, data)
        mgr.wait()
    res = trainlib.fit(cfg.replace(train_steps=3), str(tmp_path / "two"),
                       device="cpu")
    assert (res.restored_from, res.state.step) == (2, 3)
    record = json.loads((tmp_path / "two" / "flight_recorder_p0.json")
                        .read_text())
    assert record["reason"] == "resize_restore"
    crossing = [e for e in record["events"]
                if e.get("name") == "fit/resize_restore"]
    assert [(e["args"]["from_nproc"], e["args"]["to_nproc"])
            for e in crossing] == [(2, 1)]
    assert not (tmp_path / "one" / "flight_recorder_p0.json").exists()


# -- end to end on the CPU -------------------------------------------------

@pytest.fixture
def cpu_fleet(monkeypatch):
    """The fleets' processes inherit two threads each; the solo
    reference on the CPU."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    return serve_drill.SoloReference("cpu")


@pytest.mark.two_proc
def test_serve_drill_base_arm_on_the_cpu(cpu_fleet, tmp_path):
    """Two replicas, replica 1 SIGTERMs itself after 3 answers: every
    request claimed and answered once, each stream = solo ``generate``,
    both replicas served, drain artifacts schema-clean, R1 reported."""
    errors, responses = serve_drill.run_drill(
        str(tmp_path), 24, device="cpu", solo=cpu_fleet)
    assert not errors, errors
    assert sorted(responses) == list(range(24))
    assert {r["replica"] for r in responses.values()} == {0, 1}
    for i in (0, 1):
        report = json.loads((tmp_path / "wd" / f"r1_launches_p{i}.json")
                            .read_text())
        assert report["device"] == "cpu"
        assert report["r1_launches"] == {"wgmma": 0, "simt": 0}


@pytest.mark.two_proc
def test_fleet_drill_baseline_and_skew_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    errors, ref = fleet_drill.drill_baseline(str(tmp_path), device="cpu")
    assert not errors, errors
    assert ref["step"] == fleet_drill.STEPS
    assert ref["params_sha"] and ref["opt_sha"]
    assert fleet_drill.drill_skew(str(tmp_path), ref, device="cpu") == []


@pytest.mark.slow
@pytest.mark.two_proc
@pytest.mark.parametrize("arm", ["speculative", "slo", "disagg", "overload",
                                 "autoscale", "deploy"])
def test_serve_drill_arm_on_the_cpu(cpu_fleet, tmp_path, arm):
    s, solo, errors = str(tmp_path), cpu_fleet, []
    if arm == "speculative":
        errors += serve_drill.run_drill(s, 24, device="cpu", solo=solo,
                                        spec_tokens=3)[0]
    elif arm == "slo":
        for name, breach, extra in (
                ("clean", False, ()),
                ("stall", True, ("--stall-prefill-ms",
                                 str(serve_drill.SLO_STALL_MS)))):
            d = str(tmp_path / name)
            errors += serve_drill.run_drill(
                d, 24, device="cpu", solo=solo,
                extra_argv=serve_drill.SLO_ARGV + extra)[0]
            errors += serve_drill.check_slo_arm(os.path.join(d, "wd"),
                                                expect_breach=breach)
    elif arm == "disagg":
        trace = serve_drill._disagg_trace(24)
        fphases = serve_drill._fleet_trace(8)
        ftrace = [r for p in fphases for r in p]
        for name, reqs, kw, roles in (
                ("d1", trace, dict(role_map="prefill,decode"),
                 ["prefill", "decode"]),
                ("ref", trace, {}, None),
                ("d2", ftrace, dict(role_map="prefill,prefill,decode",
                                    victim=0, fleet_cache=True,
                                    phases=fphases),
                 ["prefill", "prefill", "decode"]),
                ("d3", trace, dict(role_map="prefill,decode,decode",
                                   victim=2), ["prefill", "decode",
                                               "decode"])):
            d = str(tmp_path / name)
            errors += serve_drill.run_disagg_drill(d, reqs, device="cpu",
                                                   solo=solo, **kw)[0]
            if roles:
                errors += serve_drill.check_disagg_report(
                    os.path.join(d, "wd"), roles, len(reqs))
    elif arm == "overload":
        errors += serve_drill.run_overload_arm(
            str(tmp_path / "o"), 24, device="cpu", solo=solo)
        errors += serve_drill.run_backpressure_arm(
            str(tmp_path / "b"), 16, device="cpu", solo=solo)
    elif arm == "autoscale":
        for name, on in (("auto", True), ("ref", False)):
            errors += serve_drill.run_autoscale_arm(
                str(tmp_path / name), device="cpu", solo=solo,
                controller_on=on)[0]
    else:
        errors += serve_drill.run_deploy_arm(s, device="cpu")
    assert not errors, errors


@pytest.mark.slow
@pytest.mark.two_proc
@pytest.mark.parametrize("drill", ["kill", "straggler", "nan", "resize"])
def test_fleet_drill_on_the_cpu(tmp_path, monkeypatch, drill):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    errors, ref = fleet_drill.drill_baseline(str(tmp_path), device="cpu")
    assert not errors, errors
    fn = getattr(fleet_drill, f"drill_{drill}")
    assert fn(str(tmp_path), ref, device="cpu") == []


def test_drills_run_as_modules_with_their_help():
    for mod in ("serve_drill", "fleet_drill"):
        proc = subprocess.run(
            [sys.executable, "-m",
             f"distributed_tensorflow_models_tpu_torch.scripts.{mod}",
             "--help"], capture_output=True, text=True, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        assert "--device" in proc.stdout
