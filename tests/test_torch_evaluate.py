"""The port's eval loops (``harness/evaluate.py``) and the CLI's ``eval``,
on the CPU, against the JAX package's ``harness/evaluate.py``.

Each case builds one set of weights (the port's seeded init, perturbed by
seeded noise so that nothing is at its initial value, the EMA shadows
apart from the parameters) and saves it twice: into a JAX checkpoint that
the JAX ``evaluate_*`` restores, and into a port checkpoint that the
port's restores.  Held: top-1/top-5 counts and the example count equal,
xent and perplexity within 1e-5 relative (both sum f32 batch sums in
f64; the logits differ by f32 round-off).  Cases: LeNet over three
batches; LeNet over batches of 8, 8 and 5 rows (the partial batch padded
with label -1 on both sides); LeNet with an EMA, with and without the
shadows; the cut ``ptb_medium`` over three batches, its zero carry
threaded across them.  Each case's two checkpoints are made once for the
module.  Also ``continuous_eval``
(one eval per new checkpoint), the CLI's JSON line, and the two-process
gloo run of ``tests/torch_data_parallel_worker.py``: its ``fit``'s FLOPs
and its eval counts against one process at the global batch.
"""

import json
import math
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.harness import checkpoint as jckpt
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import evaluate as jeval
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import evaluate
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_data_parallel_worker as worker  # noqa: E402
from test_torch_data_parallel import cluster  # noqa: E402,F401

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
REL = 1e-5
STEP = 5
CASES = {
    "lenet": ("lenet_mnist", dict(global_batch_size=8)),
    "lenet_ema": ("lenet_mnist", dict(global_batch_size=8, ema_decay=0.9)),
    "ptb_cut": ("ptb_medium", dict(
        global_batch_size=8, num_steps=5, vocab_size=64,
        model_kwargs={"config": "medium", "vocab_size": 64,
                      "hidden_size": 16})),
}


def _configs(case):
    name, kw = CASES[case]
    return tconfig.get_config(name, **kw), jconfig.get_config(name, **kw)


def _noisy(flat: dict, rng, positive: bool = False) -> dict:
    """Each array moved by seeded noise of its own scale (kept positive
    where it is a variance)."""
    out = {}
    for k, v in flat.items():
        if positive or k.endswith("var"):
            out[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(v.dtype)
        else:
            scale = float(np.std(v)) or 0.1
            out[k] = (v + 0.3 * scale * rng.standard_normal(v.shape)
                      ).astype(v.dtype)
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """``saved(case) -> (port config, JAX config, directory)``: the case's
    two checkpoints, made at the first use in the module."""
    made = {}

    def get(case):
        if case not in made:
            path = tmp_path_factory.mktemp(case)
            made[case] = (*_save_both(case, path), path)
        return made[case]

    return get


def _save_both(case, tmp_path, step: int = STEP):
    """One set of weights in a port checkpoint (``tmp_path/'port'``) and a
    JAX checkpoint (``tmp_path/'jax'``), both at ``step``."""
    tcfg, jcfg = _configs(case)
    rng = np.random.default_rng(7)
    state = trainlib.build_state(tcfg, CPU)
    tree = interop.to_flax_variables(state.model)
    flat = {c: _noisy(interop._flatten(tree.get(c, {})), rng)
            for c in interop.COLLECTIONS}
    interop.load_flax_variables(
        state.model, {c: interop._unflatten(f) for c, f in flat.items()})
    ema = None
    if state.ema_params is not None:
        ema = _noisy(flat["params"], rng)
        with torch.no_grad():
            for k, t in state.ema_params.items():
                t.copy_(torch.from_numpy(ema[k]))
    state.device_step.fill_(step)
    state = state.replace(step=step)
    manager = ckptlib.CheckpointManager(str(tmp_path / "port"))
    manager.save(state, {})
    manager.wait()

    jstate = jtrain.build_state(jcfg, jtrain.mesh_from_config(jcfg))
    as_jax = lambda f: jax.tree.map(jnp.asarray,  # noqa: E731
                                    interop._unflatten(f))
    jstate = jstate.replace(
        step=jnp.asarray(step, jstate.step.dtype),
        params=as_jax(flat["params"]),
        batch_stats=(as_jax(flat["batch_stats"]) if flat["batch_stats"]
                     else jstate.batch_stats),
        ema_params=None if ema is None else as_jax(ema))
    jmanager = jckpt.CheckpointManager(str(tmp_path / "jax"))
    jmanager.save(jstate, {}, force=True)
    jmanager.close()
    return tcfg, jcfg


def _assert_same_counts(port, ref):
    assert port.step == ref.step == STEP
    count = ref.metrics["count"]
    assert port.metrics["count"] == count
    for k in ("top1", "top5"):
        assert round(port.metrics[k] * count) == round(ref.metrics[k] * count)
    assert port.metrics["xent"] == pytest.approx(ref.metrics["xent"],
                                                 rel=REL)


def test_classification_matches_jax(saved, mesh8):
    tcfg, jcfg, tmp_path = saved("lenet")
    ref = jeval.evaluate_classification(jcfg, str(tmp_path / "jax"),
                                        mesh=mesh8, max_batches=3)
    port = evaluate.evaluate_classification(tcfg, str(tmp_path / "port"),
                                            device="cpu", max_batches=3)
    assert ref.metrics["count"] == 24
    _assert_same_counts(port, ref)


def test_partial_final_batch_matches_jax(saved, mesh8, monkeypatch):
    """Batches of 8, 8 and 5 rows: the JAX side pads the last to its 8
    devices, the port to the full batch, both with label -1; 21 examples
    counted on both sides."""
    tcfg, jcfg, tmp_path = saved("lenet")
    rng = np.random.default_rng(11)
    batches = [{"image": rng.standard_normal((n, 28, 28, 1)
                                             ).astype(np.float32),
                "label": rng.integers(0, 10, n).astype(np.int32)}
               for n in (8, 8, 5)]
    monkeypatch.setattr(jtrain, "build_dataset",
                        lambda cfg, split="train": list(batches))
    monkeypatch.setattr(trainlib, "build_dataset",
                        lambda cfg, split="train", mesh=None: list(batches))
    ref = jeval.evaluate_classification(jcfg, str(tmp_path / "jax"),
                                        mesh=mesh8)
    port = evaluate.evaluate_classification(tcfg, str(tmp_path / "port"),
                                            device="cpu")
    assert ref.metrics["count"] == 21
    _assert_same_counts(port, ref)


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "params"])
def test_ema_shadows_match_jax(saved, mesh8, use_ema):
    tcfg, jcfg, tmp_path = saved("lenet_ema")
    ref = jeval.evaluate_classification(jcfg, str(tmp_path / "jax"),
                                        mesh=mesh8, max_batches=2,
                                        use_ema=use_ema)
    port = evaluate.evaluate_classification(tcfg, str(tmp_path / "port"),
                                            device="cpu", max_batches=2,
                                            use_ema=use_ema)
    _assert_same_counts(port, ref)
    other = evaluate.evaluate_classification(
        tcfg, str(tmp_path / "port"), device="cpu", max_batches=2,
        use_ema=not use_ema)
    assert other.metrics["xent"] != port.metrics["xent"]


def test_lm_perplexity_matches_jax(saved, mesh8):
    """Three batches of the cut ``ptb_medium`` with the zero carry
    threaded: equal perplexity to 1e-5; without the threading (a zero
    carry each batch) the port's differs."""
    tcfg, jcfg, tmp_path = saved("ptb_cut")
    ref = jeval.evaluate_lm(jcfg, str(tmp_path / "jax"), mesh=mesh8,
                            max_batches=3)
    port = evaluate.evaluate_lm(tcfg, str(tmp_path / "port"), device="cpu",
                                max_batches=3)
    assert port.step == ref.step == STEP
    assert port.metrics["perplexity"] == pytest.approx(
        ref.metrics["perplexity"], rel=REL)
    assert port.metrics["nll"] == pytest.approx(ref.metrics["nll"], rel=REL)
    first = evaluate.evaluate_lm(tcfg, str(tmp_path / "port"), device="cpu",
                                 max_batches=1)
    assert first.metrics["nll"] != port.metrics["nll"]


def test_continuous_eval_follows_new_checkpoints(saved, tmp_path):
    """One eval per new checkpoint, newest first: step 5, then step 7
    once it is written."""
    tcfg, _, path = saved("lenet")
    workdir = str(tmp_path / "port")
    shutil.copytree(path / "port", workdir)
    evals = evaluate.continuous_eval(tcfg, workdir, interval_secs=0.01,
                                     max_evals=2, max_batches=1,
                                     device="cpu")
    first = next(evals)
    assert first.step == STEP
    state = trainlib.build_state(tcfg, CPU)
    manager = ckptlib.CheckpointManager(workdir)
    manager.restore(state)
    state.device_step.fill_(7)
    manager.save(state.replace(step=7), {})
    manager.wait()
    second = next(evals)
    assert second.step == 7
    assert second.metrics == first.metrics  # the same weights
    assert list(evals) == []


def test_cli_eval_prints_the_json_line(saved, capsys):
    tcfg, _, tmp_path = saved("lenet")
    want = evaluate.evaluate_classification(tcfg, str(tmp_path / "port"),
                                            device="cpu", max_batches=2)
    capsys.readouterr()
    assert cli.main(["eval", "--config", "lenet_mnist", "--workdir",
                     str(tmp_path / "port"), "--batch-size", "8",
                     "--max-batches", "2", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"step": STEP, **want.metrics}


def test_eval_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tcfg, _ = _configs("lenet")
    for fn in (evaluate.evaluate_classification, evaluate.evaluate_lm):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(tcfg, str(tmp_path), max_batches=1)


@pytest.mark.two_proc
def test_two_processes_count_the_global_batch(cluster):  # noqa: F811
    """Two gloo processes: ``fit``'s ``telemetry.json`` prices the global
    batch (the one-process count at 8 rows, over 2 devices), the
    telemetry rows carry the per-process aggregates, and each process's
    eval of the checkpoint equals one process's eval of it."""
    cfg = worker.TELEMETRY
    checks = [json.loads((cluster / f"checks_p{p}.json").read_text())
              for p in (0, 1)]
    chief = checks[0]["telemetry"]
    flops = trainlib.step_flops_fn(cfg, meshlib.local_mesh("cpu"))(
        {"image": torch.empty(cfg.global_batch_size, 28, 28, 1),
         "label": torch.empty(cfg.global_batch_size, dtype=torch.int32)})
    report = chief["report"]
    assert report["flops_per_step"] == flops > 0
    assert report["flops_total"] == cfg.train_steps * flops
    assert report["n_devices"] == 2 and report["steps"] == cfg.train_steps
    assert math.fsum(report["fractions"].values()) == pytest.approx(1.0)
    assert [r["step"] for r in chief["rows"]] == [2, 4]
    for row in chief["rows"]:
        for key in ("hosts/steps_per_sec_min", "hosts/steps_per_sec_mean",
                    "hosts/stall_fraction_max", "mfu", "data_wait_s"):
            assert key in row, key
    assert checks[1]["telemetry"]["eval"] == chief["eval"]
    one = evaluate.evaluate_classification(
        cfg, str(cluster / "telemetry"), device="cpu",
        max_batches=worker.EVAL_BATCHES)
    assert chief["step"] == one.step == cfg.train_steps
    got = chief["eval"]
    assert got["count"] == one.metrics["count"] == (
        worker.EVAL_BATCHES * cfg.global_batch_size)
    for k in ("top1", "top5"):
        assert round(got[k] * got["count"]) == round(
            one.metrics[k] * got["count"])
    assert got["xent"] == pytest.approx(one.metrics["xent"], rel=REL)
