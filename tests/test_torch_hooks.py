"""The port's hooks and chunk logic against the JAX package's, exactly:
``_chunk_len`` over a grid of steps, chunk lengths, log cadences, run
lengths and hook cadences; ``run_hooks_after_chunk``'s walked steps, its
``train/hook_walks`` count and the stop; ``LazyMetricRow``'s overlay; the
NaN guard's attribution of a mid-chunk NaN; the step-driven hooks."""

import itertools
import json

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu import telemetry as jtelemetry
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import hooks as jhooks
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu_torch import telemetry as ttelemetry
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import hooks as thooks
from distributed_tensorflow_models_tpu_torch.harness import train as ttrain


class _Every:
    """A hook wanting every ``every``-th step (or none), recording the
    steps it is walked at and the loss it reads there."""

    def __init__(self, every):
        self.every = every
        self.seen = []

    def begin(self, state):
        pass

    def wants_step(self, step):
        return bool(self.every) and step % self.every == 0

    def after_step(self, state, metrics, step):
        self.seen.append((step, float(metrics["loss"])))

    def end(self, state):
        pass


def _cadence_hooks(cadences):
    return [_Every(c) for c in cadences]


CHUNK_GRID = list(itertools.product(
    range(0, 24), (1, 3, 4, 8), (0, 5, 7), (10, 23), ((), (3,), (6, 4))))


def test_chunk_len_equals_jax_over_a_grid():
    """Every (step, steps_per_loop, log_every_steps, train_steps, hook
    cadences) of the grid, with and without a StopAtStepHook at the run's
    end: the same chunk length."""
    checked = 0
    for step, spl, log_every, train_steps, cadences in CHUNK_GRID:
        if step >= train_steps:
            continue
        kw = dict(steps_per_loop=spl, log_every_steps=log_every,
                  train_steps=train_steps)
        jcfg = jconfig.get_config("lenet_mnist", **kw)
        tcfg = tconfig.get_config("lenet_mnist", **kw)
        for stop in (False, True):
            hooks = _cadence_hooks(cadences)
            jh = hooks + ([jhooks.StopAtStepHook(train_steps)] if stop else [])
            th = hooks + ([thooks.StopAtStepHook(train_steps)] if stop else [])
            assert (ttrain._chunk_len(step, tcfg, th)
                    == jtrain._chunk_len(step, jcfg, jh)), (step, kw,
                                                           cadences, stop)
            checked += 1
    assert checked > 1000


def _walk(lib, telemetry, cadences, stop_at, start, length):
    hooks = _cadence_hooks(cadences)
    if stop_at is not None:
        hooks.append(lib.StopAtStepHook(stop_at))
    registry = telemetry.MetricsRegistry()
    losses = np.arange(length, dtype=np.float32) + 0.5
    stacked = ({"loss": losses} if lib is jhooks
               else {"loss": torch.from_numpy(losses)})
    final = lib.LazyMetricRow(stacked, length - 1, start + 1)
    ok = lib.run_hooks_after_chunk(hooks, None, stacked, start, length,
                                   registry=registry, final_row=final)
    walks = registry.snapshot().get(telemetry.HOOK_WALKS, 0)
    return ok, walks, [h.seen for h in hooks if isinstance(h, _Every)]


@pytest.mark.parametrize("cadences,stop_at", [
    ((), None), ((2,), None), ((3, 5), None), ((1,), 14), ((4,), 12),
    ((2, 3), 17), ((), 11), ((7,), 30),
])
@pytest.mark.parametrize("start,length", [(0, 8), (10, 8), (13, 1)])
def test_chunk_walk_equals_jax(cadences, stop_at, start, length):
    """The steps walked, the values read there, the walk count and the
    stop, for chunks of steps start+1 .. start+length."""
    got = _walk(thooks, ttelemetry, cadences, stop_at, start, length)
    want = _walk(jhooks, jtelemetry, cadences, stop_at, start, length)
    assert got == want


def test_lazy_metric_row_overlay_equals_jax():
    """Reads index the stacked column; writes go to an overlay that
    shadows it; deletes remove the overlay only; iteration and length
    count each key once."""
    values = np.array([1.0, 2.0, 3.0], np.float32)
    rows = []
    for lib, stacked in ((jhooks, {"loss": values, "acc": values * 2}),
                         (thooks, {"loss": torch.from_numpy(values),
                                   "acc": torch.from_numpy(values * 2)})):
        row = lib.LazyMetricRow(stacked, 1, 5)
        log = [float(row["loss"]), len(row), sorted(row),
               row.index, row.chunk_start_step]
        row["loss"] = 9.0
        row["extra"] = 4.0
        log += [float(row["loss"]), len(row), sorted(row),
                [float(v) for v in np.asarray(row.stacked("acc"))]]
        del row["loss"]
        log += [float(row["loss"]), len(row), sorted(row)]
        with pytest.raises(KeyError):
            row.stacked("extra")
        rows.append(log)
    assert rows[0] == rows[1]


@pytest.mark.parametrize("bad_index", [0, 2])
def test_nan_guard_names_the_step_of_a_mid_chunk_nan(bad_index):
    """The guard walked at a chunk's last step reads every row up to it
    and names the first non-finite one's step, as the JAX guard does."""
    values = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    values[bad_index] = np.nan
    messages = []
    for lib, stacked in ((jhooks, {"loss": values}),
                         (thooks, {"loss": torch.from_numpy(values)})):
        row = lib.LazyMetricRow(stacked, 3, 9)
        with pytest.raises(FloatingPointError) as err:
            lib.NanGuardHook(every_steps=4).after_step(None, row, 12)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == (
        f"loss is nan at step {9 + bad_index}")


def test_step_hooks_want_the_same_steps_as_jax(tmp_path):
    """StopAtStepHook, StepCounterHook, NanGuardHook, LoggingHook and
    MetricWriterHook want the same steps in both packages, and the writer
    writes the same rows (time aside) for the same metrics."""
    pairs = [(jhooks.StopAtStepHook(7), thooks.StopAtStepHook(7)),
             (jhooks.StepCounterHook(5), thooks.StepCounterHook(5)),
             (jhooks.NanGuardHook(4), thooks.NanGuardHook(4)),
             (jhooks.LoggingHook(3), thooks.LoggingHook(3))]
    for j, t in pairs:
        assert ([j.wants_step(s) for s in range(1, 30)]
                == [t.wants_step(s) for s in range(1, 30)])
    rows = []
    for lib, d, wrap in ((jhooks, tmp_path / "j", np.float32),
                         (thooks, tmp_path / "t", torch.tensor)):
        writer = lib.MetricWriterHook(str(d), every_steps=2)
        for step in range(1, 6):
            writer.after_step(None, {"loss": wrap(step / 4),
                                     "vec": wrap([1.0, 2.0])}, step)
        writer.end(None)
        lines = (d / "metrics.jsonl").read_text().splitlines()
        rows.append([{k: v for k, v in json.loads(line).items()
                      if k != "time"} for line in lines])
    assert rows[0] == rows[1] == [{"step": 2, "loss": 0.5},
                                  {"step": 4, "loss": 1.0}]


def test_run_hooks_after_step_runs_every_hook_past_a_stop():
    for lib in (jhooks, thooks):
        seen = _Every(1)
        ok = lib.run_hooks_after_step(
            [lib.StopAtStepHook(3), seen], None,
            {"loss": torch.tensor(1.5) if lib is thooks else np.float32(1.5)},
            3)
        assert not ok and seen.seen == [(3, 1.5)]
