"""The K-step train call and what it needs, on the CPU:

- ``MultiStep`` over a chunk of 4 then a tail of 2 equals 6 single steps
  bit for bit (metrics, parameters, BN statistics, optimizer slots, EMA
  shadows, the carry): a BN + dropout model under Adam with a schedule and
  the EMA, ``lenet_mnist``, ``resnet32_cifar10`` cut to one block a stage,
  ``ptb_small`` with its carry and dropout (the JAX package's
  ``tests/test_train_loop.py`` contract);
- ``fit`` at ``steps_per_loop`` 4 equals ``steps_per_loop`` 1 bit for bit,
  and matches the JAX package's ``fit`` at ``steps_per_loop`` 4 on a tiny
  ``lenet_mnist`` from the same weights, step by step, at the tolerance of
  the port's step parity tests (``tests/test_torch_zoo.py``'s
  ``STATE_TOL``);
- the in-place optimizers and EMA equal the per-tensor forms they replace
  bit for bit, and the device rate tables equal the host schedules bit
  for bit at every step of a run;
- ``BatchStacker``'s chunks, tail and ``get_state`` equal the JAX
  package's exactly on a host numpy upstream.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.data import pipeline as jpipe
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu_torch import interop
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.data import pipeline as tpipe
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.ops import optim
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm

import torch_reference_optim as ref

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
# The port's step parity tolerance (tests/test_torch_zoo.py STATE_TOL).
STATE_TOL = dict(atol=5e-4, rtol=5e-4)


class _BnDropoutNet(torch.nn.Module):
    """Dense, BN, ReLU, dropout 0.5, dense: the smallest model with BN
    statistics and dropout bits in its step."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        self.kernel = torch.nn.Parameter(torch.randn(12, 16, generator=gen))
        self.bn = BatchNorm(16)
        self.head_kernel = torch.nn.Parameter(
            torch.randn(16, 5, generator=gen) * 0.3)

    def forward(self, x, train=True, rngs=None):
        h = x.reshape(x.shape[0], -1) @ self.kernel
        h = torch.relu(self.bn(h, use_running_average=not train))
        return dropout(h, 0.5, train, rngs) @ self.head_kernel


def _bn_dropout_case():
    model = _BnDropoutNet()
    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adam(optim.exponential_decay(0.01, 2, 0.5),
                                num_steps=6))
    state = TrainState.create(model, tx, ema_decay=0.9)
    step = train_loop.make_train_step(train_loop.classification_loss_fn(
        model, weight_decay=1e-3))
    rng = np.random.default_rng(4)
    batches = [{"image": torch.tensor(rng.standard_normal((8, 3, 4)),
                                      dtype=torch.float32),
                "label": torch.tensor(rng.integers(0, 5, 8))}
               for _ in range(6)]
    return state, step, batches


CONFIG_CASES = {
    "lenet_mnist": dict(global_batch_size=4),
    "resnet32_cifar10": dict(global_batch_size=2,
                             model_kwargs={"blocks_per_stage": 1}),
    "ptb_small": dict(global_batch_size=2, num_steps=5, vocab_size=64,
                      model_kwargs={"config": "small", "vocab_size": 64,
                                    "hidden_size": 16, "dropout_rate": 0.5}),
}


def _case(name):
    """(a fresh state, its step, 6 batches) of case ``name``."""
    if name == "bn_dropout":
        return _bn_dropout_case()
    cfg = tconfig.get_config(name, train_steps=6, **CONFIG_CASES[name])
    state = trainlib.build_state(cfg, CPU)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in itertools.islice(iter(trainlib.build_dataset(cfg)),
                                         6)]
    return state, trainlib.build_step(cfg, state), batches


def _snapshot(state):
    leaves = train_loop._leaves((state.params, state.batch_stats,
                                 state.opt_state, state.ema_params,
                                 state.carry, state.device_step))
    return [t.detach().clone() for t in leaves]


@pytest.mark.parametrize("name", ["bn_dropout", *sorted(CONFIG_CASES)])
def test_multi_step_equals_single_steps(name):
    state, step, batches = _case(name)
    metrics = []
    for b in batches:
        state, m = step(state, b, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    want = _snapshot(state)

    state, step, batches = _case(name)
    multi = train_loop.make_multi_step(step.loss_fn)
    rows = []
    for chunk in (batches[:4], batches[4:]):
        state, stacked = multi(state, {k: torch.stack([b[k] for b in chunk])
                                       for k in chunk[0]}, 0)
        assert stacked["loss"].shape == (len(chunk),)
        rows += [dict(zip(stacked.names, r))
                 for r in stacked.values.tolist()]
    assert rows == metrics
    assert state.step == 6 and int(state.device_step) == 6
    got = _snapshot(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert multi.captures == multi.replays == 0


@pytest.mark.parametrize("name,over", [
    ("lenet_mnist", dict(global_batch_size=4)),
    ("ptb_small", CONFIG_CASES["ptb_small"]),
])
def test_fit_in_chunks_equals_a_step_a_call(name, over):
    """steps_per_loop 4 and 1 over 7 steps with a log cadence of 5 (chunks
    4, 1, 2): the same history metrics and final state bit for bit."""
    results = [trainlib.fit(tconfig.get_config(
        name, train_steps=7, log_every_steps=5, steps_per_loop=k, **over),
        device="cpu") for k in (1, 4)]
    keys = [k for k in results[0].history[0]
            if k not in ("data_s", "step_time_s", "end_s")]
    for a, b in zip(*(r.history for r in results)):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert [len(r.history) for r in results] == [7, 7]
    for a, b in zip(*(_snapshot(r.state) for r in results)):
        assert torch.equal(a, b)
    assert results[1].window_steps == 3 and results[1].images_per_sec > 0


class _ChunkLosses:
    """A hook of the JAX package's ``fit``: records every step's loss from
    the rows a chunk's walk hands over (wanted at each ``every``-th step:
    the chunk ends there)."""

    def __init__(self, every):
        self.every = every
        self.losses = {}

    def begin(self, state):
        pass

    def wants_step(self, step):
        return step % self.every == 0

    def after_step(self, state, metrics, step):
        if step % self.every:
            return
        column = np.asarray(metrics.stacked("loss"))[: metrics.index + 1]
        for i, v in enumerate(column):
            self.losses[metrics.chunk_start_step + i] = float(v)

    def end(self, state):
        pass

    def abort(self, state):
        pass


def test_fit_in_chunks_matches_jax_fit(tmp_path, monkeypatch, mesh8):
    """lenet_mnist (dropout 0, batch 16, SGD 0.1) for 8 steps at
    steps_per_loop 4 through both packages' ``fit`` from the port's seeded
    weights: every step's loss within STATE_TOL."""
    kw = dict(train_steps=8, global_batch_size=16, log_every_steps=4,
              steps_per_loop=4, model_kwargs={"dropout_rate": 0.0})
    tcfg = tconfig.get_config("lenet_mnist", **kw)
    jcfg = jconfig.get_config("lenet_mnist", checkpoint_every_secs=1e4, **kw)
    tree = interop.to_flax_variables(trainlib.build_model(tcfg, CPU))
    real = jtrain.build_state

    def bridged(cfg, mesh):
        s = real(cfg, mesh)
        params = jax.tree.map(jax.numpy.asarray, tree["params"])
        return s.replace(params=params, opt_state=s.tx.init(params))

    monkeypatch.setattr(jtrain, "build_state", bridged)
    jrec = _ChunkLosses(4)
    jtrain.fit(jcfg, str(tmp_path / "jax"), extra_hooks=[jrec], mesh=mesh8)
    result = trainlib.fit(tcfg, str(tmp_path / "port"), device="cpu")
    assert sorted(jrec.losses) == list(range(1, 9))
    assert len(result.history) == 8
    np.testing.assert_allclose([r["loss"] for r in result.history],
                               [jrec.losses[s] for s in range(1, 9)],
                               **STATE_TOL)


@pytest.mark.parametrize("name", ref.CASES)
def test_in_place_optimizers_equal_the_per_tensor_form(name):
    ref.check_against_per_tensor_form(name, CPU)


SCHEDULES = {
    "exponential_staircase": optim.exponential_decay(0.1, 7, 0.94),
    "exponential": optim.exponential_decay(0.5, 3, 0.9, staircase=False),
    "zaremba": optim.zaremba_decay(1.0, 5, 4, 1 / 1.15),
    "piecewise": optim.piecewise_constant([10, 40, 90],
                                          [0.1, 0.05, 0.01 / 3, 0.0007]),
    "adam_c1": lambda t: 1.0 - 0.9 ** t,
    "adam_c2": lambda t: 1.0 - 0.999 ** t,
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_device_schedule_equals_the_host_schedule(name):
    """The table read by the device count gives, at every count of a
    200-step run, the host value rounded to f32 (what an op on f32 tensors
    makes of the Python float), bit for bit; a count past it raises."""
    fn = SCHEDULES[name]
    table = optim._CountTable(fn, 200, name)
    table.init(CPU)
    count = torch.zeros((), dtype=torch.int64)
    for c in range(201):
        got = table(count)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy().tobytes() == np.float32(fn(c)).tobytes(), c
        count.add_(1)
    with pytest.raises(IndexError):
        table(count)


@pytest.mark.parametrize("make", [
    lambda: optim.sgd(optim.exponential_decay(0.1, 2, 0.5)),
    lambda: optim.tf_momentum(optim.zaremba_decay(1.0, 2, 1, 0.5)),
    lambda: optim.tf_rmsprop(optim.piecewise_constant([1], [0.1, 0.05])),
    lambda: optim.adam(1e-3),
    lambda: tconfig.get_config("transformer_lm_tiny").optimizer.make(),
], ids=["sgd_schedule", "momentum_schedule", "rmsprop_schedule",
        "adam_constant", "config_adam"])
def test_a_table_needs_the_runs_length(make):
    """A schedule, and Adam's bias corrections even at a constant rate, are
    device tables of the run's counts: made without ``num_steps`` they
    raise at once, naming it."""
    with pytest.raises(ValueError, match="pass num_steps"):
        make()


def test_step_limit_is_the_least_table_and_none_without_one():
    clip = optim.clip_by_global_norm(1.0)
    assert optim.sgd(0.1).num_steps is None
    assert optim.tf_momentum(0.1, num_steps=9).num_steps is None
    assert optim.adam(1e-3, num_steps=9).num_steps == 9
    assert optim.chain(clip, optim.sgd(0.1)).num_steps is None
    assert optim.chain(clip, optim.adam(1e-3, num_steps=9),
                       optim.sgd(optim.exponential_decay(0.1, 2, 0.5),
                                 num_steps=5)).num_steps == 5


@pytest.mark.parametrize("call", ["single", "chunk"])
def test_steps_past_the_tables_raise_on_the_host(call):
    """A run made for 6 steps: the step (or the K-step call) that would
    read past the tables raises a ValueError naming the limit before it
    changes the state; the steps within it run."""
    state, step, batches = _case("bn_dropout")
    for b in batches[:4]:
        state, _ = step(state, b, 0)
    before = _snapshot(state)
    tail = batches[4:] + batches[:1]
    with pytest.raises(ValueError, match="past the 6 steps"):
        if call == "single":
            for b in tail:
                state, _ = step(state, b, 0)
        else:
            train_loop.make_multi_step(step.loss_fn)(
                state, {k: torch.stack([b[k] for b in tail])
                        for k in tail[0]}, 0)
    assert state.step == (6 if call == "single" else 4)
    if call == "chunk":
        assert all(torch.equal(a, b)
                   for a, b in zip(_snapshot(state), before))


def test_sgd_applies_the_device_rate_of_each_step():
    """SGD's update at each count is -f32(schedule(count)) x g, the rate
    read on the device from the count the state carries."""
    sched = optim.zaremba_decay(1.0, 2, 1, 0.5)
    tx = optim.sgd(sched, num_steps=10)
    p = {"w": torch.zeros(3)}
    state = tx.init(p)
    for c in range(10):
        updates, state = tx.update({"w": torch.ones(3)}, state)
        assert torch.equal(updates["w"],
                           torch.full((3,), -np.float32(sched(c))))
    assert int(state["count"]) == 10


class _Upstream:
    """A host numpy upstream of ``n`` batches with a resumable cursor."""

    def __init__(self, n):
        self.n, self.i = n, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return {"image": np.full((2, 3), self.i, np.float32),
                "label": np.arange(2, dtype=np.int32) + self.i}

    def get_state(self):
        return {"i": self.i}


def _chunks(lib, ks):
    stacker = lib.BatchStacker(_Upstream(10))
    out = [stacker.get_state()]
    for k in ks:
        try:
            chunk, n = stacker.next_chunk(k)
        except StopIteration:
            out.append("stop")
            continue
        out.append((n, {key: np.asarray(v).tolist()
                        for key, v in chunk.items()}, stacker.get_state()))
    return out


def test_batch_stacker_equals_jax():
    """Chunks of 3, 1, 4 and 4 from 10 batches: the rows stacked on a new
    leading axis, a ragged tail of 2, then StopIteration (and again), the
    producer state of each chunk's last batch."""
    ks = (3, 1, 4, 4, 2, 1)
    got, want = _chunks(tpipe, ks), _chunks(jpipe, ks)
    assert got == want
    assert got[4][0] == 2 and got[5] == got[6] == "stop"


def test_batch_stacker_stacks_device_batches_as_tensors():
    """Tensor rows (the prefetcher's) stack with torch on their device."""
    rows = [{"x": torch.full((2,), float(i))} for i in range(3)]
    chunk, n = tpipe.BatchStacker(iter(rows)).next_chunk(4)
    assert n == 3 and isinstance(chunk["x"], torch.Tensor)
    assert chunk["x"].tolist() == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]
