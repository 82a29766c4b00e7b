"""The port's data parallelism across processes, on the CPU over gloo.

One cluster of two processes (``tests/torch_data_parallel_worker.py``,
which imports only the port) is launched once for the module by the JAX
package's ``launch.launch_local``, which sets only the framework-neutral
``DTM_*`` variables.  Each process joins through the port's
``launch.initialize_from_env(device="cpu")`` and runs ``fit`` for a few
steps of three configs at cut widths; each is compared here with a
one-process ``fit`` of the port at the same global batch:

- ``lenet_mnist`` (the ``tests/test_launch.py`` contract: two processes
  on disjoint halves of each batch reproduce one process);
- ``resnet32_cifar10`` cut to one block a stage (BatchNorm's moments global
  across the processes, forward and backward);
- ``ptb_medium`` at a cut width (dropout 0.5 drawn for the global batch,
  global batch 20 so 10 rows a process, the carry sharded by rows, the
  clip below every step's gradient norm so that it acts on the global
  gradient).

Tolerance: f32 sums taken per process and then across processes reorder
the reduction, so losses, gradient norms and the state agree to ~1e-6;
they are held to 1e-5 relative (1e-5 relative L2 over each state tensor,
1e-6 absolute where it is near 0).  The single-process port is held to the
JAX package elsewhere (``tests/test_torch_zoo.py``,
``tests/test_torch_ptb_lstm.py``), which closes the chain to the
reference.

The module's cluster runs once per test session however the tests are
spread over xdist workers: the first worker to take the machine-wide
two-process lock runs it and leaves its output in the session's shared
temporary directory; the others read it there.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu import launch as jax_launch
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_data_parallel_worker as worker  # noqa: E402

pytestmark = pytest.mark.two_proc

REL = 1e-5
ATOL = 1e-6
WORKER = Path(worker.__file__).resolve()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory) -> Path:
    """The two-process run's output directory (run once per session)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "torch_data_parallel"
    lock = os.environ.get("DTM_TWO_PROC_LOCK", "/tmp/dtm-two-proc.lock")
    with open(lock, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not (out / "codes.json").exists():
                out.mkdir(exist_ok=True)
                env = {"OMP_NUM_THREADS": "2",
                       "PYTHONPATH": os.pathsep.join(
                           [str(WORKER.parent.parent),
                            os.environ.get("PYTHONPATH", "")])}
                codes = jax_launch.launch_local(
                    2, [sys.executable, str(WORKER), str(out)],
                    port=_free_port(), extra_env=env, timeout=240)
                (out / "codes.json").write_text(json.dumps(codes))
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    codes = json.loads((out / "codes.json").read_text())
    assert codes == [0, 0], f"the two-process cluster exited {codes}"
    return out


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(
        np.linalg.norm(a - b))


@pytest.mark.parametrize("name", sorted(worker.CASES))
def test_two_processes_match_one(cluster, name):
    """Two processes at the global batch reproduce one process's losses,
    gradient norms and state (parameters, BN statistics, optimizer slots,
    step; the carry's rows from both processes in process order)."""
    cfg = worker.CASES[name]
    got = np.load(cluster / f"{name}.npz")
    one = trainlib.fit(cfg, device="cpu")
    assert list(got["batch_size"]) == [cfg.global_batch_size] * worker.STEPS
    want_loss = [h["loss"] for h in one.history]
    want_norm = [h["grad_norm"] for h in one.history]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=REL)
    np.testing.assert_allclose(got["grad_norm"], want_norm, rtol=REL)
    leaves = train_loop._replicated_leaves(one.state)
    assert sorted(k for k, _ in leaves) == sorted(
        k for k in got.files
        if k not in ("loss", "grad_norm", "batch_size"))
    for k, t in leaves:
        want = t.detach().float().numpy()
        assert got[k].shape == want.shape, k
        assert (_rel_l2(got[k], want) <= REL
                or np.abs(got[k] - want).max() <= ATOL), k
    if one.state.carry is not None:
        parts = [np.load(cluster / f"{name}_carry_p{p}.npz") for p in (0, 1)]
        want = [t.numpy() for t in train_loop._leaves(one.state.carry)]
        for i, w in enumerate(want):
            halves = [p[f"arr_{i}"] for p in parts]
            assert all(h.shape == (w.shape[0] // 2, *w.shape[1:])
                       for h in halves)
            assert _rel_l2(np.concatenate(halves), w) <= REL


def test_ptb_clip_acts_on_the_global_gradient(cluster):
    """In the cut ptb_medium every step's gradient norm, read after the
    all-reduce, is above the clip, so the clipped update depends on the
    global gradient's norm, and both processes' runs land on the
    one-process state (``test_two_processes_match_one``)."""
    got = np.load(cluster / "ptb_medium.npz")
    assert worker.CASES["ptb_medium"].optimizer.clip_global_norm == (
        worker.PTB_CLIP)
    assert all(n > worker.PTB_CLIP for n in got["grad_norm"])
    assert all(math.isfinite(v) for v in got["loss"])


def test_all_reduce_mean_on_mixed_dtypes(cluster):
    """f32, bf16 and f64 tensors held as (p + 1) x v by process p come back
    on both processes as 1.5 x v in their own dtypes, one collective per
    dtype (f32 and bf16 in f32 buckets, f64 in an f64 one)."""
    for p in (0, 1):
        checks = json.loads((cluster / f"checks_p{p}.json").read_text())
        assert checks["mixed_dtypes"] == ["torch.float32", "torch.bfloat16",
                                          "torch.float64"]
        for k, (dtype, v) in worker.MIXED.items():
            want = (torch.tensor(v, dtype=torch.float64) * 1.5).to(dtype)
            assert checks["mixed"][k] == want.double().tolist(), k
        assert checks["mixed_collectives"] == {
            "grads": [3, 4 * (3 + 4) + 8 * 2]}


def test_replica_check_raises_on_states_that_differ(cluster):
    """States built from different seeds on the two processes: the
    startup check (an all-reduce of each tensor's checksum by MIN and by
    MAX) raises on both, naming tensors of the state."""
    for p in (0, 1):
        checks = json.loads((cluster / f"checks_p{p}.json").read_text())
        msg = checks["replica_check"]
        assert msg is not None and "do not hold the same initial" in msg
        assert "state/params/" in msg
