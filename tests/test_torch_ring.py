"""The port's sequence parallelism (``parallel/ring.py``) against the JAX
package's, on the CPU.

- ``ring_attention`` (fold, and flash through the chunk kernels' plain
  versions) and ``ulysses_attention`` run on 2 and 4 gloo processes
  (``tests/torch_parallel_cluster.py``), each on its block of a global
  Q/K/V, forward and the gradients of a seeded cotangent.  The blocks put
  together are held to the JAX package's ``ring_attention`` /
  ``ulysses_attention`` on its ``seq_mesh`` (8 fake CPU devices, data 2 x
  seq 4; data 4 x seq 2 for Ulysses at 2 KV heads, which do not split
  over 4, at its batch of 4), and
  to its ``reference_attention``, at the JAX suite's own tolerances
  (``tests/test_attention.py``: 2e-5 forward, 2e-4 gradients).
- The ring driven in one process (``ring.emulate``: the per-rotation
  function of each virtual rank in turn, as ``chip_smoke.py`` phase 17
  drives it on the card) equals the gloo ring bit for bit, output and
  gradients.
- The JAX package's errors: an indivisible sequence, a window below 1,
  indivisible heads, an unknown impl or ``seq_impl``.
- A wholly masked chunk through the plain versions of K2-K4: out 0, lse at
  NEG_INF, gradients 0 also under an LSE cotangent.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

import torch_parallel_cluster
import torch_parallel_worker as worker
from distributed_tensorflow_models_tpu.core import mesh as jmesh
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu.ops import attention as jattn
from distributed_tensorflow_models_tpu.parallel import ring as jring
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.ops import attention as tattn
from distributed_tensorflow_models_tpu_torch.parallel import ring as tring

jax.config.update("jax_platforms", "cpu")

pytestmark = pytest.mark.two_proc

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    return torch_parallel_cluster.cluster(tmp_path_factory, 4)


def _blocks(out_dir, n, name):
    """The n processes' blocks put together along the sequence."""
    parts = [np.load(out_dir / f"attn{n}_{name}_p{p}.npz") for p in range(n)]
    return {k: np.concatenate([p[k] for p in parts], axis=1)
            for k in ("out", "dq", "dk", "dv")}


_JAX: dict = {}


def _jax_run(index):
    """The JAX package's ring/Ulysses and reference on case ``index``:
    ``(ring out, ring grads, reference out, reference grads)``."""
    if index in _JAX:
        return _JAX[index]
    name, impl, causal, window, H, Hkv = worker.ATTN_CASES[index][:6]
    q, k, v, do = (jnp.asarray(x) for x in worker.attn_inputs(index))
    seq = 2 if impl == "ulysses" and Hkv % 4 else 4
    mesh = jmesh.create_mesh(jmesh.MeshSpec(data=-1, seq=seq))
    if impl == "ulysses":
        fn = functools.partial(jring.ulysses_attention, mesh=mesh,
                               causal=causal, window=window)
    else:
        fn = functools.partial(jring.ring_attention, mesh=mesh,
                               causal=causal, impl=impl, window=window,
                               interpret=impl == "flash")
    ref = functools.partial(jattn.reference_attention, causal=causal,
                            window=window)
    runs = []
    for f in (fn, ref):
        out, vjp = jax.vjp(jax.jit(f), q, k, v)
        runs += [np.asarray(out), [np.asarray(g) for g in vjp(do)]]
    _JAX[index] = runs
    return runs


RUNS = [(n, i) for n in (2, 4) for i, c in enumerate(worker.ATTN_CASES)
        if c in worker.attn_runs(n)]


@pytest.mark.parametrize("n,index", RUNS, ids=[
    f"n{n}-{worker.ATTN_CASES[i][0]}" for n, i in RUNS])
def test_ring_and_ulysses_on_gloo_match_jax(cluster2, cluster4, n, index):
    got = _blocks({2: cluster2, 4: cluster4}[n], n,
                  worker.ATTN_CASES[index][0])
    out, grads, ref_out, ref_grads = _jax_run(index)
    np.testing.assert_allclose(got["out"], out, **FWD)
    np.testing.assert_allclose(got["out"], ref_out, **FWD)
    for name, g, want, ref in zip(("dq", "dk", "dv"), (got[k] for k in (
            "dq", "dk", "dv")), grads, ref_grads):
        np.testing.assert_allclose(g, want, err_msg=name, **GRAD)
        np.testing.assert_allclose(g, ref, err_msg=name, **GRAD)


EMULATED = [(n, i) for n, i in RUNS if worker.ATTN_CASES[i][1] != "ulysses"]


@pytest.mark.parametrize("n,index", EMULATED, ids=[
    f"n{n}-{worker.ATTN_CASES[i][0]}" for n, i in EMULATED])
def test_one_process_ring_equals_the_gloo_ring_bit_for_bit(
        cluster2, cluster4, n, index):
    """``ring.emulate`` drives ``ring_step`` for each virtual rank on the
    KV blocks in the order the rank receives them, and sums the KV
    gradients in the order the ring's backward does: every value equals
    the ring's across n processes bit for bit."""
    name, impl, causal, window = worker.ATTN_CASES[index][:4]
    got = _blocks({2: cluster2, 4: cluster4}[n], n, name)
    q, k, v, do = (torch.from_numpy(x) for x in worker.attn_inputs(index))
    out, dq, dk, dv = tring.emulate(q, k, v, n, impl=impl, causal=causal,
                                    window=window, dout=do)
    for key, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert torch.equal(t, torch.from_numpy(got[key])), key


def _mesh(seq=2):
    """A simulated seq axis (no group): validation raises before any
    exchange."""
    return meshlib.Mesh((1, 1, seq, 1, 1), 0, 1, CPU, coords=(0, 0, 1, 0, 0),
                        process_index=1, process_count=seq)


def _both_raise(port_fn, jax_fn):
    with pytest.raises(ValueError) as port:
        port_fn()
    with pytest.raises(ValueError) as want:
        jax_fn()
    assert str(port.value) == str(want.value)


def test_errors_match_jax():
    jm = jmesh.create_mesh(jmesh.MeshSpec(data=-1, seq=4))
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k3 = np.ascontiguousarray(q[:, :, :3])
    odd = np.ascontiguousarray(q[:, :63])
    tq, tk3 = torch.from_numpy(q), torch.from_numpy(k3)
    # The sequence must split over the axis.
    _both_raise(lambda: tring.split_sequence(torch.from_numpy(odd),
                                             _mesh(4)),
                lambda: jring.ring_attention(odd, odd, odd, jm))
    # A window below 1, on the fold.
    _both_raise(lambda: tring.ring_attention(tq, tq, tq, _mesh(), causal=True,
                                             impl="fold", window=0),
                lambda: jring.ring_attention(q, q, q, jm, causal=True,
                                             impl="fold", window=0))
    # Query heads that the KV heads do not divide.
    _both_raise(lambda: tring.ring_attention(tq, tk3, tk3, _mesh()),
                lambda: jring.ring_attention(q, k3, k3, jm))
    # Ulysses: both head counts must divide by the axis.
    k2 = np.ascontiguousarray(q[:, :, :2])
    _both_raise(lambda: tring.ulysses_attention(
                    tq, torch.from_numpy(k2), torch.from_numpy(k2),
                    _mesh(4), causal=True),
                lambda: jring.ulysses_attention(q, k2, k2, jm, causal=True))
    # An unknown ring impl.
    _both_raise(lambda: tring.ring_attention(tq, tq, tq, _mesh(), impl="x"),
                lambda: jring.ring_attention(q, q, q, jm, impl="x"))


def test_unknown_seq_impl_raises_the_jax_error():
    kw = dict(mesh_seq=1, seq_impl="spiral")
    with pytest.raises(ValueError) as port:
        trainlib._model_kwargs(trainlib.ExperimentConfig(
            name="t", model="transformer_lm", task="lm", **kw))
    with pytest.raises(ValueError) as want:
        jtrain._mesh_model_kwargs(jconfig.ExperimentConfig(
            name="t", model="transformer_lm", task="lm", **kw), None)
    assert str(port.value) == str(want.value)


@pytest.mark.parametrize("attn_impl,want", [
    ("auto", "auto"), ("flash", "flash"), ("reference", "fold"),
    ("blockwise", "fold")])
def test_attn_impl_picks_the_ring_impl(monkeypatch, attn_impl, want):
    """The harness's ring takes ``auto`` from ``attn_impl="auto"`` and
    ``flash`` from ``"flash"`` (which never folds: the kernels on the
    card, their plain versions on the CPU), the fold from the plain
    impls and for the FLOPs count; on the CPU ``auto`` folds."""
    seen = []
    monkeypatch.setattr(tring, "ring_attention",
                        lambda *a, impl, **kw: seen.append(impl))
    cfg = trainlib.ExperimentConfig(name="t", model="transformer_lm",
                                    task="lm", seq_impl="ring",
                                    attn_impl=attn_impl)
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    trainlib.seq_attention_fn(cfg, None)(q, q, q)
    trainlib.seq_attention_fn(cfg, None, counting=True)(q, q, q)
    assert seen == [want, "fold"]
    assert tring.resolve_impl(want, q) == ("fold" if want == "auto"
                                           else want)


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None, q_offset=0, kv_offset=128),
    dict(causal=True, window=32, q_offset=256, kv_offset=64),
], ids=["future", "older-than-the-window"])
def test_wholly_masked_chunk_through_the_plain_versions(kw):
    """What a ring's flash path sends through K2-K4 for a block that no
    query sees: out 0 and lse at NEG_INF (zero weight in the merge), and
    zero gradients, also with a nonzero LSE cotangent."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 64, 4, 16)),
                                dtype=torch.float32, requires_grad=i < 3)
                   for i in range(4))
    dlse = torch.tensor(rng.standard_normal((2, 64, 4)), dtype=torch.float32)
    assert tring.fully_masked(kw["q_offset"], kw["kv_offset"], 64, 64,
                              kw["causal"], kw["window"])
    out, lse = tattn.flash_attention_chunk(q, k, v, **kw)
    assert bool((out == 0).all())
    assert float(lse.detach().max()) <= tattn.NEG_INF / 2
    torch.autograd.backward([out, lse], [do, dlse])
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        assert bool((t.grad == 0).all()), name
