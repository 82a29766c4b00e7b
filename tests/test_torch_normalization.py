"""The port's BatchNorm and pooling against the JAX package's.

Inputs come from numpy seeds and go to both frameworks.  BatchNorm is
compared in train mode (output and updated running statistics) and eval
mode, in f32 and bf16; pooling in SAME and VALID for every lowering.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.ops import conv as jconv
from distributed_tensorflow_models_tpu.ops.normalization import BatchNorm as JBatchNorm
from distributed_tensorflow_models_tpu_torch.ops import conv as tconv
from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm

jax.config.update("jax_platforms", "cpu")

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          # bf16: both sides round the same f32 affine constants and do one
          # multiply-add in bf16; allow two bf16 ulps (2^-7 relative).
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _bn_case(seed, shape=(4, 5, 6, 8)):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    params = {"scale": rng.rand(c).astype(np.float32) + 0.5,
              "bias": rng.randn(c).astype(np.float32)}
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": rng.rand(c).astype(np.float32) + 0.5}
    return x, params, stats


def _port_bn(params, stats):
    bn = BatchNorm(len(params["scale"]))
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    return bn


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_jax(dtype, train):
    jdt, tdt, tol = DTYPES[dtype]
    x, params, stats = _bn_case(0)
    jbn = JBatchNorm(use_running_average=not train, momentum=0.9,
                     epsilon=1e-5)
    variables = {"params": params, "batch_stats": stats}
    jx = jnp.asarray(x).astype(jdt)
    if train:
        want, updated = jbn.apply(variables, jx, mutable=["batch_stats"])
        want_stats = updated["batch_stats"]
    else:
        want, want_stats = jbn.apply(variables, jx), stats
    bn = _port_bn(params, stats)
    got = bn(torch.from_numpy(x).to(tdt), use_running_average=not train)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    for k in ("mean", "var"):
        # Statistics are f32 on both sides whatever the activation dtype.
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(want_stats[k]),
                                   atol=1e-5, rtol=1e-5)


def test_batchnorm_grads_match_jax():
    x, params, stats = _bn_case(1)
    jbn = JBatchNorm(use_running_average=False)

    def jloss(x, p):
        y, _ = jbn.apply({"params": p, "batch_stats": stats}, x,
                         mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y))

    gx, gp = jax.grad(jloss, (0, 1))(jnp.asarray(x), params)
    bn = _port_bn(params, stats)
    tx = torch.tensor(x, requires_grad=True)
    torch.sum(torch.sin(bn(tx, use_running_average=False))).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=5e-4, rtol=5e-4)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(bn, k).grad.numpy(),
                                   np.asarray(gp[k]), atol=5e-4, rtol=5e-4)


def test_batchnorm_variance_is_biased_and_clamped():
    # Two values 0 and 2: biased variance 1 (nn.BatchNorm2d would keep 2).
    x = torch.tensor([0.0, 2.0]).reshape(2, 1, 1, 1)
    bn = BatchNorm(1, momentum=0.0)
    bn(x, use_running_average=False)
    assert bn.var.item() == 1.0 and bn.mean.item() == 1.0
    # Constant channels: E[x^2]-E[x]^2 rounds to either side of 0 and is
    # clamped at 0.
    for v in np.linspace(0.1, 5.0, 50, dtype=np.float32):
        bn(torch.full((3, 3, 3, 1), float(v)), use_running_average=False)
        assert bn.var.item() >= 0.0


POOL_CASES = [
    ((2, 9, 9, 4), (3, 3), (2, 2), "SAME"),
    ((2, 8, 8, 4), (3, 3), (2, 2), "SAME"),
    ((2, 9, 8, 4), (2, 2), (2, 2), "VALID"),
    ((2, 7, 7, 4), (3, 3), (1, 1), "SAME"),
]


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("impl", ["xla", "patches", "mxu"])
@pytest.mark.parametrize("xshape,window,strides,padding", POOL_CASES,
                         ids=["s2_same_odd", "s2_same_even", "valid",
                              "s1_same"])
def test_pool_matches_jax(kind, impl, xshape, window, strides, padding):
    x = np.random.RandomState(2).randn(*xshape).astype(np.float32)
    jfn = jconv.max_pool if kind == "max" else jconv.avg_pool
    tfn = tconv.max_pool if kind == "max" else tconv.avg_pool
    want = jfn(jnp.asarray(x), window, strides, padding, impl="xla")
    got = tfn(torch.from_numpy(x), window, strides, padding, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)
