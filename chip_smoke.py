#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Every phase fails loudly (exit code 1); none is caught and skipped.

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``csrc/`` (one nvcc per source, all started at once).
2. K1 (``csrc/conv_implicit_gemm.cu``) against its plain version
   (``conv_mxu._core_reference``, f32) at every launch shape of one
   ResNet-50 training step: the 3x3 convs at 56/28/14/7, the four phase
   kernels of each stride-2 conv, and the dx of all of them.  The shapes
   come from running the port's ResNet-50 on the meta device, so they are
   the main path's own.  Times K1, the plain version and ``F.conv2d``
   (cuDNN, a yardstick only) with CUDA events and works out the bound.
3. ``conv2d_mxu`` forward and gradients (dx, dw), stride 1 and 2, against
   the ``patches`` lowering in f32 on the card.
4. The slice: the port's CLI trains ``resnet50_synthetic`` (224x224,
   widths 64..2048, 1000 classes) on the card with ``DTM_CONV_IMPL=mxu``.
   K1's launch counter is zeroed just before and read just after, and must
   equal its launches per step (from phase 2's trace) times the steps.
   The same run with ``F.conv2d`` convs (cuDNN) follows as a yardstick,
   in turns with a second K1 run.
5. Where the step's device time goes: ``torch.profiler`` over two steps
   of each arm, device time by kernel class and the device's idle share.
6. K2, K3 and K4 (``csrc/flash_attention.cu``) against their plain
   versions (``ops/attention.py``) in bf16 at (a) the LM slice's launch
   shape B16 T256 H8 D32 causal, (b) the flash sweep shape B4 T2048 H8 D64
   causal, (c) B4 T2048 H8 Hkv2 D32 causal window 256, and (d) a chunk
   call with nonzero q/kv offsets and an LSE cotangent.  At (a) and (b)
   each kernel is timed against its bound and its plain version, K2
   against ``F.scaled_dot_product_attention``'s forward and K3+K4 against
   its backward (a yardstick only: the port never calls it).
7. The LM slice: the port's CLI trains ``transformer_lm`` (4 layers, 8
   heads, d_model 256, d_ff 1024, vocab 10000, sequence 256, batch 16,
   Adam with clipping, fused bf16 head) on the card with ``--attn-impl
   flash``.  The three flash counters are zeroed just before and read
   just after: each must equal 4 layers x steps.  The same run with
   ``--attn-impl auto`` (blockwise attention in plain PyTorch, the
   config's default) follows as a yardstick, in turns with the flash arm.
8. ``torch.profiler`` over two steps of each LM arm.

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense bf16 tensor cores, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# K1 writes bf16: its output rounding is at most half an ulp, 2^-8 of the
# value; the f32 sums run in another order than the plain version's.
# Allow one ulp (2^-7) relative plus 1e-3 of the output's scale.
K1_RTOL = 2.0 ** -7
K1_ATOL_OF_SCALE = 1e-3
# conv2d_mxu in bf16 against f32: each K1 output and each dw tap rounds to
# bf16 once, and a stride-2 forward adds its four phase outputs in bf16.
GRAD_TOL_OF_SCALE = 2.0 ** -6
K1_SOURCE = "distributed_tensorflow_models_tpu_torch/csrc/conv_implicit_gemm.cu"
K1_REPLACES = "distributed_tensorflow_models_tpu/ops/conv_mxu.py:174"
FLASH_SOURCE = "distributed_tensorflow_models_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = (
    # id, its wrapper in ops/attention.py, the TPU kernel it replaces
    ("K2", "flash_forward", "distributed_tensorflow_models_tpu/ops/attention.py:578"),
    ("K3", "flash_dkv", "distributed_tensorflow_models_tpu/ops/attention.py:799"),
    ("K4", "flash_dq", "distributed_tensorflow_models_tpu/ops/attention.py:916"),
)
# K2-K4 against their plain versions in bf16: both round P and dS to bf16
# at the same points; they differ by the f32 summation order (the kernel
# rescales by a running max where the plain version sums at once), rare
# one-ulp flips of a rounded P or dS and each output's bf16 rounding (half
# an ulp).  Two ulps (2^-6) relative plus 1e-2 of the output's largest
# magnitude; the f32 LSE to 1e-4 absolute.
FLASH_RTOL = 2.0 ** -6
FLASH_ATOL_OF_SCALE = 1e-2
LSE_ATOL = 1e-4
# name, B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset,
# LSE cotangent, timed
FLASH_SHAPES = (
    ("a: LM main path", 16, 256, 256, 8, 8, 32, True, None, 0, 0, False, True),
    ("b: flash sweep", 4, 2048, 2048, 8, 8, 64, True, None, 0, 0, False, True),
    ("c: GQA + window", 4, 2048, 2048, 8, 2, 32, True, 256, 0, 0, False,
     False),
    ("d: chunk, offsets", 2, 256, 384, 8, 2, 64, True, None, 384, 256, True,
     False),
)


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_launch_shapes(batch: int) -> list[tuple[str, tuple, tuple]]:
    """``(role, xpad shape, kernel shape)`` of every K1 launch of one
    ResNet-50 training step at ``batch``, in order: the port's model run
    forward and backward on the meta device, with the core's forward
    recorded (it takes the plain version there: nothing is launched)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.models import get_model
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    calls = []
    role = ["fwd"]
    core_forward = conv_mxu._core_forward

    def record(xpad, kernel):
        calls.append((role[0], tuple(xpad.shape), tuple(kernel.shape)))
        return core_forward(xpad, kernel)

    conv_mxu._core_forward = record
    try:
        with torch.device("meta"):
            model = get_model("resnet50", conv_impl="mxu")
            logits = model(torch.empty(batch, 224, 224, 3), train=True)
        role[0] = "dx"
        logits.sum().backward()
    finally:
        conv_mxu._core_forward = core_forward
    return calls


def bound_ms(xshape, kshape) -> tuple[float, str]:
    """Least time the card needs for one K1 call: FLOPs over the bf16
    peak or bytes (inputs read once, output written once) over the memory
    rate, whichever is larger."""
    b, hp, wp, cin = xshape
    kh, kw, _, cout = kshape
    m = b * (hp - kh + 1) * (wp - kw + 1)
    flops = 2.0 * m * kh * kw * cin * cout
    nbytes = 2.0 * (b * hp * wp * cin + kh * kw * cin * cout + m * cout)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_k1(calls, seed: int) -> dict:
    """K1 against its plain version at each distinct launch shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    per_shape = collections.OrderedDict()
    for role, xs, ks in calls:
        per_shape.setdefault((xs, ks), collections.Counter())[role] += 1
    rng = np.random.default_rng(seed)
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    totals = collections.Counter()
    log(f"{'xpad':>22} {'kernel':>18} {'per step':>12} {'k1_ms':>9} "
        f"{'plain_ms':>9} {'cudnn_ms':>9} {'bound_ms':>9} {'bound_by':>10} "
        f"{'TFLOP/s':>8} {'max_abs':>9} {'max_rel':>9}")
    for (xs, ks), roles in per_shape.items():
        fan_in = ks[0] * ks[1] * ks[2]
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).cuda()
        k = torch.from_numpy(rng.standard_normal(ks, dtype=np.float32)
                             / math.sqrt(fan_in)).cuda()
        x, k = x.to(torch.bfloat16), k.to(torch.bfloat16)
        got = conv_mxu.conv_implicit_gemm(x, k)
        torch.cuda.synchronize()
        want = conv_mxu._core_reference(x.float(), k.float())
        err = (got.float() - want).abs()
        scale = float(want.abs().max())
        atol = K1_ATOL_OF_SCALE * scale
        bad = err > atol + K1_RTOL * want.abs()
        max_abs = float(err.max())
        max_rel = max_abs / scale
        if bool(bad.any()):
            fail(f"K1 disagrees with its plain version at x{xs} k{ks}: "
                 f"{int(bad.sum())} elements over atol {atol:.3g} + rtol "
                 f"{K1_RTOL:.3g}; max abs err {max_abs:.4g}")
        del got, want, err, bad
        # cuDNN's own layout: NHWC activations seen as NCHW, the weight
        # stored OHWI (channels_last OIHW), arranged outside the timing.
        x_nchw = x.permute(0, 3, 1, 2)
        w_cl = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        ms = time_ms(lambda: conv_mxu.conv_implicit_gemm(x, k), 20)
        plain_ms = time_ms(lambda: conv_mxu._core_reference(x, k), 5, 1)
        lib_ms = time_ms(lambda: F.conv2d(x_nchw, w_cl), 20)
        bms, bound_by = bound_ms(xs, ks)
        n = sum(roles.values())
        m = xs[0] * (xs[1] - ks[0] + 1) * (xs[2] - ks[1] + 1)
        tflops = 2.0 * m * ks[0] * ks[1] * ks[2] * ks[3] / (ms * 1e9)
        log(f"{str(xs):>22} {str(ks):>18} "
            f"{' '.join(f'{r}x{c}' for r, c in roles.items()):>12} "
            f"{ms:9.4f} {plain_ms:9.4f} {lib_ms:9.4f} {bms:9.4f} "
            f"{bound_by:>10} {tflops:8.1f} {max_abs:9.3g} {max_rel:9.3g}")
        rows.append(dict(xpad=xs, kernel=ks, roles=dict(roles), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=bound_by, max_abs_err=max_abs,
                         max_rel_err=max_rel))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bms)):
            totals[key] += n * val
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        del x, k, x_nchw, w_cl
        torch.cuda.empty_cache()
    # The bound of a step's K1 work is the larger total of the two sides.
    flops = sum(2.0 * xs[0] * (xs[1] - ks[0] + 1) * (xs[2] - ks[1] + 1)
                * ks[0] * ks[1] * ks[2] * ks[3] for _, xs, ks in calls)
    nbytes = sum(2.0 * (math.prod(xs) + math.prod(ks) + xs[0]
                        * (xs[1] - ks[0] + 1) * (xs[2] - ks[1] + 1) * ks[3])
                 for _, xs, ks in calls)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    log(f"K1 per training step ({len(calls)} launches): "
        f"{totals['ms']:.3f} ms; plain {totals['plain_ms']:.3f} ms; "
        f"cuDNN {totals['library_ms']:.3f} ms; bound {1e3 * max(t_ops, t_bytes):.3f} ms "
        f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB); "
        f"K1 at {flops / (totals['ms'] * 1e9):.1f} TFLOP/s; "
        f"worst max abs err {worst_abs:.4g} (rel to scale {worst_rel:.4g})")
    return dict(rows=rows, ms=totals["ms"], plain_ms=totals["plain_ms"],
                library_ms=totals["library_ms"],
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=worst_abs, max_rel_err=worst_rel)


def phase_grads(seed: int) -> None:
    """conv2d_mxu (K1 in bf16) forward, dx and dw against the patches
    lowering in f32 on the same values."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    rng = np.random.default_rng(seed)
    cases = [((32, 28, 28, 128), (3, 3, 128, 128), (1, 1)),
             ((32, 56, 56, 128), (3, 3, 128, 128), (2, 2))]
    for xs, ks, strides in cases:
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32))
        k = torch.from_numpy(rng.standard_normal(ks, dtype=np.float32)
                             / math.sqrt(ks[0] * ks[1] * ks[2]))
        x, k = x.cuda().bfloat16(), k.cuda().bfloat16()
        xb, kb = x.clone().requires_grad_(), k.clone().requires_grad_()
        x32 = x.float().requires_grad_()
        k32 = k.float().requires_grad_()
        before = conv_mxu.conv_implicit_gemm.launches
        y = conv_mxu.conv2d_mxu(xb, kb, strides, "SAME")
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape),
                                                 dtype=np.float32)).cuda()
        y.backward(g.bfloat16())
        y32 = convlib.conv2d_patches(x32, k32, strides, "SAME")
        y32.backward(g.bfloat16().float())
        torch.cuda.synchronize()
        if conv_mxu.conv_implicit_gemm.launches == before:
            fail(f"conv2d_mxu {strides} launched no K1")
        for name, got, want in (("y", y.detach(), y32.detach()),
                                ("dx", xb.grad, x32.grad),
                                ("dw", kb.grad, k32.grad)):
            if got.dtype != torch.bfloat16 or got.shape != want.shape:
                fail(f"conv2d_mxu {strides} {name}: {got.dtype} "
                     f"{tuple(got.shape)} vs {tuple(want.shape)}")
            scale = float(want.abs().max())
            err = float((got.float() - want).abs().max())
            log(f"conv2d_mxu strides {strides} x{xs} k{ks} {name}: max abs "
                f"err {err:.4g}, scale {scale:.4g}, rel {err / scale:.4g} "
                f"(limit {GRAD_TOL_OF_SCALE:.4g})")
            if not math.isfinite(err) or err > GRAD_TOL_OF_SCALE * scale:
                fail(f"conv2d_mxu {strides} {name} disagrees with the "
                     f"patches lowering")


def run_cli(config: str, steps: int, batch: int, workdir: Path,
            *extra: str) -> dict:
    """The port's CLI ``train`` in this process; returns its JSON line."""
    from distributed_tensorflow_models_tpu_torch.harness import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", "--config", config, "--workdir",
                       str(workdir), "--train-steps", str(steps),
                       "--batch-size", str(batch), "--device", "cuda",
                       *extra])
    out = buf.getvalue()
    log(out.rstrip())
    if rc != 0:
        fail(f"cli train exited {rc}")
    result = json.loads(out.strip().splitlines()[-1])
    rows = [json.loads(line) for line in
            (workdir / "metrics.jsonl").read_text().splitlines()]
    if result["steps"] != steps or len(rows) != steps:
        fail(f"trained {result['steps']} steps ({len(rows)} rows), "
             f"asked for {steps}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    result["losses"] = losses
    steady = rows[1:] or rows
    result["data_s"] = sum(r["data_s"] for r in steady) / len(steady)
    times = sorted(r["step_time_s"] for r in steady)
    result["median_step_s"] = times[len(times) // 2]
    result["max_step_s"] = times[-1]
    return result


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "conv_implicit_gemm" in low:
        return "K1"
    for kid, marker in (("K2", "dtm_flash_fwd"), ("K3", "dtm_flash_dkv"),
                        ("K4", "dtm_flash_dq")):
        if marker in low:
            return kid
    # cuDNN's conv kernels are implicit GEMMs too: match them first.
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "cuDNN conv"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "cuBLAS matmul"
    if "reduce" in low:
        return "reductions"
    if any(s in low for s in ("copy", "cat", "pad", "fill", "memset",
                              "memcpy", "index", "slice")):
        return "copies, pads, fills"
    return "elementwise and other"


def phase_profile(cfg, arm: str, steps: int = 2) -> None:
    """Device time of the training step by kernel class, and the device's
    idle share, over ``steps`` steps after one warm-up step (the batches
    are on the card beforehand), with the conv lowering set as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    batch = cfg.global_batch_size
    dev = torch.device("cuda")
    state = trainlib.build_state(cfg, dev)
    step_fn = trainlib.build_step(cfg, state)
    batches = iter(trainlib.build_dataset(cfg))
    on_card = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(batches).items()} for _ in range(steps + 1)]
    state, metrics = step_fn(state, on_card[0], cfg.seed)
    float(metrics["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in on_card[1:]:
            state, metrics = step_fn(state, b, cfg.seed)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched.
    kernels = [(e.device_time_total / 1e3 / steps, e.count // steps, e.key)
               for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU
               and e.device_time_total > 0]
    busy_ms = sum(ms for ms, _, _ in kernels)
    if busy_ms == 0:
        fail(f"profile ({arm}): the profiler saw no device time")
    if not 0.0 <= 1 - busy_ms / wall_ms <= 1.0:
        fail(f"profile ({arm}): device busy {busy_ms:.2f} ms exceeds the "
             f"wall {wall_ms:.2f} ms: kernels are counted more than once")
    classes = collections.Counter()
    for ms, _, name in kernels:
        classes[_kernel_class(name)] += ms
    log(f"profile ({arm}), per step at batch {batch}: wall {wall_ms:.2f} ms "
        f"(profiler on), device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for cls, ms in classes.most_common():
        log(f"  {cls:>22}: {ms:8.2f} ms  {ms / busy_ms:6.1%} of busy")
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms x{count:<4d} {name[:110]}")


def _flash_inputs(shape, seed: int):
    import numpy as np
    import torch

    _, B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, with_glse, _ = shape
    rng = np.random.default_rng(seed)

    def bf16(*dims):
        return torch.from_numpy(rng.standard_normal(
            dims, dtype=np.float32)).cuda().bfloat16()

    q, do = bf16(B, Tq, H, D), bf16(B, Tq, H, D)
    k, v = bf16(B, Tkv, Hkv, D), bf16(B, Tkv, Hkv, D)
    g_lse = bf16(B, Tq, H).float() if with_glse else None
    kw = dict(scale=D ** -0.5, causal=causal, window=window, q_offset=qo,
              kv_offset=ko)
    return q, k, v, do, g_lse, kw


def _flash_work(shape):
    """Valid (query, key) pairs per (batch, head) row, from the mask."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    _, B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, _, _ = shape
    valid = attnlib._valid(Tq, Tkv, causal, window, qo, ko, "cuda")
    pairs = Tq * Tkv if valid is None else int(valid.sum())
    rows = (torch.ones(Tq, dtype=torch.bool, device="cuda") if valid is None
            else valid.any(-1))
    return pairs, rows


def flash_bound_ms(kid: str, shape, pairs: int) -> tuple[float, str]:
    """Least time for one launch: the bytes it must move (each input read
    once, each output written once) over the memory rate, or its
    tensor-core FLOPs on the valid pairs over the bf16 peak.  K2 reads Q,
    K, V and writes O and the f32 LSE, 4*D FLOPs a pair; K3 reads Q, K, V,
    dO, LSE and delta and writes per-query-head dK and dV, 8*D; K4 reads
    the same and writes dQ, 6*D."""
    _, B, Tq, Tkv, H, Hkv, D, *_ = shape
    q_b, kv_b = 2.0 * B * Tq * H * D, 2.0 * B * Tkv * Hkv * D
    rows_b = 4.0 * B * H * Tq
    if kid == "K2":
        nbytes, per_pair = 2 * q_b + 2 * kv_b + rows_b, 4
    elif kid == "K3":
        nbytes = 2 * q_b + 2 * kv_b + 2 * rows_b + 2 * (2.0 * B * Tkv * H * D)
        per_pair = 8
    else:
        nbytes, per_pair = 3 * q_b + 2 * kv_b + 2 * rows_b, 6
    flops = float(per_pair) * D * pairs * B * H
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_err(what: str, got, want) -> float:
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = err > FLASH_ATOL_OF_SCALE * scale + FLASH_RTOL * want.abs()
    max_abs = float(err.max())
    if bool(bad.any()) or not math.isfinite(max_abs):
        fail(f"{what} disagrees with its plain version: {int(bad.sum())} of "
             f"{bad.numel()} elements over atol {FLASH_ATOL_OF_SCALE * scale:.3g}"
             f" + rtol {FLASH_RTOL:.3g}; max abs err {max_abs:.4g}")
    return max_abs


def phase_flash(seed: int) -> dict:
    """K2, K3 and K4 against their plain versions at FLASH_SHAPES; at the
    timed shapes also their times, bounds and the SDPA yardstick.
    Returns, per kernel id, the worst error and the timings by shape."""
    import torch
    import torch.nn.functional as F

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    out = {kid: {"max_abs_err": 0.0, "timed": {}} for kid, _, _ in FLASH_KERNELS}
    for n, shape in enumerate(FLASH_SHAPES):
        name, B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, _, timed = shape
        q, k, v, do, g_lse, kw = _flash_inputs(shape, seed + n)
        pairs, rows = _flash_work(shape)
        o, lse = attnlib.flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_o, ref_lse = attnlib._flash_forward_reference(q, k, v, **kw)
        errs = {"K2": _flash_err(f"K2 out at {name}", o[:, rows],
                                 ref_o[:, rows])}
        lse_err = float((lse - ref_lse)[:, :, rows].abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"K2 lse at {name}: max abs err {lse_err:.4g} > {LSE_ATOL}")
        if not bool(rows.all()):
            fail(f"{name}: every query row needs a valid key here")
        delta = (do.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse
        delta = delta.transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dk, dv = attnlib.flash_dkv(*args, **kw)
        dq = attnlib.flash_dq(*args, **kw)
        torch.cuda.synchronize()
        ref_dk, ref_dv = attnlib._flash_dkv_reference(*args, **kw)
        ref_dq = attnlib._flash_dq_reference(*args, **kw)
        errs["K3"] = max(_flash_err(f"K3 dk at {name}", dk, ref_dk),
                         _flash_err(f"K3 dv at {name}", dv, ref_dv))
        errs["K4"] = _flash_err(f"K4 dq at {name}", dq, ref_dq)
        del ref_o, ref_lse, ref_dk, ref_dv, ref_dq
        log(f"flash {name}: B{B} Tq{Tq} Tkv{Tkv} H{H} Hkv{Hkv} D{D} causal "
            f"{causal} window {window} offsets {qo}/{ko} lse cotangent "
            f"{g_lse is not None}; max abs err K2 {errs['K2']:.4g} (lse "
            f"{lse_err:.3g}), K3 {errs['K3']:.4g}, K4 {errs['K4']:.4g}; "
            f"valid pairs per row {pairs}")
        for kid, err in errs.items():
            out[kid]["max_abs_err"] = max(out[kid]["max_abs_err"], err)
        if not timed:
            continue
        fns = {
            "K2": (lambda: attnlib.flash_forward(q, k, v, **kw),
                   lambda: attnlib._flash_forward_reference(q, k, v, **kw)),
            "K3": (lambda: attnlib.flash_dkv(*args, **kw),
                   lambda: attnlib._flash_dkv_reference(*args, **kw)),
            "K4": (lambda: attnlib.flash_dq(*args, **kw),
                   lambda: attnlib._flash_dq_reference(*args, **kw)),
        }
        # SDPA (the yardstick) on the same values, heads-second views.
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        gs = do.transpose(1, 2)
        lib = {"K2": time_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=causal), 20),
               "K3+K4": time_ms(lambda: torch.autograd.grad(
                   so, (qs, ks, vs), gs, retain_graph=True), 20)}
        for kid, (kern, plain) in fns.items():
            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 3, 1)
            bms, bound_by = flash_bound_ms(kid, shape, pairs)
            out[kid]["timed"][name] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by,
                library_ms=lib["K2"] if kid == "K2" else lib["K3+K4"])
            log(f"  {kid} at {name}: {ms:.4f} ms per launch; plain "
                f"{plain_ms:.4f} ms; bound {bms:.4f} ms ({bound_by}, "
                f"{bms / ms:.1%} of it); SDPA "
                + ("forward" if kid == "K2" else "backward (dQ, dK and dV)")
                + f" {out[kid]['timed'][name]['library_ms']:.4f} ms")
        del qs, ks, vs, so, q, k, v, do, o, lse, dk, dv, dq, args, fns
        torch.cuda.empty_cache()
    return out


def run_lm_arm(impl: str, steps: int, workdir: Path) -> dict:
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    batch = get_config("transformer_lm").global_batch_size
    return run_cli("transformer_lm", steps, batch, workdir / impl,
                   "--attn-impl", impl)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", type=int, default=256,
                        help="global batch of the training phase "
                        "(resnet50_synthetic's own: 256)")
    parser.add_argument("--train-steps", type=int, default=11)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    # conv.py reads the default conv lowering when it is first imported.
    os.environ["DTM_CONV_IMPL"] = "mxu"
    sys.path.insert(0, str(ROOT))
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import _kernels
    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    # f32 comparisons in full f32: no TF32 in cuDNN or cuBLAS.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. Device and build.
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(conv_mxu._load), pool.submit(attnlib._load)]:
            fut.result()
    for kids, src in (("K1", "conv_implicit_gemm.cu"),
                      ("K2-K4", "flash_attention.cu")):
        nvcc_s = _kernels.build_seconds.get(src)
        log(f"{kids} ({src}) build+load: " + (
            "cached build loaded" if nvcc_s is None
            else f"nvcc {nvcc_s:.2f} s"))
    log(f"both builds, in parallel: {time.perf_counter() - t0:.2f} s wall")

    # 2. K1 at the main path's launch shapes.
    calls = k1_launch_shapes(args.batch_size)
    roles = collections.Counter(r for r, _, _ in calls)
    log(f"K1 launches per ResNet-50 step at batch {args.batch_size}: "
        f"{len(calls)} ({dict(roles)})")
    if roles != {"fwd": 25, "dx": 25}:
        fail(f"expected 25 forward and 25 dx launches per step, got {roles}")
    k1 = phase_k1(calls, args.seed)

    # 3. Gradients through conv2d_mxu.
    phase_grads(args.seed + 1)

    # 4. The slice's main path, K1's counter zeroed just before it.
    if convlib.get_default_conv_impl() != "mxu":
        fail("DTM_CONV_IMPL=mxu did not reach the port's conv selector")
    workdir = ROOT / "build" / "chip_smoke"
    torch.cuda.reset_peak_memory_stats()
    conv_mxu.conv_implicit_gemm.launches = 0
    run = run_cli("resnet50_synthetic", args.train_steps, args.batch_size,
                  workdir / "mxu")
    launches = conv_mxu.conv_implicit_gemm.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = len(calls) * args.train_steps
    log(f"K1 launches in the training run: {launches} (expected "
        f"{len(calls)} per step x {args.train_steps} steps = {want})")
    if launches != want:
        fail(f"K1 launched {launches} times, expected {want}")
    log(f"slice (K1 convs): batch {args.batch_size}, steps "
        f"{args.train_steps}, losses {run['losses']}, "
        f"{run['images_per_sec']:.1f} images/s end to end over "
        f"{args.train_steps - 1} steady steps; step (batch copy in to "
        f"metrics back) mean {run['steady_step_time_s'] * 1e3:.2f} ms, "
        f"median {run['median_step_s'] * 1e3:.2f} ms, max "
        f"{run['max_step_s'] * 1e3:.2f} ms; peak memory "
        f"{peak_gib:.2f} GiB, K1 {k1['ms']:.2f} ms of the step | {card}")

    # Yardstick: the same run with every conv through F.conv2d (cuDNN),
    # in turns with the K1 arm (K1, cuDNN, K1, cuDNN): host noise on a
    # shared machine moves step times between runs.
    arms = [("K1", run)]
    for impl in ("xla", "mxu", "xla"):
        convlib.set_default_conv_impl(impl)
        arms.append(("K1" if impl == "mxu" else "F.conv2d",
                     run_cli("resnet50_synthetic", args.train_steps,
                             args.batch_size, workdir / impl)))
    for name, r in arms:
        log(f"arm {name:>8}: {r['images_per_sec']:.1f} images/s end to "
            f"end (steady wall, host batch assembly included); step "
            f"median {r['median_step_s'] * 1e3:.2f} ms, mean "
            f"{r['steady_step_time_s'] * 1e3:.2f} ms, max "
            f"{r['max_step_s'] * 1e3:.2f} ms "
            f"({args.batch_size / r['steady_step_time_s']:.1f} images/s "
            f"for the step alone); host batch assembly "
            f"{r['data_s'] * 1e3:.2f} ms per step, in series | {card}")

    # 5. Where the device time goes, on the main path and the yardstick.
    r50 = get_config("resnet50_synthetic", global_batch_size=args.batch_size)
    for impl, arm in (("mxu", "K1 convs"), ("xla", "F.conv2d convs")):
        convlib.set_default_conv_impl(impl)
        phase_profile(r50, arm)
    convlib.set_default_conv_impl("mxu")

    # 6. K2-K4 against their plain versions, timed against their bounds.
    flash = phase_flash(args.seed + 2)

    # 7. The LM slice's main path, the three flash counters zeroed just
    # before it and read just after.
    lm_cfg = get_config("transformer_lm")
    layers = lm_cfg.model_kwargs["num_layers"]
    torch.cuda.reset_peak_memory_stats()
    for _, name, _ in FLASH_KERNELS:
        getattr(attnlib, name).launches = 0
    lm_run = run_lm_arm("flash", args.train_steps, workdir / "lm")
    flash_launches = {kid: getattr(attnlib, name).launches
                      for kid, name, _ in FLASH_KERNELS}
    lm_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = layers * args.train_steps
    log(f"flash launches in the LM training run: {flash_launches} "
        f"(expected {layers} layers x {args.train_steps} steps = {want} each)")
    if any(n != want for n in flash_launches.values()):
        fail(f"flash kernels launched {flash_launches}, expected {want} each")
    tokens = lm_cfg.global_batch_size * lm_cfg.num_steps
    log(f"LM slice (flash attention, K2-K4): batch {lm_cfg.global_batch_size}"
        f" x {lm_cfg.num_steps} tokens, steps {args.train_steps}, losses "
        f"{lm_run['losses']}; peak memory {lm_peak_gib:.3f} GiB | {card}")

    # 8. Yardstick: blockwise attention in plain PyTorch (the config's
    # default), in turns with the flash arm (flash, auto, flash, auto).
    lm_arms = [("flash", lm_run)]
    for impl in ("auto", "flash", "auto"):
        lm_arms.append((impl, run_lm_arm(impl, args.train_steps,
                                         workdir / f"lm{len(lm_arms)}")))
    for name, r in lm_arms:
        log(f"LM arm {name:>6}: {r['tokens_per_sec']:.0f} tokens/s end to end"
            f" (steady wall, host batch assembly included); step median "
            f"{r['median_step_s'] * 1e3:.3f} ms, mean "
            f"{r['steady_step_time_s'] * 1e3:.3f} ms, max "
            f"{r['max_step_s'] * 1e3:.3f} ms ({tokens / r['steady_step_time_s']:.0f}"
            f" tokens/s for the step alone); host batch assembly "
            f"{r['data_s'] * 1e3:.3f} ms per step, in series | {card}")
    for impl, arm in (("flash", "LM, flash (K2-K4)"),
                      ("auto", "LM, blockwise attention")):
        phase_profile(lm_cfg.replace(attn_impl=impl), arm)

    log(card)
    kernels = [{
        "name": "K1 conv_implicit_gemm",
        "status": "ported",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "scope": f"sum over the {len(calls)} K1 launches of one ResNet-50 "
                 f"training step at batch {args.batch_size}",
    }]
    main_shape, sweep_shape = FLASH_SHAPES[0][0], FLASH_SHAPES[1][0]
    for kid, name, replaces in FLASH_KERNELS:
        at_a = flash[kid]["timed"][main_shape]
        kernels.append({
            "name": f"{kid} {name}",
            "status": "ported",
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": flash_launches[kid],
            "max_abs_err": flash[kid]["max_abs_err"],
            **at_a,
            "scope": "one launch at the LM slice's shape B16 T256 H8 D32 "
                     "causal bf16; max_abs_err over shapes a-d; library: "
                     + ("SDPA forward" if kid == "K2" else
                        "SDPA backward, which computes dQ, dK and dV: "
                        "compare with K3 ms + K4 ms"),
            "at_flash_sweep_shape": flash[kid]["timed"][sweep_shape],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
