#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Every phase fails loudly (exit code 1); none is caught and skipped.

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``csrc/`` (one nvcc per source, both started at
   once): K1 and K6 in ``conv_implicit_gemm.cu``, K2-K5 in
   ``flash_attention.cu``, both on the shared Hopper helpers of
   ``hopper.cuh``; the build seconds and what ``-Xptxas -v`` says of every
   kernel instance (registers, shared memory, spills), K2's instances,
   K3's and K5's, and K4's summarised on lines of their own.
2. K1 and K6 against K1's plain version (``conv_mxu._core_reference``, f32)
   at every launch shape of one ResNet-50 training step at batch 256
   (traced on the meta device, so they are the main path's own, each
   given as the padded input it reads as a window); K6 must equal K1 bit
   for bit.  Prints each shape's N tile and times K1, K6, the plain
   version and ``F.conv2d`` (cuDNN, a yardstick only) with CUDA events
   beside the bound.
3. ``conv2d_mxu`` forward and gradients (dx, dw), stride 1 and 2, against
   the ``patches`` lowering in f32 on the card.
3b. The input pipeline alone (``data/pipeline.py``): ResNet-50 batches at
   the full batch through ``HostPipeline`` (4 workers) and the CUDA
   ``DevicePrefetcher`` (page-locked staging, a copy stream), each read
   back on the card with the consumer's stream kept busy before the read
   and the batch dropped after it, must equal the host stream byte for
   byte; then both stages drained without a step for ResNet-50 and
   Inception-v3 batches at 1 and 4 workers: batches/s, host-to-device
   GB/s, pinned bytes and the waits.  The ImageNet records path is not
   driven: it needs PIL and OpenCV, which the card's machine lacks.  With
   ``--parent-tree DIR`` (another checkout, e.g. the parent commit's from
   ``git archive``) that tree's ``fit`` and this one's train
   ``resnet50_synthetic`` (K1) and ``inception_v3_imagenet`` (K6) in turns
   (parent, this, this, parent), and ``transformer_lm`` (K2-K4) in five
   such rounds, each run a process of its own.
4. The ResNet-50 path: the port's CLI trains ``resnet50_synthetic``
   (224x224, batch 256) with ``DTM_CONV_IMPL=mxu``; K1's counter must equal
   its launches per step times the steps (K6's stays 0).  The ``F.conv2d``
   arm (cuDNN) follows as a yardstick, in turns with a second K1 arm.
5. ``torch.profiler`` over two steps of each ResNet arm: device time by
   kernel class, the copy class split by source (the mxu route's forward
   and dx, its dw windows, the patches lowering's im2col, the branch
   concatenations, dtype casts, other), and the device's idle share.
6. Phase 2 at every launch shape of one ``inception_v3_imagenet`` step at
   batch 256 (the 1x7, 7x1, 1x3, 3x1 taps, the aux head's 5x5, the phase
   kernels of its stride-2 convs and the dx of all of them).
7. The Inception-v3 path: the CLI trains ``inception_v3_imagenet``
   (299x299, batch 256, RMSProp, label smoothing, the 0.4-weighted aux
   head, L2, the weight EMA) with ``DTM_CONV_MXU_PIPELINE=1``: K6's
   counter must equal its launches per step times the steps and K1's must
   stay 0.  The K1 arm (knob 0) follows in turns, then one ``F.conv2d``
   arm; images/s, step times, peak memory and losses of each, and
   profiles of the K6 and K1 arms as in phase 5.
8. K2-K5 (``csrc/flash_attention.cu``) against their plain versions in
   bf16 at (a) the LM path's launch shape B16 T256 H8 D32 causal, (b) the
   flash sweep shape B4 T2048 H8 D64 causal, (c) B4 T2048 H8 Hkv2 D32
   causal window 256, (d) a chunk call with nonzero q/kv offsets and an
   LSE cotangent, and (e) B4 T2048 H8 D128 causal.  K5's dS stage is
   filled with NaN first; its dK and dV must equal K3's bit for bit, and
   its dQ K4's (the count of elements that differ and the largest
   difference are printed).  At (a), (b), (c) and (e) each launch is
   timed against its bound and its plain version, K2 against
   ``F.scaled_dot_product_attention``'s forward and the backward launches
   against its backward (a yardstick only: the port never calls it; with
   ``enable_gqa`` and an explicit window mask at (c)); at each, the host
   time to encode K2's three TMA tensor maps, and every kernel's and both
   SDPA directions' time with the host's launch cost taken out (launches
   replayed in a CUDA graph; SDPA's backward as a fresh forward and
   backward less the fresh forward).  With ``--parent-csrc DIR`` (another
   tree's ``csrc/``, e.g. the parent commit's from ``git archive``) that
   tree's K2-K5 are built too, its K5 dQ is counted against its K4, and
   its kernels are replayed in turns with this tree's (parent, this,
   this, parent).  ``--flash-only`` runs phases 1 and 8 alone.
9. The transformer_lm path: the CLI trains ``transformer_lm`` (4 layers, 8
   heads, d_model 256, sequence 256, batch 16) with ``--attn-impl
   flash``; K2, K3 and K4 must each launch 4 layers x steps times.  The
   blockwise arm (``auto``) follows as a yardstick, in turns with a second
   flash arm (the same counts; the blockwise arms launch none); a profile
   of each.
10. The transformer_lm_modern path: the same width with rotary positions,
   GQA (2 KV heads for 8) and a 256-token window, ``DTM_FLASH_BWD=staged``:
   K2 and both K5 launches must each equal layers x steps, K3 and K4 0.
   The pair backward follows in turns; tokens/s and peak memory of each,
   and a profile of the staged arm.

Every training arm reads its batches through ``fit``'s pipeline
(``HostPipeline``, one worker, then the CUDA ``DevicePrefetcher``) and
prints its median and mean wait for input (``data_s``) beside its images/s
or tokens/s.  Every comparison of arms runs them in turns (K1, F.conv2d,
K1, F.conv2d for ResNet-50; flash, blockwise, flash, blockwise for
transformer_lm):
host noise on a shared machine moves step times between runs.  The last
lines are the card's name and power limit, a ``{"kernels": ...}`` JSON line (K1
to K6, K5 as its two launches) and ``{"ok": true, "device": {...}}``.
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
import re
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
K6_REPLACES = "distributed_tensorflow_models_tpu/ops/conv_mxu.py:204"
FLASH_SOURCE = "distributed_tensorflow_models_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = (
    # id, its wrapper in ops/attention.py, the TPU kernel it replaces
    ("K2", "flash_forward", "distributed_tensorflow_models_tpu/ops/attention.py:578"),
    ("K3", "flash_dkv", "distributed_tensorflow_models_tpu/ops/attention.py:799"),
    ("K4", "flash_dq", "distributed_tensorflow_models_tpu/ops/attention.py:916"),
)
# K5's two launches: _flash_dkv_kernel(stage_ds=True) and
# _flash_dq_staged_kernel.
STAGED_KERNELS = (
    ("K5 dKV", "flash_dkv_staged",
     "distributed_tensorflow_models_tpu/ops/attention.py:799"),
    ("K5 dQ", "flash_dq_staged",
     "distributed_tensorflow_models_tpu/ops/attention.py:877"),
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
# The input pipeline phase: batches read back and held to their host
# batches; batches drained per arm after the warm-up ones (enough of those
# to empty what both stages buffer and hold in flight at 4 workers, about
# 12 batches, so the timed window is the steady rate); and the spin that
# keeps the consumer's stream busy before each read (~20 ms at the H100's
# ~1.7 GHz).
PIPE_CHECK_BATCHES = 6
PIPE_WARM_BATCHES = 15
PIPE_DRAIN_BATCHES = 20
PIPE_SLEEP_CYCLES = 34_000_000
# name, B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset,
# LSE cotangent, timed
FLASH_SHAPES = (
    ("a: LM main path", 16, 256, 256, 8, 8, 32, True, None, 0, 0, False, True),
    ("b: flash sweep", 4, 2048, 2048, 8, 8, 64, True, None, 0, 0, False, True),
    ("c: GQA + window", 4, 2048, 2048, 8, 2, 32, True, 256, 0, 0, False,
     True),
    ("d: chunk, offsets", 2, 256, 384, 8, 2, 64, True, None, 384, 256, True,
     False),
    ("e: D128 sweep", 4, 2048, 2048, 8, 8, 128, True, None, 0, 0, False,
     True),
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


def core_launch_shapes(model_name: str, image_size: int, batch: int,
                       **model_kw) -> list[tuple[str, tuple, tuple]]:
    """``(role, xpad shape, kernel shape)`` of every launch of the conv
    core (K1, or K6 with ``DTM_CONV_MXU_PIPELINE=1``) in one training step
    of ``model_name`` at ``batch``, in order: the port's model run forward
    and backward on the meta device, with the core's forward recorded (it
    takes the plain version there: nothing is launched)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.models import get_model
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    calls = []
    role = ["fwd"]
    core_window = conv_mxu._core_window

    def record(x, kernel, win, out=None):
        # The window's padded extent: the core's input as the padded route
        # materialised it.
        kh, kw, cin, _ = kernel.shape
        oh, ow = win[4], win[5]
        calls.append((role[0], (x.shape[0], oh + kh - 1, ow + kw - 1, cin),
                      tuple(kernel.shape)))
        return core_window(x, kernel, win, out)

    conv_mxu._core_window = record
    try:
        with torch.device("meta"):
            model = get_model(model_name, conv_impl="mxu", **model_kw)
            out = model(torch.empty(batch, image_size, image_size, 3),
                        train=True)
        role[0] = "dx"
        outs = out if isinstance(out, tuple) else (out,)
        sum(o.sum() for o in outs).backward()
    finally:
        conv_mxu._core_window = core_window
    return calls


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instance of an ``nvcc -Xptxas -v`` log (its
    mangled name, registers, shared memory, stack and spills), and every
    warning line as it is."""
    out, name = [], None
    for line in log.splitlines():
        if "warning" in line.lower():
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            # Drop the anonymous namespace's mangled prefix.
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                          name)[:72]
            props = []
        elif name and ("spill" in line or "Used" in line):
            props.append(line.split(":", 1)[-1].strip())
            if "Used" in line:
                out.append(f"{name}: " + "; ".join(props))
                name = None
    return out


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
    """K1 against its plain version at each distinct launch shape, and K6,
    which must equal K1 bit for bit, timed beside it.  Per-step totals
    weight each shape by its launches per step."""
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
    log(f"{'xpad':>22} {'kernel':>18} {'per step':>12} {'tile':>8} "
        f"{'k1_ms':>9} {'k6_ms':>9} "
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
        got6 = conv_mxu.conv_implicit_gemm_pipelined(x, k)
        torch.cuda.synchronize()
        if not torch.equal(got6, got):
            fail(f"K6 differs from K1 at x{xs} k{ks}: "
                 f"{int((got6 != got).sum())} elements")
        del got6
        del got, want, err, bad
        # cuDNN's own layout: NHWC activations seen as NCHW, the weight
        # stored OHWI (channels_last OIHW), arranged outside the timing.
        x_nchw = x.permute(0, 3, 1, 2)
        w_cl = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        ms = time_ms(lambda: conv_mxu.conv_implicit_gemm(x, k), 20)
        k6_ms = time_ms(lambda: conv_mxu.conv_implicit_gemm_pipelined(x, k),
                        20)
        plain_ms = time_ms(lambda: conv_mxu._core_reference(x, k), 5, 1)
        lib_ms = time_ms(lambda: F.conv2d(x_nchw, w_cl), 20)
        bms, bound_by = bound_ms(xs, ks)
        n = sum(roles.values())
        m = xs[0] * (xs[1] - ks[0] + 1) * (xs[2] - ks[1] + 1)
        tile = conv_mxu.tile_n(ks[3], m)
        tflops = 2.0 * m * ks[0] * ks[1] * ks[2] * ks[3] / (ms * 1e9)
        log(f"{str(xs):>22} {str(ks):>18} "
            f"{' '.join(f'{r}x{c}' for r, c in roles.items()):>12} "
            f"{f'128x{tile}':>8} {ms:9.4f} {k6_ms:9.4f} "
            + f"{plain_ms:9.4f} {lib_ms:9.4f} {bms:9.4f} "
            f"{bound_by:>10} {tflops:8.1f} {max_abs:9.3g} {max_rel:9.3g}")
        rows.append(dict(xpad=xs, kernel=ks, roles=dict(roles), tile_n=tile,
                         ms=ms,
                         k6_ms=k6_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bms, bound_by=bound_by, max_abs_err=max_abs,
                         max_rel_err=max_rel))
        for key, val in (("ms", ms), ("k6_ms", k6_ms), ("plain_ms", plain_ms),
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
        f"{totals['ms']:.3f} ms; "
        + f"K6 {totals['k6_ms']:.3f} ms (K6 = K1 bit for bit at every "
        f"shape); "
        + f"plain {totals['plain_ms']:.3f} ms; "
        f"cuDNN {totals['library_ms']:.3f} ms; bound {1e3 * max(t_ops, t_bytes):.3f} ms "
        f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB); "
        f"K1 at {flops / (totals['ms'] * 1e9):.1f} TFLOP/s; "
        f"worst max abs err {worst_abs:.4g} (rel to scale {worst_rel:.4g})")
    return dict(rows=rows, ms=totals["ms"], k6_ms=totals["k6_ms"],
                plain_ms=totals["plain_ms"],
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


def phase_pipeline(card: str, batch: int, seed: int) -> dict:
    """The input pipeline alone: the CUDA prefetcher's batches held to the
    host stream byte for byte at the full ResNet-50 batch, then both
    stages drained without a step for ResNet-50 and Inception-v3 batches
    at 1 and 4 workers."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch import telemetry
    from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    def stack(cfg, workers, registry):
        host = pipelib.HostPipeline(trainlib.build_dataset(cfg), prefetch=4,
                                    num_workers=workers, registry=registry)
        return host, pipelib.DevicePrefetcher(host, "cuda", depth=2,
                                              registry=registry)

    # Byte equality with the consumer's stream kept busy before each read
    # and each batch dropped right after it: a missing wait_event or
    # record_stream shows as a batch that differs from the host's.
    r50 = get_config("resnet50_synthetic", global_batch_size=batch,
                     seed=seed)
    host, pf = stack(r50, 4, telemetry.MetricsRegistry())
    reads = []
    try:
        for _ in range(PIPE_CHECK_BATCHES):
            torch.cuda._sleep(PIPE_SLEEP_CYCLES)
            got = next(pf)
            reads.append({k: v * 1 for k, v in got.items()})
            del got
    finally:
        pf.stop()
        host.stop()
    torch.cuda.synchronize()
    ref = iter(trainlib.build_dataset(r50))
    for i, got in enumerate(reads):
        want = next(ref)
        for k, v in want.items():
            if not np.array_equal(got[k].cpu().numpy(), v):
                fail(f"prefetched ResNet-50 batch {i} ({k}) differs from "
                     f"the host stream")
    shapes = {k: tuple(v.shape) for k, v in reads[0].items()}
    log(f"pipeline: {len(reads)} ResNet-50 batches {shapes} through "
        f"HostPipeline(4 workers) and the CUDA DevicePrefetcher equal the "
        f"host stream byte for byte, the consumer's stream busy before each "
        f"read and each batch dropped after it")
    del reads

    arms = []
    inc = get_config("inception_v3_imagenet", global_batch_size=batch,
                     seed=seed)
    for name, cfg in (("ResNet-50", r50), ("Inception-v3", inc)):
        for workers in (1, 4):
            reg = telemetry.MetricsRegistry()
            host, pf = stack(cfg, workers, reg)
            try:
                for _ in range(PIPE_WARM_BATCHES):
                    nbytes = sum(v.nbytes for v in next(pf).values())
                torch.cuda.synchronize()
                waits = []
                t0 = time.perf_counter()
                for _ in range(PIPE_DRAIN_BATCHES):
                    t = time.perf_counter()
                    next(pf)
                    waits.append(time.perf_counter() - t)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                pinned = pf.pinned_bytes
            finally:
                pf.stop()
                host.stop()
            snap = reg.snapshot()
            waits.sort()
            arm = {
                "batches": name, "workers": workers, "batch_bytes": nbytes,
                "batches_per_s": PIPE_DRAIN_BATCHES / wall,
                "h2d_gb_per_s": PIPE_DRAIN_BATCHES * nbytes / wall / 1e9,
                "pinned_bytes": pinned,
                "next_wait_median_ms": 1e3 * waits[len(waits) // 2],
                "prefetch_fill_p50_ms":
                    1e3 * snap[f"{telemetry.PREFETCH_FILL}/p50_s"],
            }
            arms.append(arm)
            log(f"pipeline drained, {name} batches ({nbytes / 1e6:.1f} MB), "
                f"{workers} worker(s): {arm['batches_per_s']:.2f} batches/s, "
                f"{arm['h2d_gb_per_s']:.2f} GB/s host to device, pinned "
                f"{pinned / 2**20:.1f} MiB, wait in next() median "
                f"{arm['next_wait_median_ms']:.2f} ms, fill thread's wait "
                f"on the host stage p50 {arm['prefetch_fill_p50_ms']:.2f} ms "
                f"| {card}")
    log(json.dumps({"pipeline": arms}))
    return {"arms": arms}


# --parent-tree: config, DTM_CONV_MXU_PIPELINE, extra CLI flags, rounds of
# (parent, this, this, parent).  The LM's host-bound rate spreads by up to a
# third between runs of one tree, so it takes five rounds (ten pairs).
TREE_AB_ARMS = (
    ("resnet50_synthetic", "0", ("--batch-size", "{batch}"), 1),
    ("inception_v3_imagenet", "1", ("--batch-size", "{batch}"), 1),
    ("transformer_lm", "0", ("--attn-impl", "flash"), 5),
)


def phase_tree_ab(parent: Path, steps: int, batch: int, card: str) -> None:
    """``fit`` of another tree (``parent``) and of this one in turns
    (parent, this, this, parent), each through its CLI in a process of its
    own, for each arm of ``TREE_AB_ARMS``: the same steps, the CNNs at
    ``batch``.  Prints each run's end-to-end rate and its median wait for
    input and step time, and per arm each tree's median rate."""
    for config, knob, extra, rounds in TREE_AB_ARMS:
        extra = [a.format(batch=batch) for a in extra]
        rates = {"parent": [], "this": []}
        order = (("parent", parent), ("this", ROOT), ("this", ROOT),
                 ("parent", parent)) * rounds
        for n, (label, tree) in enumerate(order):
            workdir = ROOT / "build" / "chip_smoke" / f"ab_{config}_{n}"
            env = {**os.environ, "PYTHONPATH": str(tree),
                   "DTM_CONV_IMPL": "mxu", "DTM_CONV_MXU_PIPELINE": knob,
                   "DTM_FLASH_BWD": "pair"}
            out = subprocess.run(
                [sys.executable, "-m",
                 "distributed_tensorflow_models_tpu_torch.harness.cli",
                 "train", "--config", config, "--workdir", str(workdir),
                 "--train-steps", str(steps), "--device", "cuda", *extra],
                cwd=tree, env=env, capture_output=True, text=True,
                timeout=900)
            if out.returncode != 0:
                fail(f"{label} tree's {config} run exited {out.returncode}: "
                     f"{out.stderr[-2000:]}")
            result = json.loads(out.stdout.strip().splitlines()[-1])
            steady = [json.loads(line) for line in
                      (workdir / "metrics.jsonl").read_text().splitlines()][1:]

            def median(key):
                return sorted(r[key] for r in steady)[len(steady) // 2]

            unit = "tokens/s" if result.get("tokens_per_sec") else "images/s"
            rate = result["tokens_per_sec" if unit == "tokens/s"
                          else "images_per_sec"]
            rates[label].append(rate)
            log(f"trees in turns, {config} ({label}, {tree}): {rate:.1f} "
                f"{unit} end to end; wait for input (data_s) median "
                f"{median('data_s') * 1e3:.3f} ms; step_time_s median "
                f"{median('step_time_s') * 1e3:.3f} ms | {card}")
        med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
        log(f"trees in turns, {config}: {len(order)} runs, median {unit} "
            f"parent {med['parent']:.1f}, this {med['this']:.1f}; every run "
            f"of this above every parent run: "
            f"{min(rates['this']) > max(rates['parent'])}, below: "
            f"{max(rates['this']) < min(rates['parent'])} | {card}")


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
    waits = sorted(r["data_s"] for r in steady)
    result["data_s"] = sum(waits) / len(waits)
    result["median_data_s"] = waits[len(waits) // 2]
    times = sorted(r["step_time_s"] for r in steady)
    result["median_step_s"] = times[len(times) // 2]
    result["max_step_s"] = times[-1]
    return result


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host's launch cost taken out:
    ``iters`` calls captured in a CUDA graph, the graph replayed
    ``replays`` times between CUDA events.  (Events over back-to-back
    eager calls time the host once it is slower than the card; at the LM
    shape it is.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "conv_implicit_gemm_pipelined" in low:
        return "K6"
    if "conv_implicit_gemm" in low:
        return "K1"
    if "dtm_flash_dkv" in low and "true" in low:
        return "K5 dKV"
    for kid, marker in (("K5 dQ", "dtm_flash_dq_staged"),
                        ("K2", "dtm_flash_fwd"), ("K3", "dtm_flash_dkv"),
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
        return COPY_CLASS
    return "elementwise and other"


COPY_CLASS = "copies, pads, fills"


@contextlib.contextmanager
def copy_sources():
    """Marks the port's functions whose copies the profile tells apart with
    ``record_function`` ranges ``src:<source>``: the mxu route's forward
    and dx (which copy weight slices only: the core's inputs are windows
    the kernels read), its dw window dots and the patches lowering's
    im2col (the 1x1 and low-Cin convs)."""
    from torch.profiler import record_function

    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    saved = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def marked(*a, **kw):
            with record_function(f"src:{label}"):
                return fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, marked)

    wrap(conv_mxu, "_forward", "mxu forward: core inputs, phase sums")
    wrap(conv_mxu, "_dx", "mxu dx: core inputs, dx buffer")
    wrap(conv_mxu, "_dw", "mxu dw windows")
    wrap(convlib, "conv2d_patches", "patches im2col")
    wrap(conv_mxu, "conv2d_patches", "patches im2col")
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def copy_split(prof, steps: int) -> collections.Counter:
    """Device ms per step of the copy class by source: the innermost
    ``src:`` range around the op that launched the kernel, else
    ``torch.cat`` outside them (the branch concatenations), else a dtype
    cast (``aten::_to_copy``), else other (pools' pads, zero fills,
    autograd's accumulations)."""
    split = collections.Counter()
    for e in prof.events():
        for k in getattr(e, "kernels", None) or ():
            if _kernel_class(k.name) != COPY_CLASS:
                continue
            src, seen, cur = None, set(), e
            while cur is not None:
                if cur.name.startswith("src:"):
                    src = cur.name[4:]
                    break
                seen.add(cur.name)
                cur = cur.cpu_parent
            key = src or ("branch concatenations" if "aten::cat" in seen
                          else "dtype casts" if "aten::_to_copy" in seen
                          else "other")
            split[key] += k.duration / 1e3 / steps
    return split


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
    with copy_sources(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in on_card[1:]:
            state, metrics = step_fn(state, b, cfg.seed)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched.
    # (The src: ranges show on the device timeline as annotations, not
    # kernels.)
    kernels = [(e.device_time_total / 1e3 / steps, e.count // steps, e.key)
               for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU
               and e.device_time_total > 0 and not e.key.startswith("src:")]
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
    split = copy_split(prof, steps)
    log(f"  {COPY_CLASS} by source ({sum(split.values()):.2f} ms of "
        f"{classes[COPY_CLASS]:.2f} attributed):")
    for src, ms in split.most_common():
        log(f"    {src:>40}: {ms:8.2f} ms")
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
    the same and writes dQ, 6*D.  K5's dKV launch is K3 plus the bf16 dS
    of every valid pair written; its dQ launch reads those dS and K and
    writes dQ, 2*D a pair."""
    _, B, Tq, Tkv, H, Hkv, D, *_ = shape
    q_b, kv_b = 2.0 * B * Tq * H * D, 2.0 * B * Tkv * Hkv * D
    rows_b = 4.0 * B * H * Tq
    ds_b = 2.0 * B * H * pairs
    if kid == "K2":
        nbytes, per_pair = 2 * q_b + 2 * kv_b + rows_b, 4
    elif kid in ("K3", "K5 dKV"):
        nbytes = 2 * q_b + 2 * kv_b + 2 * rows_b + 2 * (2.0 * B * Tkv * H * D)
        per_pair = 8
        if kid == "K5 dKV":
            nbytes += ds_b
    elif kid == "K5 dQ":
        nbytes, per_pair = ds_b + kv_b + q_b, 2
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


@contextlib.contextmanager
def flash_lib(lib):
    """The flash wrappers launch ``lib``'s kernels inside the block (none:
    this tree's own)."""
    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    if lib is None:
        yield
        return
    own = attnlib._load()
    attnlib._lib = lib
    try:
        yield
    finally:
        attnlib._lib = own


def _staged(args, kw):
    """K5's two launches with the current flash library, the dKV launch
    writing into a stage filled with NaN first: ``(dk, dv, stage, dq)``."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    q, k = args[:2]
    stage = torch.full((q.shape[0] * q.shape[2], q.shape[1], k.shape[1]),
                       float("nan"), dtype=torch.bfloat16, device="cuda")
    sdk, sdv, stage = attnlib.flash_dkv_staged(*args, **kw, ds=stage)
    sdq = attnlib.flash_dq_staged(stage, k, **kw)
    torch.cuda.synchronize()
    return sdk, sdv, stage, sdq


def phase_flash(seed: int, parent=None) -> dict:
    """K2 to K5 against their plain versions at FLASH_SHAPES; at the timed
    shapes also their times (CUDA events over back-to-back launches, and
    the kernel alone by CUDA-graph replay), bounds and the SDPA yardstick
    (its forward, and its backward by graph replay of a fresh forward and
    backward less the forward's own graph time).  K5's dKV launch writes
    into a dS stage filled with NaN first, so a tile its dQ launch reads
    but the dKV launch never wrote shows as NaN in dQ; its dK and dV must
    equal K3's bit for bit, and its dQ K4's (element by element, the count
    that differ printed).  With ``parent`` (another tree's flash library)
    the same count is taken, and only printed, with that tree's K4 and K5,
    and its K2-K5 are replayed in turns with this tree's (parent, this,
    this, parent).  Returns, per kernel id, the worst error and the
    timings by shape, and K5's dQ differences from K4 by shape (this
    tree's, and the parent's)."""
    import torch
    import torch.nn.functional as F

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    out = {kid: {"max_abs_err": 0.0, "timed": {}}
           for kid, _, _ in FLASH_KERNELS + STAGED_KERNELS}
    out["dq_vs_k4"] = {}
    out["dq_vs_k4_parent"] = {}
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
        sdk, sdv, stage, sdq = _staged(args, kw)
        if not (torch.equal(sdk, dk) and torch.equal(sdv, dv)):
            fail(f"K5 dK/dV at {name} differ from K3's")
        if bool(torch.isnan(sdq).any()):
            fail(f"K5 dq at {name} holds NaN: its dQ launch read a dS tile "
                 f"the dKV launch did not write")
        ref_sdk, ref_sdv, ref_ds = attnlib._flash_dkv_staged_reference(
            *args, **kw)
        ref_sdq = attnlib._flash_dq_staged_reference(ref_ds, k, **kw)
        errs["K5 dKV"] = max(_flash_err(f"K5 dk at {name}", sdk, ref_sdk),
                             _flash_err(f"K5 dv at {name}", sdv, ref_sdv))
        errs["K5 dQ"] = _flash_err(f"K5 dq at {name}", sdq, ref_sdq)
        n_diff = int((sdq != dq).sum())
        max_diff = float((sdq.float() - dq.float()).abs().max())
        out["dq_vs_k4"][name] = dict(differing=n_diff, of=sdq.numel(),
                                     max_abs_diff=max_diff)
        del ref_sdk, ref_sdv, ref_sdq, sdk, sdv
        log(f"K5 at {name}: dK and dV equal K3's bit for bit; dq differs "
            f"from K4's in {n_diff} of {sdq.numel()} elements, max abs diff "
            f"{max_diff:.4g}; no NaN from the NaN-filled stage")
        if n_diff:
            fail(f"K5 dq at {name} differs from K4's: the pair and staged "
                 f"backwards must give the same dQ")
        if parent is not None:
            with flash_lib(parent):
                psdq = _staged(args, kw)[3]
                pdq = attnlib.flash_dq(*args, **kw)
            p_diff = int((psdq != pdq).sum())
            out["dq_vs_k4_parent"][name] = dict(
                differing=p_diff, of=psdq.numel(),
                max_abs_diff=float((psdq.float() - pdq.float()).abs().max()))
            log(f"  parent tree at {name}: its K5 dq differs from its K4's in "
                f"{p_diff} of {psdq.numel()} elements (this tree: {n_diff})")
            del psdq, pdq
        log(f"flash {name}: B{B} Tq{Tq} Tkv{Tkv} H{H} Hkv{Hkv} D{D} causal "
            f"{causal} window {window} offsets {qo}/{ko} lse cotangent "
            f"{g_lse is not None}; max abs err K2 {errs['K2']:.4g} (lse "
            f"{lse_err:.3g}), K3 {errs['K3']:.4g}, K4 {errs['K4']:.4g}, K5 "
            f"dKV {errs['K5 dKV']:.4g}, K5 dQ {errs['K5 dQ']:.4g}; valid "
            f"pairs per (batch, head) {pairs}")
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
            "K5 dKV": (lambda: attnlib.flash_dkv_staged(*args, **kw,
                                                        ds=stage),
                       lambda: attnlib._flash_dkv_staged_reference(*args,
                                                                   **kw)),
            "K5 dQ": (lambda: attnlib.flash_dq_staged(stage, k, **kw),
                      lambda: attnlib._flash_dq_staged_reference(ref_ds, k,
                                                                 **kw)),
        }
        # SDPA (the yardstick) on the same values, heads-second views; with
        # GQA or a window, enable_gqa and the explicit mask.
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        if window is None and Hkv == H and qo == ko:
            sdpa_kw = dict(is_causal=causal)
        else:
            sdpa_kw = dict(attn_mask=attnlib._valid(Tq, Tkv, causal, window,
                                                    qo, ko, "cuda"),
                           enable_gqa=Hkv != H)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)

        so = sdpa()
        gs = do.transpose(1, 2)
        lib = {"K2": time_ms(sdpa, 20),
               "K3+K4": time_ms(lambda: torch.autograd.grad(
                   so, (qs, ks, vs), gs, retain_graph=True), 20)}
        # Device times by graph replay: SDPA's forward, and its backward as
        # a fresh forward and backward captured together, less that fresh
        # forward.  The fresh forward runs on copies of the inputs made in
        # the graph (leaves whose autograd nodes live on the capture
        # stream; the copies cost the same in both graphs).
        lib_dev = {"K2": graph_ms(sdpa)}

        def fresh_forward():
            ins = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]
            return ins, F.scaled_dot_product_attention(*ins, **sdpa_kw)

        def fresh_backward():
            ins, so_fresh = fresh_forward()
            torch.autograd.grad(so_fresh, ins, gs)

        lib_dev["K3+K4"] = graph_ms(fresh_backward) - graph_ms(fresh_forward)
        log(f"  SDPA at {name} by graph replay: forward {lib_dev['K2']:.4f} "
            f"ms, backward (dQ, dK and dV) {lib_dev['K3+K4']:.4f} ms "
            f"(events from Python: {lib['K2']:.4f}, {lib['K3+K4']:.4f})")
        encode_us = 1e6 * attnlib.flash_forward_encode_seconds(q, k, v)
        log(f"  K2 at {name}: its three TMA tensor maps take {encode_us:.2f} "
            f"us of host time to encode, each launch")
        for kid, (kern, plain) in fns.items():
            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 3, 1)
            bms, bound_by = flash_bound_ms(kid, shape, pairs)
            lk = "K2" if kid == "K2" else "K3+K4"
            # This tree's kernel alone, and the parent's in turns with it.
            if parent is None:
                dev_ms = graph_ms(kern)
                parent_ms = None
            else:
                runs = []
                for which in (parent, None, None, parent):
                    with flash_lib(which):
                        runs.append(graph_ms(kern))
                dev_ms = (runs[1] + runs[2]) / 2
                parent_ms = (runs[0] + runs[3]) / 2
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=bound_by, device_ms=dev_ms,
                       library_ms=lib[lk] if kid == "K2" else lib_dev[lk],
                       library_device_ms=lib_dev[lk],
                       library_events_ms=lib[lk])
            if parent_ms is not None:
                rec["parent_device_ms"] = parent_ms
                rec["parent_device_runs_ms"] = [runs[0], runs[3]]
                rec["device_runs_ms"] = [runs[1], runs[2]]
            if kid == "K2":
                rec["map_encode_us"] = encode_us
            out[kid]["timed"][name] = rec
            log(f"  {kid} at {name}: {ms:.4f} ms per launch (events), "
                f"{dev_ms:.4f} ms alone (graph replay, {bms / dev_ms:.1%} of "
                f"the bound)"
                + ("" if parent_ms is None else
                   f", the parent tree's {parent_ms:.4f} ms in turns "
                   f"({runs[0]:.4f} {runs[1]:.4f} {runs[2]:.4f} "
                   f"{runs[3]:.4f})")
                + f"; plain {plain_ms:.4f} ms; bound {bms:.4f} ms "
                f"({bound_by}); SDPA "
                + ("forward" if kid == "K2" else "backward (dQ, dK and dV)")
                + f" {lib_dev[lk]:.4f} ms alone, {lib[lk]:.4f} ms events")
        del qs, ks, vs, so, sdpa_kw, q, k, v, do, o, lse, dk, dv, dq, args
        del fns
        del stage, ref_ds, sdq
        torch.cuda.empty_cache()
    return out


def run_lm_arm(config: str, impl: str, steps: int, workdir: Path) -> dict:
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    batch = get_config(config).global_batch_size
    return run_cli(config, steps, batch, workdir, "--attn-impl", impl)


def log_arm(label: str, r: dict, per_step: int, card: str) -> None:
    """One arm's end-to-end rate, step times and wait for input; ``per_step``
    is the images (or tokens, for an LM) of one step."""
    unit = "tokens" if r.get("tokens_per_sec") else "images"
    rate = r["tokens_per_sec"] if unit == "tokens" else r["images_per_sec"]
    log(f"arm {label:>18}: {rate:.1f} {unit}/s end to end (steady wall, "
        f"the wait for input included); wait for input (data_s) median "
        f"{r['median_data_s'] * 1e3:.3f} ms, mean {r['data_s'] * 1e3:.3f} ms "
        f"a step; step median {r['median_step_s'] * 1e3:.3f} ms, mean "
        f"{r['steady_step_time_s'] * 1e3:.3f} ms, max "
        f"{r['max_step_s'] * 1e3:.3f} ms "
        f"({per_step / r['steady_step_time_s']:.1f} {unit}/s for the step "
        f"alone) | {card}")


def zero_counts(fns) -> None:
    for fn in fns:
        fn.launches = 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", type=int, default=256,
                        help="global batch of the ResNet-50 and Inception-v3 "
                        "phases (their configs' own: 256)")
    parser.add_argument("--train-steps", type=int, default=11)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent-csrc", type=Path, default=None,
                        help="a csrc/ directory of another tree (say the "
                        "parent commit's, unpacked by git archive): phase 8 "
                        "also runs its flash kernels, K5 dQ's differences "
                        "from its K4 and its K2-K5 replayed in turns with "
                        "this tree's")
    parser.add_argument("--parent-tree", type=Path, default=None,
                        help="another checkout of the repository (say the "
                        "parent commit's, unpacked by git archive): phase 3b "
                        "also trains resnet50_synthetic, "
                        "inception_v3_imagenet and transformer_lm through "
                        "its CLI and this tree's in turns, each in a "
                        "process of its own")
    parser.add_argument("--flash-only", action="store_true",
                        help="phases 1 and 8 alone, for work on K2-K5: no "
                        "main path and no result line")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    # conv.py reads the default conv lowering when it is first imported.
    os.environ["DTM_CONV_IMPL"] = "mxu"
    os.environ["DTM_CONV_MXU_PIPELINE"] = "0"
    os.environ["DTM_FLASH_BWD"] = "pair"
    sys.path.insert(0, str(ROOT))
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import _kernels
    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    # f32 comparisons in full f32: no TF32 in cuDNN or cuBLAS.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    steps = args.train_steps
    k1, k6 = conv_mxu.conv_implicit_gemm, conv_mxu.conv_implicit_gemm_pipelined
    flash_fns = {kid: getattr(attnlib, name)
                 for kid, name, _ in FLASH_KERNELS + STAGED_KERNELS}

    # 1. Device and build.
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    parent = None
    builds = [("K1, K6", "conv_implicit_gemm.cu"),
              ("K2-K5", "flash_attention.cu")]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(conv_mxu._load), pool.submit(attnlib._load)]
        if args.parent_csrc is not None:
            csrc = args.parent_csrc.resolve()
            futs.append(pool.submit(_kernels.load, "flash_attention.cu",
                                    csrc))
            builds.append(("the parent tree's K2-K5",
                           str(csrc / "flash_attention.cu")))
        for fut in futs:
            fut.result()
        if args.parent_csrc is not None:
            parent = attnlib.typed(futs[-1].result())
    for kids, src in builds:
        nvcc_s = _kernels.build_seconds.get(src)
        log(f"{kids} ({src}) build+load: " + (
            "cached build loaded" if nvcc_s is None
            else f"nvcc {nvcc_s:.2f} s"))
        for line in ptxas_summary(_kernels.build_logs.get(src, "")):
            log(f"  ptxas {line}")
    k2_lines = [line for line in ptxas_summary(
        _kernels.build_logs.get("flash_attention.cu", ""))
        if "dtm_flash_fwd_kernel" in line]
    log(f"K2 instances (D 32, 64, 128): {len(k2_lines)} in this build" + (
        "" if k2_lines else " (a cached build: no ptxas output)"))
    for line in k2_lines:
        log(f"  K2 ptxas {line}")
    bwd_lines = [line for line in ptxas_summary(
        _kernels.build_logs.get("flash_attention.cu", ""))
        if "dtm_flash_dkv_kernel" in line
        or "dtm_flash_dq_staged_kernel" in line]
    log(f"K3 and K5 instances (dKV without and with the dS stage, staged "
        f"dQ; D 32, 64, 128): {len(bwd_lines)} in this build")
    for line in bwd_lines:
        log(f"  K3/K5 ptxas {line}")
    k4_lines = [line for line in ptxas_summary(
        _kernels.build_logs.get("flash_attention.cu", ""))
        if "dtm_flash_dq_kernel" in line]
    log(f"K4 instances (D 32, 64, 128): {len(k4_lines)} in this build")
    for line in k4_lines:
        log(f"  K4 ptxas {line}")
    log(f"both builds, in parallel: {time.perf_counter() - t0:.2f} s wall")

    if args.flash_only:
        phase_flash(args.seed + 2, parent)
        log(card)
        log("flash-only run: phases 1 and 8 alone, no main path, no result")
        return 0

    # 2. K1 at the ResNet-50 path's launch shapes.
    calls = core_launch_shapes("resnet50", 224, args.batch_size)
    roles = collections.Counter(r for r, _, _ in calls)
    log(f"K1 launches per ResNet-50 step at batch {args.batch_size}: "
        f"{len(calls)} ({dict(roles)})")
    if roles != {"fwd": 25, "dx": 25}:
        fail(f"expected 25 forward and 25 dx launches per step, got {roles}")
    k1_res = phase_k1(calls, args.seed)

    # 3. Gradients through conv2d_mxu.
    phase_grads(args.seed + 1)

    # 3b. The input pipeline alone; with --parent-tree, fit of both trees
    # in turns.
    phase_pipeline(card, args.batch_size, args.seed)
    if args.parent_tree is not None:
        phase_tree_ab(args.parent_tree.resolve(), steps, args.batch_size,
                      card)

    # 4. The ResNet-50 path, K1's counter zeroed just before it.
    if convlib.get_default_conv_impl() != "mxu":
        fail("DTM_CONV_IMPL=mxu did not reach the port's conv selector")
    workdir = ROOT / "build" / "chip_smoke"
    torch.cuda.reset_peak_memory_stats()
    zero_counts((k1, k6))
    run = run_cli("resnet50_synthetic", steps, args.batch_size,
                  workdir / "mxu")
    k1_launches, k6_stray = k1.launches, k6.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = len(calls) * steps
    log(f"K1 launches in the ResNet-50 run: {k1_launches} (expected "
        f"{len(calls)} per step x {steps} steps = {want}); K6 {k6_stray}")
    if k1_launches != want or k6_stray:
        fail(f"K1 launched {k1_launches} times (expected {want}), K6 "
             f"{k6_stray} (expected 0)")
    log(f"ResNet-50 path (K1 convs): batch {args.batch_size}, steps {steps}, "
        f"losses {run['losses']}, {run['images_per_sec']:.1f} images/s end "
        f"to end over {steps - 1} steady steps; peak memory {peak_gib:.2f} "
        f"GiB, K1 {k1_res['ms']:.2f} ms of the step | {card}")
    # Yardstick: the same run with every conv through F.conv2d (cuDNN), in
    # turns with the K1 arm: host noise on a shared machine moves step times
    # between runs.
    arms = [("K1", run)]
    for impl in ("xla", "mxu", "xla"):
        convlib.set_default_conv_impl(impl)
        arms.append(("K1" if impl == "mxu" else "F.conv2d",
                     run_cli("resnet50_synthetic", steps, args.batch_size,
                             workdir / f"{impl}{len(arms)}")))
    for label, r in arms:
        log_arm(f"ResNet {label}", r, args.batch_size, card)

    # 5. Where the ResNet step's device time goes, on both arms.
    r50 = get_config("resnet50_synthetic", global_batch_size=args.batch_size)
    for impl, arm in (("mxu", "ResNet-50, K1 convs"),
                      ("xla", "ResNet-50, F.conv2d convs")):
        convlib.set_default_conv_impl(impl)
        phase_profile(r50, arm)
    convlib.set_default_conv_impl("mxu")

    # 6. K1 and K6 at every launch shape of the Inception-v3 path.
    inc_calls = core_launch_shapes("inception_v3", 299, args.batch_size,
                                   dropout_rate=0.0)
    inc_roles = collections.Counter(r for r, _, _ in inc_calls)
    log(f"conv core launches per Inception-v3 step at batch "
        f"{args.batch_size}: {len(inc_calls)} ({dict(inc_roles)}), "
        f"{len({(x, w) for _, x, w in inc_calls})} distinct shapes")
    k6_res = phase_k1(inc_calls, args.seed + 3)

    # 7. The Inception-v3 path with every routed conv on K6, the two
    # counters zeroed just before it and read just after; then the K1 arm
    # in turns and the F.conv2d arm as a yardstick.
    inc_cfg = get_config("inception_v3_imagenet",
                         global_batch_size=args.batch_size)
    inc_arms = []
    for impl, knob, label in (("mxu", "1", "K6"), ("mxu", "0", "K1"),
                              ("mxu", "1", "K6"), ("mxu", "0", "K1"),
                              ("xla", "0", "F.conv2d")):
        convlib.set_default_conv_impl(impl)
        os.environ["DTM_CONV_MXU_PIPELINE"] = knob
        torch.cuda.reset_peak_memory_stats()
        zero_counts((k1, k6))
        r = run_cli("inception_v3_imagenet", steps, args.batch_size,
                    workdir / f"inception{len(inc_arms)}")
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        want = (len(inc_calls) * steps if impl == "mxu" else 0)
        got = (k6.launches, k1.launches) if knob == "1" else (k1.launches,
                                                              k6.launches)
        log(f"Inception-v3 arm {label}: {label if impl == 'mxu' else 'K1/K6'}"
            f" launches {got[0]} (expected {len(inc_calls)} per step x "
            f"{steps} steps = {want}), the other kernel {got[1]} (expected "
            f"0); peak memory {r['peak_gib']:.2f} GiB; losses {r['losses']}")
        if got != (want, 0):
            fail(f"Inception-v3 {label} arm launched {got}, expected "
                 f"({want}, 0)")
        if not inc_arms:
            k6_launches = k6.launches
        inc_arms.append((label, r))
    for label, r in inc_arms:
        log_arm(f"Inception {label}", r, args.batch_size, card)
    # Device time of the K6 and K1 arms.
    convlib.set_default_conv_impl("mxu")
    for knob, kid in (("1", "K6"), ("0", "K1")):
        os.environ["DTM_CONV_MXU_PIPELINE"] = knob
        phase_profile(inc_cfg, f"Inception-v3, {kid} convs")

    # 8. K2-K5 against their plain versions, timed against their bounds.
    flash = phase_flash(args.seed + 2, parent)

    # 9. The transformer_lm path (pair backward), the flash counters zeroed
    # just before it and read just after; the blockwise yardstick after it.
    lm_cfg = get_config("transformer_lm")
    layers = lm_cfg.model_kwargs["num_layers"]
    tokens = lm_cfg.global_batch_size * lm_cfg.num_steps
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash_fns.values())
    lm_run = run_lm_arm("transformer_lm", "flash", steps, workdir / "lm")
    lm_launches = {kid: fn.launches for kid, fn in flash_fns.items()}
    lm_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {kid: layers * steps if kid in ("K2", "K3", "K4") else 0
            for kid in flash_fns}
    log(f"flash launches in the transformer_lm run: {lm_launches} (expected "
        f"{want})")
    if lm_launches != want:
        fail(f"flash kernels launched {lm_launches}, expected {want}")
    log(f"transformer_lm (flash, K2-K4): {tokens} tokens a step, steps "
        f"{steps}, losses {lm_run['losses']}; peak memory {lm_peak_gib:.3f} "
        f"GiB | {card}")
    lm_arms = [("flash", lm_run)]
    for impl in ("auto", "flash", "auto"):
        zero_counts(flash_fns.values())
        lm_arms.append((impl, run_lm_arm("transformer_lm", impl, steps,
                                         workdir / f"lm{len(lm_arms)}")))
        got = {kid: fn.launches for kid, fn in flash_fns.items()}
        arm_want = want if impl == "flash" else dict.fromkeys(want, 0)
        if got != arm_want:
            fail(f"transformer_lm {impl} arm launched {got}, expected "
                 f"{arm_want}")
    for label, r in lm_arms:
        log_arm(f"LM {label}", r, tokens, card)
    for impl, arm in (("flash", "transformer_lm, flash (K2-K4)"),
                      ("auto", "transformer_lm, blockwise attention")):
        phase_profile(lm_cfg.replace(attn_impl=impl), arm)

    # 10. The transformer_lm_modern path (rope, GQA 2/8, window 256) with
    # the staged backward: K2 and both K5 launches once per layer per step,
    # K3 and K4 never; then the pair backward in turns.
    mod_cfg = get_config("transformer_lm_modern")
    mod_layers = mod_cfg.model_kwargs["num_layers"]
    mod_tokens = mod_cfg.global_batch_size * mod_cfg.num_steps
    mod_arms = []
    for bwd in ("staged", "pair", "staged", "pair"):
        os.environ["DTM_FLASH_BWD"] = bwd
        torch.cuda.reset_peak_memory_stats()
        zero_counts(flash_fns.values())
        r = run_lm_arm("transformer_lm_modern", "flash", steps,
                       workdir / f"modern{len(mod_arms)}")
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        got = {kid: fn.launches for kid, fn in flash_fns.items()}
        on = ("K2", "K5 dKV", "K5 dQ") if bwd == "staged" else ("K2", "K3",
                                                                "K4")
        want = {kid: mod_layers * steps if kid in on else 0
                for kid in flash_fns}
        log(f"transformer_lm_modern, {bwd} backward: flash launches {got} "
            f"(expected {want}); peak memory {r['peak_gib']:.3f} GiB; losses "
            f"{r['losses']}")
        if got != want:
            fail(f"transformer_lm_modern ({bwd}) launched {got}, expected "
                 f"{want}")
        if not mod_arms:
            mod_launches = got
        mod_arms.append((bwd, r))
    for label, r in mod_arms:
        log_arm(f"modern {label}", r, mod_tokens, card)
    os.environ["DTM_FLASH_BWD"] = "staged"
    phase_profile(mod_cfg.replace(attn_impl="flash"),
                  "transformer_lm_modern, flash with the staged backward (K5)")
    os.environ["DTM_FLASH_BWD"] = "pair"

    log(card)
    kernels = [{
        "name": "K1 conv_implicit_gemm",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": k1_launches,
        "max_abs_err": k1_res["max_abs_err"],
        "ms": k1_res["ms"],
        "plain_ms": k1_res["plain_ms"],
        "bound_ms": k1_res["bound_ms"],
        "bound_by": k1_res["bound_by"],
        "library_ms": k1_res["library_ms"],
        "scope": f"sum over the {len(calls)} K1 launches of one ResNet-50 "
                 f"training step at batch {args.batch_size}; library: "
                 f"F.conv2d (cuDNN)",
        "at_inception_shapes_ms": k6_res["ms"],
    }]
    main_shape, sweep_shape, gqa_shape, d128_shape = (
        FLASH_SHAPES[n][0] for n in (0, 1, 2, 4))
    for kid, name, replaces in FLASH_KERNELS + STAGED_KERNELS:
        at_a = flash[kid]["timed"][main_shape]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": (mod_launches if kid.startswith("K5")
                         else lm_launches)[kid],
            "max_abs_err": flash[kid]["max_abs_err"],
            **at_a,
            "scope": "one launch at the LM path's shape B16 T256 H8 D32 "
                     "causal bf16; launches from the "
                     + ("transformer_lm_modern" if kid.startswith("K5")
                        else "transformer_lm") + " run; max_abs_err over "
                     "shapes a-e; library: "
                     + ("SDPA forward (events from Python)" if kid == "K2"
                        else "SDPA backward by CUDA-graph replay, which "
                        "computes dQ, dK and dV: compare with the sum of "
                        "the backward launches' device_ms"),
            "at_flash_sweep_shape": flash[kid]["timed"][sweep_shape],
            "at_gqa_window_shape": flash[kid]["timed"][gqa_shape],
            "at_d128_sweep_shape": flash[kid]["timed"][d128_shape],
        })
    kernels[-1]["dq_vs_k4"] = flash["dq_vs_k4"]
    if parent is not None:
        kernels[-1]["dq_vs_k4_parent"] = flash["dq_vs_k4_parent"]
    kernels.append({
        "name": "K6 conv_implicit_gemm_pipelined",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K6_REPLACES,
        "launches": k6_launches,
        "max_abs_err": k6_res["max_abs_err"],
        "ms": k6_res["k6_ms"],
        "plain_ms": k6_res["plain_ms"],
        "bound_ms": k6_res["bound_ms"],
        "bound_by": k6_res["bound_by"],
        "library_ms": k6_res["library_ms"],
        "scope": f"sum over the {len(inc_calls)} conv core launches of one "
                 f"Inception-v3 training step at batch {args.batch_size}; "
                 f"equal to K1 bit for bit at every shape (K1 there: "
                 f"{k6_res['ms']:.3f} ms); library: F.conv2d (cuDNN)",
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
