#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Every phase fails loudly (exit code 1); none is caught and skipped.

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``csrc/`` (nvcc, at first use).
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

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
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


def run_cli(config: str, steps: int, batch: int, workdir: Path) -> dict:
    """The port's CLI ``train`` in this process; returns its JSON line."""
    from distributed_tensorflow_models_tpu_torch.harness import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", "--config", config, "--workdir",
                       str(workdir), "--train-steps", str(steps),
                       "--batch-size", str(batch), "--device", "cuda"])
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


def phase_profile(batch: int, arm: str, steps: int = 2) -> None:
    """Device time of the training step by kernel class, and the device's
    idle share, over ``steps`` steps after one warm-up step (the batches
    are on the card beforehand), with the conv lowering set as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    cfg = get_config("resnet50_synthetic", global_batch_size=batch)
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
    from distributed_tensorflow_models_tpu_torch.ops import _kernels
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
    conv_mxu._load()
    nvcc_s = _kernels.build_seconds.get("conv_implicit_gemm.cu")
    log(f"K1 build+load: {time.perf_counter() - t0:.2f} s ("
        + ("cached build loaded" if nvcc_s is None
           else f"nvcc {nvcc_s:.2f} s") + ")")

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
    for impl, arm in (("mxu", "K1 convs"), ("xla", "F.conv2d convs")):
        convlib.set_default_conv_impl(impl)
        phase_profile(args.batch_size, arm)

    log(card)
    log(json.dumps({"kernels": [{
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
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
