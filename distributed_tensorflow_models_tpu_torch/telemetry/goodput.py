"""Goodput accounting: where did the wall time go?

The port's copy of ``distributed_tensorflow_models_tpu/telemetry/
goodput.py``.  The report splits total wall time into exactly four
categories — ``compute`` is the residual, so the fractions sum to 1.0 by
construction:

    compute     = total - data_stall - checkpoint - compile
    data_stall  = train/data_wait        (loop blocked in next_chunk)
    checkpoint  = checkpoint/{save,restore,wait,fence}
    compile     = train/compile          (CUDA-graph captures of the step)

The report also carries a ``startup`` section — the restart-MTTR
numbers (``startup/restore_s``, ``startup/aot_compile_s``,
``startup/time_to_first_step_s`` gauges).  They are overlapped wall
readings, reported beside — never added into — the four exclusive
fractions above.

MFU is wall-clock-inclusive (FLOPs retired per second of *total* time over
peak), i.e. it already prices in every stall.  The FLOPs are the step's
model work as ``core/train_loop.py::step_flops`` counts it; the peak is
the dense bf16 rate of the card, per device, times the devices of the
world, also for f32 configs (the JAX package's convention).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

# Peak dense bf16 FLOPs/sec per device by the name torch reports
# (``torch.cuda.get_device_name``), matched as a prefix: NVIDIA's H100
# datasheet, SXM part, without sparsity.
PEAK_BF16_FLOPS = (
    ("NVIDIA H100 80GB HBM3", 989.4e12),
)


def peak_flops(kind: Optional[str]) -> Optional[float]:
    """Peak bf16 FLOPs/sec for a device name; None when unknown (a CPU,
    an unlisted card — MFU then reports 0.0 rather than a made-up
    number).  ``DTM_PEAK_FLOPS`` overrides for unlisted accelerators."""
    env = os.environ.get("DTM_PEAK_FLOPS")
    if env:
        return float(env)
    if not kind:
        return None
    for prefix, peak in PEAK_BF16_FLOPS:
        if kind.startswith(prefix):
            return peak
    return None


def device_kind(device: Optional[torch.device | str] = None
                ) -> Optional[str]:
    """The CUDA card's name (``torch.cuda.get_device_name``) when CUDA is
    available and ``device`` is not another device type, else None
    (telemetry must never be the thing that crashes)."""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 — report generation must not raise
        return None


def device_count() -> int:
    """Devices of the training world: the ``torch.distributed`` world's
    size (one device per process), or 1 without a process group.  The MFU
    denominator scales by this: the FLOPs counted are the *global*
    batch's, so the peak must be the whole world's."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return max(dist.get_world_size(), 1)
    except Exception:  # noqa: BLE001
        pass
    return 1


def goodput_report(
    registry: reglib.MetricsRegistry,
    total_s: float,
    steps: int,
    kind: Optional[str] = None,
    n_devices: Optional[int] = None,
) -> dict:
    """Build the ``telemetry.json`` payload from a registry snapshot.

    ``total_s`` is the run's full wall time (fit entry to report time);
    ``steps`` the steps executed by this invocation.  If attributed time
    exceeds ``total_s`` (clock skew between span endpoints), the total is
    raised to the attributed sum so no fraction goes negative and the four
    still sum to 1.0.
    """
    snap = registry.snapshot()

    def total(name: str) -> float:
        return snap.get(f"{name}/total_s", 0.0)

    data_stall = total(reglib.DATA_WAIT)
    checkpoint = (
        total(reglib.CKPT_SAVE)
        + total(reglib.CKPT_RESTORE)
        + total(reglib.CKPT_WAIT)
        + total(reglib.CKPT_FENCE)
    )
    compile_s = total(reglib.COMPILE)
    attributed = data_stall + checkpoint + compile_s
    total_s = max(float(total_s), attributed, 1e-9)
    compute = total_s - attributed

    kind = kind if kind is not None else device_kind()
    n_devices = n_devices if n_devices is not None else device_count()
    peak = peak_flops(kind)
    flops_per_step = snap.get(reglib.FLOPS_PER_STEP, 0.0)
    # Retired-FLOPs counter (signature-exact under mixed batch shapes);
    # gauge × steps is the fallback for registries populated without
    # per-step accumulation.  Both are GLOBAL-batch FLOPs, so the peak
    # is the whole world's: per-device peak × device count.
    flops_total = snap.get(reglib.FLOPS_TOTAL, 0.0) or (
        flops_per_step * steps
    )
    mfu = (
        flops_total / (total_s * peak * n_devices)
        if peak and flops_total
        else 0.0
    )
    return {
        "total_s": round(total_s, 6),
        "steps": int(steps),
        "steps_per_sec": round(steps / total_s, 6),
        "seconds": {
            "compute": round(compute, 6),
            "data_stall": round(data_stall, 6),
            "checkpoint": round(checkpoint, 6),
            "compile": round(compile_s, 6),
        },
        "fractions": {
            "compute": compute / total_s,
            "data_stall": data_stall / total_s,
            "checkpoint": checkpoint / total_s,
            "compile": compile_s / total_s,
        },
        "compile_events": int(snap.get(f"{reglib.COMPILE}/count", 0.0)),
        # Restart-MTTR section (overlapped wall readings — reported
        # beside the exclusive four-way split, never summed into it).
        "startup": {
            "restore_s": snap.get(reglib.STARTUP_RESTORE, 0.0),
            "aot_compile_s": snap.get(reglib.STARTUP_AOT_COMPILE, 0.0),
            "time_to_first_step_s": snap.get(
                reglib.STARTUP_FIRST_STEP, 0.0
            ),
        },
        "flops_per_step": flops_per_step,
        "flops_total": flops_total,
        "device_kind": kind,
        "n_devices": n_devices,
        "peak_bf16_flops": peak,  # per device
        "mfu": round(mfu, 6),
        # The raw snapshot rides along: every timer's p50/p95/max for the
        # stall post-mortem (which pipeline stage, how bad at the tail).
        "metrics": snap,
    }


def write_report(path: str, report: dict) -> None:
    """Atomic (tmp + rename) JSON dump — a reader tailing the workdir
    never sees a half-written report."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
