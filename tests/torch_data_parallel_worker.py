"""One process of the port's data-parallel test cluster (CPU, gloo).

Run by ``tests/test_torch_data_parallel.py`` in every process of a
localhost cluster whose facts come in the ``DTM_*`` variables:

    python tests/torch_data_parallel_worker.py <outdir>

Each process joins the group through the port's
``launch.initialize_from_env(device="cpu")`` and trains each of
:data:`CASES` for a few steps through ``fit``; process 0 writes the losses,
the gradient norms and the replicated state to ``<outdir>/<case>.npz``, and
every process its carry rows to ``<outdir>/<case>_carry_p<i>.npz``.  Then
three checks that need several processes: a run killed at a checkpoint and
resumed (:func:`resume_check`), ``all_reduce_mean_`` on tensors of three
dtypes, and ``place_state``'s replica check on states built from different
seeds (``<outdir>/checks_p<i>.json``).  This module imports only
the port (the test imports :data:`CASES` from it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_tensorflow_models_tpu_torch.harness.config import (  # noqa: E402
    get_config,
)

STEPS = 3
# The clip of the cut ptb_medium, below its steps' gradient norms (0.29 to
# 0.38 at these widths), so that clipping acts on the global gradient.
PTB_CLIP = 0.25
CASES = {
    "lenet_mnist": get_config("lenet_mnist", train_steps=STEPS,
                              global_batch_size=8),
    "resnet32_cifar10": get_config(
        "resnet32_cifar10", train_steps=STEPS, global_batch_size=8,
        model_kwargs={"blocks_per_stage": 1}),
    "ptb_medium": get_config(
        "ptb_medium", train_steps=STEPS, num_steps=5, vocab_size=64,
        model_kwargs={"config": "medium", "vocab_size": 64,
                      "hidden_size": 16},
        optimizer=dataclasses.replace(get_config("ptb_medium").optimizer,
                                      clip_global_norm=PTB_CLIP)),
}
# The resume case: the cut ptb_medium (its carry is each process's rows),
# checkpointed every 2 steps, killed at step 4 and resumed to step 6.
RESUME = CASES["ptb_medium"].replace(train_steps=6, log_every_steps=2,
                                     checkpoint_every_secs=10_000.0,
                                     checkpoint_every_steps=2)
# all_reduce_mean_ inputs: process i holds (i + 1) x these values.
MIXED = {"f32": (torch.float32, [1.5, -2.25, 3.0]),
         "bf16": (torch.bfloat16, [[0.5, 1.25], [-4.0, 8.0]]),
         "f64": (torch.float64, [1e-3, 7.0])}


def resume_check(workdir: str) -> dict:
    """The straight two-process run of :data:`RESUME`, and one killed at
    step 4 (both processes raise after the step-4 checkpoint) and resumed
    from it: whether the resumed state (this process's carry rows
    included) equals the straight one bit for bit, and what the resume
    found."""
    from distributed_tensorflow_models_tpu_torch.harness import checkpoint
    from distributed_tensorflow_models_tpu_torch.harness import hooks
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    straight = trainlib.fit(RESUME, device="cpu")
    try:
        trainlib.fit(RESUME, workdir, device="cpu",
                     extra_hooks=[hooks.FaultInjectionHook(4)])
        killed = None
    except RuntimeError as e:
        killed = str(e)
    resumed = trainlib.fit(RESUME, workdir, device="cpu")
    a, _ = checkpoint.flatten_state(straight.state)
    b, _ = checkpoint.flatten_state(resumed.state)
    sidecars = os.path.join(workdir, "checkpoints", "dataset_states", "4")
    return {
        "killed": killed,
        "restored_from": resumed.restored_from,
        "steps": resumed.state.step,
        "differ": sorted(k for k in a if not torch.equal(a[k], b[k])),
        "names": sorted(a) == sorted(b),
        "losses_equal": [h["loss"] for h in resumed.history]
        == [h["loss"] for h in straight.history[4:]],
        "sidecars": sorted(os.listdir(sidecars)),
    }


def main(outdir: str) -> int:
    from distributed_tensorflow_models_tpu_torch import launch

    if not launch.initialize_from_env(device="cpu"):
        raise SystemExit("cluster env missing")
    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    torch.set_num_threads(2)
    pid = dist.get_rank()
    try:
        for name, cfg in CASES.items():
            r = trainlib.fit(cfg, device="cpu")
            if pid == 0:
                np.savez(os.path.join(outdir, f"{name}.npz"),
                         loss=[h["loss"] for h in r.history],
                         grad_norm=[h["grad_norm"] for h in r.history],
                         batch_size=[h["batch_size"] for h in r.history],
                         **{k: t.detach().float().numpy() for k, t in
                            train_loop._replicated_leaves(r.state)})
            if r.state.carry is not None:
                np.savez(os.path.join(outdir, f"{name}_carry_p{pid}.npz"),
                         *[t.numpy() for t in
                           train_loop._leaves(r.state.carry)])

        checks = {"resume": resume_check(os.path.join(outdir, "resume"))}
        mesh = trainlib.mesh_from_config(CASES["lenet_mnist"], "cpu")
        tensors = {k: torch.tensor(v, dtype=dt) * (pid + 1)
                   for k, (dt, v) in MIXED.items()}
        before = sharding.collective_counts()
        sharding.all_reduce_mean_(tensors.values(), mesh)
        checks["mixed"] = {k: t.double().tolist() for k, t in tensors.items()}
        checks["mixed_dtypes"] = [str(t.dtype) for t in tensors.values()]
        checks["mixed_collectives"] = sharding.counts_since(before)
        state = trainlib.build_state(CASES["lenet_mnist"].replace(seed=pid),
                                     torch.device("cpu"), mesh)
        try:
            train_loop.place_state(state, mesh)
            checks["replica_check"] = None
        except RuntimeError as e:
            checks["replica_check"] = str(e)
        with open(os.path.join(outdir, f"checks_p{pid}.json"), "w") as f:
            json.dump(checks, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
