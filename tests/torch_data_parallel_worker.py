"""One process of the port's data-parallel test cluster (CPU, gloo).

Run by ``tests/test_torch_data_parallel.py`` in every process of a
localhost cluster whose facts come in the ``DTM_*`` variables:

    python tests/torch_data_parallel_worker.py <outdir>

Each process joins the group through the port's
``launch.initialize_from_env(device="cpu")`` and trains each of
:data:`CASES` for a few steps through ``fit``; process 0 writes the losses,
the gradient norms and the replicated state to ``<outdir>/<case>.npz``, and
every process its carry rows to ``<outdir>/<case>_carry_p<i>.npz``.  Then
four checks that need several processes: a run killed at a checkpoint and
resumed (:func:`resume_check`), a run's telemetry and the eval of its
checkpoint (:func:`telemetry_check`), ``all_reduce_mean_`` on tensors of
three dtypes, and ``place_state``'s replica check on states built from
different seeds (``<outdir>/checks_p<i>.json``); and the MoE FFN on each
process's half of a token set, with its gradients
(:func:`moe_check`, ``<outdir>/moe_p<i>.npz``, read by
``tests/test_torch_moe.py``).  This module imports only
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
    OptimizerConfig,
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
    # The cut MoE transformer in f32 (bf16 products would round each
    # process's partial sums): its MoE block routes the global batch.  SGD,
    # not the config's Adam: the key projection's bias has an exactly-zero
    # true gradient, and Adam scales each run's round-off there to a step
    # of up to lr.
    "transformer_lm_moe": get_config(
        "transformer_lm_moe", train_steps=STEPS, global_batch_size=4,
        num_steps=16, vocab_size=64, fused_unembed=False,
        optimizer=OptimizerConfig(name="sgd", learning_rate=0.1),
        model_kwargs={"num_layers": 2, "num_heads": 2, "d_model": 32,
                      "d_ff": 64, "max_len": 16, "vocab_size": 64,
                      "dropout_rate": 0.1, "num_experts": 4,
                      "dtype": torch.float32}),
}
# The resume case: the cut ptb_medium (its carry is each process's rows),
# checkpointed every 2 steps, killed at step 4 and resumed to step 6.
RESUME = CASES["ptb_medium"].replace(train_steps=6, log_every_steps=2,
                                     checkpoint_every_secs=10_000.0,
                                     checkpoint_every_steps=2)
# The telemetry case: LeNet with a workdir, the telemetry hook firing every
# 2 steps, then EVAL_BATCHES batches of eval on its checkpoint.
TELEMETRY = CASES["lenet_mnist"].replace(train_steps=4, log_every_steps=2,
                                         checkpoint_every_secs=10_000.0)
EVAL_BATCHES = 2
# The MoE check: MOE_TOKENS tokens of width MOE_D over MOE_EXPERTS experts
# (hidden MOE_F), from numpy seed MOE_SEED, at each capacity factor.
MOE_TOKENS, MOE_D, MOE_F, MOE_EXPERTS, MOE_SEED = 64, 16, 32, 4, 17
MOE_FACTORS = (0.5, 1.25)


def moe_inputs():
    """The MoE check's f32 inputs, the same on every process: the
    parameters, the global tokens and a cotangent for the output."""
    rng = np.random.default_rng(MOE_SEED)
    d, f, e = MOE_D, MOE_F, MOE_EXPERTS
    params = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
              "w_in": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_out": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((MOE_TOKENS, d))
    g = rng.standard_normal((MOE_TOKENS, d))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32), g.astype(np.float32))


def moe_check(outdir: str, pid: int) -> None:
    """``moe_ffn`` on this process's rows of :func:`moe_inputs`' tokens,
    the loss ``sum(out * g) / local tokens + aux`` (whose mean over the
    processes is the global batch's), and its gradients: the parameters'
    averaged over the processes, the tokens' as this process has them."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    mesh = meshlib.data_parallel_mesh("cpu")
    params, x, g = moe_inputs()
    rows = sharding.batch_rows(mesh, MOE_TOKENS)
    out = {}
    for cf in MOE_FACTORS:
        p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        xl = torch.tensor(x[rows], requires_grad=True)
        before = sharding.collective_counts()
        res = moe.moe_ffn(p, xl, mesh=mesh, capacity_factor=cf)
        loss = (res.out * torch.from_numpy(g[rows])).sum() / xl.shape[0]
        loss = loss + res.aux_loss
        grads = torch.autograd.grad(loss, [*p.values(), xl])
        sharding.all_reduce_mean_(grads[:-1], mesh)
        counts = sharding.counts_since(before)
        out.update({f"{cf}/out": res.out.detach().numpy(),
                    f"{cf}/aux": res.aux_loss.detach().numpy(),
                    f"{cf}/dropped": res.dropped_fraction.detach().numpy(),
                    f"{cf}/dx": grads[-1].numpy(),
                    f"{cf}/gathers": counts["moe_tokens"][0],
                    f"{cf}/gather_grads": counts["moe_tokens_grad"][0]})
        out.update({f"{cf}/d{k}": t.numpy() for k, t in zip(p, grads)})
    np.savez(os.path.join(outdir, f"moe_p{pid}.npz"), **out)


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


def telemetry_check(workdir: str) -> dict:
    """Two processes' ``fit`` of :data:`TELEMETRY` into ``workdir`` and an
    eval of its checkpoint: this process's eval metrics and, on the chief,
    the run's ``telemetry.json`` and ``metrics.jsonl`` rows."""
    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch.harness import evaluate
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    trainlib.fit(TELEMETRY, workdir, device="cpu")
    ev = evaluate.evaluate_classification(TELEMETRY, workdir, device="cpu",
                                          max_batches=EVAL_BATCHES)
    out = {"eval": ev.metrics, "step": ev.step}
    if dist.get_rank() == 0:
        with open(os.path.join(workdir, "telemetry.json")) as f:
            report = json.load(f)
        out["report"] = {k: v for k, v in report.items() if k != "metrics"}
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            out["rows"] = [json.loads(line) for line in f]
    return out


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

        moe_check(outdir, pid)
        checks = {"resume": resume_check(os.path.join(outdir, "resume")),
                  "telemetry": telemetry_check(
                      os.path.join(outdir, "telemetry"))}
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
