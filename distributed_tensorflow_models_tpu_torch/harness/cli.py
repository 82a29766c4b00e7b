"""Command-line entry point of the port: ``train`` and ``list``.

    python -m distributed_tensorflow_models_tpu_torch.harness.cli train \\
        --config resnet50_synthetic --workdir /tmp/r50 --train-steps 3
    python -m distributed_tensorflow_models_tpu_torch.harness.cli list

Flags are spelled as in the JAX package's CLI.  ``--device`` defaults to
``cuda``; the run raises when no GPU is found unless ``--device cpu`` is
given.  ``train`` prints one JSON object with the final metrics, the
steady-state step time and the end-to-end images/s and, for an LM, tokens/s
(the wait for input included), and how the steps ran (CUDA-graph captures,
their seconds, the steps replayed).  ``--attn-impl`` picks the attention of
attention models: ``flash`` runs kernels K2-K4 on the card (K2 and K5
with ``DTM_FLASH_BWD=staged``).

``--workdir`` is also the checkpoint directory: ``train`` resumes from
its newest valid checkpoint (``<workdir>/checkpoints``), saves on the
config's cadence (and every ``--checkpoint-every-steps``) and at the end,
restarts in process on transient failures (``recoverable_fit``), and on
SIGTERM writes an emergency checkpoint and exits with
``launch.RESUMABLE_EXIT_CODE`` (75): rerunning the same command resumes.
``python -m distributed_tensorflow_models_tpu_torch.resilience.fsck
<workdir>`` checks (and with ``--repair`` clears) the checkpoints.

Started by a launcher that sets ``DTM_COORDINATOR_ADDRESS``,
``DTM_NUM_PROCESSES`` and ``DTM_PROCESS_ID`` (``launch.py``), ``train``
first joins that process group (NCCL on ``cuda:{LOCAL_RANK or 0}``, gloo
with ``--device cpu``) and trains as one process of a data-parallel
world; the global batch is ``--batch-size``.
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    parser = argparse.ArgumentParser(prog="dtm-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="train a config for N steps")
    p_train.add_argument("--config", required=True,
                         help="config name (see `list`)")
    p_train.add_argument("--workdir", required=True,
                         help="metrics and checkpoint dir (a rerun resumes "
                         "from its newest valid checkpoint)")
    p_train.add_argument("--train-steps", type=int, default=None)
    p_train.add_argument("--batch-size", type=int, default=None)
    p_train.add_argument("--seed", type=int, default=None)
    p_train.add_argument("--attn-impl",
                         choices=("auto", "reference", "blockwise", "flash"),
                         default=None,
                         help="attention implementation (auto = blockwise)")
    p_train.add_argument("--data-workers", type=int, default=None,
                         help="host input pipeline: worker threads "
                         "assembling batches behind ordered reassembly (1 = "
                         "one producer thread); the batch stream is the "
                         "same for any value")
    p_train.add_argument("--steps-per-loop", type=int, default=None,
                         help="train steps per call of the K-step train "
                         "call: one chunk of stacked batches, one hook walk "
                         "and no metric read back in between (1 = a call a "
                         "step); the trajectory and the hooks' steps are "
                         "the same for any value.  On CUDA every step after "
                         "the first replays the step captured as a CUDA "
                         "graph")
    p_train.add_argument("--nan-policy", choices=("abort", "rollback"),
                         default=None,
                         help="divergence policy: abort (default: a "
                         "non-finite loss kills the run) or rollback "
                         "(restore the last finite checkpoint, skip exactly "
                         "the offending chunk's batches, retry under "
                         "--rollback-budget)")
    p_train.add_argument("--rollback-budget", type=int, default=None,
                         help="max nan_policy=rollback rewinds per run "
                         "(default 3)")
    p_train.add_argument("--watchdog-timeout-s", type=float, default=None,
                         help="step-progress watchdog: an ERROR log (and the "
                         "train/watchdog_last_progress_s gauge) when no chunk "
                         "completes within this many seconds")
    p_train.add_argument("--watchdog-abort",
                         action=argparse.BooleanOptionalAction, default=None,
                         help="escalate a stall of 2+ watchdog intervals, "
                         "after at least one chunk, to an interrupt of the "
                         "main thread")
    p_train.add_argument("--checkpoint-every-steps", type=int, default=None,
                         help="also checkpoint every N steps (deterministic, "
                         "so restart points reproduce; the 600 s clock "
                         "cadence stays on)")
    p_train.add_argument("--preempt-poll-steps", type=int, default=None,
                         help="multi-process preemption-notice poll cadence "
                         "in steps (a collective; default 20); one process "
                         "polls at every chunk boundary")
    p_train.add_argument("--device", default="cuda",
                         help="torch device (default cuda; cpu must be "
                         "asked for)")
    sub.add_parser("list", help="list available configs")
    args = parser.parse_args(argv)

    from distributed_tensorflow_models_tpu_torch.harness.config import (
        get_config,
        list_configs,
    )

    if args.cmd == "list":
        for name in list_configs():
            print(name)
        return 0

    overrides = {}
    if args.train_steps is not None:
        overrides["train_steps"] = args.train_steps
    if args.batch_size is not None:
        overrides["global_batch_size"] = args.batch_size
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.attn_impl is not None:
        overrides["attn_impl"] = args.attn_impl
    if args.data_workers is not None:
        overrides["data_workers"] = args.data_workers
    if args.steps_per_loop is not None:
        overrides["steps_per_loop"] = args.steps_per_loop
    for field in ("nan_policy", "rollback_budget", "watchdog_timeout_s",
                  "watchdog_abort", "checkpoint_every_steps",
                  "preempt_poll_steps"):
        if getattr(args, field) is not None:
            overrides[field] = getattr(args, field)
    cfg = get_config(args.config, **overrides)

    from distributed_tensorflow_models_tpu_torch import launch
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    # Cluster facts from a launcher (DTM_* env): join its process group
    # first; fit then runs as this process's share of the data axis.
    in_cluster = launch.initialize_from_env(device=args.device)
    try:
        result = trainlib.recoverable_fit(cfg, args.workdir,
                                          device=args.device)
    finally:
        if in_cluster:
            import torch.distributed

            torch.distributed.destroy_process_group()
    print(json.dumps({
        "final_metrics": result.final_metrics,
        "steps": result.state.step,
        "device": result.device,
        "steady_step_time_s": result.steady_step_time_s,
        "images_per_sec": result.images_per_sec,
        "tokens_per_sec": result.tokens_per_sec,
        "captures": result.captures,
        "capture_s": result.capture_s,
        "replayed_steps": result.replayed_steps,
        "preempted": result.preempted,
        "restored_from": result.restored_from,
        "rollbacks": result.rollbacks,
        "skipped_batches": result.skipped_batches,
    }))
    if result.preempted:
        # Checkpointed and stopped early: the resumable code (BSD
        # EX_TEMPFAIL) tells a launcher "rerun me" from a failure.
        return launch.RESUMABLE_EXIT_CODE
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
