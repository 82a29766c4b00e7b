"""Command-line entry point of the port: ``train``, ``eval``, ``generate``
and ``list``.

    python -m distributed_tensorflow_models_tpu_torch.harness.cli train \\
        --config resnet50_synthetic --workdir /tmp/r50 --train-steps 3
    python -m distributed_tensorflow_models_tpu_torch.harness.cli eval \\
        --config resnet50_synthetic --workdir /tmp/r50 --max-batches 4
    python -m distributed_tensorflow_models_tpu_torch.harness.cli generate \\
        --config transformer_lm --workdir /tmp/lm --prompt 5,6,7 \\
        --max-new-tokens 32
    python -m distributed_tensorflow_models_tpu_torch.harness.cli list

Flags are spelled as in the JAX package's CLI.  ``--device`` defaults to
``cuda``; the run raises when no GPU is found unless ``--device cpu`` is
given.  ``train`` prints one JSON object with the final metrics, the
steady-state step time and the end-to-end images/s and, for an LM, tokens/s
(the wait for input included), how the steps ran (CUDA-graph captures,
their seconds, the steps replayed) and each hand-written kernel's launches
in the process.  ``--attn-impl`` picks the attention of
attention models: ``flash`` runs kernels K2-K4 on the card (K2 and K5
with ``DTM_FLASH_BWD=staged``).

``--workdir`` is also the checkpoint directory: ``train`` resumes from
its newest valid checkpoint (``<workdir>/checkpoints``), saves on the
config's cadence (and every ``--checkpoint-every-steps``) and at the end,
restarts in process on transient failures (``recoverable_fit``), and on
SIGTERM writes an emergency checkpoint and exits with
``launch.RESUMABLE_EXIT_CODE`` (75): rerunning the same command resumes.
``--chaos K=V[,K=V...]`` injects deterministic faults for drills
(``resilience/chaos.py``), e.g. ``--nan-policy rollback --chaos
nan_at_step=6`` or ``--chaos sigterm_at_step=4`` (exit 75).
``python -m distributed_tensorflow_models_tpu_torch.resilience.fsck
<workdir>`` checks (and with ``--repair`` clears) the checkpoints.  The
workdir also receives ``metrics.jsonl``, TensorBoard events under
``tensorboard/`` and, on exit, ``telemetry.json`` (the goodput split and
the MFU).

``eval`` restores the workdir's newest valid checkpoint (the EMA shadows
when the config keeps them) and prints one JSON line: ``step`` and top-1,
top-5, xent and the example count for a classifier, perplexity and nll
for an LM; ``--max-batches`` bounds the pass, ``--continuous``
re-evaluates each new checkpoint and prints a line for each.

``generate`` restores the workdir's newest valid checkpoint of a
``transformer_lm`` config and continues ``--prompt`` (comma-separated
token ids; empty is the single token 0) by ``--max-new-tokens`` tokens
through the KV cache (``harness/generate.py``; on the card the one-token
step is a captured CUDA graph), greedy at ``--temperature 0`` (the
default), else sampled with ``--top-k``/``--top-p`` from ``--seed``
(default 0); ``--eos-id`` freezes a row at that token.  It prints one JSON
line, ``{"step", "prompt", "tokens"}`` (the prompt included).  Other
configs, and pipelined checkpoints, are refused.

``train --aot-compile`` (the default) loads or builds the step's kernel
libraries and counts its FLOPs on a background thread while the
checkpoint restores (``harness/startup.py``); ``--no-aot-compile`` leaves
both to the first step.  ``--xla-cache-dir`` names the kernel build cache
(default ``build/kernels/``; ``''`` builds into a temporary directory).

Started by a launcher that sets ``DTM_COORDINATOR_ADDRESS``,
``DTM_NUM_PROCESSES`` and ``DTM_PROCESS_ID`` (``launch.py``, e.g.
``python -m distributed_tensorflow_models_tpu_torch.launch
--num-processes 2 --max-restarts 1 -- python -m
distributed_tensorflow_models_tpu_torch.harness.cli train ...``),
``train`` and ``eval`` first start the heartbeat the launcher reads and
join that process group (NCCL on ``cuda:{LOCAL_RANK or 0}``, gloo with
``--device cpu``), and run as one process of a data-parallel world; the
global batch is ``--batch-size``.
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
    _add_common(p_train)
    p_train.add_argument("--train-steps", type=int, default=None)
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
    p_train.add_argument("--log-every-steps", type=int, default=None,
                         help="the hooks' cadence: metrics.jsonl rows, the "
                         "loss log line, the NaN guard, the telemetry and "
                         "fleet gauges (the config's by default)")
    p_train.add_argument("--chaos", type=_parse_chaos, default=None,
                         metavar="K=V[,K=V...]",
                         help="deterministic fault injection (drills; off "
                         "by default): pipeline_fail_at_batch, nan_at_step, "
                         "torn_checkpoint_at_step, sigterm_at_step, "
                         "kill_at_step, hide_newest_ckpt, "
                         "straggler_delay_ms, chaos_host — e.g. --chaos "
                         "'nan_at_step=50' (resilience/chaos.py)")
    p_train.add_argument("--xla-cache-dir", type=str, default=None,
                         help="the kernel build cache (the JAX package's "
                         "name for its compilation cache): nvcc builds go "
                         "there and a relaunch loads them (default "
                         "build/kernels/ at the repository root; '' builds "
                         "into a fresh temporary directory)")
    p_train.add_argument("--aot-compile",
                         action=argparse.BooleanOptionalAction, default=None,
                         help="load (or build) the step's kernel libraries "
                         "and count its FLOPs on a background thread while "
                         "the checkpoint restores (default on; the run is "
                         "the same bit for bit); --no-aot-compile leaves "
                         "them to the first step")
    p_eval = sub.add_parser("eval", help="evaluate the latest checkpoint")
    _add_common(p_eval)
    p_eval.add_argument("--continuous", action="store_true",
                        help="re-evaluate as new checkpoints appear")
    p_eval.add_argument("--max-batches", type=int, default=None)
    p_gen = sub.add_parser("generate", help="continue a prompt with a "
                           "trained transformer LM checkpoint (KV-cache "
                           "decode)")
    p_gen.add_argument("--config", required=True)
    p_gen.add_argument("--workdir", required=True)
    p_gen.add_argument("--prompt", default="",
                       help="comma-separated token ids (empty = the single "
                       "token 0)")
    p_gen.add_argument("--max-new-tokens", type=int, default=64)
    p_gen.add_argument("--temperature", type=float, default=0.0)
    p_gen.add_argument("--top-k", type=int, default=0)
    p_gen.add_argument("--top-p", type=float, default=1.0)
    # None keeps cfg.seed; the sampling seed falls back to 0.
    p_gen.add_argument("--seed", type=int, default=None)
    p_gen.add_argument("--eos-id", type=int, default=None)
    p_gen.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu must be asked "
                       "for)")
    sub.add_parser("list", help="list available configs")
    args = parser.parse_args(argv)

    if args.cmd == "list":
        from distributed_tensorflow_models_tpu_torch.harness.config import (
            list_configs,
        )

        for name in list_configs():
            print(name)
        return 0

    overrides = _overrides(args)

    from distributed_tensorflow_models_tpu_torch import launch

    # Cluster facts from a launcher (DTM_* env): start the fleet heartbeat
    # (before torch is imported) and join its process group first; fit or
    # the eval then runs as this process's share of the data axis.
    in_cluster = launch.initialize_from_env(device=args.device)
    try:
        if args.cmd == "eval":
            from distributed_tensorflow_models_tpu_torch.harness.config import (
                get_config,
            )

            return _eval(get_config(args.config, **overrides), args)
        if args.cmd == "generate":
            from distributed_tensorflow_models_tpu_torch.harness.config import (
                get_config,
            )

            return _generate(get_config(args.config, **overrides), args)
        return _train(args, overrides)
    finally:
        if in_cluster:
            import torch.distributed

            torch.distributed.destroy_process_group()


def _train(args, overrides: dict) -> int:
    from distributed_tensorflow_models_tpu_torch import launch
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import (
        get_config,
    )

    cfg = get_config(args.config, **overrides)
    result = trainlib.recoverable_fit(cfg, args.workdir, device=args.device)
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
        "kernel_launches": _kernel_launches(),
    }))
    if result.preempted:
        # Checkpointed and stopped early: the resumable code (BSD
        # EX_TEMPFAIL) tells a launcher "rerun me" from a failure.
        return launch.RESUMABLE_EXIT_CODE
    return 0


# Config field of each flag that overrides one; a command without the flag
# leaves the field alone.
_OVERRIDES = (("batch_size", "global_batch_size"), ("seed", "seed"),
              ("attn_impl", "attn_impl"), ("train_steps", "train_steps"),
              ("data_workers", "data_workers"),
              ("steps_per_loop", "steps_per_loop"),
              ("nan_policy", "nan_policy"),
              ("rollback_budget", "rollback_budget"),
              ("watchdog_timeout_s", "watchdog_timeout_s"),
              ("watchdog_abort", "watchdog_abort"),
              ("checkpoint_every_steps", "checkpoint_every_steps"),
              ("preempt_poll_steps", "preempt_poll_steps"),
              ("log_every_steps", "log_every_steps"), ("chaos", "chaos"),
              ("xla_cache_dir", "xla_cache_dir"),
              ("aot_compile", "aot_compile"))


def _overrides(args) -> dict:
    """The config overrides of the parsed flags: every flag given."""
    return {field: getattr(args, flag) for flag, field in _OVERRIDES
            if getattr(args, flag, None) is not None}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True,
                   help="config name (see `list`)")
    p.add_argument("--workdir", required=True,
                   help="metrics and checkpoint dir (a rerun resumes from "
                   "its newest valid checkpoint)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--attn-impl",
                   choices=("auto", "reference", "blockwise", "flash"),
                   default=None,
                   help="attention implementation (auto = blockwise)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked "
                   "for)")


def _eval(cfg, args) -> int:
    from distributed_tensorflow_models_tpu_torch.harness import (
        evaluate as evallib,
    )

    if args.continuous:
        for res in evallib.continuous_eval(
                cfg, args.workdir, max_batches=args.max_batches,
                device=args.device):
            print(json.dumps({"step": res.step, **res.metrics}), flush=True)
        return 0
    fn = (evallib.evaluate_lm if cfg.task == "lm"
          else evallib.evaluate_classification)
    res = fn(cfg, args.workdir, max_batches=args.max_batches,
             device=args.device)
    print(json.dumps({"step": res.step, **res.metrics}))
    return 0


def _generate(cfg, args) -> int:
    import torch

    from distributed_tensorflow_models_tpu_torch.core.mesh import (
        resolve_device,
    )
    from distributed_tensorflow_models_tpu_torch.harness import (
        checkpoint as ckptlib,
    )
    from distributed_tensorflow_models_tpu_torch.harness import (
        generate as genlib,
    )
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    if cfg.task != "lm" or cfg.model != "transformer_lm":
        raise SystemExit("generate requires a transformer_lm config "
                         f"(got model={cfg.model!r})")
    if cfg.mesh_pipe > 1 or cfg.model_kwargs.get("pipelined"):
        raise SystemExit("generate does not support pipelined checkpoints "
                         "(stacked parameter layout)")
    try:
        tokens = [int(t) for t in args.prompt.split(",") if t.strip()]
    except ValueError as e:
        raise SystemExit(f"--prompt must be comma-separated ints: {e}") from e
    tokens = tokens or [0]
    dev = resolve_device(args.device)
    template = trainlib.build_state(cfg, dev)
    manager = ckptlib.CheckpointManager(args.workdir,
                                        keep=cfg.keep_checkpoints)
    try:
        state, _ = manager.restore(template)
    except FileNotFoundError as e:
        raise SystemExit(f"no checkpoint in {args.workdir!r}: {e}") from e
    out = genlib.generate(
        state.model, torch.tensor([tokens], dtype=torch.int64, device=dev),
        args.max_new_tokens, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed or 0, eos_id=args.eos_id)
    print(json.dumps({"step": int(state.step), "prompt": tokens,
                      "tokens": out[0].tolist()}))
    return 0


def _kernel_launches() -> dict:
    """This process's launches of each hand-written kernel (its wrapper's
    counters, replays included), the ones that launched."""
    from distributed_tensorflow_models_tpu_torch.ops import _kernels

    return {f"{fn.__name__}.{attr}": n
            for (fn, attr), n in _kernels.launch_counts().items() if n}


def _parse_chaos(text: str) -> dict:
    """argparse ``type=`` for ``--chaos``: a ValueError here becomes a
    clean usage error naming the bad key or value."""
    from distributed_tensorflow_models_tpu_torch.resilience import chaos

    return chaos.parse_chaos_spec(text)


if __name__ == "__main__":
    raise SystemExit(main())
