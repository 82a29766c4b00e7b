"""Command-line entry point of the port: ``train`` and ``list``.

    python -m distributed_tensorflow_models_tpu_torch.harness.cli train \\
        --config resnet50_synthetic --workdir /tmp/r50 --train-steps 3
    python -m distributed_tensorflow_models_tpu_torch.harness.cli list

Flags are spelled as in the JAX package's CLI.  ``--device`` defaults to
``cuda``; the run raises when no GPU is found unless ``--device cpu`` is
given.  ``train`` prints one JSON object with the final metrics, the
steady-state step time and the end-to-end images/s and, for an LM, tokens/s
(host batch assembly included).  ``--attn-impl`` picks the attention of
attention models: ``flash`` runs kernels K2-K4 on the card (K2 and K5
with ``DTM_FLASH_BWD=staged``).
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
    p_train.add_argument("--workdir", required=True, help="metrics dir")
    p_train.add_argument("--train-steps", type=int, default=None)
    p_train.add_argument("--batch-size", type=int, default=None)
    p_train.add_argument("--seed", type=int, default=None)
    p_train.add_argument("--attn-impl",
                         choices=("auto", "reference", "blockwise", "flash"),
                         default=None,
                         help="attention implementation (auto = blockwise)")
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
    cfg = get_config(args.config, **overrides)

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    result = trainlib.fit(cfg, args.workdir, device=args.device)
    print(json.dumps({
        "final_metrics": result.final_metrics,
        "steps": result.state.step,
        "device": result.device,
        "steady_step_time_s": result.steady_step_time_s,
        "images_per_sec": result.images_per_sec,
        "tokens_per_sec": result.tokens_per_sec,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
