"""The tensor- and sequence-parallel test clusters, run once per session.

``cluster(tmp_path_factory, world)`` launches ``world`` processes of
``tests/torch_parallel_worker.py`` (2 or 4, gloo on the CPU) through the
port's own ``launch.launch_local`` and returns their output directory;
with 2 it then runs the CLI's ``train`` as a 2-process cluster of its own
on each of :data:`CLI_RUNS` (``--mesh-seq 2 --seq-impl ring``,
``--mesh-pipe 2``, ``--mesh-expert 2``) into ``<outdir>/cli_<name>``.  The first xdist
worker to take the machine-wide multi-process lock (the one the other
clusters of the port's tests take) runs it and leaves its output in the
session's shared temporary directory; the others read it there.
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import sys
from pathlib import Path

from distributed_tensorflow_models_tpu_torch import launch

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
REPO = WORKER.parent.parent
CLI_ARGV = ["-m", "distributed_tensorflow_models_tpu_torch.harness.cli",
            "train", "--batch-size", "4", "--train-steps", "2", "--device",
            "cpu"]
# name -> the config and mesh flags of a CLI run.
CLI_RUNS = {
    "ring": ["--config", "transformer_lm_tiny", "--mesh-seq", "2",
             "--seq-impl", "ring"],
    "pipe": ["--config", "transformer_lm_tiny", "--mesh-pipe", "2"],
    "expert": ["--config", "transformer_lm_moe", "--mesh-expert", "2",
               "--batch-size", "2", "--train-steps", "1"],
}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(REPO), os.environ.get("PYTHONPATH", "")])}


def cluster(tmp_path_factory, world: int) -> Path:
    """The output directory of the ``world``-process run (run once per
    session); asserts every process exited 0."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / f"torch_parallel_{world}"
    lock = os.environ.get("DTM_TWO_PROC_LOCK", "/tmp/dtm-two-proc.lock")
    with open(lock, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not (out / "codes.json").exists():
                out.mkdir(exist_ok=True)
                codes = launch.launch_local(
                    world, [sys.executable, str(WORKER), str(out)],
                    port=_free_port(), extra_env=_env(), timeout=300)
                for name, flags in (CLI_RUNS.items() if world == 2
                                     else ()):
                    if codes != [0] * len(codes):
                        break
                    codes += launch.launch_local(
                        2, [sys.executable, *CLI_ARGV, *flags, "--workdir",
                            str(out / f"cli_{name}")],
                        port=_free_port(), extra_env=_env(), timeout=120)
                (out / "codes.json").write_text(json.dumps(codes))
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    codes = json.loads((out / "codes.json").read_text())
    assert codes == [0] * len(codes) and codes, (
        f"the {world}-process cluster exited {codes}")
    return out
