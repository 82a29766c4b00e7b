"""The port's isolation from JAX, its entry points and its device rule.

- No file of the port, and not ``chip_smoke.py``, imports jax, flax,
  optax, orbax or the JAX package (an AST walk, so nothing is imported).
- Importing the port's CLI leaves ``jax`` out of ``sys.modules``.
- The CLI trains a tiny config on the CPU when asked for it.
- An entry point given no device raises where there is no CUDA device; it
  never runs on the CPU instead.
- The synthetic ImageNet stream is the JAX package's, value for value.
"""

import ast
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tensorflow_models_tpu.data import datasets as jdata
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu_torch.data import datasets as tdata
from distributed_tensorflow_models_tpu_torch.harness import cli
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_tensorflow_models_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "distributed_tensorflow_models_tpu")


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value))
    return names


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_walks_every_module_of_the_port():
    """The walk covers each module of the port, those of the LM slice
    included; what else the package holds is CUDA source under csrc/,
    which imports nothing of Python."""
    walked = {p.relative_to(PORT).as_posix() for p in _port_files()
              if PORT in p.parents}
    assert {"ops/attention.py", "ops/embed.py", "ops/losses.py",
            "ops/optim.py", "models/transformer_lm.py", "interop.py",
            "core/train_loop.py", "data/datasets.py",
            "harness/cli.py"} <= walked
    others = [p.relative_to(PORT).as_posix() for p in PORT.rglob("*")
              if p.is_file() and p.suffix not in (".py", ".pyc")]
    assert sorted(others) == ["csrc/conv_implicit_gemm.cu",
                              "csrc/flash_attention.cu"]


def test_ast_walk_catches_a_jax_import(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import os\ndef f():\n    from jax import numpy\n"
                 "    import distributed_tensorflow_models_tpu.ops.conv\n")
    assert {"jax", "distributed_tensorflow_models_tpu.ops.conv"} <= (
        _imported_modules(f))


def test_cli_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import distributed_tensorflow_models_tpu_torch.harness.cli\n"
            "import distributed_tensorflow_models_tpu_torch.harness.train\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_trains_tiny_config_on_cpu(tmp_path, capsys):
    rc = cli.main(["train", "--config", "resnet50_synthetic_tiny",
                   "--workdir", str(tmp_path), "--train-steps", "2",
                   "--device", "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 2 and result["device"] == "cpu"
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in rows)
    assert result["images_per_sec"] > 0


def test_entry_points_refuse_to_run_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.get_config("resnet50_synthetic_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainlib.fit(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", "resnet50_synthetic_tiny",
                  "--workdir", str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()
    assert trainlib.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["resnet50_synthetic", "resnet50_imagenet"])
def test_configs_match_jax(name):
    j, t = jconfig.get_config(name), tconfig.get_config(name)
    for field in ("model", "image_size", "global_batch_size",
                  "weight_decay", "train_steps", "seed"):
        assert getattr(t, field) == getattr(j, field), field
    # The port trains classification only, with no label smoothing, no
    # auxiliary head and no EMA.
    assert j.task == "classification" and j.ema_decay is None
    assert j.label_smoothing == 0 and j.aux_loss_weight == 0
    for field in ("name", "learning_rate", "momentum", "decay_steps",
                  "decay_rate", "staircase"):
        assert (getattr(t.optimizer, field)
                == getattr(j.optimizer, field)), field


def test_synthetic_imagenet_matches_jax():
    # Small images keep this cheap; the generator is the same function at
    # every size (the class means are keyed on hash((h, w, c, classes))).
    # 256 rows in batches of 128: five batches cross two epoch boundaries,
    # so the per-epoch reshuffle is held too.
    jds = jdata.synthetic_imagenet_dataset(128, image_size=16, seed=3)
    tds = tdata.synthetic_imagenet_dataset(128, image_size=16, seed=3)
    for jb, tb in itertools.islice(zip(iter(jds), iter(tds)), 5):
        for k in ("image", "label"):
            np.testing.assert_array_equal(tb[k], jb[k])
    assert jds.get_state() == {"epoch": 2, "batch_idx": 1}
