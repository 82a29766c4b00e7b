"""The port's isolation from JAX, its entry points and its device rule.

- No file of the port, and not ``chip_smoke.py``, imports jax, flax,
  optax, orbax or the JAX package (an AST walk, so nothing is imported).
- Importing the port's CLI leaves ``jax`` out of ``sys.modules``.
- The CLI trains a tiny config on the CPU when asked for it.
- An entry point given no device raises where there is no CUDA device; it
  never runs on the CPU instead.
- The synthetic ImageNet stream is the JAX package's, value for value.
- A kernel build's key covers its source, every shared header and the
  flags.
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
    included; what else the package holds is CUDA source and its shared
    header under csrc/, which import nothing of Python."""
    walked = {p.relative_to(PORT).as_posix() for p in _port_files()
              if PORT in p.parents}
    assert {"ops/attention.py", "ops/embed.py", "ops/losses.py",
            "ops/optim.py", "models/transformer_lm.py", "interop.py",
            "core/train_loop.py", "data/datasets.py",
            "harness/cli.py", "ops/ema.py", "ops/rotary.py",
            "ops/dropout.py", "models/inception_v3.py",
            "core/train_state.py"} <= walked
    others = [p.relative_to(PORT).as_posix() for p in PORT.rglob("*")
              if p.is_file() and p.suffix not in (".py", ".pyc")]
    assert sorted(others) == ["csrc/conv_implicit_gemm.cu",
                              "csrc/flash_attention.cu", "csrc/hopper.cuh"]


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


@pytest.mark.parametrize("name", ["resnet50_synthetic", "resnet50_imagenet",
                                  "inception_v3_imagenet"])
def test_configs_match_jax(name):
    j, t = jconfig.get_config(name), tconfig.get_config(name)
    for field in ("model", "dataset", "image_size", "global_batch_size",
                  "weight_decay", "label_smoothing", "aux_loss_weight",
                  "ema_decay", "train_steps", "seed"):
        assert getattr(t, field) == getattr(j, field), field
    assert j.task == t.task == "classification"
    for field in ("name", "learning_rate", "momentum", "decay_steps",
                  "decay_rate", "staircase", "rmsprop_decay",
                  "rmsprop_epsilon"):
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


@pytest.mark.parametrize("size", [75, 299])
def test_fit_trains_inception_on_cpu(size):
    """One step of inception_v3_imagenet (RMSProp, smoothing, the aux head
    and its 0.4 loss, L2, the EMA) through fit on the CPU, batch 2, via
    get_config overrides.  The aux head needs a 299x299 input (at 75x75 it
    raises: tests/test_torch_inception.py), so 75x75 trains with the head
    off."""
    cfg = tconfig.get_config("inception_v3_imagenet", image_size=size,
                             global_batch_size=2, train_steps=1)
    if size == 75:
        cfg = cfg.replace(model_kwargs={"aux_head": False})
    result = trainlib.fit(cfg, device="cpu")
    assert result.state.step == 1
    assert math.isfinite(result.final_metrics["loss"])
    state = result.state
    assert state.ema_decay == 0.9999 and state.ema_params is not None
    assert state.opt_state["count"] == 1
    # The shadows moved 0.9 of the way from the seeded init to the updated
    # parameters (TF's damped decay, min(0.9999, 1/10) at update 0).
    init = dict(trainlib.build_model(cfg, torch.device("cpu"))
                .named_parameters())
    for name in ("head.kernel", "ConvBN_0.Conv2D_0.kernel"):
        p0 = init[name].detach()
        step = state.params[name].detach() - p0
        assert float(step.abs().max()) > 0, name
        torch.testing.assert_close(state.ema_params[name] - p0, 0.9 * step,
                                   rtol=1e-5, atol=1e-7, msg=name)
    assert trainlib.train_loop.state_is_finite(state)


def test_fit_trains_tiny_modern_lm_staged_on_cpu(monkeypatch):
    """transformer_lm_modern at a tiny width (rope, GQA 2 of 4, window)
    with flash attention and the staged backward, two steps on the CPU."""
    monkeypatch.setenv("DTM_FLASH_BWD", "staged")
    cfg = tconfig.get_config(
        "transformer_lm_modern", global_batch_size=2, num_steps=64,
        vocab_size=256, train_steps=2, attn_impl="flash",
        model_kwargs={"num_layers": 2, "num_heads": 4, "d_model": 64,
                      "d_ff": 128, "max_len": 64, "vocab_size": 256,
                      "dropout_rate": 0.1, "pos_encoding": "rope",
                      "num_kv_heads": 2, "attn_window": 32})
    result = trainlib.fit(cfg, device="cpu")
    assert result.state.step == 2
    assert all(math.isfinite(r["loss"]) for r in result.history)
    assert "pos_embedding" not in result.state.params
    assert result.tokens_per_sec > 0


@pytest.mark.parametrize("edit", ["source", "header", "new header"])
def test_kernel_build_key_covers_every_header(tmp_path, monkeypatch, edit):
    """A build is keyed on its .cu, every csrc/*.cuh and the flags: an edit
    to a shared header changes the key of every source that includes it,
    so no stale library is loaded (csrc/hopper.cuh serves K1, K6 and K2)."""
    from distributed_tensorflow_models_tpu_torch.ops import _kernels

    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// helpers\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    before = _kernels._source_key(tmp_path / "a.cu")
    assert _kernels._source_key(tmp_path / "a.cu") == before
    if edit == "source":
        (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n// K\n')
    elif edit == "header":
        (tmp_path / "hopper.cuh").write_text("// helpers, edited\n")
    else:
        (tmp_path / "other.cuh").write_text("// more\n")
    assert _kernels._source_key(tmp_path / "a.cu") != before
