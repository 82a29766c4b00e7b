"""One process of the port's tensor- and sequence-parallel test clusters
(CPU, gloo).

Run by ``tests/torch_parallel_cluster.py`` in every process of a
localhost cluster of 2 or 4 processes whose facts come in the ``DTM_*``
variables:

    python tests/torch_parallel_worker.py <outdir>

Each process joins the group through the port's
``launch.initialize_from_env(device="cpu")`` and writes what it computed
under ``<outdir>`` (``*_p<rank>.npz`` and ``*.json``):

- :data:`ATTN_CASES` — ``ring_attention`` (fold, and flash on its plain
  versions) and ``ulysses_attention`` on this process's block of a global
  Q/K/V over a seq axis of the world's size, with the gradients of a
  seeded cotangent;
- :data:`TP_CASES` (world 2) — one step of LeNet (``cnn_tp``,
  ``head_tp``), the tiny transformer (``transformer_tp``, unfused and
  fused head) and a cut PTB LSTM (``lstm_tp``) at ``model=2``: the loss,
  the whole parameters after the step, and the gradients of the
  replicated parameters on each process;
- :data:`FIT_CASES` — ``fit`` of the tiny transformer (dropout 0.1) on
  each layout of the world's size, its per-step losses; at world 2 also
  the ring's first loss with dropout off, an eval of a seq-layout
  checkpoint on the seq mesh, a ``model=2`` run killed at step 2 and
  resumed against its straight run, and the MoE FFN on each process's
  block under data x seq;
- :data:`CLIP_CASES` (world 2) — ``fit`` under SGD with a global-norm
  clip that acts at every step on the ``model``, ``pipe`` and ``expert``
  layouts: losses, ``grad_norm`` and the whole parameters at the end;
- :data:`ASYNC_CASES` (world 2) — the async-PS emulator, two workers in
  round robin, on a data axis of two and at ``model=2`` under
  :data:`CLIP`: each event's loss, ``grad_norm``, staleness and dropped
  flag, and the whole parameters after the events;
- :data:`STAGE_CASES` — ``pipeline_apply`` of the JAX package's tanh
  stages (forward and gradients), and :data:`PIPE_LM_CASES` the pipelined
  tiny transformer's loss and gradients (dropout 0.3) on the pipe
  layouts of the world's size; :data:`EXPERT_CASES` the expert-parallel
  MoE FFN (out, aux, dropped, gradients) on the expert layouts; at world
  2 a ``pipe=2`` run checkpointed at step 2 and resumed against its
  straight run, and evals of pipe and expert checkpoints on their
  meshes.

The models' weights are built whole from their seeds, every bias set to a
seeded nonzero value (a bias added before a row-parallel sum would show),
and cut by ``parallel/tensor.py::shard_model``; :func:`tp_model` makes the
same whole model for the tests' single-process and JAX oracles.  This
module imports only the port.
"""

from __future__ import annotations

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

# (name, impl, causal, window, H, Hkv, T, D, B): the JAX package's
# seq-mesh shapes (T 64 for the fold and Ulysses, 256 for the flash
# chunks; B 4 where its mesh of seq 2 has a data axis of 4).
ATTN_CASES = [
    ("fold_causal", "fold", True, None, 4, 4, 64, 16, 2),
    ("fold_full", "fold", False, None, 4, 4, 64, 16, 2),
    ("fold_gqa_window", "fold", True, 20, 4, 2, 64, 16, 2),
    ("flash_causal_gqa", "flash", True, None, 4, 2, 256, 32, 2),
    ("flash_window_mqa", "flash", True, 80, 4, 1, 256, 32, 2),
    ("ulysses_causal", "ulysses", True, None, 4, 4, 64, 16, 2),
    ("ulysses_gqa_window", "ulysses", True, 20, 4, 2, 64, 16, 4),
]


def attn_inputs(index: int):
    """The global q, k, v and output cotangent of case ``index`` (f32)."""
    _, _, _, _, H, Hkv, T, D, B = ATTN_CASES[index]
    rng = np.random.default_rng(100 + index)
    q, do = (rng.standard_normal((B, T, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def attn_runs(n: int):
    """The cases that run on a seq axis of ``n`` (Ulysses needs both head
    counts to divide by it)."""
    return [c for c in ATTN_CASES
            if c[1] != "ulysses" or (c[4] % n == 0 and c[5] % n == 0)]


# The tiny transformer: f32, so the port's layouts and the JAX package
# compare at f32 round-off.
LM_KW = {"num_layers": 2, "num_heads": 4, "d_model": 32, "d_ff": 64,
         "max_len": 16, "vocab_size": 64, "dropout_rate": 0.1,
         "dtype": torch.float32}
LM = get_config("transformer_lm_tiny", train_steps=3, global_batch_size=4,
                num_steps=16, vocab_size=64, log_every_steps=3,
                checkpoint_every_secs=10_000.0,
                optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
                model_kwargs=LM_KW)
# The pipelined tiny transformer: 4 layers (one a stage at pipe 4), two
# microbatches; the MoE one at capacity factor 8, where no token drops and
# the expert layout's per-chunk capacity routes as one process does.
PIPE_KW = {**LM_KW, "num_layers": 4, "pipelined": True,
           "pipeline_microbatches": 2}
MOE_KW = {**LM_KW, "num_experts": 4, "moe_capacity_factor": 8.0}
FIT_CASES = {
    2: {
        "ring": dict(mesh_data=1, mesh_seq=2, seq_impl="ring"),
        "ulysses": dict(mesh_data=1, mesh_seq=2, seq_impl="ulysses"),
        "model": dict(mesh_data=1, mesh_model=2),
        "ring_gqa_window": dict(
            mesh_data=1, mesh_seq=2, seq_impl="ring",
            model_kwargs={**LM_KW, "num_kv_heads": 2, "attn_window": 6,
                          "pos_encoding": "rope"}),
        "moe_remat_ring": dict(
            mesh_data=1, mesh_seq=2, seq_impl="ring", fused_unembed=False,
            model_kwargs={**LM_KW, "num_experts": 4, "remat": True}),
    },
    4: {
        "model_seq": dict(mesh_data=1, mesh_model=2, mesh_seq=2,
                          seq_impl="ring"),
    },
}
FIT_CASES[2].update({
    "pipe": dict(mesh_data=1, mesh_pipe=2, model_kwargs=PIPE_KW),
    "expert": dict(mesh_data=1, mesh_expert=2, fused_unembed=False,
                   model_kwargs=MOE_KW),
})
FIT_CASES[4].update({
    "pipe4": dict(mesh_data=1, mesh_pipe=4, model_kwargs=PIPE_KW),
    "data_pipe": dict(mesh_data=2, mesh_pipe=2, model_kwargs=PIPE_KW),
    "data_expert": dict(mesh_data=2, mesh_expert=2, fused_unembed=False,
                        model_kwargs=MOE_KW),
})
# The fields that make a layout; the data-parallel oracle resets them.
LAYOUT = dict(mesh_data=-1, mesh_model=1, mesh_seq=1, mesh_pipe=1,
              mesh_expert=1, seq_impl=None)

# SGD with a clip far below the tiny transformer's gradient norm (~2-4),
# so it scales every step: the norm must be the whole arrays'.
CLIP = OptimizerConfig(name="sgd", learning_rate=0.5, clip_global_norm=0.05)
CLIP_CASES = {
    "model": dict(mesh_data=1, mesh_model=2),
    "pipe": dict(mesh_data=1, mesh_pipe=2, model_kwargs=PIPE_KW),
    "expert": dict(mesh_data=1, mesh_expert=2, fused_unembed=False,
                   model_kwargs=MOE_KW),
}

# The async-PS emulator (parallel/async_ps.py) across processes: two
# workers in round robin, ASYNC_EVENTS events of the tiny transformer on a
# data axis of two (SGD and the f32 head: Adam would turn the round-off
# of the key biases' zero gradient into steps of lr, and the fused bf16
# head rounds each process's rows apart), and at model=2 under CLIP.
ASYNC_EVENTS = 3
ASYNC_CASES = {
    "data": dict(mesh_data=2, fused_unembed=False,
                 optimizer=OptimizerConfig(name="sgd", learning_rate=0.1)),
    "model_clip": dict(mesh_data=1, mesh_model=2, optimizer=CLIP),
}

# The JAX package's pipeline test (tests/test_pipeline.py): 4 tanh stages
# of width 16, 8 microbatches of 4 rows; a process of a pipe axis of n
# applies 4/n of them.
STAGES, MICRO, MICRO_ROWS, WIDTH = 4, 8, 4, 16
STAGE_CASES = {2: {"pipe2": dict(data=1, pipe=2)},
               4: {"pipe4": dict(data=1, pipe=4),
                   "data_pipe": dict(data=2, pipe=2)}}
PIPE_LM_CASES = STAGE_CASES
PIPE_LM_KW = {**PIPE_KW, "dropout_rate": 0.3, "attn_impl": "reference"}
# The JAX package's MoE test (tests/test_moe.py): 8 experts, d 16, f 32,
# 64 tokens.
EXPERTS, MOE_D, MOE_F, MOE_TOKENS = 8, 16, 32, 64
EXPERT_CASES = {2: {"expert2": dict(data=1, expert=2)},
                4: {"expert4": dict(data=1, expert=4),
                    "data_expert": dict(data=2, expert=2)}}

TP_LR = 0.1
# name -> (model, model kwargs, rule set, loss kind)
TP_CASES = {
    "lenet_cnn_tp": ("lenet", {"image_size": 28, "dropout_rate": 0.0},
                     "cnn_tp", "classification"),
    "lenet_head_tp": ("lenet", {"image_size": 28, "dropout_rate": 0.0},
                      "head_tp", "classification"),
    "transformer_tp": ("transformer_lm", {**LM_KW, "dropout_rate": 0.0,
                                          "attn_impl": "reference"},
                       "transformer_tp", "lm"),
    "transformer_tp_fused": ("transformer_lm", {**LM_KW, "dropout_rate": 0.0,
                                                "attn_impl": "reference"},
                             "transformer_tp", "lm_fused"),
    "ptb_lstm_tp": ("ptb_lstm", {"config": "small", "hidden_size": 16,
                                 "vocab_size": 64, "dropout_rate": 0.0},
                    "lstm_tp", "lm"),
}


def tp_model(name: str):
    """Case ``name``'s model, whole: built from seed 0, every bias set to a
    seeded nonzero normal(0.1)."""
    from distributed_tensorflow_models_tpu_torch.models import get_model

    model_name, kw, _, _ = TP_CASES[name]
    model = get_model(model_name, generator=torch.Generator().manual_seed(0),
                      **kw)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("bias"):
                p.copy_(torch.from_numpy(
                    rng.standard_normal(p.shape).astype(np.float32) * 0.1))
    return model


def tp_batch(name: str) -> dict:
    """Case ``name``'s batch (numpy), and for the LSTM its carry."""
    rng = np.random.default_rng(11)
    kind = TP_CASES[name][3]
    if kind == "classification":
        return {"image": rng.standard_normal((8, 28, 28, 1)).astype(
                    np.float32),
                "label": rng.integers(0, 10, 8).astype(np.int32)}
    T = 5 if name.startswith("ptb") else 16
    toks = rng.integers(0, 64, (4, T + 1)).astype(np.int64)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def tp_carry(batch: int = 4, hidden: int = 16, layers: int = 2):
    rng = np.random.default_rng(12)
    return tuple(tuple(torch.from_numpy(
        rng.standard_normal((batch, hidden)).astype(np.float32) * 0.5)
        for _ in range(2)) for _ in range(layers))


def tp_loss(name: str, model):
    from distributed_tensorflow_models_tpu_torch.core import train_loop

    kind = TP_CASES[name][3]
    if kind == "classification":
        return train_loop.classification_loss_fn(model)
    return train_loop.lm_loss_fn(model, fused_unembed=kind == "lm_fused")


def tp_state(name: str, model):
    from distributed_tensorflow_models_tpu_torch.core.train_state import (
        TrainState,
    )
    from distributed_tensorflow_models_tpu_torch.ops import optim

    carry = tp_carry() if name.startswith("ptb") else None
    return TrainState.create(model, optim.sgd(TP_LR), carry=carry)


def _save(path, arrays) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def run_attention(out: str, mesh, rank: int) -> None:
    from distributed_tensorflow_models_tpu_torch.parallel import ring as ringlib

    n = mesh.seq_size
    runs = attn_runs(n)
    for index, case in enumerate(ATTN_CASES):
        if case not in runs:
            continue
        name, impl, causal, window = case[:4]
        q, k, v, do = (torch.from_numpy(x) for x in attn_inputs(index))
        ql, kl, vl = (ringlib.split_sequence(x, mesh).clone()
                      .requires_grad_() for x in (q, k, v))
        if impl == "ulysses":
            o = ringlib.ulysses_attention(ql, kl, vl, mesh, causal=causal,
                                          window=window)
        else:
            o = ringlib.ring_attention(ql, kl, vl, mesh, causal=causal,
                                       impl=impl, window=window)
        (o * ringlib.split_sequence(do, mesh)).sum().backward()
        _save(os.path.join(out, f"attn{n}_{name}_p{rank}.npz"),
              {"out": o.detach(), "dq": ql.grad, "dk": kl.grad,
               "dv": vl.grad})


def run_tp(out: str, mesh, rank: int) -> None:
    from distributed_tensorflow_models_tpu_torch import interop
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.parallel import tensor

    for name, (_, _, rules, kind) in TP_CASES.items():
        model = tp_model(name)
        dims = tensor.shard_model(model, tensor.get_rules(rules), mesh)
        state = tp_state(name, model)
        batch = {k: torch.from_numpy(v) for k, v in tp_batch(name).items()}
        loss_fn = tp_loss(name, model)
        with meshlib.data_parallel(mesh, 1 if kind != "classification"
                                   else None):
            loss, _ = loss_fn(state.params, state, batch, {})
            names = [k for k in state.params if k not in dims]
            grads = (torch.autograd.grad(loss, [state.params[k]
                                                for k in names])
                     if names else [])
            step = train_loop.make_train_step(loss_fn)
            state, metrics = step(state, batch, 0)
        _save(os.path.join(out, f"tp_{name}_grads_p{rank}.npz"),
              dict(zip(names, grads)))
        whole = _flat(interop.to_flax_variables(model)["params"])
        if rank == 0:
            _save(os.path.join(out, f"tp_{name}.npz"),
                  {**whole, "__loss": float(metrics["loss"])})


def run_fits(out: str, world: int, rank: int) -> None:
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    results = {}
    for name, kw in FIT_CASES[world].items():
        before = sharding.collective_counts()
        res = trainlib.fit(LM.replace(**kw), device="cpu")
        results[name] = {
            **{k: [float(r[k]) for r in res.history]
               for k in ("loss", "nll", "aux_loss", "grad_norm")
               if k in res.history[0]},
            "collectives": {k: list(v) for k, v in
                            sharding.counts_since(before).items()}}
    if rank == 0:
        with open(os.path.join(out, f"fits{world}.json"), "w") as f:
            json.dump(results, f)


def first_loss_on_ring(out: str, rank: int) -> None:
    """The ring layout's loss at the initial weights on the first batch,
    dropout off: the JAX package's single-device loss is its oracle."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = LM.replace(mesh_data=1, mesh_seq=2, seq_impl="ring",
                     model_kwargs={**LM_KW, "dropout_rate": 0.0})
    mesh = trainlib.mesh_from_config(cfg, "cpu")
    state = trainlib.build_state(cfg, torch.device("cpu"), mesh)
    batch = next(iter(trainlib.build_dataset(cfg, mesh=mesh)))
    loss_fn = train_loop.lm_loss_fn(state.model, cfg.fused_unembed)
    with meshlib.data_parallel(mesh, 1):
        loss, _ = loss_fn(state.params, state, {
            k: torch.from_numpy(v) for k, v in batch.items()}, {})
    losses = [torch.zeros(()) for _ in range(2)]
    torch.distributed.all_gather(losses, loss.detach())
    if rank == 0:
        with open(os.path.join(out, "first_loss_ring.json"), "w") as f:
            json.dump([float(x) for x in losses], f)


def eval_on_seq_mesh(out: str, rank: int) -> None:
    """A seq-layout run checkpointed at its end, then evaluated on the seq
    mesh; the test evaluates the same checkpoint in one process."""
    from distributed_tensorflow_models_tpu_torch.harness import evaluate
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = LM.replace(**FIT_CASES[2]["ring"], train_steps=2)
    workdir = os.path.join(out, "eval_ring")
    trainlib.fit(cfg, workdir, device="cpu")
    res = evaluate.evaluate_lm(cfg, workdir, max_batches=2, device="cpu")
    if rank == 0:
        with open(os.path.join(out, "eval_ring.json"), "w") as f:
            json.dump({"step": res.step, **res.metrics}, f)


def resume_on_tp(out: str, rank: int) -> None:
    """``model=2``, 4 steps straight against 2 steps checkpointed and
    resumed to 4; both states' whole parameters."""
    from distributed_tensorflow_models_tpu_torch import interop
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = LM.replace(**FIT_CASES[2]["model"], train_steps=4,
                     log_every_steps=2)
    straight = trainlib.fit(cfg, device="cpu")
    workdir = os.path.join(out, "resume_tp")
    trainlib.fit(cfg.replace(train_steps=2), workdir, device="cpu")
    resumed = trainlib.fit(cfg, workdir, device="cpu")
    arrays = {}
    for tag, res in (("straight", straight), ("resumed", resumed)):
        for k, v in _flat(interop.to_flax_variables(
                res.state.model)["params"]).items():
            arrays[f"{tag}/{k}"] = v
        arrays[f"{tag}/__step"] = res.state.step
    arrays["__restored_from"] = resumed.restored_from
    if rank == 0:
        _save(os.path.join(out, "resume_tp.npz"), arrays)


def moe_on_blocks(out: str, mesh, rank: int) -> None:
    """The MoE FFN on this process's ``[B, Tl, d]`` block of a global token
    set under data x seq (data 1, seq 2): output block, aux, and the
    gradients of the parameters and of the block."""
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    params = {k: v.requires_grad_() for k, v in moe.init_moe_params(
        4, 8, 16, torch.Generator().manual_seed(3)).items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8)).astype(np.float32))
    xl = sharding.shard_batch(mesh, {"x": x}, seq_dim=1)["x"]
    xl = xl.clone().requires_grad_()
    res = moe.moe_ffn(params, xl, mesh=mesh)
    loss = (res.out ** 2).sum() + res.aux_loss
    grads = torch.autograd.grad(loss, [xl, *params.values()])
    _save(os.path.join(out, f"moe_seq_p{rank}.npz"),
          {"out": res.out.detach(), "aux": res.aux_loss.detach(),
           "dx": grads[0], **{f"d_{k}": g for k, g in
                              zip(params, grads[1:])}})


def stage_inputs():
    """The tanh stages' stacked parameters, the microbatches and the
    target, as the JAX package's test draws them (numpy)."""
    rng = np.random.RandomState(0)
    w, b = [], []
    for _ in range(STAGES):
        w.append((rng.randn(WIDTH, WIDTH) / np.sqrt(WIDTH)).astype(
            np.float32))
        b.append((rng.randn(WIDTH) * 0.1).astype(np.float32))
    x = rng.randn(MICRO * MICRO_ROWS, WIDTH).astype(np.float32)
    return {"w": np.stack(w), "b": np.stack(b)}, x


def tanh_stage(p, x):
    """The JAX test's ``tanh(x @ w + b)`` for each of the stage's layers."""
    for i in range(len(p["w"])):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def run_stages(out: str, world: int, rank: int) -> None:
    """``pipeline_apply`` of the tanh stages: this process's output rows
    and the gradients of ``mean((out - 0.3)**2)`` (the JAX test's loss
    over the whole batch) for its stage's parameters and its input rows."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.parallel import pipeline

    params, x = stage_inputs()
    for name, spec in STAGE_CASES[world].items():
        mesh = meshlib.create_mesh(meshlib.MeshSpec(**spec), "cpu")
        n, r = mesh.pipe_size, mesh.coord("pipe")
        k = STAGES // n
        mine = {key: torch.from_numpy(v[r * k:(r + 1) * k]).requires_grad_()
                for key, v in params.items()}
        rows = sharding.batch_rows(mesh, MICRO_ROWS)
        mbs = pipeline.split_microbatches(torch.from_numpy(x), MICRO)
        xl = mbs[:, rows].clone().requires_grad_()
        y = pipeline.pipeline_apply(tanh_stage, mine, xl, mesh=mesh)
        loss = ((y - 0.3) ** 2).sum() / (MICRO * MICRO_ROWS * WIDTH)
        grads = torch.autograd.grad(loss, [xl, *mine.values()])
        _save(os.path.join(out, f"stages_{name}_p{rank}.npz"),
              {"out": y.detach(), "dx": grads[0],
               **{f"d_{key}": g for key, g in zip(mine, grads[1:])}})


def pipe_lm(kw=None):
    """The pipelined tiny transformer, whole, from seed 0."""
    from distributed_tensorflow_models_tpu_torch.models import get_model

    return get_model("transformer_lm", generator=torch.Generator().manual_seed(
        0), **{**PIPE_LM_KW, **(kw or {})})


def pipe_lm_batch() -> dict:
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 64, (8, 17)).astype(np.int64)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def run_pipe_lm(out: str, world: int, rank: int) -> None:
    """The pipelined transformer cut over each pipe layout: the loss of
    this process's rows (dropout 0.3, generator seed 9) and the whole
    gradients averaged over the data axis (the step's gradient)."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.parallel import tensor

    batch = pipe_lm_batch()
    for name, spec in PIPE_LM_CASES[world].items():
        mesh = meshlib.create_mesh(meshlib.MeshSpec(**spec), "cpu")
        model = pipe_lm()
        tensor.shard_model(model, [], mesh)
        rows = sharding.batch_rows(mesh, 8)
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        params = dict(model.named_parameters())
        loss_fn = train_loop.lm_loss_fn(model)
        with meshlib.data_parallel(mesh, 1):
            loss, _ = loss_fn(params, train_loop.TrainState(
                step=0, params=params, batch_stats={}, opt_state={},
                model=model, tx=None, device_step=torch.zeros(())), local,
                {"dropout": torch.Generator().manual_seed(9)})
            grads = torch.autograd.grad(loss, list(params.values()))
            sharding.all_reduce_mean_(grads, mesh)
        whole = {}
        dims = model.split_dims
        for (k, g) in zip(params, grads):
            if k in dims and mesh.shape[dims[k][0]] > 1:
                g = tensor.gather_whole(g, mesh, *dims[k])
            whole[f"d/{k}"] = g
        _save(os.path.join(out, f"pipe_lm_{name}_p{rank}.npz"),
              {"loss": loss.detach(), **whole})


def moe_inputs():
    """The MoE test's parameters and tokens (numpy, seeded)."""
    rng = np.random.default_rng(21)
    params = {
        "router": rng.standard_normal((MOE_D, EXPERTS)) / np.sqrt(MOE_D),
        "w_in": rng.standard_normal((EXPERTS, MOE_D, MOE_F)) / np.sqrt(MOE_D),
        "w_out": rng.standard_normal((EXPERTS, MOE_F, MOE_D)) / np.sqrt(MOE_F),
    }
    x = rng.standard_normal((MOE_TOKENS, MOE_D))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def run_experts(out: str, world: int, rank: int) -> None:
    """The MoE FFN over each expert layout: this process's rows of the
    output, aux, the dropped fraction, and the gradients of the JAX test's
    ``mean(out**2) + 0.01 * aux`` over the whole tokens (summed over the
    data axis) for this process's parameters and rows."""
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    params, x = moe_inputs()
    for name, spec in EXPERT_CASES[world].items():
        mesh = meshlib.create_mesh(meshlib.MeshSpec(**spec), "cpu")
        E, c = mesh.expert_size, mesh.coord("expert")
        el = EXPERTS // E
        mine = {k: torch.from_numpy(v if k == "router"
                                    else v[c * el:(c + 1) * el]
                                    ).requires_grad_()
                for k, v in params.items()}
        xl = torch.from_numpy(x[sharding.batch_rows(mesh, MOE_TOKENS)]
                              ).requires_grad_()
        res = moe.moe_ffn(mine, xl, mesh=mesh)
        loss = ((res.out ** 2).sum() / (MOE_TOKENS * MOE_D)
                + 0.01 * res.aux_loss / mesh.data_size)
        grads = list(torch.autograd.grad(loss, [xl, *mine.values()]))
        for g in grads[1:]:
            sharding.all_reduce_sum_(g, mesh, "test_grads")
        _save(os.path.join(out, f"experts_{name}_p{rank}.npz"),
              {"out": res.out.detach(), "aux": res.aux_loss.detach(),
               "dropped": res.dropped_fraction, "dx": grads[0],
               **{f"d_{k}": g for k, g in zip(mine, grads[1:])}})


def run_clips(out: str, rank: int) -> None:
    """Each :data:`CLIP_CASES` layout's ``fit`` under :data:`CLIP`: the
    losses, the ``grad_norm`` metric, the whole parameters, and the count
    of the norm's sums over the layout's axis (``<axis>/norm``)."""
    from distributed_tensorflow_models_tpu_torch import interop
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    arrays = {}
    for name, kw in CLIP_CASES.items():
        before = sharding.collective_counts()
        res = trainlib.fit(LM.replace(optimizer=CLIP, **kw), device="cpu")
        counts = sharding.counts_since(before)
        arrays[f"{name}/__norm_sums"] = counts.get(f"{name}/norm",
                                                   (0, 0))[0]
        arrays[f"{name}/__loss"] = [float(r["loss"]) for r in res.history]
        arrays[f"{name}/__grad_norm"] = [float(r["grad_norm"])
                                         for r in res.history]
        for k, v in _flat(interop.to_flax_variables(
                res.state.model)["params"]).items():
            arrays[f"{name}/{k}"] = v
    if rank == 0:
        _save(os.path.join(out, "clips.npz"), arrays)


def async_run(name: str, single: bool = False) -> dict:
    """:data:`ASYNC_CASES` ``name``: the emulator's per-event losses,
    ``grad_norm``, staleness and dropped flags and the whole parameters
    after the events, each process feeding its block of the A/B's batch
    stream (``harness/experiment.py::ab_batches``); ``single``: the case
    with the layout taken out, alone (the one-process oracle)."""
    from distributed_tensorflow_models_tpu_torch import interop
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.harness import experiment
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.parallel import async_ps

    cfg = LM.replace(**ASYNC_CASES[name])
    if single:
        cfg = cfg.replace(**LAYOUT)
        mesh = meshlib.local_mesh("cpu")
    else:
        mesh = trainlib.mesh_from_config(cfg, "cpu")
    state = train_loop.place_state(trainlib.build_state(
        cfg, mesh.device, mesh, num_steps=ASYNC_EVENTS), mesh)
    emu = async_ps.AsyncPSEmulator(state, trainlib.build_loss(cfg, state),
                                   async_ps.AsyncConfig(num_workers=2))
    batches = experiment.ab_batches(cfg, ASYNC_EVENTS, mesh)
    with meshlib.data_parallel(mesh, trainlib.seq_dim(cfg)):
        recs = emu.run(batches, cfg.seed + 1)
    arrays = {"__loss": [float(r["metrics"]["loss"]) for r in recs],
              "__grad_norm": [float(r["metrics"]["grad_norm"])
                              for r in recs],
              "__staleness": emu.staleness_log,
              "__dropped": [r["dropped"] for r in recs]}
    arrays.update(_flat(interop.to_flax_variables(
        emu.state.model)["params"]))
    return arrays


def run_async(out: str, rank: int) -> None:
    for name in ASYNC_CASES:
        arrays = async_run(name)
        if rank == 0:
            _save(os.path.join(out, f"async_{name}.npz"), arrays)


def resume_and_eval_on_pipe(out: str, rank: int) -> None:
    """``pipe=2``, 4 steps straight against 2 steps checkpointed and
    resumed to 4 (both states' whole parameters), then ``eval`` of the
    resumed run's checkpoint on the pipe mesh."""
    from distributed_tensorflow_models_tpu_torch import interop
    from distributed_tensorflow_models_tpu_torch.harness import evaluate
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = LM.replace(**FIT_CASES[2]["pipe"], train_steps=4,
                     log_every_steps=2)
    straight = trainlib.fit(cfg, device="cpu")
    workdir = os.path.join(out, "resume_pipe")
    trainlib.fit(cfg.replace(train_steps=2), workdir, device="cpu")
    resumed = trainlib.fit(cfg, workdir, device="cpu")
    arrays = {}
    for tag, res in (("straight", straight), ("resumed", resumed)):
        for k, v in _flat(interop.to_flax_variables(
                res.state.model)["params"]).items():
            arrays[f"{tag}/{k}"] = v
        arrays[f"{tag}/__step"] = res.state.step
    arrays["__restored_from"] = resumed.restored_from
    ev = evaluate.evaluate_lm(cfg, workdir, max_batches=2, device="cpu")
    if rank == 0:
        _save(os.path.join(out, "resume_pipe.npz"), arrays)
        with open(os.path.join(out, "eval_pipe.json"), "w") as f:
            json.dump({"step": ev.step, **ev.metrics}, f)


def eval_on_expert(out: str, rank: int) -> None:
    """An ``expert=2`` run checkpointed at its end, evaluated on the
    expert mesh."""
    from distributed_tensorflow_models_tpu_torch.harness import evaluate
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = LM.replace(**FIT_CASES[2]["expert"], train_steps=2)
    workdir = os.path.join(out, "eval_expert")
    trainlib.fit(cfg, workdir, device="cpu")
    res = evaluate.evaluate_lm(cfg, workdir, max_batches=2, device="cpu")
    if rank == 0:
        with open(os.path.join(out, "eval_expert.json"), "w") as f:
            json.dump({"step": res.step, **res.metrics}, f)


def main(out: str) -> int:
    from distributed_tensorflow_models_tpu_torch import launch
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib

    launch.initialize_from_env(device="cpu")
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    seq_mesh = meshlib.create_mesh(meshlib.MeshSpec(data=1, seq=world), "cpu")
    run_attention(out, seq_mesh, rank)
    if world == 2:
        model_mesh = meshlib.create_mesh(meshlib.MeshSpec(data=1, model=2),
                                         "cpu")
        run_tp(out, model_mesh, rank)
        moe_on_blocks(out, seq_mesh, rank)
        first_loss_on_ring(out, rank)
    run_stages(out, world, rank)
    run_pipe_lm(out, world, rank)
    run_experts(out, world, rank)
    run_fits(out, world, rank)
    if world == 2:
        eval_on_seq_mesh(out, rank)
        resume_on_tp(out, rank)
        run_clips(out, rank)
        run_async(out, rank)
        resume_and_eval_on_pipe(out, rank)
        eval_on_expert(out, rank)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))

