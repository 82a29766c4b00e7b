"""Eval loops: checkpoint-restoring top-1/top-5 (and perplexity) passes.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/harness/
evaluate.py``.  Reference semantics (SURVEY.md §3.5): the eval process
restores the newest checkpoint — EMA *shadow* variables when the model
maintains them (TF moving_averages.py:638) — runs top-1/top-5 counts over
the validation set, and optionally repeats every N minutes on the newest
checkpoint (``--run_once`` flag in the inception eval program).

The restore goes through the port's ``CheckpointManager`` into a fresh
:func:`~.train.build_state` on the run's device; the forward runs eagerly
under ``torch.no_grad`` on whatever route the config's convolutions and
attention take (K1, or K6 under ``DTM_CONV_MXU_PIPELINE=1``, and K2 on the
card).  The sums stay on the device until the pass ends; under a process
group each process reads its rows of every batch, and the sums are added
over the processes once, on the host, through the consensus's gloo group.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Iterator, Optional

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.mesh import resolve_device
from distributed_tensorflow_models_tpu_torch.harness import checkpoint as ckptlib
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.harness.config import ExperimentConfig
from distributed_tensorflow_models_tpu_torch.ops import losses as losslib
from distributed_tensorflow_models_tpu_torch.parallel import tensor as tensorlib

log = logging.getLogger("dtm")


@dataclasses.dataclass
class EvalResult:
    """The checkpoint's step, the eval's metrics and ``seconds``: the
    pass's wall time on the host, from its first batch to the sums read
    back (the device synchronised)."""

    step: int
    metrics: dict
    seconds: Optional[float] = None


def _restore(cfg: ExperimentConfig, workdir: str, mesh: meshlib.Mesh):
    """The newest valid checkpoint of ``workdir`` restored into a fresh
    state on the mesh's device, and the consensus of the mesh's processes
    (the restore walk is chief-decided, as in ``fit``)."""
    dev = resolve_device(mesh.device)
    consensus = trainlib.mesh_consensus(mesh)
    state = train_loop.place_state(trainlib.build_state(cfg, dev, mesh),
                                   mesh)
    manager = ckptlib.CheckpointManager(
        workdir, keep=cfg.keep_checkpoints,
        process_index=consensus.process_index,
        process_count=consensus.process_count, consensus=consensus)
    # The checkpoint holds whole tensors: read into a whole-shaped
    # template, then keep this process's slices.
    whole, _ = manager.restore(tensorlib.whole_state(state, mesh))
    return tensorlib.scatter_state_(state, whole, mesh), consensus, dev


def _summed(sums: torch.Tensor, consensus) -> list[float]:
    """The device sums read back once and added over the processes."""
    rows = consensus.allgather_floats(sums.tolist(), label="eval")
    return [math.fsum(col) for col in zip(*rows)]


def evaluate_classification(
    cfg: ExperimentConfig,
    workdir: str,
    *,
    mesh: Optional[meshlib.Mesh] = None,
    max_batches: Optional[int] = None,
    use_ema: bool = True,
    device: Optional[str | torch.device] = None,
) -> EvalResult:
    """One eval pass at the latest checkpoint: top-1/top-5 over the
    validation split (counting scheme of the reference's eval loop), on
    ``device`` (default: the mesh's; CUDA without a process group)."""
    if mesh is None:
        mesh = trainlib.mesh_from_config(cfg, device)
    state, consensus, dev = _restore(cfg, workdir, mesh)
    eval_step = train_loop.make_eval_step(
        state.model, use_ema=use_ema and state.ema_params is not None)

    dataset = trainlib.build_dataset(cfg, "test", mesh=mesh)
    max_batches = max_batches or cfg.eval_batches
    if max_batches is None:
        # One pass over the validation set.  Epoch-looping datasets
        # (ArrayDataset) expose batches_per_epoch; one-pass datasets
        # (eval TFRecord) terminate on their own.
        max_batches = getattr(dataset, "batches_per_epoch", None)
    rows = meshlib.local_batch_size(cfg.global_batch_size, mesh)
    sums = torch.zeros(4, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    for i, batch in enumerate(dataset):
        if max_batches is not None and i >= max_batches:
            break
        if len(batch["label"]) % rows:
            # Partial final batch: pad to the full batch, masked by label.
            batch = _pad_batch(batch, rows)
        out = eval_step(state, {k: torch.as_tensor(v).to(dev)
                                for k, v in batch.items()})
        sums += torch.stack([out["top1_count"], out["top5_count"],
                             out["count"], out["xent_sum"]]).double()
    top1, top5, count, xent = _summed(sums, consensus)
    seconds = time.perf_counter() - t0
    metrics = {
        "top1": top1 / max(count, 1),
        "top5": top5 / max(count, 1),
        "xent": xent / max(count, 1),
        "count": count,
    }
    log.info("eval @ step %d: top1=%.4f top5=%.4f over %d examples",
             state.step, metrics["top1"], metrics["top5"], int(count))
    return EvalResult(step=state.step, metrics=metrics, seconds=seconds)


def _pad_batch(batch, multiple: int):
    """Pad with copies of row 0, tagging padding with label -1 so top-k
    counts ignore it (label -1 matches nothing)."""
    n = len(batch["label"])
    pad = (-n) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pad_rows = np.repeat(v[:1], pad, axis=0)
        if k == "label":
            pad_rows = np.full((pad,), -1, v.dtype)
        out[k] = np.concatenate([v, pad_rows], axis=0)
    return out


def evaluate_lm(
    cfg: ExperimentConfig,
    workdir: str,
    *,
    mesh: Optional[meshlib.Mesh] = None,
    max_batches: Optional[int] = None,
    device: Optional[str | torch.device] = None,
) -> EvalResult:
    """Perplexity over the validation stream (R8's ``run_epoch`` eval):
    a fresh zero carry (the PTB LSTM's; ``None`` for the transformer),
    threaded across the whole split, ppl = exp(mean nll)."""
    if mesh is None:
        mesh = trainlib.mesh_from_config(cfg, device)
    state, consensus, dev = _restore(cfg, workdir, mesh)
    model = state.model
    # The restore wrote the checkpoint's carry into the template's: the
    # eval's carry is a new zero one.
    carry = None
    if hasattr(model, "initial_carry"):
        carry = model.initial_carry(
            meshlib.local_batch_size(cfg.global_batch_size, mesh), dev)
    params = {**state.eval_params, **state.batch_stats}

    dataset = trainlib.build_dataset(cfg, "valid", mesh=mesh)
    n_batches = dataset.batches_per_epoch
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    it = iter(dataset)
    t0 = time.perf_counter()
    with torch.no_grad(), meshlib.data_parallel(mesh, trainlib.seq_dim(cfg)):
        for _ in range(n_batches):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in next(it).items()}
            logits, carry = torch.func.functional_call(
                model, params, (batch["inputs"],),
                {"carry": carry, "train": False})
            nll = losslib.softmax_cross_entropy(logits, batch["targets"])
            sums[0] += nll.sum()
            sums[1] += batch["targets"].numel()
    total_nll, total_tok = _summed(sums, consensus)
    seconds = time.perf_counter() - t0
    nll = total_nll / max(total_tok, 1)
    metrics = {"perplexity": float(np.exp(nll)), "nll": nll}
    log.info("eval @ step %d: perplexity=%.2f", state.step,
             metrics["perplexity"])
    return EvalResult(step=state.step, metrics=metrics, seconds=seconds)


def continuous_eval(
    cfg: ExperimentConfig,
    workdir: str,
    *,
    interval_secs: float = 60.0,
    max_evals: Optional[int] = None,
    max_batches: Optional[int] = None,
    device: Optional[str | torch.device] = None,
) -> Iterator[EvalResult]:
    """Re-evaluate whenever a new checkpoint appears — the reference's
    repeat-every-N-minutes eval loop (SURVEY.md §3.5 last line).  Yields
    :class:`EvalResult` per new checkpoint."""
    seen: Optional[int] = None
    evals = 0
    manager = ckptlib.CheckpointManager(workdir, keep=cfg.keep_checkpoints)
    while max_evals is None or evals < max_evals:
        latest = manager.latest_step()
        if latest is not None and latest != seen:
            seen = latest
            fn = evaluate_lm if cfg.task == "lm" else evaluate_classification
            yield fn(cfg, workdir, max_batches=max_batches, device=device)
            evals += 1
        else:
            time.sleep(interval_secs)
