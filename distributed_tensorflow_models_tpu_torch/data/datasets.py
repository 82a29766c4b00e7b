"""Shuffled array batches, synthetic ImageNet and the PTB token stream.

The port's own copy of the parts of
``distributed_tensorflow_models_tpu/data/datasets.py`` the training slices
read (numpy only, so the batch stream is the reference's, value for
value): the seeded per-epoch shuffle of :class:`ArrayDataset`, the
synthetic class-conditional image generator,
:func:`synthetic_imagenet_dataset`, and the PTB windows of
:class:`PTBDataset`.  Batches are numpy dicts; ``harness/train.py`` moves
them to the device.  Real PTB text is read only from ``$DTM_DATA_DIR`` when that
is set; otherwise the synthetic Zipfian stream stands in, as in the JAX
package when its files are absent.
"""

from __future__ import annotations

import collections
import itertools
import os
from typing import Iterator

import numpy as np


class ArrayDataset:
    """Endless whole batches over in-memory arrays: epoch ``e`` visits the
    rows in the permutation seeded by ``seed + e``."""

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int, *,
                 seed: int = 0):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"mismatched array lengths {sizes}")
        self._n = next(iter(sizes.values()))
        if self._n < batch_size:
            raise ValueError(f"{self._n} rows cannot fill a batch of "
                             f"{batch_size}")
        self._arrays = arrays
        self._batch_size = batch_size
        self._seed = seed

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        bs = self._batch_size
        for epoch in itertools.count():
            perm = np.random.RandomState(
                (self._seed + epoch) & 0x7FFFFFFF).permutation(self._n)
            for lo in range(0, self._n - bs + 1, bs):
                idx = perm[lo:lo + bs]
                yield {k: v[idx] for k, v in self._arrays.items()}


def _synthetic_images(n, h, w, c, classes, seed):
    """Class-conditional gaussian blobs: learnable by a small net, so
    loss-decrease integration tests (SURVEY.md §4.4) are meaningful.
    Class means depend only on the *shape* signature, not ``seed``, so a
    model trained on the train split generalizes to the test split."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n).astype(np.int32)
    means = np.random.RandomState(hash((h, w, c, classes)) & 0x7FFFFFFF).rand(
        classes, 1, 1, c
    ).astype(np.float32)
    images = (
        means[labels]
        + 0.1 * rng.randn(n, h, w, c).astype(np.float32)
    ).clip(0, 1)
    return images.astype(np.float32), labels


def synthetic_imagenet_dataset(batch_size: int, image_size: int = 224,
                               seed: int = 0) -> ArrayDataset:
    """On-host synthetic ImageNet batches (shapes and 1000 classes exact),
    the throughput-benchmark input."""
    x, y = _synthetic_images(
        max(2 * batch_size, 256), image_size, image_size, 3, 1000, seed)
    return ArrayDataset({"image": x, "label": y}, batch_size, seed=seed)


class PTBDataset:
    """``ptb_producer`` semantics: the token stream laid out
    ``[batch_size, -1]`` and cut into consecutive ``num_steps`` windows;
    ``targets`` are ``inputs`` shifted by one token.  Endless: epochs loop.
    ``get_state``/``set_state`` expose the cursor."""

    def __init__(self, tokens: np.ndarray, batch_size: int, num_steps: int):
        n_batches = len(tokens) // batch_size
        self._data = tokens[:n_batches * batch_size].reshape(batch_size,
                                                             n_batches)
        self._num_steps = num_steps
        self._epoch_size = (n_batches - 1) // num_steps
        if self._epoch_size <= 0:
            raise ValueError("token stream too short for batch/num_steps")
        self._pos = 0
        self._epoch = 0

    @property
    def batches_per_epoch(self) -> int:
        return self._epoch_size

    def get_state(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos}

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        T = self._num_steps
        while True:
            if self._pos >= self._epoch_size:
                self._epoch += 1
                self._pos = 0
            i = self._pos * T
            self._pos += 1
            yield {"inputs": self._data[:, i:i + T].astype(np.int32),
                   "targets": self._data[:, i + 1:i + T + 1].astype(np.int32)}


def load_ptb_tokens(split: str = "train", vocab_size: int = 10000) -> np.ndarray:
    """Word ids of ``ptb.{split}.txt`` under ``$DTM_DATA_DIR`` (vocab built
    from the train split) when both files are there, else a synthetic
    Zipfian stream: 200,000 train or 20,000 other tokens, seeded 5 or 6."""
    data_dir = os.environ.get("DTM_DATA_DIR")
    if data_dir:
        path = os.path.join(data_dir, f"ptb.{split}.txt")
        train_path = os.path.join(data_dir, "ptb.train.txt")
        if os.path.exists(path) and os.path.exists(train_path):
            with open(train_path) as f:
                words = f.read().replace("\n", " <eos> ").split()
            vocab = {w: i for i, (w, _) in enumerate(sorted(
                collections.Counter(words).items(),
                key=lambda kv: (-kv[1], kv[0])))}
            with open(path) as f:
                data = f.read().replace("\n", " <eos> ").split()
            return np.array([vocab[w] for w in data if w in vocab], np.int32)
    rng = np.random.RandomState(5 if split == "train" else 6)
    n = 200_000 if split == "train" else 20_000
    toks = rng.zipf(1.3, n).astype(np.int64) % vocab_size
    return toks.astype(np.int32)


def ptb_dataset(batch_size: int, num_steps: int, split: str = "train",
                vocab_size: int = 10000) -> PTBDataset:
    return PTBDataset(load_ptb_tokens(split, vocab_size), batch_size,
                      num_steps)
