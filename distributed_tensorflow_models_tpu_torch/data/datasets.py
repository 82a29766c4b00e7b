"""Shuffled array batches and synthetic ImageNet.

The port's own copy of the parts of
``distributed_tensorflow_models_tpu/data/datasets.py`` the training slice
reads (numpy only, so the batch stream is the reference's, value for
value): the seeded per-epoch shuffle of :class:`ArrayDataset`, the
synthetic class-conditional image generator, and
:func:`synthetic_imagenet_dataset`.  Batches are numpy dicts; the driver
moves them to the device.
"""

from __future__ import annotations

import itertools
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
