"""Array- and TFRecord-backed datasets for every reference config.

Covers the reference zoo's inputs (SURVEY.md §2.1): MNIST (R3), CIFAR-10
(R4), ImageNet TFRecord shards (R9), and the PTB token stream (R8).  Real
data is loaded when present under ``DATA_DIR`` (``$DTM_DATA_DIR``, else
the reference's default directory); otherwise a deterministic synthetic
substitute with the exact shapes/classes is generated, so every pipeline
runs and is testable without the data.

All iterators expose ``get_state()/set_state()`` for mid-epoch resume —
the capability gap called out in SURVEY.md §5.4 (the reference's queue
pipeline cannot resume; it restarts input from scratch after recovery).

Worker-pool split (``pipeline.py::HostPipeline`` with ``num_workers>1``):
every dataset here additionally factors its iteration into

- ``next_work()`` — advance the *cheap cursor* and return a work
  descriptor for the next batch.  The cursor (epoch/batch position, or
  the TFRecord read head + global record count) is the entire
  checkpointable state; ``next_work`` is the only method that mutates it.
- ``assemble(work)`` — the *pure function* a pool worker executes:
  work descriptor → numpy batch, thread-safe, deterministic (all
  augmentation rngs are derived from positions carried in the work item,
  the reference's many-QueueRunner parallelism made reproducible).

``__iter__`` is defined *through* this split (:func:`iterate_via_work`),
so the serial producer and the worker pool can never diverge — the
emitted stream is bit-identical at any worker count.

The port's own copy of ``distributed_tensorflow_models_tpu/data/datasets.py``
(numpy and the stdlib only), so every stream here is the reference's, byte
for byte.  One difference: :class:`ImageNetTFRecordDataset` checks at
construction that PIL and OpenCV import and raises ImportError if not,
where the reference fails at the first decode.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

from distributed_tensorflow_models_tpu_torch.data import augment, example_proto, tfrecord

# Read once at import, as the reference reads it.
DATA_DIR = os.environ.get("DTM_DATA_DIR", "/root/data")


def _validate_process_shard(
    batch_size: int, process_index: int, process_count: int
) -> int:
    """Common multi-host shard validation; returns the local batch size."""
    if batch_size % process_count:
        raise ValueError(
            f"global batch {batch_size} not divisible by "
            f"process count {process_count}"
        )
    if not 0 <= process_index < process_count:
        raise ValueError(f"bad process {process_index}/{process_count}")
    return batch_size // process_count


def iterate_via_work(dataset) -> Iterator[dict[str, np.ndarray]]:
    """Serial iteration expressed through the worker-pool split: pull a
    work item off the cursor, assemble it inline.  Every dataset's
    ``__iter__`` routes through this, so the single-producer path and the
    N-worker pool execute the *same* code and emit the same stream."""
    while True:
        try:
            work = dataset.next_work()
        except StopIteration:
            return
        yield dataset.assemble(work)


# --------------------------------------------------------------------------
# Generic array dataset
# --------------------------------------------------------------------------


class ArrayDataset:
    """Shuffled, checkpointable batch iterator over in-memory arrays.

    Replaces ``shuffle_batch`` over an in-graph queue (TF training/input.py:
    1255 — SURVEY.md §2.2 F10): per-epoch seeded permutation instead of a
    RandomShuffleQueue, so batches are reproducible and the position
    ``(epoch, batch_idx)`` is the full iterator state.

    ``transform(image, rng) -> image`` runs per sample with an rng derived
    from ``(seed, epoch, sample_position)`` — deterministic augmentation.

    Multi-host (SURVEY.md §3.4 — each reference worker feeds its own input
    stream): ``batch_size`` stays the *global* batch; with
    ``process_count > 1`` each process materializes only its
    ``batch_size/process_count`` row block of every global batch, drawn from
    the same seeded permutation.  Process blocks are disjoint and their
    process-order concatenation reproduces the single-process batch exactly
    (``shard_batch`` assembles them in process order), so a multi-process
    run is trajectory-identical to a single-process run at the same global
    batch — the property the 2-process launcher test pins.  Augmentation
    rngs are keyed by *global* sample position, so this holds under
    transforms too.
    """

    def __init__(
        self,
        arrays: dict[str, np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        transform: Optional[Callable] = None,
        transform_key: str = "image",
        drop_remainder: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"mismatched array lengths {sizes}")
        self._arrays = arrays
        self._n = next(iter(sizes.values()))
        self._batch_size = batch_size
        self._local_batch = _validate_process_shard(
            batch_size, process_index, process_count
        )
        self._local_lo = process_index * self._local_batch
        self._shuffle = shuffle
        self._seed = seed
        self._transform = transform
        self._transform_key = transform_key
        if not drop_remainder and self._n % batch_size:
            raise NotImplementedError("partial final batches unsupported")
        self._epoch = 0
        self._batch_idx = 0
        # Per-epoch permutation cache: assemble() is called from pool
        # worker threads that may straddle an epoch boundary, so the perm
        # is computed once per epoch under a lock (the value is a pure
        # function of (seed, epoch) — any thread computes the same one)
        # and old epochs are pruned to bound memory.
        self._perm_lock = threading.Lock()
        self._perm_cache: dict[int, np.ndarray] = {}

    @property
    def batches_per_epoch(self) -> int:
        return self._n // self._batch_size

    def get_state(self) -> dict:
        return {"epoch": self._epoch, "batch_idx": self._batch_idx}

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._batch_idx = int(state["batch_idx"])

    def _perm_for(self, epoch: int) -> np.ndarray:
        if not self._shuffle:
            return np.arange(self._n)
        with self._perm_lock:
            perm = self._perm_cache.get(epoch)
            if perm is None:
                perm = np.random.RandomState(
                    (self._seed + epoch) & 0x7FFFFFFF
                ).permutation(self._n)
                self._perm_cache[epoch] = perm
                while len(self._perm_cache) > 4:
                    self._perm_cache.pop(min(self._perm_cache))
            return perm

    def next_work(self) -> tuple[int, int]:
        """Advance the cursor; return the ``(epoch, batch_idx)`` position
        the next batch is a pure function of.  Infinite (epochs loop)."""
        if self._batch_idx >= self.batches_per_epoch:
            self._epoch += 1
            self._batch_idx = 0
        work = (self._epoch, self._batch_idx)
        self._batch_idx += 1
        return work

    def assemble(self, work: tuple[int, int]) -> dict[str, np.ndarray]:
        """Pure position → batch (thread-safe; what a pool worker runs).

        Augmentation rngs are keyed by ``(seed, epoch, global sample
        position)`` exactly as the serial path always did, so the batch
        depends only on the work item — never on which worker assembles
        it or in what order."""
        epoch, batch_idx = work
        perm = self._perm_for(epoch)
        lo = batch_idx * self._batch_size + self._local_lo
        idx = perm[lo : lo + self._local_batch]
        batch = {k: v[idx] for k, v in self._arrays.items()}
        if self._transform is not None:
            key = self._transform_key
            out = []
            for j, img in enumerate(batch[key]):
                rng = np.random.default_rng((self._seed, epoch, lo + j))
                out.append(self._transform(img, rng))
            batch[key] = np.stack(out)
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return iterate_via_work(self)


# --------------------------------------------------------------------------
# MNIST / CIFAR-10
# --------------------------------------------------------------------------


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


def load_mnist(split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """``[N,28,28,1]`` float32 in [0,1] + int32 labels (R3's input)."""
    path = os.path.join(DATA_DIR, "mnist.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            x = z[f"x_{split}"].astype(np.float32)[..., None] / 255.0
            y = z[f"y_{split}"].astype(np.int32)
            return x, y
    n = 8192 if split == "train" else 1024
    return _synthetic_images(n, 28, 28, 1, 10, seed=1 if split == "train" else 2)


def load_cifar10(split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """``[N,32,32,3]`` float32 in [0,1] + int32 labels (R4's input)."""
    path = os.path.join(DATA_DIR, "cifar10.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            x = z[f"x_{split}"].astype(np.float32) / 255.0
            y = z[f"y_{split}"].reshape(-1).astype(np.int32)
            return x, y
    n = 8192 if split == "train" else 1024
    return _synthetic_images(n, 32, 32, 3, 10, seed=3 if split == "train" else 4)


def mnist_dataset(
    batch_size: int,
    split: str = "train",
    seed: int = 0,
    *,
    process_index: int = 0,
    process_count: int = 1,
):
    x, y = load_mnist(split)
    return ArrayDataset(
        {"image": x, "label": y},
        batch_size,
        shuffle=split == "train",
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )


def cifar10_dataset(
    batch_size: int,
    split: str = "train",
    seed: int = 0,
    *,
    process_index: int = 0,
    process_count: int = 1,
):
    x, y = load_cifar10(split)
    transform = (
        augment.preprocess_cifar_train
        if split == "train"
        else lambda img, rng: augment.preprocess_cifar_eval(img)
    )
    return ArrayDataset(
        {"image": x, "label": y},
        batch_size,
        shuffle=split == "train",
        seed=seed,
        transform=transform,
        process_index=process_index,
        process_count=process_count,
    )


# --------------------------------------------------------------------------
# ImageNet TFRecord (R9)
# --------------------------------------------------------------------------


class ImageNetTFRecordDataset:
    """TFRecord shards → decoded, augmented batches (R9 end-to-end).

    Record schema (inception convention): ``image/encoded`` JPEG bytes,
    ``image/class/label`` int64 (1-based in the reference's shards —
    ``label_offset`` subtracts it away), optional ``image/object/bbox/*``.

    Multi-host, the reference's per-worker reader model (SURVEY.md §3.4,
    [TF input.py:1089] — each worker's ``string_input_producer`` consumes
    its own shard files):

    - **train**: shard files round-robin by process
      (``paths[process_index::process_count]``); each process decodes and
      yields only its ``batch_size/process_count`` slice of the global
      batch.  Falls back to replicated-read row-slicing when there are
      fewer shard files than processes.
    - **eval**: every process reads *all* files (one deterministic pass —
      the counting loop of SURVEY.md §3.5 needs a stable global record
      order) and yields its row block of each global batch; the final
      partial batch is padded to the full global size with ``label=-1``
      rows (masked by the padded-batch counting, core/train_loop.py) so
      every process yields equal shapes.
    """

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        *,
        train: bool = True,
        image_size: int = 224,
        seed: int = 0,
        label_offset: int = 0,
        native: bool | None = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        # Decode and resize need PIL and OpenCV; fail here, not at the
        # first batch, and never stand synthetic images in for records.
        augment.require_image_libs()
        self._local_batch = _validate_process_shard(
            batch_size, process_index, process_count
        )
        self._process_index = process_index
        self._process_count = process_count
        # File-sharded mode: this process's stream IS its slice of the
        # global batch, so only local_batch records are decoded per step.
        self._file_sharded = (
            train and process_count > 1 and len(paths) >= process_count
        )
        if self._file_sharded:
            paths = list(paths)[process_index::process_count]
        # Eval is exactly one pass (the reference eval loop counts over the
        # validation set once per checkpoint, SURVEY.md §3.5); training
        # loops epochs forever.
        self._records = tfrecord.ShardedRecordIterator(
            paths,
            shuffle_shards=train,
            seed=seed + (process_index if self._file_sharded else 0),
            native=native,
            num_epochs=None if train else 1,
        )
        self._batch_size = batch_size
        self._train = train
        self._size = image_size
        self._seed = seed
        self._label_offset = label_offset
        self._count = 0
        # Persistent record iterator behind the cursor (created lazily so
        # set_state before first use replays into a fresh one).
        self._rec_it: Optional[Iterator[bytes]] = None
        self._exhausted = False

    def get_state(self) -> dict:
        return {"records": self._records.get_state(), "count": self._count}

    def set_state(self, state: dict) -> None:
        self._records.set_state(state["records"])
        self._count = int(state["count"])
        self._rec_it = None
        self._exhausted = False

    def _parse(self, raw: bytes, count: int) -> tuple[np.ndarray, int]:
        feats = example_proto.parse_example(raw)
        img = augment.decode_jpeg(feats["image/encoded"][0])
        label = int(feats["image/class/label"][0]) - self._label_offset
        bbox = None
        if self._train and feats.get("image/object/bbox/ymin"):
            bbox = np.array(
                [
                    feats["image/object/bbox/ymin"][0],
                    feats["image/object/bbox/xmin"][0],
                    feats["image/object/bbox/ymax"][0],
                    feats["image/object/bbox/xmax"][0],
                ],
                np.float32,
            )
        if self._train:
            # Replicated modes key by global record count so every process
            # derives identical augmentations for the rows it owns
            # (trajectory-match with single-process).  File-sharded mode has
            # per-process counts, so the process index salts the key —
            # without it all hosts would apply identical crop/flip
            # parameters at each within-batch position.
            salt = self._process_index if self._file_sharded else 0
            rng = np.random.default_rng((self._seed, salt, count))
            img = augment.preprocess_imagenet_train(
                img, rng, size=self._size, bbox=bbox
            )
        else:
            img = augment.preprocess_imagenet_eval(img, size=self._size)
        return img.astype(np.float32), label

    def next_work(self) -> dict[str, Any]:
        """Pull the raw records for the next batch off the read head.

        This is the *cheap cursor* half of the pool split: serial record
        I/O plus count bookkeeping, no decode.  The returned work item
        carries ``(raw bytes, global record count)`` pairs — everything
        :meth:`assemble` needs to be a pure function — plus the number of
        ``label=-1`` fill rows (multi-process eval tail only).
        """
        if self._exhausted:
            raise StopIteration
        if self._rec_it is None:
            self._rec_it = iter(self._records)
        items: list[tuple[bytes, int]] = []
        if self._file_sharded:
            # Own shard files == own slice of the global batch; nothing
            # but local records are ever read or decoded.
            for raw in self._rec_it:
                items.append((raw, self._count))
                self._count += 1
                if len(items) == self._local_batch:
                    return {"items": items, "pad": 0}
            # Finite stream ended mid-batch: the ragged train tail is
            # dropped, exactly as the serial loop always did.
            self._exhausted = True
            raise StopIteration

        # Replicated-read modes: all processes see the same global record
        # stream; each keeps only its row block [lo, hi) of every global
        # batch.  ``_count`` advances globally (even past skipped rows), so
        # augmentation rngs agree with a single-process run and the
        # process-order concatenation reproduces its batches exactly.
        lo = self._process_index * self._local_batch
        hi = lo + self._local_batch
        pos = 0
        for raw in self._rec_it:
            if lo <= pos < hi:
                items.append((raw, self._count))
            self._count += 1
            pos += 1
            if pos == self._batch_size:
                return {"items": items, "pad": 0}
        self._exhausted = True
        if pos and not self._train:
            # Partial final global batch so a one-pass eval covers every
            # record.  Single-process: ragged (the eval loop pads).
            # Multi-process: pad every row block to equal shape with
            # label=-1 rows, masked out by the padded-batch counting.
            if self._process_count == 1:
                if items:
                    return {"items": items, "pad": 0}
                raise StopIteration
            return {"items": items, "pad": self._local_batch - len(items)}
        raise StopIteration

    def assemble(self, work: dict[str, Any]) -> dict[str, np.ndarray]:
        """Pure work → batch: JPEG decode + augment for every carried
        record (the expensive half, what a pool worker runs).  Rngs key on
        the global record count inside the work item, so the result is
        independent of assembly order and worker identity."""
        images, labels = [], []
        for raw, count in work["items"]:
            img, label = self._parse(raw, count)
            images.append(img)
            labels.append(label)
        if work["pad"]:
            fill = np.zeros((self._size, self._size, 3), np.float32)
            images.extend([fill] * work["pad"])
            labels.extend([-1] * work["pad"])
        return {
            "image": np.stack(images),
            "label": np.asarray(labels, np.int32),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return iterate_via_work(self)


def synthetic_imagenet_dataset(
    batch_size: int,
    image_size: int = 224,
    seed: int = 0,
    *,
    process_index: int = 0,
    process_count: int = 1,
):
    """On-host synthetic ImageNet batches (shapes/classes exact) — the
    throughput-benchmark input, the role slim's fake dataset played for the
    reference's own benchmarking (see bench.py)."""
    x, y = _synthetic_images(
        max(2 * batch_size, 256), image_size, image_size, 3, 1000, seed
    )
    return ArrayDataset(
        {"image": x, "label": y},
        batch_size,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )


# --------------------------------------------------------------------------
# PTB (R8)
# --------------------------------------------------------------------------


class PTBDataset:
    """``ptb_producer`` semantics: the token stream is laid out
    ``[batch_size, -1]`` and cut into consecutive ``num_steps`` windows;
    ``targets`` are inputs shifted by one.  Consecutive batches are
    consecutive in the stream, which is what makes threading the LSTM carry
    across steps meaningful (truncated BPTT, SURVEY.md §7.4.5).

    Multi-host: ``batch_size`` is global; each process holds the row block
    ``[process_index*local : (process_index+1)*local]`` of the
    ``[batch_size, -1]`` token layout.  Rows are stable across steps, so
    each process's carry slice stays aligned with its rows, and the
    process-order concatenation equals the single-process batch."""

    def __init__(
        self,
        tokens: np.ndarray,
        batch_size: int,
        num_steps: int,
        *,
        process_index: int = 0,
        process_count: int = 1,
    ):
        local = _validate_process_shard(
            batch_size, process_index, process_count
        )
        n_batches = len(tokens) // batch_size
        data = tokens[: n_batches * batch_size].reshape(batch_size, n_batches)
        data = data[process_index * local : (process_index + 1) * local]
        self._data = data
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

    def next_work(self) -> int:
        """Advance the cursor; return the window position the next batch
        is a pure function of.  Infinite (epochs loop)."""
        if self._pos >= self._epoch_size:
            self._epoch += 1
            self._pos = 0
        work = self._pos
        self._pos += 1
        return work

    def assemble(self, work: int) -> dict[str, np.ndarray]:
        """Pure position → window batch (thread-safe; slices only)."""
        T = self._num_steps
        i = work * T
        return {
            "inputs": self._data[:, i : i + T].astype(np.int32),
            "targets": self._data[:, i + 1 : i + T + 1].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return iterate_via_work(self)


def load_ptb_tokens(split: str = "train", vocab_size: int = 10000) -> np.ndarray:
    """Real PTB ids if ``ptb.{split}.txt`` exists under DATA_DIR (word-level,
    vocab built from the train split), else a synthetic Zipfian stream."""
    path = os.path.join(DATA_DIR, f"ptb.{split}.txt")
    train_path = os.path.join(DATA_DIR, "ptb.train.txt")
    if os.path.exists(path) and os.path.exists(train_path):
        with open(train_path) as f:
            words = f.read().replace("\n", " <eos> ").split()
        from collections import Counter

        vocab = {
            w: i
            for i, (w, _) in enumerate(
                sorted(Counter(words).items(), key=lambda kv: (-kv[1], kv[0]))
            )
        }
        with open(path) as f:
            data = f.read().replace("\n", " <eos> ").split()
        return np.array([vocab[w] for w in data if w in vocab], np.int32)
    rng = np.random.RandomState(5 if split == "train" else 6)
    n = 200_000 if split == "train" else 20_000
    # Zipf-ish distribution over the vocab, clipped into range.
    toks = rng.zipf(1.3, n).astype(np.int64) % vocab_size
    return toks.astype(np.int32)


def ptb_dataset(
    batch_size: int,
    num_steps: int,
    split: str = "train",
    vocab_size: int = 10000,
    *,
    process_index: int = 0,
    process_count: int = 1,
) -> PTBDataset:
    return PTBDataset(
        load_ptb_tokens(split, vocab_size),
        batch_size,
        num_steps,
        process_index=process_index,
        process_count=process_count,
    )
