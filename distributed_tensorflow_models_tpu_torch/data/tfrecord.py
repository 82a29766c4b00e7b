"""TFRecord container format: framing, CRC, shard iteration.

The reference reads ImageNet as TFRecord shards through TF's C++
``TFRecordReader`` kernel (SURVEY.md §2.1 R9; TF io_ops.py:542).  This module
reimplements the *container format* natively so the framework can ingest the
same files with zero TensorFlow dependency:

    record := length  : uint64 little-endian
              crc32c(length) masked : uint32 LE
              data    : bytes[length]
              crc32c(data) masked   : uint32 LE
    masked(c) = ((c >> 15) | (c << 17)) + 0xa282ead8   (mod 2^32)

A native C++ fast path (``native/tfrecord_loader.cc``, loaded via ctypes)
handles bulk reading; this pure-Python implementation is the always-available
fallback and the reference semantics for tests.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, Sequence

_CRC_TABLE: list[int] | None = None
_MASK_DELTA = 0xA282EAD8


def _make_table() -> list[int]:
    # CRC-32C (Castagnoli), reflected, polynomial 0x1EDC6F41.
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


def crc32c(data: bytes, value: int = 0) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        _CRC_TABLE = _make_table()
    crc = value ^ 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class CorruptRecordError(IOError):
    pass


def read_records(
    path: str | os.PathLike, *, verify_crc: bool = True
) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise CorruptRecordError(f"{path}: truncated length header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and masked_crc32c(header[:8]) != len_crc:
                raise CorruptRecordError(f"{path}: bad length CRC")
            data = f.read(length)
            if len(data) < length:
                raise CorruptRecordError(f"{path}: truncated record")
            footer = f.read(4)
            if len(footer) < 4:
                raise CorruptRecordError(f"{path}: truncated data CRC")
            if verify_crc:
                (data_crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != data_crc:
                    raise CorruptRecordError(f"{path}: bad data CRC")
            yield data


def write_records(path: str | os.PathLike, records: Iterable[bytes]) -> int:
    """Write payloads as a TFRecord file; returns the record count.

    (The reference never writes records — its dataset-prep scripts do — but
    a writer is required for self-contained tests and synthetic shards.)
    """
    n = 0
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
            n += 1
    return n


class ShardedRecordIterator:
    """Deterministic, checkpointable iterator over a set of TFRecord shards.

    Replaces ``string_input_producer`` + ``TFRecordReader`` (SURVEY.md §3.4
    lines 1-2): shard order is a seeded permutation per epoch, and the
    position (epoch, shard index, record index) is exposed as state so a
    restored run resumes mid-epoch — a capability the reference *lacks*
    (its queues restart from scratch on recovery; SURVEY.md §5.3-5.4).
    """

    def __init__(
        self,
        paths: Sequence[str],
        *,
        shuffle_shards: bool = True,
        seed: int = 0,
        native: bool | None = None,
        num_epochs: int | None = None,
    ):
        """``native``: None = use the C++ loader when built, True = require
        it (raise if missing), False = pure Python.  ``num_epochs``: stop
        after that many passes (eval loops need exactly one); None = loop
        forever (training)."""
        if not paths:
            raise ValueError("no shard paths given")
        self._paths = list(paths)
        self._shuffle = shuffle_shards
        self._seed = seed
        self._epoch = 0
        self._shard_idx = 0
        self._record_idx = 0
        self._native = native
        self._num_epochs = num_epochs

    def _epoch_order(self) -> list[str]:
        if not self._shuffle:
            return self._paths
        import numpy as np

        order = np.random.RandomState(
            (self._seed + self._epoch) & 0x7FFFFFFF
        ).permutation(len(self._paths))
        return [self._paths[i] for i in order]

    def _read_shard(self, path: str) -> Iterator[bytes]:
        use_native = self._native
        if use_native is None or use_native:
            from distributed_tensorflow_models_tpu_torch.data import native_loader

            if native_loader.available():
                return iter(native_loader.read_all_records(path))
            if use_native:
                raise RuntimeError(
                    "native=True but the native library is not built; "
                    "run `make -C native` or pass native=None for "
                    "automatic fallback"
                )
        return read_records(path)

    def get_state(self) -> dict:
        return {
            "epoch": self._epoch,
            "shard_idx": self._shard_idx,
            "record_idx": self._record_idx,
        }

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._shard_idx = int(state["shard_idx"])
        self._record_idx = int(state["record_idx"])

    def __iter__(self) -> Iterator[bytes]:
        while self._num_epochs is None or self._epoch < self._num_epochs:
            order = self._epoch_order()
            while self._shard_idx < len(order):
                path = order[self._shard_idx]
                for i, rec in enumerate(self._read_shard(path)):
                    if i < self._record_idx:
                        continue
                    self._record_idx = i + 1
                    yield rec
                self._shard_idx += 1
                self._record_idx = 0
            self._epoch += 1
            self._shard_idx = 0
