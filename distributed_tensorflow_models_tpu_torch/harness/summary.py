"""TensorBoard-compatible scalar summary writer — no TensorFlow dependency.

The port's copy of ``distributed_tensorflow_models_tpu/harness/summary.py``
(stdlib only), on the port's own protobuf helpers and record checksum.

The reference's observability is ``tf.summary.*`` scalars written by the
summary hooks/threads every 100 steps (SURVEY.md §5.1, §5.5; TF
monitored_session.py:517-518,585-590, supervisor.py:881).  This module
reproduces the *artifact*: standard ``events.out.tfevents.*`` files any
TensorBoard can load, written with this repo's own TFRecord framing
(``data/tfrecord.py``) and a hand-rolled encoder for the tiny subset of the
``Event``/``Summary`` protos scalars need — the same
no-framework-dependency stance as ``data/example_proto.py``.

Wire format (protobuf):
  Event:   wall_time double=1, step int64=2, file_version string=3,
           summary message=5
  Summary: repeated Value value=1
  Value:   tag string=1, simple_value float=2
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping

from distributed_tensorflow_models_tpu_torch.data.example_proto import (
    _encode_len_field,
    _write_varint,
)
from distributed_tensorflow_models_tpu_torch.data.tfrecord import masked_crc32c


def _encode_value(tag: str, value: float) -> bytes:
    out = bytearray()
    _encode_len_field(out, 1, tag.encode("utf-8"))
    out += bytes([0x15])  # field 2, wire type 5 (fixed32)
    out += struct.pack("<f", value)
    return bytes(out)


def _encode_summary(scalars: Mapping[str, float]) -> bytes:
    out = bytearray()
    for tag, value in scalars.items():
        _encode_len_field(out, 1, _encode_value(tag, float(value)))
    return bytes(out)


def encode_event(
    wall_time: float,
    step: int | None = None,
    *,
    scalars: Mapping[str, float] | None = None,
    file_version: str | None = None,
) -> bytes:
    out = bytearray()
    out += bytes([0x09])  # field 1, wire type 1 (fixed64 double)
    out += struct.pack("<d", wall_time)
    if step is not None:
        out += bytes([0x10])  # field 2, varint
        _write_varint(out, step)
    if file_version is not None:
        _encode_len_field(out, 3, file_version.encode("utf-8"))
    if scalars is not None:
        _encode_len_field(out, 5, _encode_summary(scalars))
    return bytes(out)


class SummaryWriter:
    """Append-mode TensorBoard event-file writer.

    ``events.out.tfevents.<ts>.<host>`` in ``logdir``, starting with the
    standard ``brain.Event:2`` version record, then one Event per
    :meth:`scalars` call.  Safe to re-open a logdir: each writer instance
    creates its own event file and TensorBoard merges them by wall time.
    """

    def __init__(self, logdir: str | os.PathLike):
        os.makedirs(logdir, exist_ok=True)
        # pid suffix: co-hosted processes sharing a workdir (the localhost
        # launcher) must not append to the same file — interleaved buffered
        # writes would corrupt the record framing.  Same scheme as TF's
        # writer.
        name = (
            f"events.out.tfevents.{int(time.time())}"
            f".{socket.gethostname()}.{os.getpid()}"
        )
        self._path = os.path.join(logdir, name)
        self._f = open(self._path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    @property
    def path(self) -> str:
        return self._path

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    # Largest finite float32; values beyond it must not reach
    # struct.pack('<f', …), which raises OverflowError for finite doubles
    # out of f32 range — a diverging (but still finite) loss would
    # otherwise crash training from the logging path.
    _F32_MAX = 3.4028235e38

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        """Write one Event carrying all of ``values`` at ``step``."""
        finite = {}
        for tag, v in values.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if f > self._F32_MAX:
                f = float("inf")
            elif f < -self._F32_MAX:
                f = float("-inf")
            finite[tag] = f
        if finite:
            self._write(encode_event(time.time(), step, scalars=finite))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.scalars(step, {tag: value})

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
