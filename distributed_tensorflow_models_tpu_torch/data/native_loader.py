"""ctypes binding for the native C++ TFRecord loader.

The reference's record ingest is a C++ kernel (``TFRecordReader``, TF
io_ops.py:542 binding — SURVEY.md §2.3).  This framework keeps that layer
native too: ``native/tfrecord_loader.cc`` implements framed-record reading
with hardware-friendly CRC32C and a multi-threaded shard prefetch pool,
built into ``_dtm_native.so`` (see ``native/Makefile``).

This module is the Python edge: it loads the library if present and
exposes the same record-iteration surface as the pure-Python fallback in
:mod:`tfrecord`.  Everything degrades gracefully when the library has not
been built — correctness never depends on native code, only throughput.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "_dtm_native.so"),
    os.path.join(os.path.dirname(__file__), "_dtm_native.so"),
]


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in _LIB_PATHS:
        path = os.path.abspath(path)
        if os.path.exists(path):
            lib = ctypes.CDLL(path)
            lib.dtm_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.dtm_reader_open.restype = ctypes.c_void_p
            lib.dtm_reader_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.dtm_reader_next.restype = ctypes.c_int
            lib.dtm_reader_close.argtypes = [ctypes.c_void_p]
            lib.dtm_reader_close.restype = None
            lib.dtm_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.dtm_crc32c.restype = ctypes.c_uint32
            lib.dtm_pool_open.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.dtm_pool_open.restype = ctypes.c_void_p
            lib.dtm_pool_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.dtm_pool_next.restype = ctypes.c_int
            lib.dtm_pool_close.argtypes = [ctypes.c_void_p]
            lib.dtm_pool_close.restype = None
            lib.dtm_free.argtypes = [ctypes.c_void_p]
            lib.dtm_free.restype = None
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def crc32c(data: bytes) -> int:
    lib = _load()
    assert lib is not None
    return lib.dtm_crc32c(data, len(data))


def read_all_records(path: str, *, verify_crc: bool = True) -> list[bytes]:
    """Read every record of one shard through the native reader."""
    lib = _load()
    assert lib is not None, "native library not built"
    handle = lib.dtm_reader_open(path.encode(), 1 if verify_crc else 0)
    if not handle:
        raise IOError(f"native reader failed to open {path}")
    out = []
    try:
        buf = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_uint64()
        while True:
            rc = lib.dtm_reader_next(handle, ctypes.byref(buf), ctypes.byref(size))
            if rc == 0:  # EOF
                return out
            if rc < 0:
                raise IOError(f"corrupt record in {path} (code {rc})")
            out.append(ctypes.string_at(buf, size.value))
            lib.dtm_free(buf)
    finally:
        lib.dtm_reader_close(handle)


class NativeRecordPool:
    """Multi-threaded shard reader: N worker threads stream records from a
    shard list into a bounded ring buffer (the C++ analogue of the
    reference's ``batch_join`` N-reader-thread pattern, TF input.py:1089)."""

    def __init__(self, paths: list[str], *, threads: int = 4, capacity: int = 1024):
        lib = _load()
        assert lib is not None, "native library not built"
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.dtm_pool_open(arr, len(paths), threads, capacity)
        if not self._handle:
            raise IOError("native pool failed to start")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        buf = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_uint64()
        rc = self._lib.dtm_pool_next(
            self._handle, ctypes.byref(buf), ctypes.byref(size)
        )
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise IOError(f"corrupt record (code {rc})")
        data = ctypes.string_at(buf, size.value)
        self._lib.dtm_free(buf)
        return data

    def close(self) -> None:
        if self._handle:
            self._lib.dtm_pool_close(self._handle)
            self._handle = None
