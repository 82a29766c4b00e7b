"""KV page shipping: the wire layer of disaggregated serving.

The paged arena makes KV pages a natural wire unit — a finished
prefill's block table + pages are a self-contained artifact any decode
replica can adopt.  This module is the TRANSPORT half of that split and
is deliberately stdlib + numpy only (``serving/server.py`` is a
torch-free-zone root and imports it at module level; the device half —
gather/scatter of the pages themselves — stays in ``engine.py``).

Three layers, all built on the same two idioms the file-queue replica
protocol already proved (tmp + atomic rename to publish, rename into a
claim directory for exactly-once ownership):

**Wire format** (:func:`pack_bundle` / :func:`unpack_bundle`) — a
versioned, checksummed, torch-free container for one request's KV pages
plus metadata::

    magic "DTMSHIP1" | u32 header_len | header JSON | leaf payloads
    | u32 crc32(all preceding) | u64 total_len

The header carries ``meta`` (ids, tokens, sampling knobs, timing
stamps) and a leaf manifest (path, dtype, shape, nbytes, per-leaf
crc32).  Every integer in ``meta`` must fit int32 — the same
silent-truncation contract dtm-lint's ``int32-wire`` rule polices on
collectives applies to this wire format, enforced at PACK time so a
64-bit id can never leave the building.  ``unpack_bundle`` rejects
truncation (length fields disagree with the buffer) and corruption
(any crc mismatch) with :class:`ShipError` — a decode replica never
adopts half a cache.

**Handoff protocol** (:func:`publish_bundle` / :func:`claim_bundle`) —
a prefill replica publishes ``ship-<rid>.kvh`` into the handoff
directory via tmp + atomic rename (the tmp file is removed in a
``finally`` on any failure — the resource-lifecycle rule's motif); a
decode replica claims by renaming into ``claimed/<name>.p<replica>``:
the rename either fully succeeds or a peer already owns the bundle, so
exactly one decode replica adopts each request.  ``PREFILL_DONE.p<i>``
markers (:func:`mark_prefill_done`) let decode replicas distinguish
"no bundles right now" from "no bundles ever again".

**Fleet prefix index** (:class:`FleetPrefixIndex`) — a shared,
content-addressed directory of resident prefix pages.  Entries are
keyed by the sha256 chain digest of the page's full token prefix
(digest(i) hashes digest(i-1) + page i's tokens), so lookup walks a
prompt's pages digest-by-digest and any replica's resident prefix
serves the whole fleet: the pages ship instead of re-prefilling.
Advertise is publish-if-absent (concurrent twins dedupe exactly like
the radix trie's insert); eviction is mtime-LRU over entry files and
ENOENT-tolerant — losing an entry mid-lookup is a cache miss, never an
error, because the index only ever short-circuits work (capacity
management, never token-affecting).

Wall-clock note: :func:`mono_of_wall` / :func:`wall_of_mono` read
``time.time()`` on purpose — handoff bundles cross process boundaries,
and ``perf_counter`` origins are per-process, so timing stamps travel
as wall time and are rebased into the consumer's monotonic frame on
arrival.  Like ``telemetry/timeseries.py``, this module is therefore
deliberately NOT in dtm-lint's determinism scope: the stamps feed
telemetry attribution only and can never affect a token.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
import zlib

import numpy as np

MAGIC = b"DTMSHIP1"
WIRE_VERSION = 1
BUNDLE_SUFFIX = ".kvh"
FLEET_SUFFIX = ".kvp"
CLAIMED_DIR = "claimed"
_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1
# Leaf dtypes a bundle may carry: KV pages (floats) + key material /
# tables (unsigned and signed 32-bit).  int64 is rejected by
# construction — nothing 64-bit belongs on this wire.
_WIRE_DTYPES = (
    "float32", "float16", "bfloat16", "int32", "uint32", "bool",
)


# numpy has no bfloat16 of its own (``ml_dtypes`` registers one where it
# is installed; the port does not need it).  Without it a bfloat16 leaf
# travels as its raw 16-bit patterns in an array of this dtype: uint16
# whose metadata names the wire dtype.  ``pack_bundle`` writes such a leaf
# as "bfloat16", byte for byte what a numpy bfloat16 array would give, and
# ``unpack_bundle`` returns "bfloat16" leaves in it when numpy cannot name
# the dtype.
BF16_BITS = np.dtype(np.uint16, metadata={"wire_dtype": "bfloat16"})


def wire_dtype_name(dtype) -> str:
    """The wire name of a leaf's numpy dtype (``BF16_BITS`` -> "bfloat16")."""
    return (dtype.metadata or {}).get("wire_dtype", dtype.name)


def _numpy_dtype(name: str):
    try:
        return np.dtype(name)
    except TypeError:
        if name == "bfloat16":
            return BF16_BITS
        raise


def seeds_to_wire(seeds) -> np.ndarray:
    """A request's per-token seed schedule (int64, the port's
    ``harness/generate.py::key_schedule``) as ``[n, 2]`` uint32 (low,
    high) halves: no 64-bit leaf rides the wire, and the halves rebuild
    every seed exactly (:func:`seeds_from_wire`)."""
    bits = np.ascontiguousarray(np.asarray(seeds, np.int64).reshape(-1))
    bits = bits.view(np.uint64)
    return np.stack(
        [(bits & 0xFFFFFFFF).astype(np.uint32),
         (bits >> np.uint64(32)).astype(np.uint32)], axis=1,
    )


def seeds_from_wire(halves) -> np.ndarray:
    """Inverse of :func:`seeds_to_wire`: ``[n]`` int64 seeds."""
    h = np.asarray(halves, np.uint32).reshape(-1, 2).astype(np.uint64)
    return (h[:, 0] | (h[:, 1] << np.uint64(32))).view(np.int64)


class ShipError(ValueError):
    """A bundle that must not be adopted: truncated, corrupt, or
    carrying values that do not fit the wire."""


def _check_int32(value, where: str) -> None:
    """Every integer in bundle metadata must fit int32 (recursing into
    lists/dicts) — the wire-format twin of the ``int32-wire`` lint."""
    if isinstance(value, bool):
        return
    if isinstance(value, int):
        if not _INT32_MIN <= value <= _INT32_MAX:
            raise ShipError(
                f"{where}: {value} does not fit int32 — 64-bit ids are "
                "not wire-safe"
            )
        return
    if isinstance(value, dict):
        for k, v in value.items():
            _check_int32(v, f"{where}.{k}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_int32(v, f"{where}[{i}]")


def pack_bundle(meta: dict, leaves: dict) -> bytes:
    """Serialize ``meta`` + ``{path: ndarray}`` leaves into one
    self-validating byte string (layout in the module docstring).
    Leaves are written in sorted path order — the byte stream is a pure
    function of its contents, so identical bundles are identical
    bytes."""
    _check_int32(meta, "meta")
    manifest = []
    payloads = []
    for path in sorted(leaves):
        arr = np.ascontiguousarray(leaves[path])
        dtype = wire_dtype_name(arr.dtype)
        if dtype not in _WIRE_DTYPES:
            raise ShipError(
                f"leaf {path!r}: dtype {dtype} is not "
                f"wire-safe (allowed: {', '.join(_WIRE_DTYPES)})"
            )
        raw = arr.tobytes()
        manifest.append({
            "path": path,
            "dtype": dtype,
            "shape": list(arr.shape),
            "nbytes": len(raw),
            "crc32": zlib.crc32(raw),
        })
        payloads.append(raw)
    header = json.dumps(
        {"version": WIRE_VERSION, "meta": meta, "leaves": manifest},
        sort_keys=True,
    ).encode("utf-8")
    body = b"".join(
        [MAGIC, struct.pack("<I", len(header)), header, *payloads]
    )
    trailer = struct.pack("<I", zlib.crc32(body))
    total = len(body) + len(trailer) + 8
    return body + trailer + struct.pack("<Q", total)


def unpack_bundle(data: bytes) -> tuple:
    """Parse + validate a :func:`pack_bundle` byte string; returns
    ``(meta, {path: ndarray})``.  Raises :class:`ShipError` on ANY
    defect — wrong magic/version, truncation (length fields vs actual
    bytes), or corruption (trailer or per-leaf crc mismatch)."""
    if len(data) < len(MAGIC) + 4 + 4 + 8:
        raise ShipError(f"bundle truncated: {len(data)} bytes")
    if data[: len(MAGIC)] != MAGIC:
        raise ShipError("bad magic: not a KV handoff bundle")
    (total,) = struct.unpack("<Q", data[-8:])
    if total != len(data):
        raise ShipError(
            f"bundle truncated: trailer says {total} bytes, "
            f"have {len(data)}"
        )
    body, (crc,) = data[:-12], struct.unpack("<I", data[-12:-8])
    if zlib.crc32(body) != crc:
        raise ShipError("bundle corrupt: trailer crc mismatch")
    (hlen,) = struct.unpack(
        "<I", data[len(MAGIC): len(MAGIC) + 4]
    )
    hstart = len(MAGIC) + 4
    if hstart + hlen > len(body):
        raise ShipError("bundle truncated: header overruns payload")
    try:
        header = json.loads(data[hstart: hstart + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ShipError(f"bundle corrupt: header not JSON ({e})") from e
    if header.get("version") != WIRE_VERSION:
        raise ShipError(
            f"unsupported wire version {header.get('version')!r} "
            f"(this build speaks {WIRE_VERSION})"
        )
    leaves = {}
    off = hstart + hlen
    for entry in header["leaves"]:
        raw = body[off: off + entry["nbytes"]]
        if len(raw) != entry["nbytes"]:
            raise ShipError(
                f"leaf {entry['path']!r} truncated: want "
                f"{entry['nbytes']} bytes, have {len(raw)}"
            )
        if zlib.crc32(raw) != entry["crc32"]:
            raise ShipError(f"leaf {entry['path']!r} corrupt: crc mismatch")
        if entry["dtype"] not in _WIRE_DTYPES:
            raise ShipError(
                f"leaf {entry['path']!r}: dtype {entry['dtype']!r} is "
                "not wire-safe"
            )
        arr = np.frombuffer(raw, dtype=_numpy_dtype(entry["dtype"]))
        leaves[entry["path"]] = arr.reshape(entry["shape"])
        off += entry["nbytes"]
    if off != len(body):
        raise ShipError(
            f"bundle corrupt: {len(body) - off} trailing payload bytes"
        )
    return header["meta"], leaves


# --------------------------------------------------------------------------
# Handoff protocol (prefill replica -> decode replica)
# --------------------------------------------------------------------------


def bundle_name(request_id: int) -> str:
    return f"ship-{int(request_id):08d}{BUNDLE_SUFFIX}"


def _publish(path: str, data: bytes, chunk_bytes: int) -> None:
    """tmp + atomic rename; the tmp file is unconditionally cleaned up
    in ``finally`` when the rename did not happen (a crashed publisher
    must not strand half-written bundles for claimants to trip on)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    done = False
    try:
        with open(tmp, "wb") as f:
            for lo in range(0, len(data), chunk_bytes):
                f.write(data[lo: lo + chunk_bytes])
        os.replace(tmp, path)
        done = True
    finally:
        if not done:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def publish_bundle(
    handoff_dir: str, request_id: int, data: bytes,
    chunk_bytes: int = 1 << 20,
) -> str:
    """Make one packed bundle claimable as ``ship-<rid>.kvh`` under
    ``handoff_dir``.  ``chunk_bytes`` bounds each write syscall (the
    ship-chunking knob — payloads stream out in page-sized slices
    instead of one giant write).  Returns the published path."""
    os.makedirs(handoff_dir, exist_ok=True)
    path = os.path.join(handoff_dir, bundle_name(request_id))
    _publish(path, data, max(1, int(chunk_bytes)))
    return path


def claim_bundle(handoff_dir: str, replica: int):
    """Claim the oldest unclaimed bundle, or None.  The atomic rename
    into ``claimed/`` is the exactly-once guarantee — losing the race
    to a peer decode replica is a skip, never an error.  Returns
    ``(name, meta, leaves)`` for the claimed bundle; a bundle that
    fails validation raises :class:`ShipError` (publish is atomic, so
    a corrupt claim is a real defect, not a torn read)."""
    claimed_dir = os.path.join(handoff_dir, CLAIMED_DIR)
    try:
        names = sorted(os.listdir(handoff_dir))
    except FileNotFoundError:
        return None
    for name in names:
        if not (name.startswith("ship-") and name.endswith(BUNDLE_SUFFIX)):
            continue
        os.makedirs(claimed_dir, exist_ok=True)
        dst = os.path.join(claimed_dir, f"{name}.p{replica}")
        try:
            os.rename(os.path.join(handoff_dir, name), dst)
        except OSError:
            continue  # peer won the race
        with open(dst, "rb") as f:
            meta, leaves = unpack_bundle(f.read())
        return name, meta, leaves
    return None


def unclaim_bundle(handoff_dir: str, name: str, replica: int) -> None:
    """Hand a claimed-but-not-adopted bundle back (SIGTERM won the race
    between claim and adopt) for a surviving decode replica."""
    try:
        os.rename(
            os.path.join(handoff_dir, CLAIMED_DIR, f"{name}.p{replica}"),
            os.path.join(handoff_dir, name),
        )
    except OSError:
        pass


def mark_prefill_done(handoff_dir: str, replica: int) -> None:
    """Publish this prefill replica's no-more-bundles marker.  Decode
    replicas exit only once EVERY prefill replica has marked done AND
    nothing is left to claim — otherwise "handoff dir empty" is
    indistinguishable from "prefill still working"."""
    os.makedirs(handoff_dir, exist_ok=True)
    _publish(
        os.path.join(handoff_dir, f"PREFILL_DONE.p{replica}"), b"", 1 << 20
    )


def prefill_done_count(handoff_dir: str) -> int:
    try:
        return sum(
            1 for n in os.listdir(handoff_dir)
            if n.startswith("PREFILL_DONE.p")
        )
    except FileNotFoundError:
        return 0


# --------------------------------------------------------------------------
# Fleet-wide prefix index
# --------------------------------------------------------------------------


class FleetPrefixIndex:
    """Shared content-addressed index of resident prefix pages.

    One file per (prefix-chain, page): ``page-<digest>.kvp``, a packed
    single-page bundle whose digest hashes the page's ENTIRE token
    prefix — so two different prompts sharing their first k pages share
    their first k index entries, and a lookup walk stops at the first
    absent digest exactly like the radix trie stops at the first
    missing child.  All mutation is publish-if-absent via tmp + rename;
    every read tolerates concurrent eviction (ENOENT = miss).
    """

    def __init__(self, root: str, page_tokens: int,
                 max_entries=None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}"
            )
        self.root = root
        self.page_tokens = int(page_tokens)
        self.max_entries = max_entries
        os.makedirs(root, exist_ok=True)

    def chain_digests(self, pages: list) -> list:
        """sha256 chain over page token tuples: digest(i) commits to
        every token of pages[0..i], so a digest IS its full prefix."""
        out = []
        prev = b"dtm-fleet-1:%d" % self.page_tokens
        for page in pages:
            h = hashlib.sha256(prev)
            for tok in page:
                _check_int32(int(tok), "fleet page token")
                h.update(struct.pack("<i", int(tok)))
            prev = h.digest()
            out.append(h.hexdigest())
        return out

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, f"page-{digest}{FLEET_SUFFIX}")

    def advertise(self, pages: list, leaves_per_page: list,
                  chunk_bytes: int = 1 << 20) -> int:
        """Publish ``pages`` (token tuples) with their KV leaves
        (``leaves_per_page[i]`` = ``{path: [page_tokens, ...]}``).
        Publish-if-absent: an already-advertised digest is skipped, so
        concurrent twins dedupe.  Returns entries actually published."""
        published = 0
        for digest, page, leaves in zip(
            self.chain_digests(pages), pages, leaves_per_page
        ):
            path = self._path(digest)
            if os.path.exists(path):
                continue
            data = pack_bundle(
                {"kind": "fleet-page", "tokens": [int(t) for t in page],
                 "page_tokens": self.page_tokens},
                leaves,
            )
            _publish(path, data, max(1, int(chunk_bytes)))
            published += 1
        if self.max_entries is not None:
            self.evict(self.max_entries)
        return published

    def any_missing(self, pages: list) -> bool:
        """True if ANY of ``pages``'s chain digests is unadvertised —
        the cheap pre-check that lets steady-state repeat traffic skip
        the gather/pack entirely (a race losing against a concurrent
        advertiser only costs a redundant publish-if-absent)."""
        return any(
            not os.path.exists(self._path(d))
            for d in self.chain_digests(pages)
        )

    def lookup(self, pages: list) -> list:
        """KV leaves for the longest advertised prefix of ``pages`` —
        ``[{path: ndarray}, ...]``, possibly empty.  A vanished or
        corrupt entry ends the walk as a miss (eviction races are
        capacity events, never errors)."""
        found = []
        for digest in self.chain_digests(pages):
            try:
                with open(self._path(digest), "rb") as f:
                    meta, leaves = unpack_bundle(f.read())
            except (OSError, ShipError):
                break
            if meta.get("page_tokens") != self.page_tokens:
                break
            found.append(leaves)
        return found

    def entry_count(self) -> int:
        try:
            return sum(
                1 for n in os.listdir(self.root)
                if n.startswith("page-") and n.endswith(FLEET_SUFFIX)
            )
        except FileNotFoundError:
            return 0

    def evict(self, down_to: int) -> int:
        """Drop oldest-mtime entries until at most ``down_to`` remain.
        Concurrent evictors double-delete benignly (ENOENT skips), and
        a reader losing its entry mid-walk just misses."""
        try:
            names = [
                n for n in os.listdir(self.root)
                if n.startswith("page-") and n.endswith(FLEET_SUFFIX)
            ]
        except FileNotFoundError:
            return 0
        stamped = []
        for n in names:
            try:
                stamped.append((os.path.getmtime(os.path.join(self.root, n)), n))
            except OSError:
                continue  # a peer evicted it first
        stamped.sort()
        evicted = 0
        excess = len(stamped) - max(0, int(down_to))
        for _, n in stamped[:max(0, excess)]:
            try:
                os.unlink(os.path.join(self.root, n))
                evicted += 1
            except OSError:
                continue
        return evicted


# --------------------------------------------------------------------------
# Cross-process clock rebase (telemetry attribution only)
# --------------------------------------------------------------------------


def wall_of_mono(t_mono: float) -> float:
    """This process's ``perf_counter`` stamp as wall time, for stamps
    that must travel across a process boundary."""
    return t_mono + (time.time() - time.perf_counter())


def mono_of_wall(t_wall: float) -> float:
    """A travelled wall stamp rebased into THIS process's
    ``perf_counter`` frame (valid on one machine — the file-queue
    fleet's scope), so a decode replica can cut queue/prefill/ship
    spans from the same clock its TTFT timer reads."""
    return t_wall - (time.time() - time.perf_counter())
