"""The port's KV-shipping wire layer (``serving/shipping.py``) against the
JAX package's.

The port's module is a copy; everything here is exact (bytes, digests,
claims, tokens), no tolerance:

- ``pack_bundle`` gives the JAX ``pack_bundle``'s bytes for the same
  ``(meta, leaves)``, every wire dtype included; a port bundle unpacks
  under the JAX package and a JAX bundle under the port;
- a bfloat16 leaf travels as its bit patterns in ``BF16_BITS`` (numpy has
  no bfloat16 of its own) and packs to the bytes of the same values as an
  ``ml_dtypes`` bfloat16 array under the JAX package;
- the port's int64 seed schedule (``harness/generate.py::key_schedule``)
  crosses the wire as uint32 halves and comes back exactly;
- the rejections (64-bit metadata, non-wire dtypes, truncation,
  corruption, wrong version), the exactly-once claim protocol, the
  prefill-done markers and the fleet prefix index behave as the JAX
  package's tests pin, and the two packages read each other's fleet
  entries.
"""

import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.serving import shipping as jship
from distributed_tensorflow_models_tpu_torch.harness.generate import (
    key_schedule,
)
from distributed_tensorflow_models_tpu_torch.serving import shipping
from distributed_tensorflow_models_tpu_torch.serving.shipping import (
    BF16_BITS,
    FleetPrefixIndex,
    ShipError,
    bundle_name,
    claim_bundle,
    mark_prefill_done,
    pack_bundle,
    prefill_done_count,
    publish_bundle,
    unclaim_bundle,
    unpack_bundle,
)


def _leaves():
    return {
        "layers/0/k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        "layers/0/v": np.ones((2, 3, 4), np.float16),
        "tables": np.arange(6, dtype=np.int32).reshape(2, 3),
        "keys": np.arange(6, dtype=np.uint32).reshape(3, 2) * 2**30,
        "mask": np.array([True, False, True]),
    }


META = {
    "kind": "request",
    "request_id": 7,
    "prompt": [1, 2, 3],
    "nested": {"cached_len": 0, "flags": [1, 0, 1]},
    "t_submit_wall": 1792287583.25,
    "eos_id": None,
}

BUNDLES = {
    "leaves": (META, _leaves()),
    "meta_only": ({"kind": "request", "request_id": 2**31 - 1}, {}),
    "empty": ({}, {}),
    "one_page": ({"kind": "fleet-page", "tokens": [4, 5], "page_tokens": 2},
                 {"k": np.full((2, 4), 0.5, np.float32)}),
}


# --------------------------------------------------------------------------
# Wire format
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(BUNDLES))
def test_pack_bundle_bytes_equal_the_jax_package(case):
    meta, leaves = BUNDLES[case]
    data = pack_bundle(meta, leaves)
    assert data == jship.pack_bundle(meta, leaves)
    # Each package reads the other's bundle.
    for unpack in (unpack_bundle, jship.unpack_bundle):
        got_meta, got = unpack(data)
        assert got_meta == meta and sorted(got) == sorted(leaves)
        for path, want in leaves.items():
            assert got[path].dtype == want.dtype
            assert np.array_equal(got[path], want)


def test_bf16_bits_pack_as_the_jax_bfloat16_leaf():
    rs = np.random.RandomState(0)
    values = rs.standard_normal((3, 16, 2, 8)).astype(ml_dtypes.bfloat16)
    bits = values.view(np.uint16).view(BF16_BITS)
    assert shipping.wire_dtype_name(bits.dtype) == "bfloat16"
    data = pack_bundle({"request_id": 1}, {"pages": bits})
    assert data == jship.pack_bundle({"request_id": 1}, {"pages": values})
    # From torch: the engine's own route to the host.
    t = torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16)
    host = t.view(torch.int16).numpy().view(BF16_BITS)
    assert pack_bundle({"request_id": 1}, {"pages": host}) == data
    _, leaves = unpack_bundle(data)
    got = leaves["pages"]
    # ml_dtypes is loaded here (the JAX package imports it), so numpy can
    # name the dtype; the bits are the same either way.
    assert got.dtype.itemsize == 2
    assert np.array_equal(got.view(np.uint16), values.view(np.uint16))


def test_bf16_leaf_without_a_numpy_bfloat16(monkeypatch):
    """Where numpy cannot name bfloat16 (no ml_dtypes), unpack returns the
    leaf's bits in ``BF16_BITS``, which packs back to the same bytes."""
    real = np.dtype

    def no_bf16(name, *a, **kw):
        if name == "bfloat16":
            raise TypeError("data type 'bfloat16' not understood")
        return real(name, *a, **kw)

    values = np.arange(12, dtype=np.float32).astype(ml_dtypes.bfloat16)
    data = jship.pack_bundle({}, {"p": values.reshape(3, 4)})
    monkeypatch.setattr(shipping.np, "dtype", no_bf16)
    _, leaves = unpack_bundle(data)
    monkeypatch.undo()
    got = leaves["p"]
    assert got.dtype == BF16_BITS and got.dtype.metadata == {
        "wire_dtype": "bfloat16"}
    assert np.array_equal(got.view(np.uint16),
                          values.view(np.uint16).reshape(3, 4))
    assert pack_bundle({}, {"p": got}) == data


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**40 + 3])
def test_seed_schedule_crosses_the_wire_exactly(seed):
    """int64 seeds up to 2^62 ride as ``[n, 2]`` uint32 halves (the wire
    rejects 64-bit leaves) and come back bit for bit."""
    seeds = np.asarray(key_schedule(seed, 33), np.int64)
    assert seeds.max() > 2**32  # the high half matters
    with pytest.raises(ShipError, match="wire-safe"):
        pack_bundle({}, {"__keydata__": seeds})
    halves = shipping.seeds_to_wire(seeds)
    assert halves.dtype == np.uint32 and halves.shape == (33, 2)
    _, leaves = unpack_bundle(pack_bundle({}, {"__keydata__": halves}))
    back = shipping.seeds_from_wire(leaves["__keydata__"])
    assert back.dtype == np.int64
    assert back.tolist() == seeds.tolist()


def test_wire_roundtrip_bit_exact():
    data = pack_bundle(META, _leaves())
    meta, leaves = unpack_bundle(data)
    assert meta == META
    for path, want in _leaves().items():
        assert leaves[path].dtype == want.dtype
        assert np.array_equal(leaves[path], want)
    assert pack_bundle(META, _leaves()) == data


@pytest.mark.parametrize("meta", [
    {"page_id": 1 << 40},
    {"ids": [1, 2, {"deep": -(1 << 35)}]},
    {"seed": 2**31},
])
def test_wire_rejects_int64_meta(meta):
    for pack in (pack_bundle, jship.pack_bundle):
        with pytest.raises(ValueError, match="int32"):
            pack(meta, {})
    pack_bundle({"ok": True, "lo": -(2**31), "hi": 2**31 - 1}, {})


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.uint64,
                                   np.int16])
def test_wire_rejects_non_wire_dtypes(dtype):
    for pack in (pack_bundle, jship.pack_bundle):
        with pytest.raises(ValueError, match="wire-safe"):
            pack({}, {"pages": np.arange(4, dtype=dtype)})


def test_wire_rejects_truncation_at_every_cut():
    data = pack_bundle(META, _leaves())
    for cut in (0, 1, len(shipping.MAGIC), len(data) // 2, len(data) - 1):
        with pytest.raises(ShipError):
            unpack_bundle(data[:cut])
    with pytest.raises(ShipError):
        unpack_bundle(data + b"\0")


def test_wire_rejects_corruption_anywhere():
    data = pack_bundle(META, _leaves())
    for pos in (0, len(shipping.MAGIC) + 6, len(data) // 2, len(data) - 9):
        corrupt = bytearray(data)
        corrupt[pos] ^= 0xFF
        with pytest.raises(ShipError):
            unpack_bundle(bytes(corrupt))


def test_wire_rejects_wrong_version(monkeypatch):
    monkeypatch.setattr(shipping, "WIRE_VERSION", shipping.WIRE_VERSION + 1)
    data = pack_bundle(META, _leaves())
    monkeypatch.undo()
    with pytest.raises(ShipError, match="version"):
        unpack_bundle(data)


# --------------------------------------------------------------------------
# Handoff protocol
# --------------------------------------------------------------------------


def test_publish_claim_roundtrip_across_packages(tmp_path):
    handoff = str(tmp_path / "handoff")
    data = pack_bundle(META, _leaves())
    path = publish_bundle(handoff, META["request_id"], data, chunk_bytes=7)
    assert os.path.basename(path) == bundle_name(META["request_id"]) == (
        jship.bundle_name(META["request_id"]))
    assert not [n for n in os.listdir(handoff) if n.endswith(".tmp")]
    got = jship.claim_bundle(handoff, replica=1)  # the JAX side claims
    assert got is not None and got[1] == META
    assert claim_bundle(handoff, replica=2) is None
    jship.publish_bundle(handoff, 8, jship.pack_bundle({"request_id": 8}, {}))
    name, meta, leaves = claim_bundle(handoff, replica=2)
    assert name == bundle_name(8) and meta == {"request_id": 8}
    assert leaves == {}


def test_claims_are_exactly_once_under_concurrency(tmp_path):
    handoff = str(tmp_path / "handoff")
    n_bundles, n_replicas = 24, 4
    for rid in range(n_bundles):
        publish_bundle(handoff, rid, pack_bundle({"request_id": rid}, {}))
    claimed: list = [[] for _ in range(n_replicas)]
    barrier = threading.Barrier(n_replicas)

    def run(replica):
        barrier.wait()
        while True:
            got = claim_bundle(handoff, replica)
            if got is None:
                return
            claimed[replica].append(got[1]["request_id"])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_replicas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(r for per in claimed for r in per) == list(range(n_bundles))
    assert len(os.listdir(os.path.join(handoff, shipping.CLAIMED_DIR))) == (
        n_bundles)


def test_unclaim_returns_bundle_to_pool(tmp_path):
    handoff = str(tmp_path / "handoff")
    publish_bundle(handoff, 3, pack_bundle({"request_id": 3}, {}))
    name, _, _ = claim_bundle(handoff, replica=0)
    assert claim_bundle(handoff, replica=1) is None
    unclaim_bundle(handoff, name, replica=0)
    got = claim_bundle(handoff, replica=1)
    assert got is not None and got[1]["request_id"] == 3


def test_prefill_done_markers_idempotent(tmp_path):
    handoff = str(tmp_path / "handoff")
    assert prefill_done_count(handoff) == 0
    mark_prefill_done(handoff, 0)
    mark_prefill_done(handoff, 0)
    assert prefill_done_count(handoff) == 1
    jship.mark_prefill_done(handoff, 1)
    assert prefill_done_count(handoff) == jship.prefill_done_count(
        handoff) == 2
    assert claim_bundle(handoff, replica=0) is None


# --------------------------------------------------------------------------
# Fleet-wide prefix index
# --------------------------------------------------------------------------


def _page_leaves(fill):
    return {"k": np.full((2, 4), fill, np.float32),
            "v": np.full((2, 4), -fill, np.float32)}


@pytest.mark.parametrize("page_tokens,pages", [
    (2, [(1, 2), (3, 4)]),
    (2, [(1, 2), (3, 5)]),
    (4, [(1, 2, 3, 4)]),
    (16, [tuple(range(16)), tuple(range(16, 32))]),
])
def test_fleet_chain_digests_equal_the_jax_index(tmp_path, page_tokens,
                                                 pages):
    idx = FleetPrefixIndex(str(tmp_path / "a"), page_tokens=page_tokens)
    jidx = jship.FleetPrefixIndex(str(tmp_path / "b"), page_tokens)
    assert idx.chain_digests(pages) == jidx.chain_digests(pages)


def test_fleet_chain_digest_commits_to_full_prefix(tmp_path):
    idx = FleetPrefixIndex(str(tmp_path / "fleet"), page_tokens=2)
    a = idx.chain_digests([(1, 2), (3, 4)])
    b = idx.chain_digests([(1, 2), (3, 5)])
    c = idx.chain_digests([(9, 2), (3, 4)])
    assert a[0] == b[0] and a[1] != b[1]
    assert a[0] != c[0] and a[1] != c[1]
    other = FleetPrefixIndex(str(tmp_path / "fleet2"), page_tokens=4)
    assert other.chain_digests([(1, 2)]) != idx.chain_digests([(1, 2)])


def test_fleet_advertise_lookup_across_packages(tmp_path):
    """Entries the port advertises are the JAX index's files, byte for
    byte, and each package looks up the other's."""
    root = str(tmp_path / "fleet")
    idx = FleetPrefixIndex(root, page_tokens=2)
    jidx = jship.FleetPrefixIndex(str(tmp_path / "jfleet"), 2)
    pages = [(1, 2), (3, 4)]
    leaves = [_page_leaves(0.5), _page_leaves(1.5)]
    assert idx.any_missing(pages)
    assert idx.advertise(pages, leaves) == 2
    assert jidx.advertise(pages, leaves) == 2
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f, open(
                os.path.join(jidx.root, name), "rb") as g:
            assert f.read() == g.read()
    assert not idx.any_missing(pages) and idx.entry_count() == 2
    assert idx.advertise(pages, leaves) == 0
    found = jship.FleetPrefixIndex(root, 2).lookup(pages)
    assert len(found) == 2 and np.array_equal(found[1]["k"], leaves[1]["k"])
    assert len(idx.lookup([(1, 2), (9, 9)])) == 1
    assert idx.lookup([(7, 7)]) == []


def test_fleet_rejects_int64_tokens(tmp_path):
    idx = FleetPrefixIndex(str(tmp_path / "fleet"), page_tokens=2)
    with pytest.raises(ShipError, match="int32"):
        idx.chain_digests([(1, 1 << 40)])


def test_fleet_eviction_reads_as_miss(tmp_path):
    idx = FleetPrefixIndex(str(tmp_path / "fleet"), page_tokens=2)
    pages = [(i, i + 1) for i in range(0, 8, 2)]
    leaves = [_page_leaves(float(i)) for i in range(4)]
    assert idx.advertise(pages, leaves) == 4
    assert idx.evict(down_to=2) == 2
    assert idx.entry_count() == 2
    assert len(idx.lookup(pages)) <= 2
    for name in os.listdir(idx.root):
        os.unlink(os.path.join(idx.root, name))
    assert idx.lookup(pages) == []
    assert idx.evict(down_to=0) == 0


def test_fleet_capacity_bound_applied_on_advertise(tmp_path):
    idx = FleetPrefixIndex(str(tmp_path / "fleet"), page_tokens=2,
                           max_entries=3)
    for i in range(5):
        idx.advertise([(10 * i, 10 * i + 1)], [_page_leaves(float(i))])
    assert idx.entry_count() <= 3


def test_fleet_concurrent_advertise_dedupes(tmp_path):
    idx = FleetPrefixIndex(str(tmp_path / "fleet"), page_tokens=2)
    pages = [(1, 2), (3, 4), (5, 6)]
    leaves = [_page_leaves(float(i)) for i in range(3)]
    barrier = threading.Barrier(4)

    def run():
        barrier.wait()
        idx.advertise(pages, leaves)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert idx.entry_count() == 3 and len(idx.lookup(pages)) == 3


def test_clock_rebase_is_inverse_within_tolerance():
    """Within 0.05 s (the JAX test's bound): two clock reads apart."""
    import time

    t = time.perf_counter()
    assert abs(shipping.mono_of_wall(shipping.wall_of_mono(t)) - t) < 0.05
