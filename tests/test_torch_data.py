"""The port's data modules against the JAX package's, byte for byte.

The same inputs, made from numpy seeds, go through both packages; every
comparison is exact equality (host-side logic: container bytes, cursors,
batches, augmentation), except the batched torch augmentation, whose
float reductions are held to f32 round-off.

- TFRecord files and ``tf.train.Example`` bytes in both directions, the
  CRC32C and the sharded iterator's resume;
- the native reader's ``native=True`` contract;
- each numpy ``augment`` function, and the torch batch helpers;
- the ``ArrayDataset``, MNIST, CIFAR-10, synthetic ImageNet and PTB
  streams with process shards and a ``set_state`` resume;
- ``ImageNetTFRecordDataset`` train and eval on records written here, and
  both packages' ``build_dataset`` on them (fault F2);
- the cursor re-split and the telemetry registry.
"""

import itertools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a share under xdist)

from distributed_tensorflow_models_tpu.data import augment as jaug
from distributed_tensorflow_models_tpu.data import datasets as jdata
from distributed_tensorflow_models_tpu.data import example_proto as jex
from distributed_tensorflow_models_tpu.data import resplit as jresplit
from distributed_tensorflow_models_tpu.data import tfrecord as jrec
from distributed_tensorflow_models_tpu.harness import config as jconfig
from distributed_tensorflow_models_tpu.harness import train as jtrain
from distributed_tensorflow_models_tpu.telemetry import registry as jreg
from distributed_tensorflow_models_tpu_torch.data import augment as taug
from distributed_tensorflow_models_tpu_torch.data import datasets as tdata
from distributed_tensorflow_models_tpu_torch.data import example_proto as tex
from distributed_tensorflow_models_tpu_torch.data import native_loader
from distributed_tensorflow_models_tpu_torch.data import resplit as tresplit
from distributed_tensorflow_models_tpu_torch.data import tfrecord as trec
from distributed_tensorflow_models_tpu_torch.harness import config as tconfig
from distributed_tensorflow_models_tpu_torch.harness import train as ttrain
from distributed_tensorflow_models_tpu_torch.telemetry import registry as treg


def _assert_batches_equal(got, want, msg=""):
    assert sorted(got) == sorted(want), msg
    for k in want:
        assert got[k].dtype == want[k].dtype, f"{msg} {k}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


def _assert_streams_equal(tds, jds, n, msg=""):
    """``n`` batches of both datasets equal, and the cursor after each."""
    for i, (tb, jb) in enumerate(itertools.islice(zip(iter(tds), iter(jds)),
                                                  n)):
        _assert_batches_equal(tb, jb, f"{msg} batch {i}")
        assert tds.get_state() == jds.get_state(), f"{msg} batch {i}"


# --------------------------------------------------------------------------
# Container and wire formats
# --------------------------------------------------------------------------


def _payloads(seed=0, n=7):
    rs = np.random.RandomState(seed)
    return [rs.bytes(int(k)) for k in rs.randint(0, 300, n)] + [b""]


def test_crc32c_equals_jax():
    for data in _payloads(1) + [b"123456789", bytes(range(256))]:
        assert trec.crc32c(data) == jrec.crc32c(data)
        assert trec.masked_crc32c(data) == jrec.masked_crc32c(data)
    assert trec.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfrecord_files_equal_jax_both_ways(tmp_path, writer):
    """A file written by one package is the other's byte for byte, and
    each package reads back the other's records."""
    recs = _payloads(2)
    mine, theirs = (trec, jrec) if writer == "port" else (jrec, trec)
    a, b = tmp_path / "a.tfrecord", tmp_path / "b.tfrecord"
    assert mine.write_records(a, recs) == len(recs)
    theirs.write_records(b, recs)
    assert a.read_bytes() == b.read_bytes()
    assert list(theirs.read_records(a)) == recs
    assert list(mine.read_records(b)) == recs


def test_tfrecord_corruption_raises_like_jax(tmp_path):
    p = tmp_path / "bad.tfrecord"
    trec.write_records(p, [b"hello world"])
    raw = bytearray(p.read_bytes())
    raw[14] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(trec.CorruptRecordError, match="bad data CRC"):
        list(trec.read_records(p))
    with pytest.raises(jrec.CorruptRecordError, match="bad data CRC"):
        list(jrec.read_records(p))


def _write_shards(tmp_path, n_shards=3, per_shard=5):
    paths = []
    for s in range(n_shards):
        p = str(tmp_path / f"shard-{s:05d}")
        trec.write_records(p, [f"{s}:{i}".encode() for i in range(per_shard)])
        paths.append(p)
    return paths


@pytest.mark.parametrize("native", [False, None])
def test_sharded_iterator_and_resume_equal_jax(tmp_path, native):
    """The seeded shard order, the records and the cursor after each, over
    three epochs; then a resume from a mid-shard state."""
    paths = _write_shards(tmp_path)
    kw = dict(shuffle_shards=True, seed=4, native=native)
    t, j = trec.ShardedRecordIterator(paths, **kw), jrec.ShardedRecordIterator(
        paths, **kw)
    for n, (tr, jr) in enumerate(itertools.islice(zip(iter(t), iter(j)), 45)):
        assert tr == jr, n
        assert t.get_state() == j.get_state(), n
    state = {"epoch": 1, "shard_idx": 1, "record_idx": 3}
    t2, j2 = trec.ShardedRecordIterator(paths, **kw), jrec.ShardedRecordIterator(
        paths, **kw)
    t2.set_state(state)
    j2.set_state(state)
    assert (list(itertools.islice(iter(t2), 12))
            == list(itertools.islice(iter(j2), 12)))
    one = trec.ShardedRecordIterator(paths, shuffle_shards=False,
                                     num_epochs=1, native=native)
    assert len(list(one)) == 15


def test_native_true_raises_without_the_library(tmp_path, monkeypatch):
    paths = _write_shards(tmp_path, 1, 2)
    monkeypatch.setattr(native_loader, "_LIB_PATHS",
                        [str(tmp_path / "missing.so")])
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_TRIED", False)
    assert not native_loader.available()
    with pytest.raises(RuntimeError, match="native=True"):
        list(trec.ShardedRecordIterator(paths, native=True))
    # native=None falls back to the pure-Python reader.
    assert len(list(trec.ShardedRecordIterator(
        paths, native=None, num_epochs=1))) == 2


def test_native_reader_matches_python_reader(tmp_path):
    """Where the native library is built, the port's binding reads the
    records and CRCs the pure-Python reader does; where it is not, asking
    for it raises."""
    p = str(tmp_path / "a.tfrecord")
    recs = _payloads(3)
    trec.write_records(p, recs)
    if native_loader.available():
        assert native_loader.read_all_records(p) == recs
        for data in recs:
            assert native_loader.crc32c(data) == trec.crc32c(data)
    else:
        with pytest.raises(RuntimeError, match="native=True"):
            list(trec.ShardedRecordIterator([p], native=True))


_FEATURES = {
    "image/encoded": [b"\xff\xd8 not really a jpeg", b""],
    "image/class/label": [7],
    "ints": [0, -1, 2**40, -(2**62)],
    "floats": [0.5, -1.25, 3.0e10],
    "np_scalars": [np.int64(5), np.int32(-3)],
    "np_floats": np.array([1.5, 2.25], np.float32),
    "empty_bytes": [b"x"],
}


def test_example_bytes_equal_jax_both_ways():
    tb, jb = tex.build_example(_FEATURES), jex.build_example(_FEATURES)
    assert tb == jb
    got, want = tex.parse_example(jb), jex.parse_example(tb)
    assert got == want
    assert got["image/class/label"] == [7]
    assert got["ints"] == [0, -1, 2**40, -(2**62)]


# --------------------------------------------------------------------------
# Augmentation
# --------------------------------------------------------------------------


def _image(seed, h=37, w=45, c=3, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return (rs.rand(h, w, c) * 255).astype(np.uint8)
    return rs.rand(h, w, c).astype(dtype)


def _rng(seed=0):
    return np.random.default_rng(seed)


AUGMENT_CASES = {
    "per_image_standardization":
        lambda m: m.per_image_standardization(_image(0)),
    "random_flip_left_right":
        lambda m: [m.random_flip_left_right(_image(1), _rng(s))
                   for s in range(4)],
    "random_crop": lambda m: m.random_crop(_image(2), _rng(1), 20, 31),
    "central_crop": lambda m: m.central_crop(_image(3), 0.875),
    "preprocess_cifar_train":
        lambda m: m.preprocess_cifar_train(_image(4, 32, 32, 3, np.float32),
                                           _rng(2)),
    "preprocess_cifar_eval":
        lambda m: m.preprocess_cifar_eval(_image(5, 32, 32, 3, np.float32)),
    "sample_distorted_bounding_box":
        lambda m: [m.sample_distorted_bounding_box(
            (37, 45), _rng(s), bbox=np.array([0.1, 0.2, 0.7, 0.9],
                                             np.float32))
            for s in range(5)],
    "resize_bilinear": lambda m: m.resize_bilinear(_image(6), 29, 33),
    "distort_color": lambda m: [m.distort_color(_image(7, dtype=np.float32),
                                                _rng(3), ordering)
                                for ordering in (0, 1)],
    "preprocess_imagenet_train":
        lambda m: m.preprocess_imagenet_train(_image(8, 60, 80), _rng(4),
                                              size=32),
    "preprocess_imagenet_eval":
        lambda m: m.preprocess_imagenet_eval(_image(9, 60, 80), size=32),
    "encode_decode_jpeg":
        lambda m: [m.encode_jpeg(_image(10)),
                   m.decode_jpeg(jaug.encode_jpeg(_image(10)))],
}


@pytest.mark.parametrize("name", sorted(AUGMENT_CASES))
def test_numpy_augment_equals_jax(name):
    got, want = AUGMENT_CASES[name](taug), AUGMENT_CASES[name](jaug)
    if not isinstance(want, list):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (bytes, tuple)):
            assert g == w
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_torch_standardization_equals_jax():
    imgs = np.random.RandomState(0).rand(3, 8, 9, 3).astype(np.float32) * 40
    got = taug.torch_per_image_standardization(torch.from_numpy(imgs))
    want = np.asarray(jaug.jax_per_image_standardization(imgs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The stddev floor of a constant image, as TF's op.
    flat = taug.torch_per_image_standardization(torch.ones(1, 4, 4, 3))
    assert torch.equal(flat, torch.zeros(1, 4, 4, 3))


def test_torch_flip_and_crop_draw_from_the_generator():
    """Each output is the image or its mirror (flip), or the zero-padded
    image's window at an offset in [0, 2 pad] (crop); the same seed gives
    the same draws, and both kinds of draw occur."""
    imgs = torch.arange(6 * 5 * 4 * 2, dtype=torch.float32).reshape(6, 5, 4, 2)
    flips = taug.torch_random_flip(imgs, torch.Generator().manual_seed(1))
    kinds = set()
    for x, y in zip(imgs, flips):
        kinds.add("same" if torch.equal(x, y) else "flip")
        assert torch.equal(y, x) or torch.equal(y, x.flip(1))
    assert kinds == {"same", "flip"}
    assert torch.equal(flips, taug.torch_random_flip(
        imgs, torch.Generator().manual_seed(1)))
    pad = 2
    crops = taug.torch_random_crop_with_pad(
        imgs, torch.Generator().manual_seed(3), pad=pad)
    padded = np.pad(imgs.numpy(), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    offsets = set()
    for i, y in enumerate(crops.numpy()):
        hits = [(t, l) for t in range(2 * pad + 1) for l in range(2 * pad + 1)
                if np.array_equal(y, padded[i, t:t + 5, l:l + 4])]
        assert hits, i
        offsets.add(hits[0])
    assert len(offsets) > 1
    assert torch.equal(crops, taug.torch_random_crop_with_pad(
        imgs, torch.Generator().manual_seed(3), pad=pad))


# --------------------------------------------------------------------------
# Datasets
# --------------------------------------------------------------------------


def _arrays(n=24):
    rs = np.random.RandomState(0)
    return {"image": rs.rand(n, 4, 4, 3).astype(np.float32),
            "label": np.arange(n, dtype=np.int32)}


def _flip_transform(img, rng):
    return img[:, ::-1] * np.float32(rng.random())


@pytest.mark.parametrize("transform", [None, _flip_transform],
                         ids=["plain", "transform"])
@pytest.mark.parametrize("pid,nproc", [(0, 1), (0, 2), (1, 2)])
def test_array_dataset_stream_and_resume_equal_jax(transform, pid, nproc):
    """Five epochs' worth of batches with the per-epoch reshuffle, a
    per-sample transform keyed by global position, and process shards;
    then a resume from the cursor of batch 7."""
    kw = dict(seed=5, transform=transform, process_index=pid,
              process_count=nproc)
    tds = tdata.ArrayDataset(_arrays(), 8, **kw)
    jds = jdata.ArrayDataset(_arrays(), 8, **kw)
    assert tds.batches_per_epoch == jds.batches_per_epoch == 3
    _assert_streams_equal(tds, jds, 15)
    tres, jres = (tdata.ArrayDataset(_arrays(), 8, **kw),
                  jdata.ArrayDataset(_arrays(), 8, **kw))
    tres.set_state({"epoch": 2, "batch_idx": 1})
    jres.set_state({"epoch": 2, "batch_idx": 1})
    _assert_streams_equal(tres, jres, 4, "resumed")


def test_array_dataset_rejects_what_jax_rejects():
    for kw in (dict(process_count=3), dict(process_index=2, process_count=2)):
        for mod in (tdata, jdata):
            with pytest.raises(ValueError):
                mod.ArrayDataset(_arrays(), 8, **kw)
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="mismatched"):
            mod.ArrayDataset({"a": np.zeros(4), "b": np.zeros(5)}, 2)
        with pytest.raises(NotImplementedError):
            mod.ArrayDataset(_arrays(), 7, drop_remainder=False)


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_cifar_streams_equal_jax(name, split):
    """The loaders' synthetic sets (no files under DATA_DIR), CIFAR's
    train augmentation and eval standardization, process shards and a
    resume."""
    make = {"mnist": (tdata.mnist_dataset, jdata.mnist_dataset),
            "cifar10": (tdata.cifar10_dataset, jdata.cifar10_dataset)}[name]
    for pid, nproc in ((0, 1), (1, 2)):
        tds, jds = (m(16, split, 3, process_index=pid, process_count=nproc)
                    for m in make)
        _assert_streams_equal(tds, jds, 3, f"{name} {split} {pid}/{nproc}")
    tds, jds = (m(16, split, 3) for m in make)
    state = {"epoch": 1, "batch_idx": 5}
    tds.set_state(state)
    jds.set_state(state)
    _assert_streams_equal(tds, jds, 2, "resumed")


def test_mnist_cifar_read_npz_from_the_data_dir_like_jax(tmp_path,
                                                         monkeypatch):
    rs = np.random.RandomState(0)
    np.savez(tmp_path / "mnist.npz",
             x_train=rs.randint(0, 256, (16, 28, 28), dtype=np.uint8),
             y_train=rs.randint(0, 10, 16))
    np.savez(tmp_path / "cifar10.npz",
             x_train=rs.randint(0, 256, (16, 32, 32, 3), dtype=np.uint8),
             y_train=rs.randint(0, 10, (16, 1)))
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", str(tmp_path))
    for name in ("mnist", "cifar10"):
        loader = f"load_{name}"
        got, want = getattr(tdata, loader)(), getattr(jdata, loader)()
        assert got[0].shape[0] == 16
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pid,nproc", [(0, 1), (1, 2)])
def test_synthetic_imagenet_and_ptb_shards_equal_jax(pid, nproc):
    proc = dict(process_index=pid, process_count=nproc)
    _assert_streams_equal(
        tdata.synthetic_imagenet_dataset(64, 8, 2, **proc),
        jdata.synthetic_imagenet_dataset(64, 8, 2, **proc), 9, "imagenet")
    tds = tdata.ptb_dataset(8, 35, "train", 1000, **proc)
    jds = jdata.ptb_dataset(8, 35, "train", 1000, **proc)
    assert tds.batches_per_epoch == jds.batches_per_epoch
    tds.set_state({"epoch": 0, "pos": tds.batches_per_epoch - 2})
    jds.set_state({"epoch": 0, "pos": jds.batches_per_epoch - 2})
    _assert_streams_equal(tds, jds, 5, "ptb across an epoch")


def test_ptb_work_split_is_the_stream():
    """``next_work``/``assemble`` reproduce ``__iter__`` (the pool's
    contract) on the port's PTB dataset."""
    a, b = (tdata.PTBDataset(np.arange(400, dtype=np.int32), 4, 7)
            for _ in range(2))
    for want in itertools.islice(iter(a), 30):
        _assert_batches_equal(b.assemble(b.next_work()), want)
    assert a.get_state() == b.get_state()


def _imagenet_records(n, seed, bbox_every=3):
    """``n`` Examples in the inception schema (1-based labels, some with a
    bbox), JPEGs encoded with PIL."""
    rs = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        h, w = rs.randint(24, 48, 2)
        feats = {"image/encoded": [jaug.encode_jpeg(
                     (rs.rand(h, w, 3) * 255).astype(np.uint8))],
                 "image/class/label": [1 + i % 10]}
        if i % bbox_every == 0:
            feats.update({"image/object/bbox/ymin": [0.1],
                          "image/object/bbox/xmin": [0.2],
                          "image/object/bbox/ymax": [0.8],
                          "image/object/bbox/xmax": [0.9]})
        recs.append(tex.build_example(feats))
    return recs


def _write_imagenet(directory, prefix, n_shards, per_shard, seed=0):
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for s in range(n_shards):
        p = str(directory / f"{prefix}-{s:05d}-of-{n_shards:05d}")
        trec.write_records(p, _imagenet_records(per_shard, seed + s))
        paths.append(p)
    return paths


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("pid,nproc,n_shards", [(0, 1, 3), (1, 2, 3),
                                                (1, 4, 3)],
                         ids=["single", "file-sharded", "replicated"])
def test_imagenet_tfrecord_stream_equals_jax(tmp_path, train, pid, nproc,
                                             n_shards):
    """Decode, crop, resize, flip and colour distortion (train) or the
    central crop (eval), per process: file-sharded where there are enough
    shards, replicated rows otherwise; eval's final partial batch (padded
    with label -1 rows across processes); then a resume."""
    paths = _write_imagenet(tmp_path, "train", n_shards, 5)
    kw = dict(train=train, image_size=24, seed=6, label_offset=1,
              process_index=pid, process_count=nproc, native=False)
    tds = tdata.ImageNetTFRecordDataset(paths, 4, **kw)
    jds = jdata.ImageNetTFRecordDataset(paths, 4, **kw)
    n = 6 if train else 10
    got = list(itertools.islice(iter(tds), n))
    want = list(itertools.islice(iter(jds), n))
    assert len(got) == len(want) >= 2
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_batches_equal(g, w, f"batch {i}")
    assert tds.get_state() == jds.get_state()
    if not train:
        assert len(want) < n  # one pass, then the stream ends
    tres, jres = (mod.ImageNetTFRecordDataset(paths, 4, **kw)
                  for mod in (tdata, jdata))
    fresh = tdata.ImageNetTFRecordDataset(paths, 4, **kw)
    next(iter(fresh))
    state = fresh.get_state()
    tres.set_state(state)
    jres.set_state(state)
    for i, (g, w) in enumerate(itertools.islice(zip(iter(tres), iter(jres)),
                                                2)):
        _assert_batches_equal(g, w, f"resumed batch {i}")


def test_imagenet_without_pil_or_cv2_raises(tmp_path, monkeypatch):
    """No synthetic stand-in for records that cannot be decoded: the
    dataset, and build_dataset with shards present, raise ImportError."""
    paths = _write_imagenet(tmp_path / "imagenet", "train", 1, 2)
    monkeypatch.setattr(tdata, "DATA_DIR", str(tmp_path))
    cfg = tconfig.get_config("resnet50_imagenet", global_batch_size=2,
                             image_size=16)
    for missing in ("cv2", "PIL"):
        with monkeypatch.context() as m:
            m.setitem(__import__("sys").modules, missing, None)
            with pytest.raises(ImportError, match="ImageNet records need"):
                tdata.ImageNetTFRecordDataset(paths, 2)
            with pytest.raises(ImportError, match="ImageNet records need"):
                ttrain.build_dataset(cfg)


@pytest.mark.parametrize("config", ["resnet50_imagenet",
                                    "inception_v3_imagenet"])
def test_imagenet_config_reads_records_like_jax(tmp_path, monkeypatch,
                                                config):
    """Fault F2: with shards under DATA_DIR/imagenet the port reads them,
    as the JAX package's fit does, instead of synthetic images; both
    packages' build_dataset give equal batches for the train and
    validation splits.  Without shards both fall back to the same
    synthetic set."""
    _write_imagenet(tmp_path / "imagenet", "train", 2, 6, seed=0)
    _write_imagenet(tmp_path / "imagenet", "validation", 1, 5, seed=9)
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", str(tmp_path))
    over = dict(global_batch_size=4, image_size=32)
    tcfg = tconfig.get_config(config, **over)
    jcfg = jconfig.get_config(config, **over)
    for split, n in (("train", 5), ("validation", 2)):
        tds, jds = ttrain.build_dataset(tcfg, split), jtrain.build_dataset(
            jcfg, split)
        assert isinstance(tds, tdata.ImageNetTFRecordDataset)
        got = list(itertools.islice(iter(tds), n))
        want = list(itertools.islice(iter(jds), n))
        assert len(got) == len(want) == n
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_batches_equal(g, w, f"{split} batch {i}")
            assert g["image"].shape[1:] == (32, 32, 3)
        # One pass over the 5 validation records: a full and a ragged batch.
        assert [len(g["label"]) for g in got] == (
            [4] * n if split == "train" else [4, 1])
        labels = np.concatenate([g["label"] for g in got])
        assert 0 <= labels.min() and labels.max() < 10
    monkeypatch.setattr(tdata, "DATA_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(jdata, "DATA_DIR", str(tmp_path / "empty"))
    _assert_streams_equal(ttrain.build_dataset(tcfg),
                          jtrain.build_dataset(jcfg), 2, "no shards")


@pytest.mark.parametrize("config,dataset", [
    ("resnet50_synthetic", "mnist"), ("resnet50_synthetic", "cifar10"),
    ("resnet50_synthetic", "imagenet_synthetic"), ("transformer_lm", "ptb")])
def test_build_dataset_equals_jax(config, dataset):
    over = dict(global_batch_size=8, image_size=16, dataset=dataset,
                num_steps=20, vocab_size=500, seed=2)
    if config == "resnet50_synthetic":
        del over["num_steps"], over["vocab_size"]
    tds = ttrain.build_dataset(tconfig.get_config(config, **over))
    jds = jtrain.build_dataset(jconfig.get_config(config, **over))
    assert type(tds).__name__ == type(jds).__name__
    _assert_streams_equal(tds, jds, 3)


def test_build_dataset_rejects_unknown_datasets():
    cfg = tconfig.get_config("resnet50_synthetic_tiny", dataset="coco")
    with pytest.raises(ValueError, match="unknown dataset"):
        ttrain.build_dataset(cfg)


# --------------------------------------------------------------------------
# Cursor re-split and telemetry
# --------------------------------------------------------------------------


_STATES = [
    {0: {"epoch": 1, "batch_idx": 4}, 1: {"epoch": 1, "batch_idx": 3}},
    {0: {"dataset": {"epoch": 2, "pos": 0}}, 1: {"epoch": 1, "pos": 9}},
    {0: {"records": {"epoch": 0}, "count": 40}, 1: {"count": 36}},
    {0: None, 1: {"unknown": 1}},
    {3: {"epoch": 0, "batch_idx": 1}},
]


@pytest.mark.parametrize("states", _STATES)
def test_resplit_equals_jax(states):
    for s in states.values():
        assert tresplit.cursor_position(s) == jresplit.cursor_position(s)
    assert tresplit.pick_source(states) == jresplit.pick_source(states)
    for nproc in (1, 3):
        if jresplit.pick_source(states) == jresplit.NO_SOURCE:
            with pytest.raises(ValueError, match="no saved dataset state"):
                tresplit.resplit_states(states, nproc)
            continue
        assert (tresplit.resplit_states(states, nproc)
                == jresplit.resplit_states(states, nproc))
    assert (tresplit.describe_positions(states)
            == jresplit.describe_positions(states))


def test_registry_names_and_snapshot_equal_jax():
    names = {k: v for k, v in vars(jreg).items()
             if k.isupper() and isinstance(v, str)}
    assert names and {k: getattr(treg, k) for k in names} == names

    def drive(mod):
        reg = mod.MetricsRegistry()
        reg.counter("c").inc(3)
        reg.gauge("g").set(2.5)
        for v in (0.1, 0.3, 0.2):
            reg.timer("t").record(v)
        return reg.snapshot()

    assert drive(treg) == drive(jreg)
