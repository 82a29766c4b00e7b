"""Input pipelines: host-side file reading, decode and augmentation
feeding a small device prefetch buffer, the step consuming one batch at a
time (the reference's graph-resident queue pipeline, SURVEY.md §3.4).

The port's own copy of ``distributed_tensorflow_models_tpu/data/``
(numpy, the stdlib and torch; no jax):

- :mod:`tfrecord` — TFRecord container format (reader/writer, masked CRC32C),
  with an optional native C++ fast path (:mod:`native_loader`).
- :mod:`example_proto` — minimal ``tf.train.Example`` wire-format codec.
- :mod:`augment` — the reference's augmentation set (numpy; PIL and
  OpenCV imported where used), and batched torch variants.
- :mod:`datasets` — MNIST, CIFAR-10, ImageNet-from-TFRecord and PTB,
  each factored into a cheap checkpointable cursor (``next_work``) plus a
  pure per-batch ``assemble`` function.
- :mod:`resplit` — cursor re-split for an N -> M process resume.
- :mod:`pipeline` — :class:`HostPipeline` (threaded producer, ordered
  worker pool, checkpointable state) and :class:`DevicePrefetcher`
  (page-locked staging and a CUDA copy stream).
"""

from distributed_tensorflow_models_tpu_torch.data.pipeline import (  # noqa: F401
    DevicePrefetcher,
    HostPipeline,
)
