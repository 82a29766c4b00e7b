"""Image decode + augmentation, transform-for-transform with the reference.

The reference's input augmentation runs as C++ TF kernels inside the graph
(SURVEY.md §3.4): ``decode_jpeg`` → ``sample_distorted_bounding_box`` crop →
resize → ``random_flip_left_right`` → color distortion (inception path,
SURVEY.md §2.1 R9), and pad+random-crop+flip+``per_image_standardization``
for CIFAR (R4).  Accuracy parity depends on replicating these details
(SURVEY.md §7.4.3: "augmentation details move final top-1 by >1%").

Here they are host-side NumPy per-image transforms (the same host-CPU role
the TF kernels played), driven by a ``numpy.random.Generator`` so the
pipeline is deterministic and checkpointable.  Batched torch variants of the
cheap transforms, on tensors and drawn from an explicit
``torch.Generator``, are provided for optional on-device augmentation.

The port's own copy of ``distributed_tensorflow_models_tpu/data/augment.py``:
the numpy transforms are the same code; PIL and OpenCV are imported inside
the functions that use them, so the module imports where neither is
installed.
"""

from __future__ import annotations

import io
import math
from typing import Optional

import numpy as np
import torch


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def require_image_libs() -> None:
    """Raise ImportError unless PIL and OpenCV import: the decode and
    resize of the ImageNet path need both, and there is no other way to
    read the records."""
    try:
        import cv2  # noqa: F401
        from PIL import Image  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"ImageNet records need PIL (JPEG decode) and OpenCV (resize): "
            f"{e}") from e


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 HWC RGB (the ``decode_jpeg`` kernel's role,
    TF gen_image_ops.py:1126)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize to ``[height, width]`` (float32 output)."""
    import cv2

    out = cv2.resize(
        img.astype(np.float32), (width, height), interpolation=cv2.INTER_LINEAR
    )
    if out.ndim == 2:
        out = out[:, :, None]
    return out


# --------------------------------------------------------------------------
# Shared primitives
# --------------------------------------------------------------------------


def per_image_standardization(img: np.ndarray) -> np.ndarray:
    """``(x - mean) / max(stddev, 1/sqrt(N))`` — exact
    ``tf.image.per_image_standardization`` semantics (CIFAR path, R4)."""
    x = img.astype(np.float32)
    mean = x.mean()
    std = max(x.std(), 1.0 / np.sqrt(x.size))
    return (x - mean) / std


def random_flip_left_right(
    img: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    return img[:, ::-1] if rng.random() < 0.5 else img


def random_crop(
    img: np.ndarray, rng: np.random.Generator, height: int, width: int
) -> np.ndarray:
    h, w = img.shape[:2]
    if h < height or w < width:
        raise ValueError(f"cannot crop {height}x{width} from {h}x{w}")
    top = int(rng.integers(0, h - height + 1))
    left = int(rng.integers(0, w - width + 1))
    return img[top : top + height, left : left + width]


def central_crop(img: np.ndarray, fraction: float) -> np.ndarray:
    """``tf.image.central_crop`` — the inception eval path's 87.5% crop."""
    h, w = img.shape[:2]
    ch = int(np.floor(h * fraction))
    cw = int(np.floor(w * fraction))
    top = (h - ch) // 2
    left = (w - cw) // 2
    return img[top : top + ch, left : left + cw]


# --------------------------------------------------------------------------
# CIFAR-10 (R4): pad 4 → random 32x32 crop → flip → standardize
# --------------------------------------------------------------------------


def preprocess_cifar_train(
    img: np.ndarray, rng: np.random.Generator, pad: int = 4
) -> np.ndarray:
    padded = np.pad(
        img, ((pad, pad), (pad, pad), (0, 0)), mode="constant"
    )
    out = random_crop(padded, rng, img.shape[0], img.shape[1])
    out = random_flip_left_right(out, rng)
    return per_image_standardization(out)


def preprocess_cifar_eval(img: np.ndarray) -> np.ndarray:
    return per_image_standardization(img)


# --------------------------------------------------------------------------
# ImageNet / inception preprocessing (R9)
# --------------------------------------------------------------------------


def sample_distorted_bounding_box(
    shape: tuple[int, int],
    rng: np.random.Generator,
    *,
    bbox: Optional[np.ndarray] = None,
    min_object_covered: float = 0.1,
    aspect_ratio_range: tuple[float, float] = (0.75, 1.33),
    area_range: tuple[float, float] = (0.05, 1.0),
    max_attempts: int = 100,
) -> tuple[int, int, int, int]:
    """Sample a crop window ``(top, left, height, width)``.

    Reimplements the ``sample_distorted_bounding_box`` kernel's algorithm
    (TF image_ops_impl.py:386 binding; inception's distorted-crop, R9):
    draw an aspect ratio and an area fraction uniformly, derive the window,
    accept the first window that fits and covers ``min_object_covered`` of
    the object bbox; fall back to the whole image after ``max_attempts``.

    ``bbox`` is ``[ymin, xmin, ymax, xmax]`` in [0,1] coordinates, or None
    for "use whole image" (the reference's path for label-only records).
    """
    height, width = shape
    if bbox is None:
        bbox = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    for _ in range(max_attempts):
        aspect = rng.uniform(*aspect_ratio_range)
        area_frac = rng.uniform(*area_range)
        target_area = area_frac * height * width
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if w > width or h > height or w <= 0 or h <= 0:
            continue
        top = int(rng.integers(0, height - h + 1))
        left = int(rng.integers(0, width - w + 1))
        # Object coverage: fraction of the bbox area inside the window.
        by0, bx0, by1, bx1 = (
            bbox[0] * height,
            bbox[1] * width,
            bbox[2] * height,
            bbox[3] * width,
        )
        inter_h = max(0.0, min(top + h, by1) - max(top, by0))
        inter_w = max(0.0, min(left + w, bx1) - max(left, bx0))
        bbox_area = max((by1 - by0) * (bx1 - bx0), 1e-6)
        if inter_h * inter_w / bbox_area >= min_object_covered:
            return top, left, h, w
    return 0, 0, height, width


def _rgb_to_hsv(x: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(x.astype(np.float32), cv2.COLOR_RGB2HSV)


def _hsv_to_rgb(x: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(x.astype(np.float32), cv2.COLOR_HSV2RGB)


def distort_color(
    img: np.ndarray, rng: np.random.Generator, ordering: int = 0
) -> np.ndarray:
    """Inception color distortion on a float image in [0, 1].

    Two operation orderings as in the reference's ``distort_color`` (R9;
    thread-id-parity trick in the original), brightness delta 32/255,
    saturation/contrast in [0.5, 1.5], hue delta 0.2 rad.  Output clipped
    to [0, 1] as TF does.
    """

    def brightness(x):
        return x + rng.uniform(-32.0 / 255.0, 32.0 / 255.0)

    def saturation(x):
        hsv = _rgb_to_hsv(np.clip(x, 0, 1))
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(0.5, 1.5), 0, 1)
        return _hsv_to_rgb(hsv)

    def hue(x):
        hsv = _rgb_to_hsv(np.clip(x, 0, 1))
        # OpenCV float HSV hue is in degrees [0, 360); 0.2 rad ≈ 11.46 deg.
        delta_deg = np.degrees(rng.uniform(-0.2, 0.2))
        hsv[..., 0] = (hsv[..., 0] + delta_deg) % 360.0
        return _hsv_to_rgb(hsv)

    def contrast(x):
        factor = rng.uniform(0.5, 1.5)
        mean = x.mean(axis=(0, 1), keepdims=True)
        return (x - mean) * factor + mean

    ops = (
        [brightness, saturation, hue, contrast]
        if ordering % 2 == 0
        else [brightness, contrast, saturation, hue]
    )
    out = img.astype(np.float32)
    for op in ops:
        out = op(out)
    return np.clip(out, 0.0, 1.0)


def preprocess_imagenet_train(
    img: np.ndarray,
    rng: np.random.Generator,
    *,
    size: int = 224,
    bbox: Optional[np.ndarray] = None,
    color_ordering: Optional[int] = None,
) -> np.ndarray:
    """Full inception training preprocessing: distorted-bbox crop → resize
    → flip → color distort → scale to [-1, 1] (R9's transform list)."""
    top, left, h, w = sample_distorted_bounding_box(img.shape[:2], rng, bbox=bbox)
    crop = img[top : top + h, left : left + w]
    out = resize_bilinear(crop, size, size) / 255.0
    out = random_flip_left_right(out, rng)
    if color_ordering is None:
        color_ordering = int(rng.integers(0, 2))
    out = distort_color(out, rng, color_ordering)
    return (out - 0.5) * 2.0


def preprocess_imagenet_eval(
    img: np.ndarray, *, size: int = 224, crop_fraction: float = 0.875
) -> np.ndarray:
    """Eval path: central crop → resize → scale to [-1, 1]."""
    out = central_crop(img, crop_fraction)
    out = resize_bilinear(out, size, size) / 255.0
    return (out - 0.5) * 2.0


# --------------------------------------------------------------------------
# Batched on-device variants (torch) for the cheap transforms, on NHWC
# tensors.  Random draws come from an explicit ``torch.Generator`` on the
# tensors' device, so a caller reproduces them by seeding it.
# --------------------------------------------------------------------------


def torch_per_image_standardization(images: torch.Tensor) -> torch.Tensor:
    """:func:`per_image_standardization` over each image of a batch."""
    x = images.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    n = math.prod(x.shape[1:])
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, keepdim=True, correction=0).clamp_min(
        1.0 / math.sqrt(n))
    return (x - mean) / std


def torch_random_flip(images: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """Flip each image left-right with probability 1/2."""
    flips = torch.rand(images.shape[0], generator=generator,
                       device=images.device) < 0.5
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def torch_random_crop_with_pad(images: torch.Tensor,
                               generator: torch.Generator,
                               pad: int = 4) -> torch.Tensor:
    """Zero-pad each image by ``pad`` and crop it back to its size at an
    offset drawn uniformly from ``[0, 2*pad]`` per axis."""
    n, h, w, _ = images.shape
    padded = torch.nn.functional.pad(images, (0, 0, pad, pad, pad, pad))
    tops = torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                         device=images.device)
    lefts = torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                          device=images.device)
    rows = (tops[:, None] + torch.arange(h, device=images.device))
    cols = (lefts[:, None] + torch.arange(w, device=images.device))
    batch = torch.arange(n, device=images.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]
