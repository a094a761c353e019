"""scikit-learn's bundled handwritten digits as a dataset (the port's copy
of :mod:`tpudist.data.digits`).

1,797 real 8x8 grayscale digits, 10 classes, split 80/20 by a seeded
permutation (``PCG64(0)``: every process computes the same split),
rescaled from 0..16 to 0..255 uint8 and upscaled to 32x32 RGB, so the
CIFAR model geometry and ``to_tensor`` apply unchanged. The arrays are
the reference's bit for bit. Without scikit-learn (the machine with the
card has none) it raises ``ImportError`` naming the package; it never
substitutes other data.
"""

from __future__ import annotations

import numpy as np

_SPLIT_SEED = 0
_TRAIN_FRACTION = 0.8


def load_digits_dataset(train: bool = True, *, upscale: int = 4,
                        rgb: bool = True) -> dict[str, np.ndarray]:
    """``{"image": uint8 NHWC, "label": int32}``: the training or
    validation split. ``upscale`` repeats each pixel into a block, ``rgb``
    replicates the gray channel."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as exc:
        raise ImportError(
            "--dataset digits needs scikit-learn (its bundled load_digits "
            "set), which is not installed here; use --dataset synthetic or "
            "cifar100") from exc
    bunch = load_digits()
    labels = bunch.target.astype(np.int32)
    order = np.random.Generator(np.random.PCG64(_SPLIT_SEED)).permutation(
        len(labels))
    n_train = int(len(labels) * _TRAIN_FRACTION)
    keep = order[:n_train] if train else order[n_train:]
    img = np.clip(bunch.images[keep] * (255.0 / 16.0), 0, 255).astype(np.uint8)
    if upscale > 1:
        img = img.repeat(upscale, axis=1).repeat(upscale, axis=2)
    img = img[..., None]
    if rgb:
        img = np.repeat(img, 3, axis=-1)
    return {"image": np.ascontiguousarray(img),
            "label": np.ascontiguousarray(labels[keep])}
