"""CIFAR-10/100, the reference's workload, from local files only.

The port's copy of :mod:`tpudist.data.cifar` without the download: the
extracted archive (``cifar-100-python/`` or ``cifar-10-batches-py/``) must
already be under ``root``, and its absence raises, naming
``--dataset synthetic``. Images are NHWC uint8 on the host, labels int32;
:func:`to_tensor` is the reference's ``ToTensor`` (float32 in [0, 1], no
normalization), and :func:`synthetic_cifar` the deterministic
class-separable stand-in with CIFAR's shapes and dtypes.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

_SPECS = {
    "cifar10": dict(
        dirname="cifar-10-batches-py",
        train_files=[f"data_batch_{i}" for i in range(1, 6)],
        test_files=["test_batch"],
        label_key=b"labels",
        num_classes=10,
    ),
    "cifar100": dict(
        dirname="cifar-100-python",
        train_files=["train"],
        test_files=["test"],
        label_key=b"fine_labels",
        num_classes=100,
    ),
}


def load_cifar(root: str | os.PathLike = "dataset", dataset: str = "cifar100",
               train: bool = True) -> dict[str, np.ndarray]:
    """Returns ``{"image": (N, 32, 32, 3) uint8, "label": (N,) int32}`` from
    the extracted python-pickle batches under ``root``."""
    spec = _SPECS[dataset]
    base = Path(root) / spec["dirname"]
    if not base.is_dir():
        raise FileNotFoundError(
            f"{base} is missing: the port reads an extracted {dataset} "
            "archive and downloads nothing. Place the extracted files "
            "there, or run with --dataset synthetic.")
    images, labels = [], []
    for fname in spec["train_files"] if train else spec["test_files"]:
        with open(base / fname, "rb") as f:
            entry = pickle.load(f, encoding="bytes")
        images.append(entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(entry[spec["label_key"]])
    return {
        "image": np.concatenate(images).astype(np.uint8),
        "label": np.asarray(labels, np.int32),
    }


def synthetic_cifar(n: int = 2048, num_classes: int = 100, image_size: int = 32,
                    seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic class-separable stand-in with CIFAR shapes/dtypes:
    each class has a fixed random template, samples are template + noise,
    so a real model can drive the loss down. The same draws as the
    reference's, from the same seed."""
    rng = np.random.Generator(np.random.PCG64(seed))
    templates = rng.integers(0, 256, (num_classes, image_size, image_size, 3))
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    noise = rng.normal(0, 24, (n, image_size, image_size, 3))
    images = np.clip(templates[labels] * 0.7 + 64 + noise, 0, 255).astype(np.uint8)
    return {"image": images, "label": labels}


def to_tensor(batch: dict) -> dict:
    """The reference's ``ToTensor``: uint8 [0, 255] -> float32 [0, 1];
    the layout stays NHWC."""
    out = dict(batch)
    out["image"] = np.asarray(batch["image"], np.float32) / 255.0
    return out
