"""ImageNet-style image folders: the streaming input of ``main.py
--dataset imagenet`` (BASELINE.json configs 2-4).

The port's copy of :mod:`tpudist.data.imagenet`, function for function: a
torchvision ``ImageFolder`` scan (``root/<class>/<image>``, classes sorted
by name, files sorted within a class) feeding a decode-on-demand loader
whose decode pool is a ``ThreadPoolExecutor`` (PIL's JPEG decode releases
the GIL). Train batches take RandomResizedCrop and a horizontal flip drawn
from ``SeedSequence([seed, epoch, position])``, so a resumed epoch redraws
the crops an uninterrupted one would have drawn; eval batches take the
resize of the short side to ``256/224 x size`` and a center crop. Both are
normalized with ImageNet's statistics. The pixels are the reference's
bit for bit. PIL is imported only by the functions that decode, so a
packed dataset (:mod:`tpudist_torch.data.packed`) runs without it.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from tpudist_torch.data.loader import SampledLoader
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                           to_tensor_normalize)

_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def scan_image_folder(root: str | os.PathLike,
                      classes: list[str] | None = None):
    """``root/<class>/<image>`` -> (paths, labels, class_names).

    Classes are the sorted subdirectory names and a label is the class's
    position. Pass the train split's ``classes`` when scanning a val
    split: labels are then positions in that list, and a class directory
    the list lacks raises (a val tree missing a class keeps every later
    label where it was)."""
    root = Path(root)
    if not root.is_dir():
        raise FileNotFoundError(f"image folder root {root} does not exist")
    found = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not found:
        raise ValueError(f"{root} has no class subdirectories")
    if classes is None:
        classes = found
    else:
        unknown = set(found) - set(classes)
        if unknown:
            raise ValueError(
                f"{root} has class dirs not in the reference class list "
                f"(train split): {sorted(unknown)[:5]}")
    index = {cls: i for i, cls in enumerate(classes)}
    paths: list[str] = []
    labels: list[int] = []
    for cls in found:
        files = sorted(p for p in (root / cls).iterdir()
                       if p.suffix.lower() in _EXTENSIONS)
        paths.extend(str(p) for p in files)
        labels.extend([index[cls]] * len(files))
    if not paths:
        raise ValueError(f"{root} has no images under its class directories")
    return paths, np.asarray(labels, np.int32), list(classes)


def _random_resized_crop(img, size: int, rng: np.random.Generator,
                         scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """A crop of random area and aspect (ten tries, then the central
    square), resized to ``size`` x ``size`` bilinearly in one pass
    (``resize(box=...)``)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        ar = math.exp(rng.uniform(log_lo, log_hi))
        cw = int(round(math.sqrt(target_area * ar)))
        ch = int(round(math.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BILINEAR,
                              box=(x, y, x + cw, y + ch))
    edge = min(w, h)
    x, y = (w - edge) // 2, (h - edge) // 2
    return img.resize((size, size), Image.BILINEAR,
                      box=(x, y, x + edge, y + edge))


def _resize_center_crop(img, size: int):
    """Resize the short side to ``round(256/224 x size)``, then crop the
    central ``size`` x ``size``: the standard ImageNet eval transform."""
    from PIL import Image

    resize_to = max(int(round(size * 256 / 224)), size)
    w, h = img.size
    if w <= h:
        new_w, new_h = resize_to, int(round(h * resize_to / w))
    else:
        new_w, new_h = int(round(w * resize_to / h)), resize_to
    img = img.resize((new_w, new_h), Image.BILINEAR)
    x, y = (new_w - size) // 2, (new_h - size) // 2
    return img.crop((x, y, x + size, y + size))


class ImageFolderLoader(SampledLoader):
    """Streaming decode-on-demand loader over an image-folder tree, with
    :class:`tpudist_torch.data.loader.DataLoader`'s contract (``sampler``,
    ``__len__``, ``iter_from``), so ``fit``, ``evaluate`` and
    ``prefetch_to_device`` take it unchanged. Yields ``{"image": float32
    [B, size, size, 3] (normalized), "label": int32 [B]}``.

    ``workers`` sizes the decode pool (0 is one thread; None is the CPU
    count up to 16). The pool starts at the first batch; ``close()`` (or
    the loader as a context manager) releases its threads."""

    def __init__(self, root: str | os.PathLike, batch_size: int, *,
                 train: bool = True, image_size: int = 224,
                 sampler: DistributedSampler | None = None,
                 num_replicas: int = 1, rank: int = 0,
                 workers: int | None = None, seed: int = 0,
                 drop_remainder: bool = True, normalize: bool = True,
                 classes: list[str] | None = None):
        self.paths, self.labels, self.classes = scan_image_folder(root,
                                                                  classes)
        self.batch_size = batch_size
        self.train = train
        self.image_size = image_size
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._transform = (to_tensor_normalize(IMAGENET_MEAN, IMAGENET_STD)
                           if normalize else None)
        self.sampler = sampler or DistributedSampler(
            len(self.paths), num_replicas=num_replicas, rank=rank,
            shuffle=train, seed=seed)
        self.workers = (max(1, workers) if workers is not None
                        else min(os.cpu_count() or 8, 16))
        self._pool: ThreadPoolExecutor | None = None

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _decode(self, index: int, position: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.paths[index]) as img:
            img = img.convert("RGB")
            if self.train:
                # keyed by (seed, epoch, sample position): the same on
                # every process, and replayed by a mid-epoch resume
                rng = np.random.Generator(np.random.PCG64(
                    np.random.SeedSequence(
                        [self.seed, self.sampler.epoch, position])))
                img = _random_resized_crop(img, self.image_size, rng)
                if rng.random() < 0.5:
                    img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
            else:
                img = _resize_center_crop(img, self.image_size)
            return np.asarray(img, np.uint8)

    def _gather_batch(self, idx: np.ndarray, start: int) -> dict:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
        images = list(self._pool.map(self._decode, idx.tolist(),
                                     range(start, start + len(idx))))
        batch = {"image": np.stack(images), "label": self.labels[idx]}
        return self._transform(batch) if self._transform else batch


def synthetic_imagenet(n: int = 512, num_classes: int = 1000,
                       image_size: int = 224,
                       seed: int = 0) -> dict[str, np.ndarray]:
    """Class-separable in-memory stand-in with ImageNet's shapes: the
    template-plus-noise recipe of
    :func:`tpudist_torch.data.cifar.synthetic_cifar`, the same draws as
    the reference's."""
    from tpudist_torch.data.cifar import synthetic_cifar

    return synthetic_cifar(n, num_classes=num_classes, image_size=image_size,
                           seed=seed)
