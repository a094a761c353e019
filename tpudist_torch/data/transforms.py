"""Batch transforms: augmentation and normalization.

The port's copy of :mod:`tpudist.data.transforms`. The host transforms
are the reference's numpy code unchanged (``dict -> dict`` over NHWC
batches, composed left to right by :func:`compose`), so the host
``--augment`` stream is bit-identical to the reference's: the same
``PCG64(seed)`` draws, the same reflect-pad, crop and flip.

The device transforms (:func:`device_normalize`,
:func:`device_random_crop_flip`, :func:`device_compose`) are functions of
a tensor on the card, for ``make_train_step(input_transform=...)`` after
:class:`tpudist_torch.data.device_cache.DeviceCachedLoader`'s gather. An
augmenting one declares ``wants_step`` and draws from a
``torch.Generator`` on the batch's device keyed by ``(seed, step)``
(:mod:`tpudist_torch.rng`): fresh every step and every grad-accumulation
microbatch, the same on every replica, as the reference's
``fold_in(key(seed), step)``. JAX's threefry bits are not reproduced.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudist_torch import rng as rng_lib

# torchvision's canonical per-dataset statistics
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_STATS = {
    "cifar10": (CIFAR10_MEAN, CIFAR10_STD),
    "cifar100": (CIFAR100_MEAN, CIFAR100_STD),
    # synthetic mimics the 100-class set (--dataset synthetic)
    "synthetic": (CIFAR100_MEAN, CIFAR100_STD),
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    # sklearn digits, stats of the 0.8 train split
    "digits": (
        np.array([0.3053, 0.3053, 0.3053], np.float32),
        np.array([0.3763, 0.3763, 0.3763], np.float32),
    ),
}


def compose(*fns):
    def run(batch):
        for f in fns:
            batch = f(batch)
        return batch

    return run


def normalize(mean=CIFAR10_MEAN, std=CIFAR10_STD, key: str = "image"):
    """Per-channel (x - mean)/std on float NHWC images."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def run(batch):
        out = dict(batch)
        out[key] = (np.asarray(batch[key], np.float32) - mean) / std
        return out

    return run


def random_crop_flip(pad: int = 4, flip: bool = True, seed: int = 0,
                     key: str = "image"):
    """Pad-reflect + random crop back to size, then random horizontal flip,
    on uint8 NHWC before ``to_tensor``: one gather per batch."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def run(batch):
        img = np.asarray(batch[key])
        n, h, w, c = img.shape
        padded = np.pad(
            img, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect"
        )
        ys = rng.integers(0, 2 * pad + 1, n)
        xs = rng.integers(0, 2 * pad + 1, n)
        rows = ys[:, None] + np.arange(h)[None, :]          # [n, h]
        cols = xs[:, None] + np.arange(w)[None, :]          # [n, w]
        cropped = padded[
            np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]
        ]
        if flip:
            do = rng.random(n) < 0.5
            cropped[do] = cropped[do, :, ::-1]
        out = dict(batch)
        out[key] = cropped
        return out

    return run


def to_tensor_normalize(mean, std, key: str = "image"):
    """ToTensor + per-channel normalize as ONE affine on uint8:
    ``(x/255 - mean)/std == x * 1/(255 std) - mean/std``. ``native_spec``
    lets the native batcher (:mod:`tpudist_torch.data.native`) fuse it
    into the gather, with the same two roundings."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = (1.0 / 255.0) / std
    shift = -mean / std

    def run(batch):
        out = dict(batch)
        out[key] = np.asarray(batch[key], np.float32) * scale + shift
        return out

    run.native_spec = {key: (scale, shift)}
    return run


def device_normalize(mean, std, dtype=None):
    """The affine of :func:`to_tensor_normalize` as a function of a
    tensor: float32 arithmetic (the host path's, bit for bit), then a cast
    to ``dtype`` when given."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = torch.from_numpy((1.0 / 255.0) / std)
    shift = torch.from_numpy(-mean / std)
    on = {}  # device -> (scale, shift) there: one copy each, not a step

    def run(x):
        if x.device not in on:
            on[x.device] = (scale.to(x.device), shift.to(x.device))
        s, b = on[x.device]
        out = x.to(torch.float32) * s + b
        return out.to(dtype) if dtype is not None else out

    return run


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``mode="reflect"`` index into ``[0, n)`` for ``idx`` in
    ``[-(n - 1), 2 (n - 1)]`` (the edge is not repeated)."""
    idx = idx.abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def device_random_crop_flip(pad: int = 4, flip: bool = True, *, seed: int = 0):
    """The device twin of :func:`random_crop_flip` on NHWC tensors:
    reflect-pad by ``pad``, a crop at a per-image offset in ``[0, 2 pad]``
    and a horizontal flip with probability 1/2, as one gather. Declares
    ``wants_step``: the draws come from a generator keyed by ``(seed,
    step)``, so every step and microbatch is fresh and a step repeats."""

    def run(x, step):
        b, h, w, _ = x.shape
        gen = rng_lib.generator(rng_lib.fold_in(seed, step), x.device)
        ys = torch.randint(0, 2 * pad + 1, (b,), generator=gen, device=x.device)
        xs = torch.randint(0, 2 * pad + 1, (b,), generator=gen, device=x.device)
        rows = _reflect(ys[:, None] + torch.arange(h, device=x.device) - pad, h)
        cols = xs[:, None] + torch.arange(w, device=x.device) - pad
        if flip:
            do = torch.rand(b, generator=gen, device=x.device) < 0.5
            cols = torch.where(do[:, None], cols.flip(-1), cols)
        cols = _reflect(cols, w)
        n = torch.arange(b, device=x.device)
        return x[n[:, None, None], rows[:, :, None], cols[:, None, :]]

    run.wants_step = True
    return run


def device_compose(*fns):
    """Compose device transforms; the composite declares ``wants_step``
    iff any part does, and the step reaches exactly the parts that asked
    for it."""

    def run(x, step=None):
        for f in fns:
            x = f(x, step) if getattr(f, "wants_step", False) else f(x)
        return x

    run.wants_step = any(getattr(f, "wants_step", False) for f in fns)
    return run


def standard_cifar_augment(seed: int = 0, dataset: str = "cifar10"):
    """crop (pad 4) + flip, then the fused ToTensor + normalize with the
    named dataset's statistics: the standard CIFAR training pipeline."""
    mean, std = _STATS[dataset]
    return compose(random_crop_flip(seed=seed), to_tensor_normalize(mean, std))


def standard_cifar_eval(dataset: str = "cifar10"):
    """The same statistics as :func:`standard_cifar_augment`, no crop or
    flip: the matching eval transform."""
    mean, std = _STATS[dataset]
    return to_tensor_normalize(mean, std)
