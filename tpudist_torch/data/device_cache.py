"""A dataset held in device memory, batches as indices.

The port's copy of :class:`tpudist.data.device_cache.DeviceCachedLoader`
(the reference's ``RotatingDeviceCache`` for sets larger than the card is
not ported yet). The whole image array is copied to the device once, at
construction, in its own dtype (uint8 for CIFAR: 6.3 MB for 2048 images);
each batch then carries only this rank's indices and their labels from the
host, a few KB a step, and the cache tensor under ``"_cache"``. The gather
runs on the device inside the step, through :meth:`input_transform`
(``make_train_step(input_transform=...)``), followed by the ToTensor or
the augmentation the caller composes after it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpudist_torch.data.sampler import DistributedSampler


class DeviceCachedLoader:
    """Iterable of index batches over a device-resident dataset.

    ``dataset``: the image array (uint8 recommended) under ``input_key``
    and per-row labels under ``label_key``; ``batch_size``: this rank's
    rows a step; ``device``: where the cache lives; ``sampler``: this
    rank's shard (a shuffling :class:`DistributedSampler` over the
    ``torch.distributed`` world by default); ``drop_remainder`` drops the
    ragged tail, as for training."""

    def __init__(self, dataset: Mapping[str, np.ndarray], batch_size: int, *,
                 device, sampler: DistributedSampler | None = None,
                 input_key: str = "image", label_key: str = "label",
                 drop_remainder: bool = True, seed: int = 0):
        self.batch_size = batch_size
        self.input_key = input_key
        self.label_key = label_key
        self.drop_remainder = drop_remainder
        images = np.ascontiguousarray(dataset[input_key])
        self.sampler = sampler or DistributedSampler(len(images), seed=seed)
        # labels stay on the host: they ride each index batch
        self._labels = np.ascontiguousarray(dataset[label_key])
        # the one host-to-device copy of the set
        self._cache = torch.from_numpy(images).to(device)

    def __len__(self) -> int:
        n = self.sampler.num_samples
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def input_transform(self, post=None):
        """The ``indices -> images`` gather for
        ``make_train_step(input_transform=...)``, then ``post`` (a ToTensor,
        :func:`tpudist_torch.data.transforms.device_normalize`, or a
        ``device_compose`` chain with augmentation). Declares
        ``wants_batch`` (the cache arrives as the batch's ``"_cache"``) and
        ``wants_step`` when ``post`` does, handing the step through."""
        post_wants_step = getattr(post, "wants_step", False)

        def run(indices, batch, step=None):
            gathered = batch["_cache"].index_select(0, indices.long())
            if post is None:
                return gathered
            return post(gathered, step) if post_wants_step else post(gathered)

        run.wants_batch = True
        run.wants_step = post_wants_step
        return run

    def _index_batches(self):
        order = self.sampler.epoch_indices()
        n = len(order)
        end = n - n % self.batch_size if self.drop_remainder else n
        for lo in range(0, end, self.batch_size):
            yield order[lo:lo + self.batch_size]

    def iter_from(self, start_batch: int):
        for i, idx in enumerate(self._index_batches()):
            if i >= start_batch:
                yield self._make_batch(idx)

    def _make_batch(self, idx: np.ndarray) -> dict:
        return {
            self.input_key: np.ascontiguousarray(idx.astype(np.int32)),
            self.label_key: np.ascontiguousarray(self._labels[idx]),
            "_cache": self._cache,
        }

    def __iter__(self):
        for idx in self._index_batches():
            yield self._make_batch(idx)
