"""A dataset held in device memory, batches as indices.

The port's copies of :class:`tpudist.data.device_cache.DeviceCachedLoader`
and, for sets larger than the card, ``RotatingDeviceCache``. The whole
image array of :class:`DeviceCachedLoader` is copied to the device once,
at construction, in its own dtype (uint8 for CIFAR: 6.3 MB for 2048 images);
each batch then carries only this rank's indices and their labels from the
host, a few KB a step, and the cache tensor under ``"_cache"``. The gather
runs on the device inside the step, through :meth:`input_transform`
(``make_train_step(input_transform=...)``), followed by the ToTensor or
the augmentation the caller composes after it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import weakref
from typing import Mapping

import numpy as np
import torch

from tpudist_torch.data.sampler import DistributedSampler

logger = logging.getLogger(__name__)

#: rows of a shard cross to the card in slices of about this many bytes,
#: through two pinned buffers of this size
CHUNK_BYTES = 64 * 1024 * 1024


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


class RotatingDeviceCache:
    """A device cache for sets larger than the card: the set is split into
    shards of ``shard_rows`` rows, and while the steps consume shard k on
    the card, shard k + 1 stages on a background thread, so every step
    still carries only indices. The card holds at most three shards: a
    shard is staged only once all but two earlier ones have been dropped
    by the consumer (``prefetch_to_device``'s queue runs several batches
    ahead, so without this wait a short shard would leave four alive) and
    the compute stream has run every use of the dropped ones. Size
    ``shard_rows`` for three; a consumer must not keep the batches of more
    than two shards (``fit`` keeps one batch), or the staging waits.

    The plan is the reference's, bit for bit: per ``(seed, epoch)`` a
    global permutation of the rows, cut into ``n // shard_rows`` shards
    (each shard's rows sorted, for sequential reads of a memory-mapped
    pack; a ragged tail of ``n % shard_rows`` rows, a fresh random subset
    each epoch, is dropped with a warning), and a permutation within each
    shard. Each batch of ``batch_size`` rows per rank is this rank's stride
    ``window[rank::world]`` of a window of ``batch_size x world`` rows of
    that order, so ``shard_rows`` must divide by the global batch, and the
    ranks' batches are disjoint. The loader is its own sampler
    (``set_epoch``); ``__len__``, ``iter_from`` (at the batch level, the
    shards before the target not staged) and ``probe`` are the
    reference's.

    Staging on the card: the staging thread gathers the shard's rows from
    the (memory-mapped) source with the C++ batcher into one of two pinned
    buffers of :data:`CHUNK_BYTES`, slice by slice, and copies each slice
    with ``non_blocking=True`` into the shard's tensor on a side stream,
    waiting for a buffer's previous copy before refilling it; an event
    recorded after the last slice is the shard's ``"_ready"``. The batch
    dict carries the shard under ``"_cache"`` and that event, and
    :meth:`input_transform` makes the compute stream wait on the event
    and marks the shard as in use by the compute stream
    (``record_stream``), so the caching allocator does not hand its block
    to a later shard while a queued step reads it. A staging error is
    raised in the consumer (through ``prefetch_to_device``, in the
    training loop), never replaced by a host path.

    Multi-process: the reference stages inline under several processes,
    because an extra thread issuing device work deadlocked XLA:CPU
    against the collective steps. Here the staging issues no collective,
    only a host gather and a copy on its own stream, so it overlaps the
    steps under a process group too; the batches are the same either way
    (they depend only on ``(seed, epoch)``, the rank and the world).

    On the CPU (``device="cpu"``) a shard is a tensor over the gathered
    rows and there is no event. ``stage_log`` records, for each shard
    staged, its ``stage_s`` (the staging thread's seconds: gather and
    copies enqueued) and ``wait_s`` (the seconds the iterator waited for
    it at the boundary); ``ready_at_use`` whether each shard's copy had
    completed when its first batch reached the compute stream."""

    def __init__(self, dataset: Mapping[str, np.ndarray], batch_size: int, *,
                 shard_rows: int, device, input_key: str = "image",
                 label_key: str = "label", seed: int = 0,
                 rank: int | None = None, num_replicas: int | None = None):
        import torch.distributed as dist

        from tpudist_torch.distributed import group_up

        self.device = torch.device(device)
        self.batch_size = batch_size  # this rank's rows a step
        self.input_key = input_key
        self.label_key = label_key
        self.seed = seed
        self._images = dataset[input_key]  # sliced per shard: a memmap works
        if not self._images.flags["C_CONTIGUOUS"]:
            raise ValueError("RotatingDeviceCache gathers shards from a "
                             "C-contiguous image array")
        self._labels = np.ascontiguousarray(dataset[label_key])
        self._n = self._images.shape[0]
        up = group_up()
        self._rank = rank if rank is not None else (
            dist.get_rank() if up else 0)
        self._world = num_replicas if num_replicas is not None else (
            dist.get_world_size() if up else 1)
        self._global_batch = batch_size * self._world
        shard_rows = min(shard_rows, self._n)
        if shard_rows % self._global_batch:
            raise ValueError(
                f"shard_rows {shard_rows} must divide by the global batch "
                f"{self._global_batch} (a batch never spans two resident "
                "shards)")
        self.shard_rows = shard_rows
        if self._n % shard_rows:
            logger.warning(
                "RotatingDeviceCache: dataset rows (%d) are not a multiple "
                "of shard_rows (%d); the ragged tail shard is dropped, so "
                "%d randomly-chosen rows (a fresh subset per epoch) sit "
                "out each epoch", self._n, shard_rows, self._n % shard_rows)
        self.epoch = 0
        # fit() calls loader.sampler.set_epoch(e): the rotation keys its
        # own plan by epoch, so it is its own sampler
        self.sampler = self
        self.stage_log: list[dict] = []
        self.ready_at_use: list[bool] = []
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._pinned: list[torch.Tensor] = []
        self._copied: list = [None, None]
        self._last_ready = None
        # weak references to the shards staged on the card, and the
        # consumer's compute stream (seen at a shard's first use)
        self._alive: list = []
        self._compute = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        # whole shards only: every step sees one [shard_rows, ...] cache
        return (self._n // self.shard_rows) * (
            self.shard_rows // self._global_batch)

    def probe(self) -> dict:
        return {self.input_key: np.zeros((1, *self._images.shape[1:]),
                                         np.float32),
                self.label_key: self._labels[:1]}

    def epoch_plan(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """(shards, orders): each shard's global rows (sorted) and its
        within-shard order, the same on every rank by (seed, epoch)."""
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self.seed, self.epoch])))
        order = rng.permutation(self._n)
        n_shards = self._n // self.shard_rows
        shards = [np.sort(order[s * self.shard_rows:(s + 1) * self.shard_rows])
                  for s in range(n_shards)]
        orders = [rng.permutation(self.shard_rows) for _ in range(n_shards)]
        return shards, orders

    def input_transform(self, post=None):
        """The step's ``indices -> images`` gather from the batch's shard,
        then ``post``, as :meth:`DeviceCachedLoader.input_transform`; on
        the card the compute stream first waits on the shard's copy and
        takes the shard as in use (class docstring)."""
        gather = DeviceCachedLoader.input_transform(self, post)

        def run(indices, batch, step=None):
            ready = batch.get("_ready")
            if ready is not None:
                if ready is not self._last_ready:
                    self._last_ready = ready
                    self.ready_at_use.append(ready.query())
                compute = torch.cuda.current_stream(self.device)
                self._compute = compute
                compute.wait_event(ready)
                batch["_cache"].record_stream(compute)
            return gather(indices, batch, step)

        run.wants_batch = True
        run.wants_step = gather.wants_step
        return run

    def _stage(self, rows: np.ndarray):
        """One shard's pixels on the device (class docstring); returns
        (shard, its labels, the ready event or None)."""
        from tpudist_torch.data.native import default_batcher

        batcher = default_batcher()
        if not self._cuda:
            cache = torch.from_numpy(batcher.gather(self._images, rows))
            return cache, self._labels[rows], None
        self._await_room()
        shape = (len(rows), *self._images.shape[1:])
        per_chunk = max(CHUNK_BYTES // max(self._images[:1].nbytes, 1), 1)
        if not self._pinned:
            tdt = torch.from_numpy(self._images[:0]).dtype
            self._pinned = [torch.empty((per_chunk, *shape[1:]), dtype=tdt,
                                        pin_memory=True) for _ in range(2)]
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            # allocated on the side stream; the consumer's record_stream
            # adds the compute stream's uses
            cache = torch.empty(shape, dtype=self._pinned[0].dtype,
                                device=self.device)
            for k, lo in enumerate(range(0, len(rows), per_chunk)):
                slot, hi = k % 2, min(len(rows), lo + per_chunk)
                if self._copied[slot] is not None:
                    self._copied[slot].synchronize()  # its last copy read it
                buf = self._pinned[slot][:hi - lo]
                batcher.gather(self._images, rows[lo:hi], out=buf.numpy())
                cache[lo:hi].copy_(buf, non_blocking=True)
                self._copied[slot] = torch.cuda.Event()
                self._copied[slot].record(self._side)
            ready = torch.cuda.Event()
            ready.record(self._side)
        self._alive.append(weakref.ref(cache))
        return cache, self._labels[rows], ready

    def _await_room(self) -> None:
        """Wait (on the staging thread) until at most two staged shards
        are still referenced, then until the compute stream has run the
        work enqueued so far, which holds every use of the dropped ones."""
        while True:
            self._alive = [r for r in self._alive if r() is not None]
            if len(self._alive) < 3:
                break
            time.sleep(0.001)
        if self._compute is not None:
            done = torch.cuda.Event()
            done.record(self._compute)
            done.synchronize()

    def _stage_async(self, rows: np.ndarray) -> queue.Queue:
        """:meth:`_stage` on a daemon thread (one that is never joined at
        exit, so a staging stuck on a failing device cannot hang the
        process's exit); the one-slot queue receives (ok, value or
        exception, the staging's seconds)."""
        out: queue.Queue = queue.Queue(1)

        def work():
            t0 = time.perf_counter()
            try:
                value = (True, self._stage(rows))
            except BaseException as e:  # raised by _resolve in the iterator
                value = (False, e)
            out.put((*value, time.perf_counter() - t0))

        threading.Thread(target=work, daemon=True).start()
        return out

    def _resolve(self, pending: queue.Queue):
        t0 = time.perf_counter()
        ok, value, stage_s = pending.get()
        if not ok:
            raise value
        self.stage_log.append({"rows": self.shard_rows, "stage_s": stage_s,
                               "wait_s": time.perf_counter() - t0})
        return value

    def __iter__(self):
        return self._iter_impl(0)

    def iter_from(self, start_batch: int):
        """Mid-epoch resume at the batch level: the shards before the
        target batch are not staged."""
        per_shard = self.shard_rows // self._global_batch
        first_shard = start_batch // per_shard
        skip = start_batch - first_shard * per_shard
        for i, batch in enumerate(self._iter_impl(first_shard)):
            if i >= skip:
                yield batch

    def _iter_impl(self, start_shard: int):
        shards, orders = self.epoch_plan()
        shards, orders = shards[start_shard:], orders[start_shard:]
        if not shards:
            return
        pending = self._stage_async(shards[0])
        for s in range(len(shards)):
            cache, labels, ready = self._resolve(pending)
            if s + 1 < len(shards):
                pending = self._stage_async(shards[s + 1])
            order = orders[s]
            for lo in range(0, self.shard_rows, self._global_batch):
                window = order[lo:lo + self._global_batch]
                # this rank's stride of the global batch: disjoint across
                # ranks, their union the window
                idx = window[self._rank::self._world]
                yield {self.input_key: np.ascontiguousarray(
                           idx.astype(np.int32)),
                       self.label_key: np.ascontiguousarray(labels[idx]),
                       "_cache": cache, "_ready": ready}
