"""Host-side batch assembly and device staging.

Counterpart of :mod:`tpudist.data.loader`'s numpy gather path and of
``prefetch_to_mesh``. :class:`DataLoader` gathers this rank's batches
from an in-memory numpy dataset (the sampler owns the shuffle) and hands
them to ``transform``; :func:`prefetch_to_device` keeps ``depth`` batches
staged ahead of the step: a background thread gathers and pins each host
batch, and the consumer's thread issues its host-to-device copy on a side
stream and records an event that the compute stream waits on, so the copy
for step k+1 overlaps the compute of step k. The reference's C++ batcher
(``data/native.py``) is host speed, not semantics, and is not ported yet.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from tpudist_torch.data.sampler import DistributedSampler


class DataLoader:
    """Iterates minibatches of an array-backed dataset for one epoch.

    ``dataset``: name -> numpy array, equal leading dims (e.g. ``{"image":
    (N, 32, 32, 3) uint8, "label": (N,) int32}``). A
    :class:`DistributedSampler` supplies this rank's index shard; batches
    are gathered on the host and passed through ``transform``. With
    ``drop_remainder`` (the default, as in the reference) the final short
    batch is dropped.
    """

    def __init__(self, dataset: Mapping[str, np.ndarray], batch_size: int,
                 sampler: DistributedSampler | None = None,
                 transform: Callable[[dict], dict] | None = None,
                 drop_remainder: bool = True):
        sizes = {k: len(v) for k, v in dataset.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset arrays: {sizes}")
        self.dataset = dict(dataset)
        self.size = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.sampler = sampler or DistributedSampler(
            self.size, num_replicas=1, rank=0, shuffle=False)
        self.transform = transform
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        n = self.sampler.num_samples
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def probe(self) -> dict:
        """A one-sample batch through ``transform``: the reference's
        shape probe, which its ``fit`` draws once before training. A
        transform with a stream of its own (the host augmentation) moves
        it on by that one row, so ``fit`` draws it too."""
        idx = self.sampler.epoch_indices()[:1]
        batch = {k: v[idx] for k, v in self.dataset.items()}
        return self.transform(batch) if self.transform else batch

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """This epoch from batch ``start_batch`` on: the skip is on the
        index level (no gather, no transform for the skipped batches), as
        the reference's is. A host ``transform`` that draws from a stream
        of its own (the host augmentation) therefore continues from where
        its stream stands, not from where an uninterrupted run's would."""
        indices = self.sampler.epoch_indices()
        limit = (len(self) * self.batch_size if self.drop_remainder
                 else len(indices))
        for start in range(start_batch * self.batch_size, limit,
                           self.batch_size):
            idx = indices[start : start + self.batch_size]
            batch = {k: v[idx] for k, v in self.dataset.items()}
            yield self.transform(batch) if self.transform else batch


#: seconds between polls of ``prefetch_to_device``'s ``stop_check``
STOP_POLL_S = 0.5


def prefetch_to_device(iterator, device, *, depth: int = 2, stop_check=None):
    """Yield the host batches of ``iterator`` (dicts of numpy arrays) as
    dicts of tensors on ``device``, ``depth`` copies in flight ahead of
    the consumer (module docstring). On the CPU the tensors share the
    numpy memory. Keys starting with ``"_"`` are per-step operands already
    on the device (the device cache's ``"_cache"``): they pass through
    untouched, and only the row data crosses. An error in the host
    iterator is raised after the batches staged before it have been
    delivered.

    ``stop_check`` is polled every :data:`STOP_POLL_S` while the consumer
    waits on the host thread: when it returns True the stream ends early
    (the batches already staged are delivered first), as if the epoch
    ended. ``fit`` passes its preemption flag, so a SIGTERM that lands
    while the input is stalled still reaches the graceful path."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    host_q: queue.Queue = queue.Queue(maxsize=depth + 1)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                host_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch in iterator:
                tensors = {}
                for k, v in batch.items():
                    if k.startswith("_"):
                        tensors[k] = v
                        continue
                    t = torch.from_numpy(np.ascontiguousarray(v))
                    tensors[k] = t.pin_memory() if cuda else t
                if not put(tensors):
                    return
            put(done)
        except BaseException as e:  # delivered to the consumer, raised there
            put(e)

    threading.Thread(target=produce, daemon=True).start()
    side = torch.cuda.Stream(device) if cuda else None
    staged: collections.deque = collections.deque()

    def stage(batch):
        if not cuda:
            return batch, None
        with torch.cuda.stream(side):
            out = {k: v if k.startswith("_") else v.to(device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def next_host():
        while True:
            try:
                return host_q.get(timeout=None if stop_check is None
                                  else STOP_POLL_S)
            except queue.Empty:
                if stop_check():
                    return done

    try:
        finished, error = False, None
        while True:
            while not finished and error is None and len(staged) < depth:
                item = next_host()
                if item is done:
                    finished = True
                elif isinstance(item, BaseException):
                    error = item
                else:
                    staged.append(stage(item))
            if not staged:
                if error is not None:
                    raise error
                return
            batch, ready = staged.popleft()
            if ready is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                for k, t in batch.items():
                    # the batch was allocated on the side stream and is read
                    # on the compute stream: keep the allocator from reusing
                    # it before the compute stream is done with it
                    if not k.startswith("_"):
                        t.record_stream(compute)
            yield batch
    finally:
        stop.set()
