"""Host-side batch assembly and device staging.

Counterpart of :mod:`tpudist.data.loader`. :class:`SampledLoader` is the
iterator contract every host loader shares (the sampler, ``__len__``,
``iter_from`` and the sample position each batch is gathered at);
:class:`DataLoader` gathers this rank's batches from an in-memory (or
memory-mapped) numpy dataset through the C++ batcher
(:mod:`tpudist_torch.data.native`), or through numpy with
``native=False``, and hands them to ``transform``;
:func:`prefetch_to_device` keeps ``depth`` batches staged ahead of the
step: a background thread gathers each host batch (into pinned memory on
a machine with a card), and the consumer's thread issues its
host-to-device copy on a side stream and records an event that the
compute stream waits on, so the copy for step k+1 overlaps the compute
of step k.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from tpudist_torch.data.sampler import DistributedSampler


class SampledLoader:
    """The iterator contract of every host loader (the reference's
    ``SampledLoader``). Subclasses set ``sampler``, ``batch_size`` and
    ``drop_remainder`` and implement ``_gather_batch(indices, start)``,
    ``start`` being the batch's position in the epoch's index stream (for
    augmentation keyed by position). The skip of :meth:`iter_from` is on
    the index level: no gather and no transform for the skipped batches,
    as the reference's is."""

    sampler: DistributedSampler
    batch_size: int
    drop_remainder: bool

    def __len__(self) -> int:
        n = self.sampler.num_samples
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _gather_batch(self, indices: np.ndarray, start: int) -> dict:
        raise NotImplementedError

    def probe(self) -> dict:
        """A one-sample batch through the loader's transform: the
        reference's shape probe, which its ``fit`` draws once before
        training. A transform with a stream of its own (the host
        augmentation) moves it on by that one row, so ``fit`` draws it
        too."""
        return self._gather_batch(self.sampler.epoch_indices()[:1], 0)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """This epoch from batch ``start_batch`` on. A host ``transform``
        that draws from a stream of its own (the host augmentation)
        continues from where its stream stands, not from where an
        uninterrupted run's would."""
        indices = self.sampler.epoch_indices()
        limit = (len(self) * self.batch_size if self.drop_remainder
                 else len(indices))
        for start in range(start_batch * self.batch_size, limit,
                           self.batch_size):
            yield self._gather_batch(indices[start : start + self.batch_size],
                                     start)


class DataLoader(SampledLoader):
    """Iterates minibatches of an array-backed dataset for one epoch.

    ``dataset``: name -> numpy array, equal leading dims (e.g. ``{"image":
    (N, 32, 32, 3) uint8, "label": (N,) int32}``; a memory-mapped pack
    works: only the gathered rows are read). A :class:`DistributedSampler`
    supplies this rank's index shard; batches are gathered on the host
    and passed through ``transform``. With ``drop_remainder`` (the
    default, as in the reference) the final short batch is dropped.

    ``native=True`` (the reference's default) gathers through the C++
    batcher, which is built at the first batch or raises: a transform
    advertising a ``native_spec`` (:func:`tpudist_torch.data.transforms.
    to_tensor_normalize`) is fused into the gather, another runs on the
    gathered rows; on a machine with a card the rows land in pinned host
    memory, which the copy to the card reads. Its arrays must be
    C-contiguous. ``native=False`` is the numpy gather. Both give the same
    batches bit for bit. ``gather_seconds`` sums the host time of this
    loader's gathers (transform included)."""

    def __init__(self, dataset: Mapping[str, np.ndarray], batch_size: int,
                 sampler: DistributedSampler | None = None,
                 transform: Callable[[dict], dict] | None = None,
                 drop_remainder: bool = True, native: bool = True):
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
        self.native = native
        if native:
            for k, v in self.dataset.items():
                if not v.flags["C_CONTIGUOUS"]:
                    raise ValueError(
                        f"DataLoader(native=True) gathers from C-contiguous "
                        f"arrays; {k!r} is not (np.ascontiguousarray it "
                        "once, or pass native=False)")
        self.gather_seconds = 0.0

    def _gather_batch(self, idx: np.ndarray, start: int) -> dict:
        t0 = time.perf_counter()
        if self.native:
            from tpudist_torch.data.native import native_batch

            batch = native_batch(self.dataset, idx, self.transform,
                                 pin=torch.cuda.is_available())
        else:
            batch = {k: v[idx] for k, v in self.dataset.items()}
            if self.transform is not None:
                batch = self.transform(batch)
        self.gather_seconds += time.perf_counter() - t0
        return batch


def _host_tensor(v) -> torch.Tensor:
    """``v`` as a CPU tensor. A numpy view of a whole tensor (the native
    gather's pinned buffer) gives that tensor's storage back, so the copy
    to the card reads the pinned block itself and records its event
    there."""
    if isinstance(v, torch.Tensor):
        return v
    base = getattr(v, "base", None)
    if (isinstance(base, torch.Tensor) and base.data_ptr() == v.ctypes.data
            and tuple(base.shape) == v.shape):
        return base
    return torch.from_numpy(np.ascontiguousarray(v))


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
                    t = _host_tensor(v)
                    tensors[k] = (t.pin_memory() if cuda and not t.is_pinned()
                                  else t)
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
