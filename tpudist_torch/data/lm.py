"""Language-model token datasets: the port's copy of :mod:`tpudist.data.lm`.

A flat token stream (a memory-mapped ``.npy`` or raw ``.bin`` file, or an
array) is cut into windows of ``seq_len`` tokens starting every
``stride`` tokens; :class:`TokenWindowLoader` gives each rank its shard
of windows through the port's :class:`DistributedSampler` (the same
windows per rank and epoch as the reference's loader) and gathers only
the rows a batch needs.
"""

from __future__ import annotations

import os
from pathlib import Path
import numpy as np

from tpudist_torch.data.loader import SampledLoader
from tpudist_torch.data.sampler import DistributedSampler


def load_token_stream(path: str | os.PathLike, dtype=None) -> np.ndarray:
    """Open a flat token file as a read-only memmap (no materialization):
    ``.npy`` of any integer dtype, or raw little-endian ``.bin`` (uint16 by
    default, GPT-2's 50257-entry vocab fits)."""
    path = Path(path)
    if path.suffix == ".npy":
        flat = np.load(path, mmap_mode="r")
        if flat.ndim != 1:
            raise ValueError(f"{path}: expected a 1-D token array, got {flat.shape}")
        return flat
    if path.suffix == ".bin":
        return np.memmap(path, dtype=dtype or np.uint16, mode="r")
    raise ValueError(f"{path}: unknown token-file suffix (want .npy or .bin)")


def encode_bytes(text: str | bytes) -> np.ndarray:
    """Byte-level tokenization (vocab 256): a stand-in for a trained
    tokenizer that needs no download."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, np.uint8).astype(np.int32)


class TokenWindowLoader(SampledLoader):
    """Batches of ``seq_len``-token windows from a flat stream.

    ``source``: a path (``.npy``/``.bin``) or a 1-D array. Windows start
    every ``stride`` tokens (default ``seq_len``: each token once per
    epoch); ``targets_in_window`` adds one token to each window. With
    ``vocab_size`` every gathered batch is checked: an id outside
    ``[0, vocab_size)`` raises instead of indexing a wrong embedding row.
    Yields ``{"tokens": int32 [batch_size, window]}``; the final short
    batch is dropped under ``drop_remainder``.

    ``transform`` (dict -> dict) runs on each gathered batch after the
    vocab check: the objective's corruption (BERT's
    :func:`~tpudist_torch.models.bert.mlm_transform`, T5's
    :func:`~tpudist_torch.models.t5.span_corrupt_transform`). One with
    ``wants_position`` is called as ``transform(batch, epoch, start)``
    (``start`` the batch's first index into the epoch's order), so
    :meth:`iter_from` replays the same corruption on a resume; any other
    as ``transform(batch)``, advancing its own stream once per batch it
    transforms."""

    def __init__(self, source, batch_size: int, seq_len: int, *,
                 stride: int | None = None, dtype=None,
                 vocab_size: int | None = None,
                 sampler: DistributedSampler | None = None,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0,
                 shuffle: bool = True, targets_in_window: bool = False,
                 drop_remainder: bool = True, transform=None):
        if isinstance(source, (str, os.PathLike)):
            source = load_token_stream(source, dtype=dtype)
        self.transform = transform
        self.flat = source
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.stride = stride or seq_len
        self.window = seq_len + (1 if targets_in_window else 0)
        self.drop_remainder = drop_remainder
        if len(self.flat) < self.window:
            raise ValueError(f"stream of {len(self.flat)} tokens is shorter "
                             f"than one window ({self.window})")
        self.num_windows = (len(self.flat) - self.window) // self.stride + 1
        self.vocab_size = vocab_size
        self.sampler = sampler or DistributedSampler(
            self.num_windows, num_replicas=num_replicas, rank=rank,
            shuffle=shuffle, seed=seed)

    def gather(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        offsets = (np.asarray(indices, np.int64)[:, None] * self.stride
                   + np.arange(self.window)[None, :])
        tokens = np.asarray(self.flat[offsets], np.int32)
        if self.vocab_size is not None and tokens.size:
            lo, hi = int(tokens.min()), int(tokens.max())
            if hi >= self.vocab_size or lo < 0:
                raise ValueError(
                    f"token id {hi if hi >= self.vocab_size else lo} outside "
                    f"[0, {self.vocab_size}) — wrong --token_dtype or "
                    "tokenizer/vocab mismatch")
        return {"tokens": tokens}

    def probe(self) -> dict | None:
        """A one-window batch through ``transform``: the reference's shape
        probe, which its ``fit`` draws once before training, so a
        transform's own stream (BERT's corruption) moves on by that one
        row there and here alike. Without a transform there is no stream
        to move: nothing is gathered and None comes back."""
        if self.transform is None:
            return None
        return self._gather_batch(self.sampler.epoch_indices()[:1], 0)

    def _gather_batch(self, indices: np.ndarray, start: int) -> dict:
        batch = self.gather(indices)
        if self.transform is None:
            return batch
        if getattr(self.transform, "wants_position", False):
            return self.transform(batch, self.sampler.epoch, start)
        return self.transform(batch)
