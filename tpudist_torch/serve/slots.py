"""Slot-pooled KV cache: counterpart of :mod:`tpudist.serve.slots`.

One pre-allocated ``[max_slots, H, max_len, dh]`` decode cache per layer
whose batch rows are SLOTS requests occupy and vacate between decode
steps: acquire a free slot (FIFO recycle order), insert the prefilled
batch-1 cache into its rows (:func:`write_slot`, in place), advance its
cursor per decode step, release it (nothing is zeroed: the next insert
overwrites, and masked slots are never read).
"""

from __future__ import annotations

import collections

import numpy as np


def write_slot(pool: dict, row_cache: dict, slot: int) -> None:
    """Copy a prefilled batch-1 cache's K/V into row ``slot`` of the pool,
    in place. Only the 4-D buffers move; per-slot lengths live with the
    engine, not in the cache."""
    for dst, src in zip(pool["layers"], row_cache["layers"]):
        dst["k"][slot] = src["k"][0]
        dst["v"][slot] = src["v"][0]


class SlotPool:
    """The pool cache plus host-side slot bookkeeping: ``cache`` is the
    live device cache the decode step writes through, ``positions`` /
    ``active`` the per-slot lanes it is fed."""

    def __init__(self, model, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if not hasattr(model, "init_cache"):
            raise ValueError(
                f"{type(model).__name__} has no init_cache hook (the decode "
                "contract the serving engine requires)"
            )
        self.max_slots = max_slots
        self.max_seq_len = model.max_seq_len
        self.cache = model.init_cache(max_slots)
        self.positions = np.zeros(max_slots, np.int32)
        self.active = np.zeros(max_slots, bool)
        self._free: collections.deque[int] = collections.deque(range(max_slots))

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def utilization(self) -> float:
        """Active-slot fraction (on this contiguous pool slots and bytes
        are the same resource)."""
        return self.n_active / self.max_slots

    def write_row(self, row_cache: dict, slot: int) -> None:
        """Copy a prefilled batch-1 cache into a given slot's row without
        the pool's occupancy bookkeeping: the speculative draft pool,
        whose row for a request is the slot the target's admission chose
        and whose cursors are the engine's shared per-slot lane."""
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} outside [0, {self.max_slots})")
        write_slot(self.cache, row_cache, slot)

    def insert(self, row_cache: dict, true_len: int) -> int:
        """Copy a prefilled batch-1 cache into a free slot; returns the
        slot. Raises when the pool is full (admission checks first)."""
        if not self._free:
            raise RuntimeError("slot pool exhausted (admission bug)")
        if not 0 < true_len <= self.max_seq_len:
            raise ValueError(
                f"prefix length {true_len} outside (0, {self.max_seq_len}]"
            )
        slot = self._free.popleft()
        write_slot(self.cache, row_cache, slot)
        self.positions[slot] = true_len
        self.active[slot] = True
        return slot

    def advance(self, slot: int) -> None:
        self.positions[slot] += 1

    def release(self, slot: int) -> None:
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} released twice")
        self.active[slot] = False
        self.positions[slot] = 0
        self._free.append(slot)
