"""Paged KV cache: counterpart of :mod:`tpudist.serve.blocks`.

- one pool per layer, ``[n_blocks, H_kv, block_size, dh]``
  (:func:`paged_cache`);
- per-slot host block tables ``[max_slots, max_blocks]`` mapping logical
  to physical blocks, fed to the decode step each tick; a slot maps its
  next block only when its cursor crosses a block boundary, so device
  memory holds the sum of actual lengths;
- refcounted blocks (:class:`BlockPool`) and a chain-hashed prompt-prefix
  cache (:class:`PrefixCache`): only FULL blocks whose tokens match
  exactly are shared, a shared block is never written again, so sharing
  is copy-on-write at block granularity with no fault machinery.

Physical block 0 is the reserved GARBAGE block, never allocated: inactive
decode rows carry all-zero tables and positions, so their ride-along
writes land there, where no live table points.

Invariants: ``refcount[b] == (#live slot tables holding b) + (1 if the
prefix cache holds b)``; a block returns to the free list exactly at
refcount 0; eviction takes LRU chain LEAVES whose block no slot maps.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np
import torch

#: reserved garbage block: inactive rows' tables point here; never allocated
GARBAGE_BLOCK = 0


def paged_cache(model, n_blocks: int, block_size: int) -> dict:
    """The device-side block pool: the model's decode-cache structure with
    every layer's K/V as ``[n_blocks, H_kv, block_size, dh]`` (``H_kv`` the
    model's ``cache_heads``: this rank's K/V heads)."""
    shape = (n_blocks, model.cache_heads, block_size, model.head_dim)
    mk = lambda: torch.zeros(shape, dtype=model.dtype, device=model.device)
    cache = {"layers": [{"k": mk(), "v": mk(), "index": 0}
                        for _ in range(model.depth)]}
    if hasattr(model, "wpe"):
        cache["position"] = 0
    return cache


def scatter_blocks(pool: dict, row_cache: dict, table, start: int, end: int,
                   *, block_size: int) -> None:
    """Copy a contiguous batch-1 prefill cache's K/V into the pool blocks
    ``table[start:end]`` in place (block ``j`` takes rows
    ``[j*bs, (j+1)*bs)`` of the row cache). Blocks outside
    ``[start, end)`` — shared prefix hits — are never touched."""
    if end <= start:
        return
    dev = pool["layers"][0]["k"].device
    ids = torch.as_tensor(np.asarray(table[start:end], np.int64), device=dev)
    lo, hi = start * block_size, end * block_size
    for dst, src in zip(pool["layers"], row_cache["layers"]):
        for name in ("k", "v"):
            row = src[name][0, :, lo:hi]  # [H, n*bs, dh]
            h, _, dh = row.shape
            dst[name][ids] = row.reshape(h, end - start, block_size, dh) \
                .transpose(0, 1).to(dst[name].dtype)


def gather_prefix(pool: dict, table) -> dict:
    """A contiguous batch-1 cache assembled from the pool blocks ``table``
    maps (fresh cursors at 0). Blocks past a hit map the garbage block;
    their bytes sit above the prefill cursor where the mask never admits
    them."""
    dev = pool["layers"][0]["k"].device
    ids = torch.as_tensor(np.asarray(table, np.int64), device=dev)
    layers = []
    for layer in pool["layers"]:
        out = {"index": 0}
        for name in ("k", "v"):
            g = layer[name][ids]  # [mb, H, bs, dh]
            mb, h, bs, dh = g.shape
            out[name] = g.transpose(0, 1).reshape(1, h, mb * bs, dh)
        layers.append(out)
    return {"position": 0, "layers": layers}


class BlockPool:
    """Host-side physical-block accounting: a free list plus per-block
    refcounts. Block 0 (:data:`GARBAGE_BLOCK`) is reserved."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (one is the garbage block), got "
                f"{n_blocks}"
            )
        self.n_blocks = n_blocks
        self.refcount = np.zeros(n_blocks, np.int32)
        self._free: collections.deque[int] = collections.deque(
            range(1, n_blocks)
        )

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_usable - self.n_free

    @property
    def occupancy(self) -> float:
        return self.n_used / self.n_usable

    def alloc(self) -> int | None:
        """A free block (refcount 1), or ``None`` when the pool is dry."""
        if not self._free:
            return None
        b = self._free.popleft()
        self.refcount[b] = 1
        return b

    def incref(self, block: int) -> None:
        if block == GARBAGE_BLOCK or self.refcount[block] <= 0:
            raise RuntimeError(f"incref of unallocated block {block}")
        self.refcount[block] += 1

    def decref(self, block: int) -> None:
        """Drop one reference; the block returns to the free list exactly
        at refcount 0 (a double free raises)."""
        if block == GARBAGE_BLOCK or self.refcount[block] <= 0:
            raise RuntimeError(f"decref of free block {block} (double free)")
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self._free.append(block)


@dataclasses.dataclass
class _PrefixEntry:
    block: int
    parent: bytes | None
    children: int
    last_use: int


class PrefixCache:
    """Content-addressed prompt-prefix blocks: chain hash -> physical
    block. Entry ``i``'s key folds entry ``i-1``'s digest with block
    ``i``'s token bytes, so a hit is an exact token-prefix match. The
    cache holds ONE pool reference per entry; slots sharing a block hold
    their own."""

    def __init__(self, pool: BlockPool, block_size: int):
        self.pool = pool
        self.block_size = block_size
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _chain(self, tokens: np.ndarray) -> list[bytes]:
        bs = self.block_size
        digests, prev = [], b""
        for j in range(len(tokens) // bs):
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(np.ascontiguousarray(
                tokens[j * bs:(j + 1) * bs], np.int32).tobytes())
            prev = h.digest()
            digests.append(prev)
        return digests

    def lookup(self, tokens: np.ndarray, max_tokens: int) -> list[int]:
        """Physical blocks of the longest cached full-block prefix of
        ``tokens``, capped at ``max_tokens``; touches the matched entries'
        LRU clocks."""
        self._tick += 1
        usable = tokens[: max(int(max_tokens), 0)]
        hits: list[int] = []
        for digest in self._chain(np.asarray(usable)):
            e = self._entries.get(digest)
            if e is None:
                break
            e.last_use = self._tick
            hits.append(e.block)
        return hits

    def insert(self, tokens: np.ndarray, blocks, n_known: int) -> None:
        """Register the full blocks of ``tokens`` beyond the first
        ``n_known`` under their chain hashes, one pool reference each."""
        self._tick += 1
        chain = self._chain(np.asarray(tokens))
        for j in range(n_known, len(chain)):
            digest = chain[j]
            if digest in self._entries:
                continue  # cached by an earlier admission: keep private copy
            parent = chain[j - 1] if j else None
            self.pool.incref(int(blocks[j]))
            self._entries[digest] = _PrefixEntry(
                int(blocks[j]), parent, 0, self._tick
            )
            if parent is not None and parent in self._entries:
                self._entries[parent].children += 1

    def evict(self, need: int) -> int:
        """Free up to ``need`` blocks by dropping LRU leaf entries only the
        cache references; returns how many were freed."""
        freed = 0
        while freed < need:
            best = None
            for digest, e in self._entries.items():
                if e.children or self.pool.refcount[e.block] != 1:
                    continue
                if best is None or e.last_use < self._entries[best].last_use:
                    best = digest
            if best is None:
                return freed
            e = self._entries.pop(best)
            if e.parent is not None and e.parent in self._entries:
                self._entries[e.parent].children -= 1
            self.pool.decref(e.block)
            freed += 1
        return freed


class PagedSlotPool:
    """The paged counterpart of :class:`tpudist_torch.serve.slots.SlotPool`:
    the same slot bookkeeping surface, but ``cache`` is the shared block
    pool and each slot owns a block TABLE. ``utilization`` reports BLOCK
    occupancy."""

    def __init__(self, model, max_slots: int, *, n_blocks: int,
                 block_size: int, prefix_cache: bool = True):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if not hasattr(model, "init_cache"):
            raise ValueError(
                f"{type(model).__name__} has no init_cache hook (the decode "
                "contract the serving engine requires)"
            )
        if block_size < 1 or model.max_seq_len % block_size:
            raise ValueError(
                f"block_size {block_size} must divide max_seq_len "
                f"{model.max_seq_len} (tables and the prefill scatter "
                "assume whole blocks)"
            )
        self.max_slots = max_slots
        self.max_seq_len = model.max_seq_len
        self.block_size = block_size
        self.max_blocks = model.max_seq_len // block_size
        self.blocks = BlockPool(n_blocks)
        self.prefix = (
            PrefixCache(self.blocks, block_size) if prefix_cache else None
        )
        self.cache = paged_cache(model, n_blocks, block_size)
        self.tables = np.zeros((max_slots, self.max_blocks), np.int32)
        self.fill = np.zeros(max_slots, np.int32)  # table entries in use
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
        return self.blocks.occupancy

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def free_after_evict(self) -> int:
        """Blocks available to a new allocation if every evictable
        prefix-cache leaf were dropped (cache-only blocks are
        transitively evictable, leaves first)."""
        free = self.blocks.n_free
        if self.prefix is None:
            return free
        return free + sum(
            1 for e in self.prefix._entries.values()
            if self.blocks.refcount[e.block] == 1
        )

    def insert(self, row_cache, true_len: int, *, prompt=None,
               hit_blocks=()) -> int:
        """Admit a prefilled request: take a slot, map ``hit_blocks``
        (one ref each), allocate private blocks for the rest of
        ``true_len`` tokens, copy the row cache's K/V into the PRIVATE
        blocks only, and register the prompt's full blocks in the prefix
        cache."""
        if not self._free:
            raise RuntimeError("slot pool exhausted (admission bug)")
        if not 0 < true_len <= self.max_seq_len:
            raise ValueError(
                f"prefix length {true_len} outside (0, {self.max_seq_len}]"
            )
        n_hit = len(hit_blocks)
        n_need = self.blocks_for(true_len)
        if n_hit > n_need:
            raise ValueError(f"hit blocks {n_hit} exceed prefix {true_len}")
        slot = self._free.popleft()
        table = np.zeros(self.max_blocks, np.int32)
        for j, b in enumerate(hit_blocks):
            self.blocks.incref(int(b))
            table[j] = int(b)
        for j in range(n_hit, n_need):
            b = self.blocks.alloc()
            if b is None:  # roll back to stay leak-free before raising
                for jj in range(j):
                    self.blocks.decref(int(table[jj]))
                self._free.appendleft(slot)
                raise RuntimeError(
                    "block pool exhausted mid-insert (admission bug)"
                )
            table[j] = b
        if n_need > n_hit:
            scatter_blocks(self.cache, row_cache, table, n_hit, n_need,
                           block_size=self.block_size)
        self.tables[slot] = table
        self.fill[slot] = n_need
        self.positions[slot] = true_len
        self.active[slot] = True
        if self.prefix is not None and prompt is not None:
            self.prefix.insert(prompt, table, n_hit)
        return slot

    def ensure_to(self, slot: int, n_tokens: int) -> bool:
        """Map blocks until the slot's table covers ``n_tokens`` positions
        (clamped to the table's extent); ``False`` when the pool runs dry
        on the way (blocks mapped so far stay mapped). A plain decode
        step asks for its cursor plus one; the speculative dispatch maps a
        whole window at once."""
        need = min(self.blocks_for(n_tokens), self.max_blocks)
        while int(self.fill[slot]) < need:
            b = self.blocks.alloc()
            if b is None:
                return False
            self.tables[slot, self.fill[slot]] = b
            self.fill[slot] += 1
        return True

    def advance(self, slot: int) -> None:
        self.positions[slot] += 1

    def release(self, slot: int) -> None:
        """Drop the slot's reference on every mapped block and recycle the
        slot."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} released twice")
        for j in range(int(self.fill[slot])):
            self.blocks.decref(int(self.tables[slot, j]))
        self.tables[slot] = 0
        self.fill[slot] = 0
        self.positions[slot] = 0
        self.active[slot] = False
        self._free.append(slot)

    def evict_prefix(self, need: int) -> int:
        return 0 if self.prefix is None else self.prefix.evict(need)

    def gather_row(self, hit_blocks) -> dict:
        """Contiguous batch-1 cache view of a prefix-cache hit (the table
        padded with the garbage block)."""
        table = np.zeros(self.max_blocks, np.int32)
        table[: len(hit_blocks)] = hit_blocks
        return gather_prefix(self.cache, table)


def draft_equivalent_blocks(model, draft_model, max_slots: int,
                            block_size: int) -> int:
    """How many target-model KV blocks the draft pool's bytes buy: the
    equal-memory handicap for a speculative-against-plain comparison (a
    speculative engine holds a whole contiguous draft pool beside its
    paged target pool, so the plain engine gets that many more blocks).
    Rounds up."""
    from tpudist_torch.serve.spec import cache_bytes

    per_token = cache_bytes(model, 1) // model.max_seq_len
    draft = cache_bytes(draft_model, max_slots)
    return -(-draft // max(per_token * block_size, 1))
