"""Gradient buckets, int8 quantization and the int8-wire ring all-reduce.

Counterpart of :mod:`tpudist.comm` (named apart from it: a CLI run as a
script path puts ``tpudist_torch/`` first on ``sys.path``, where a
``comm`` module would shadow the installed package of that name). The
explicit data-parallel reducer
(:mod:`tpudist_torch.parallel.dp`) builds on these pieces:

- :class:`BucketLayout`: a ``{name: tensor}`` dict, in the port's
  parameter order, flattened into ``[n_buckets, bucket_size]`` float32
  rows, zero-padded; ``n_buckets`` is rounded up to a multiple of the
  world so the ring splits the buckets into ``world`` equal chunks. Its
  numbers (bucket size, count, padding, wire bytes) are the reference's
  for the same leaf sizes and world.
- :func:`quantize_bucket` / :func:`dequantize`: symmetric int8 with one
  float32 scale per bucket, round-half-to-even without a key and
  stochastic ``floor(y + u)`` with one. An all-zero bucket gets scale 1; a
  non-finite amax stays the scale, so a poisoned gradient comes out
  non-finite and is never laundered into finite int8. Without a key the
  result is the reference's bit for bit.
- :func:`ring_allreduce_quantized`: ``w - 1`` reduce-scatter hops, then
  ``w - 1`` all-gather hops. Each hop ships int8 plus its scales; the
  receiver dequantizes and adds in float32. The final owner of a chunk
  quantizes the finished sum once and every rank, owner included,
  dequantizes that one pair, so the result is bit-identical on every
  rank.
- :func:`reduce_buckets`: ``"bucketed"`` is one float32 all-reduce
  divided by the world; ``"quantized"`` adds the error-feedback
  residual, quantizes once, banks ``x - dq(x)`` as the next residual,
  runs the ring and divides by the world.

The random stream of stochastic rounding is the port's own
(:mod:`tpudist_torch.rng`), keyed by (seed, step, replica, microbatch,
hop), so replicas draw independent noise; it is not the reference's
threefry stream, so only the keyless rounding is held bit for bit.

The ring is written against one exchange object, as the context-parallel
attention is (:mod:`tpudist_torch.parallel.cp`): :class:`GroupRing`
exchanges with the neighbours of a process group by
``batch_isend_irecv``; :class:`LoopbackRing` holds all ``n`` ranks'
buffers in one process along a leading dim (a rotation is a roll), so one
card or a CPU test runs every hop of an n-way ring. Tensors carry a
leading rank dim: 1 under a group, ``n`` on the loopback.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from tpudist_torch.rng import fold_in, generator

#: 4 Mi elements: 16 MB float32 / 4 MB int8 a bucket (the reference's)
DEFAULT_BUCKET_ELEMS = 4 * 1024 * 1024


class BucketLayout:
    """How a ``{name: tensor}`` dict maps onto fixed-size buckets (the
    reference's rules: the bucket is capped at ``ceil(total / world)``, so
    a model smaller than ``world * bucket_size`` does not pad to ``world``
    full buckets; ``n_buckets`` is a multiple of ``world``). Shapes only:
    a layout built from tensors on the meta device is the same layout."""

    def __init__(self, tree: dict, world: int,
                 bucket_size: int = DEFAULT_BUCKET_ELEMS):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if bucket_size < 1:
            raise ValueError(f"bucket_size must be >= 1, got {bucket_size}")
        if not tree:
            raise ValueError("BucketLayout needs at least one leaf")
        self.names = list(tree)
        self.shapes = [tuple(t.shape) for t in tree.values()]
        self.dtypes = [t.dtype for t in tree.values()]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total = sum(self.sizes)
        self.world = int(world)
        self.bucket_size = max(1, min(int(bucket_size),
                                      -(-self.total // self.world)))
        n = -(-self.total // self.bucket_size)
        self.n_buckets = n + (-n % self.world)
        self.padded_total = self.n_buckets * self.bucket_size
        self.buckets_per_chunk = self.n_buckets // self.world

    def flatten(self, tree: dict) -> torch.Tensor:
        """The dict's tensors -> ``[n_buckets, bucket_size]`` float32."""
        first = tree[self.names[0]]
        out = torch.zeros(self.padded_total, dtype=torch.float32,
                          device=first.device)
        off = 0
        for name, size in zip(self.names, self.sizes):
            out[off:off + size].copy_(tree[name].reshape(-1))
            off += size
        return out.view(self.n_buckets, self.bucket_size)

    def unflatten(self, buckets: torch.Tensor) -> dict:
        """``[n_buckets, bucket_size]`` -> ``{name: tensor}`` in the
        original shapes and dtypes (views where the dtype is float32)."""
        flat = buckets.reshape(-1)
        out, off = {}, 0
        for name, shape, size, dtype in zip(self.names, self.shapes,
                                            self.sizes, self.dtypes):
            out[name] = flat[off:off + size].view(shape).to(dtype)
            off += size
        return out

    def wire_bytes(self, method: str, *, reductions: int = 1) -> int:
        """Bytes this replica moves over the link a step: ``"quantized"``
        ``2 (w - 1)`` hops, each a chunk of int8 plus its float32 scales;
        ``"bucketed"`` the bandwidth-optimal float32 all-reduce,
        ``2 (w - 1) / w * N * 4`` (the float32 baseline)."""
        w, n = self.world, self.padded_total
        if w == 1:
            return 0
        if method == "quantized":
            per = 2 * (w - 1) * (n // w + self.buckets_per_chunk * 4)
        elif method == "bucketed":
            per = round(2 * (w - 1) / w * n * 4)
        else:
            raise ValueError(f"no wire accounting for method {method!r}")
        return per * reductions


def _uniform(key: int, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator(key, device), device=device,
                      dtype=torch.float32)


def quantize_bucket(x: torch.Tensor, key: int | None = None):
    """Symmetric int8 along the last dim, one scale per bucket: ``q =
    round(x / scale)``, ``scale = amax / 127`` (module docstring). Returns
    ``(q int8, scale float32 [..., 1])``."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0,
                        amax / torch.full((), 127.0, device=x.device),
                        torch.ones_like(amax))
    scale = torch.where(torch.isfinite(amax), scale, amax).float()
    y = x / scale
    if key is None:
        q = torch.round(y)
    else:
        q = torch.floor(y + _uniform(key, y.shape, y.device))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _quantize_ranks(x: torch.Tensor, keys):
    """:func:`quantize_bucket` of each rank's ``x[r]`` with its own key
    (``keys[r]``, or None for every rank)."""
    if keys is None:
        return quantize_bucket(x)
    qs, ss = zip(*(quantize_bucket(x[r], k) for r, k in enumerate(keys)))
    return torch.stack(qs), torch.stack(ss)


class GroupRing:
    """This rank's ring over ``group`` (None: the default group). Tensors
    carry a leading dim of 1, this rank."""

    def __init__(self, group=None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = [dist.get_rank(group)]

    def rotate(self, tensors):
        """Send each tensor to rank ``i + 1`` of the group; return those
        received from ``i - 1``."""
        i = self.ranks[0]
        dst = dist.get_global_rank(self.group or dist.group.WORLD,
                                   (i + 1) % self.n)
        src = dist.get_global_rank(self.group or dist.group.WORLD,
                                   (i - 1) % self.n)
        got = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, g in zip(tensors, got):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, self.group))
            ops.append(dist.P2POp(dist.irecv, g, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out


class LoopbackRing:
    """All ``n`` ranks in one process: rank ``r``'s tensor at index ``r``
    of a leading dim; a rotation is a roll, an all-reduce a sum over the
    leading dim (in rank order) broadcast back."""

    def __init__(self, n: int):
        self.n = int(n)
        self.ranks = list(range(self.n))

    def rotate(self, tensors):
        return [torch.roll(t, 1, 0) for t in tensors]

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        total = x[0].clone()
        for r in range(1, self.n):
            total += x[r]
        return total.expand_as(x).clone()


def ring_allreduce_quantized(chunks: torch.Tensor, comm, keys=None):
    """The int8-wire ring all-reduce (module docstring). ``chunks [R, w,
    bpc, B]``: each of this comm's ``R`` ranks' full value viewed as ``w``
    ring chunks. ``keys``: one key per rank (stochastic rounding, hop
    ``s`` on ``fold_in(key, s)``), or None (round-half-to-even). Returns
    the element-wise sum over the ranks, ``[R, w, bpc, B]``, bit-identical
    across ranks."""
    w = comm.n
    if w == 1:
        return chunks
    ranks = torch.tensor(comm.ranks, device=chunks.device)
    rows = torch.arange(len(comm.ranks), device=chunks.device)

    def hop_keys(s):
        return None if keys is None else [fold_in(k, s) for k in keys]

    acc = chunks.clone()
    for s in range(w - 1):
        send = acc[rows, (ranks - s) % w]
        q, scale = _quantize_ranks(send, hop_keys(s))
        q, scale = comm.rotate([q, scale])
        recv_idx = (ranks - s - 1) % w
        acc[rows, recv_idx] = acc[rows, recv_idx] + dequantize(q, scale)
    own = (ranks + 1) % w
    q, scale = _quantize_ranks(acc[rows, own], hop_keys(w))
    out = torch.zeros_like(chunks)
    out[rows, own] = dequantize(q, scale)
    for s in range(w - 1):
        q, scale = comm.rotate([q, scale])
        out[rows, (ranks - s) % w] = dequantize(q, scale)
    return out


def reduce_buckets(buckets: torch.Tensor, residual, layout: BucketLayout,
                   comm, keys=None, *, method: str):
    """One gradient reduction over ``comm``'s ranks. ``buckets [R,
    n_buckets, bucket_size]``: each rank's local buckets; ``residual``:
    the same shape, or None (no error feedback). Returns ``(mean,
    new_residual)``: the cross-replica mean, which every rank holds bit
    for bit, and the banked quantization error (None in, None out).
    ``keys``: one stochastic-rounding key per rank, or None."""
    w = torch.full((), float(comm.n), device=buckets.device)
    if method == "bucketed":
        return comm.all_reduce_sum(buckets) / w, residual
    if method != "quantized":
        raise ValueError(f"unknown reduce method {method!r}")
    x = buckets if residual is None else buckets + residual
    q0, s0 = _quantize_ranks(
        x, None if keys is None else [fold_in(k, 0) for k in keys])
    xq = dequantize(q0, s0)
    new_residual = None if residual is None else x - xq
    chunks = xq.view(xq.shape[0], comm.n, layout.buckets_per_chunk,
                     layout.bucket_size)
    total = ring_allreduce_quantized(
        chunks, comm, None if keys is None else [fold_in(k, 1) for k in keys])
    mean = total.view(xq.shape[0], layout.n_buckets, layout.bucket_size) / w
    return mean, new_residual


def multihost() -> bool:
    """True when the world spans more than one host (``LOCAL_WORLD_SIZE <
    WORLD_SIZE``, as the launcher sets them): the data replicas then
    cross the slower inter-host link, the regime where the quantized wire
    pays (``reduce="auto"``; the reference's ``multislice_dcn``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return world > local
