"""Context (sequence) parallelism: ring attention and Ulysses all-to-all.

Counterpart of :mod:`tpudist.parallel.cp`. Each rank of a seq group holds
one contiguous chunk ``[B, S/n, H, D]`` of the sequence (rank ``i`` the
positions ``i S/n ..``):

- **Ring** (:func:`ring_attention_local`): q stays put and the K/V chunks
  make ``n`` hops around the group; hop ``t`` scores the chunk first owned
  by rank ``(i - t) mod n`` and folds it into the online softmax with the
  reference's arithmetic: f32 scores, masked causally by global position
  with ``finfo(float32).min``, the running max, ``alpha`` and ``p`` as
  ``_online_merge`` computes them (a fully masked chunk adds exactly 0), the
  output ``acc / l`` in q's dtype. The S x S scores never exist. It is a
  ``torch.autograd.Function`` that saves q, k, v, the f32 output and the
  row log-sum-exp; its backward recomputes each hop's ``p`` from the lse,
  accumulates dq locally, and sends the dk, dv accumulators around the
  ring with their K/V chunk, so after ``n`` rotations each is back at its
  owner: the transpose of the reference's ``ppermute``. It rounds where
  the reference's ``jax.grad`` of its scan rounds: delta from the f32
  output, each hop's dq, dk, dv products and their running sums in the
  inputs' dtype, which is the dtype dk and dv travel in. Under ``causal`` a
  hop whose chunk lies wholly in the future adds nothing and is not
  computed (its rotation still happens); the forward's last rotation,
  which only brings K/V home in the reference, is not made. The chunk
  products are plain matrix products, as in the reference, which runs
  them outside any Pallas kernel.
- **Ulysses** (:func:`ulysses_attention_local`): an all-to-all re-shards
  ``[B, S/n, H, D]`` into ``[B, S, H/n, D]``, ``attn_fn`` attends over the
  whole sequence for the local head group (the dense path by default; the
  vmem or flash kernel through :func:`~tpudist_torch.ops.attention.
  kernel_attention` for ``ulysses_flash``), and the inverse all-to-all
  brings the output back. The all-to-all is an ``autograd.Function``
  whose backward is the same exchange (it is its own adjoint). Needs
  ``H % n == 0``.

- **Gathered** (:func:`gathered_attention`): a non-context-parallel
  attention (the dense path, the vmem or the flash kernel) under a seq
  axis, the reference's replicated-sequence ``shard_map``. The forward
  all-gathers q, k and v (grouped K/V heads as they are), runs
  ``attn_fn`` over the whole sequence and keeps this rank's rows; the
  backward all-gathers the output's cotangent, runs the same attention's
  backward over the whole sequence and keeps this rank's rows of dq, dk
  and dv. Every rank computes the whole attention, so each rank's result
  is bit-identical to one call on the whole sequence, and the backward
  exchanges one tensor, not three partial gradients; the price is the
  reference's, n-fold attention work.

Under a tensor axis (seq x tensor) each rank holds ``H / T`` heads of q,
k and v, and each attention here runs over the seq group on those heads:
attention is parallel over heads, so the result is the reference's,
whose ``shard_map`` keeps every head on every tensor rank. Ulysses splits
a rank's heads over the seq group; where ``H / T`` does not divide by
``n`` (the reference asks only ``H % n == 0``), q, k and v are gathered
over the tensor group first, Ulysses runs on every head, and the rank
keeps its heads of the output (:func:`context_parallel_attention`).

``n == 1`` takes no collective: Ulysses calls ``attn_fn`` on its inputs
and the ring makes one hop. The exchanges go through a small object: the
process group's (:class:`GroupComm`: ``dist.batch_isend_irecv`` to
``i + 1`` from ``i - 1``, ``dist.all_to_all_single``,
``dist.all_gather_into_tensor``), or :class:`LoopbackComm`, which holds
all ``n`` shards in one process along a leading dim, so one card (or a
CPU test) runs every hop of an n-way ring and of its reverse in the
backward at full width (:func:`ring_attention_loopback`,
:func:`ulysses_attention_loopback`, :func:`gathered_attention_loopback`).
The loopback is test scaffolding: the training CLI never selects it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpudist_torch.ops.attention import (
    dot_product_attention, kernel_attention, multi_head_attention,
)

NEG_INF = float(np.finfo(np.float32).min)
#: the context-parallel ``attn_impl`` values of the models
CP_IMPLS = ("ring", "ulysses", "ulysses_flash")


class GroupComm:
    """This rank's exchanges with its seq peers over ``group`` (None: no
    peers, no collective). Tensors carry a leading dim of 1, this rank."""

    def __init__(self, group=None):
        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        self.ranks = [0 if group is None else dist.get_rank(group)]

    def rotate(self, tensors):
        """Send each tensor to seq rank ``i + 1``; return those received
        from ``i - 1``. Over gloo a CUDA tensor travels through host
        memory: gloo's point-to-point ops take host buffers only (its
        collectives stage CUDA tensors themselves), as ranks sharing one
        card use it."""
        i = self.ranks[0]
        dst = dist.get_global_rank(self.group, (i + 1) % self.n)
        src = dist.get_global_rank(self.group, (i - 1) % self.n)
        host = (dist.get_backend(self.group) == "gloo"
                and any(t.is_cuda for t in tensors))
        where = torch.device("cpu") if host else None
        sent = [t.to(where or t.device).contiguous() for t in tensors]
        got = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
               for t in sent]
        ops = []
        for t, g in zip(sent, got):
            ops.append(dist.P2POp(dist.isend, t, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, g, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [g.to(t.device) for g, t in zip(got, tensors)] if host else got

    def all_to_all(self, x):
        """``x [1, n, ...]``: part ``j`` to seq rank ``j``; returns
        ``[1, n, ...]`` whose part ``j`` came from rank ``j``."""
        out = torch.empty_like(x[0])
        dist.all_to_all_single(out, x[0].contiguous(), group=self.group)
        return out[None]

    def all_gather(self, x):
        """``x [1, B, S/n, ...]``, this rank's chunk -> ``[B, S, ...]``, the
        seq ranks' chunks in rank order along S."""
        part = x[0].contiguous()
        out = torch.empty((self.n * part.shape[0], *part.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, part, group=self.group)
        return _unshard(out.view(self.n, *part.shape))


class LoopbackComm:
    """All ``n`` seq ranks in one process: tensors carry a leading dim of
    ``n``, rank ``i``'s shard at ``i``; a rotation is a roll, an
    all-to-all a transpose of the two leading dims."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = list(range(n))

    def rotate(self, tensors):
        return [torch.roll(t, 1, 0) for t in tensors]

    def all_to_all(self, x):
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x):
        return _unshard(x)


def _scale(d: int) -> float:
    """The reference's ``1 / sqrt(D)``, as the float32 it multiplies by."""
    return float(np.float32(1.0 / np.sqrt(d)))


def _heads(x):
    """``[R, B, S, H, D]`` -> float32 ``[R, B, H, S, D]`` (a view when
    ``x`` is float32)."""
    return x.float().permute(0, 1, 3, 2, 4)


def _hop_mask(ranks, srcs, s: int, causal: bool, device):
    """The causal mask of one hop, ``[R, 1, 1, S, S]`` by global position:
    ``False`` when every chunk lies wholly in its query chunk's future (the
    hop adds nothing), ``None`` when nothing is masked."""
    if not causal or all(j < i for i, j in zip(ranks, srcs)):
        return None
    if all(j > i for i, j in zip(ranks, srcs)):
        return False
    pos = torch.arange(s, device=device)
    q_pos = torch.tensor(ranks, device=device)[:, None] * s + pos
    k_pos = torch.tensor(srcs, device=device)[:, None] * s + pos
    return (q_pos[:, :, None] >= k_pos[:, None, :])[:, None, None]


def _scores(qh, kh, scale: float, mask):
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    return s if mask is None else s.masked_fill(~mask, NEG_INF)


def _merge(m, l, acc, s, vh):
    """The reference's ``_online_merge`` on heads-first tensors: ``m, l
    [R, B, H, S, 1]``, ``acc [R, B, H, S, D]``, ``s [R, B, H, S, S]``."""
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    # a fully masked row keeps m at NEG_INF: exp(s - 0) = 0 for it
    m_safe = m_new.masked_fill(m_new <= NEG_INF, 0.0)
    alpha = torch.exp((m - m_safe).masked_fill(m <= NEG_INF, NEG_INF))
    p = torch.exp(s - m_safe)
    return m_new, alpha * l + p.sum(-1, keepdim=True), acc * alpha + p @ vh


class _RingAttention(torch.autograd.Function):
    """Ring attention on ``[R, B, S/n, H, D]`` shards (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal):
        r, b, s, h, d = q.shape
        scale = _scale(d)
        qh = _heads(q)
        m = torch.full((r, b, h, s, 1), NEG_INF, device=q.device)
        l = torch.zeros((r, b, h, s, 1), device=q.device)
        acc = torch.zeros((r, b, h, s, d), device=q.device)
        k_cur, v_cur = k, v
        for t in range(comm.n):
            srcs = [(i - t) % comm.n for i in comm.ranks]
            mask = _hop_mask(comm.ranks, srcs, s, causal, q.device)
            if mask is not False:
                sc = _scores(qh, _heads(k_cur), scale, mask)
                m, l, acc = _merge(m, l, acc, sc, _heads(v_cur))
            if t + 1 < comm.n:
                k_cur, v_cur = comm.rotate([k_cur, v_cur])
        # the f32 output is what the reference's delta reads (its acc / l);
        # q.dtype's copy is what the caller gets
        out32 = acc / torch.where(l == 0.0, 1.0, l)
        lse = torch.where(l > 0.0, m + torch.log(l), float("inf"))
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.comm, ctx.causal = comm, causal
        return out32.permute(0, 1, 3, 2, 4).to(q.dtype).contiguous()

    @staticmethod
    def backward(ctx, do):
        q, k, v, out32, lse = ctx.saved_tensors
        comm, causal = ctx.comm, ctx.causal
        s, d = q.shape[2], q.shape[4]
        scale = _scale(d)
        qh, doh = _heads(q), _heads(do)
        delta = (doh * out32).sum(-1, keepdim=True)
        # the reference's jax.grad of its scan rounds where its cotangents
        # change hands: each hop's dq, dk, dv leave their f32 products in
        # the inputs' dtype and are added to the running sums in it, and
        # dk, dv travel the ring in it (a no-op in f32)
        rnd = lambda x: x.to(q.dtype).float()
        dq = dk = dv = None
        k_cur, v_cur = k, v
        for t in range(comm.n):
            srcs = [(i - t) % comm.n for i in comm.ranks]
            mask = _hop_mask(comm.ranks, srcs, s, causal, q.device)
            if mask is not False:
                kh, vh = _heads(k_cur), _heads(v_cur)
                p = torch.exp(_scores(qh, kh, scale, mask) - lse)
                ds = p * (doh @ vh.transpose(-1, -2) - delta) * scale
                dq = _acc(dq, rnd(ds @ kh), rnd)
                dk = _acc(dk, rnd(ds.transpose(-1, -2) @ qh), rnd)
                dv = _acc(dv, rnd(p.transpose(-1, -2) @ doh), rnd)
            # dk, dv travel with their chunk, in the inputs' dtype: n
            # rotations bring them home
            if comm.n > 1:
                dk, dv = (torch.zeros_like(qh) if g is None else g
                          for g in (dk, dv))
                sent = [dk.to(q.dtype), dv.to(q.dtype)]
                if t + 1 < comm.n:
                    k_cur, v_cur, *sent = comm.rotate([k_cur, v_cur, *sent])
                else:
                    sent = comm.rotate(sent)
                dk, dv = (g.float() for g in sent)

        def back(g, like):
            g = torch.zeros_like(qh) if g is None else g
            return g.permute(0, 1, 3, 2, 4).to(like.dtype).contiguous()

        return back(dq, q), back(dk, k), back(dv, v), None, None


def _acc(total, part, rnd):
    """``total + part`` rounded as the reference's cotangent sums are
    (``total`` None: nothing summed yet)."""
    return part if total is None else rnd(total + part)


class _AllToAll(torch.autograd.Function):
    """``comm.all_to_all`` with itself as its backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g.contiguous()), None


def _to_heads(x, comm):
    """``[R, B, S/n, H, D]`` -> ``[R, B, S, H/n, D]``: head group ``j`` to
    rank ``j``, the received chunks concatenated along S."""
    r, b, s, h, d = x.shape
    n = comm.n
    y = x.reshape(r, b, s, n, h // n, d).permute(0, 3, 1, 2, 4, 5).contiguous()
    y = _AllToAll.apply(y, comm)  # [R, source chunk, B, S/n, H/n, D]
    return y.permute(0, 2, 1, 3, 4, 5).reshape(r, b, n * s, h // n, d)


def _to_seq(x, comm):
    """The inverse of :func:`_to_heads`."""
    r, b, s_all, hn, d = x.shape
    n = comm.n
    y = x.reshape(r, b, n, s_all // n, hn, d).permute(0, 2, 1, 3, 4, 5)
    y = _AllToAll.apply(y.contiguous(), comm)  # [R, source group, ...]
    return y.permute(0, 2, 3, 1, 4, 5).reshape(r, b, s_all // n, n * hn, d)


def _ulysses(q, k, v, comm, causal: bool, attn_fn):
    r, b = q.shape[:2]
    qh, kh, vh = (_to_heads(x, comm).flatten(0, 1) for x in (q, k, v))
    out = attn_fn(qh, kh, vh, causal=causal)
    return _to_seq(out.unflatten(0, (r, b)), comm)


def _check_ring(q, k, v):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape [B, S/n, "
                         f"H, D] (repeat grouped K/V heads first), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _check_ulysses(q, n: int):
    if q.shape[2] % n:
        raise ValueError(f"num_heads {q.shape[2]} not divisible by seq axis {n}")


def ring_attention_local(q, k, v, *, group=None, causal: bool = False):
    """Ring attention on this rank's chunk ``[B, S/n, H, D]`` over the seq
    ``group`` (None: one rank)."""
    _check_ring(q, k, v)
    return _RingAttention.apply(q[None], k[None], v[None], GroupComm(group),
                                causal)[0]


def ulysses_attention_local(q, k, v, *, group=None, causal: bool = False,
                            attn_fn=None):
    """Ulysses attention on this rank's chunk ``[B, S/n, H, D]`` over the
    seq ``group``; ``attn_fn(q, k, v, causal=...)`` defaults to the dense
    attention."""
    comm = GroupComm(group)
    _check_ulysses(q, comm.n)
    attn_fn = attn_fn or dot_product_attention
    if comm.n == 1:
        return attn_fn(q, k, v, causal=causal)
    return _ulysses(q[None], k[None], v[None], comm, causal, attn_fn)[0]


def _shards(x, n: int):
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} not divisible by {n} shards")
    return torch.stack(x.chunk(n, dim=1))


def _unshard(x):
    return torch.cat(x.unbind(0), dim=1)


def ring_attention_loopback(q, k, v, n: int, *, causal: bool = False):
    """The n-way ring on whole ``[B, S, H, D]`` inputs, all ``n`` ranks in
    this process (:class:`LoopbackComm`)."""
    _check_ring(q, k, v)
    return _unshard(_RingAttention.apply(_shards(q, n), _shards(k, n),
                                         _shards(v, n), LoopbackComm(n),
                                         causal))


def ulysses_attention_loopback(q, k, v, n: int, *, causal: bool = False,
                               attn_fn=None):
    """n-way Ulysses on whole ``[B, S, H, D]`` inputs, all ``n`` ranks in
    this process (:class:`LoopbackComm`)."""
    _check_ulysses(q, n)
    return _unshard(_ulysses(_shards(q, n), _shards(k, n), _shards(v, n),
                             LoopbackComm(n), causal,
                             attn_fn or dot_product_attention))


class _GatheredAttention(torch.autograd.Function):
    """:func:`gathered_attention` on ``[R, B, S/n, H, D]`` shards."""

    @staticmethod
    def forward(ctx, q, k, v, attn_fn, comm, causal):
        s = q.shape[2]
        whole = [comm.all_gather(x) for x in (q, k, v)]
        grad = any(ctx.needs_input_grad[:3])
        outs, graphs = [], []
        for i in comm.ranks:
            # each rank's own call on the whole sequence, whose graph its
            # backward walks again with the whole cotangent
            leaves = [x.detach().requires_grad_(grad) for x in whole]
            with torch.enable_grad() if grad else torch.no_grad():
                out = attn_fn(*leaves, causal=causal)
            outs.append(out.detach()[:, i * s:(i + 1) * s])
            graphs.append((out, leaves))
        ctx.graphs, ctx.comm, ctx.s = graphs, comm, s
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, do):
        comm, s = ctx.comm, ctx.s
        do = comm.all_gather(do)
        grads = []
        for i, (out, leaves) in zip(comm.ranks, ctx.graphs):
            g = torch.autograd.grad(out, leaves, do)
            grads.append([x[:, i * s:(i + 1) * s] for x in g])
        ctx.graphs = None
        return (*(torch.stack(list(x)) for x in zip(*grads)), None, None,
                None)


def gathered_attention(q, k, v, attn_fn, comm, causal: bool):
    """A non-context-parallel ``attn_fn(q, k, v, causal=...)`` over the
    whole sequence of a seq group (module docstring): ``q, k, v`` are the
    ranks' chunks ``[R, B, S/n, H(_kv), D]`` (``R`` the ranks ``comm``
    holds: one for :class:`GroupComm`, ``n`` for :class:`LoopbackComm`),
    the result this rank's rows of the output, ``[R, B, S/n, H, D]``."""
    if comm.n == 1:
        return attn_fn(q[0], k[0], v[0], causal=causal)[None]
    return _GatheredAttention.apply(q, k, v, attn_fn, comm, causal)


def gathered_attention_local(q, k, v, *, group=None, causal: bool = False,
                             attn_fn=None):
    """:func:`gathered_attention` on this rank's chunk ``[B, S/n, H, D]``
    over the seq ``group`` (the dense attention by default, grouped K/V
    heads repeated)."""
    return gathered_attention(q[None], k[None], v[None],
                              attn_fn or multi_head_attention,
                              GroupComm(group), causal)[0]


def gathered_attention_loopback(q, k, v, n: int, *, causal: bool = False,
                                attn_fn=None):
    """n-way :func:`gathered_attention` on whole ``[B, S, H, D]`` inputs,
    all ``n`` ranks in this process (:class:`LoopbackComm`): each rank's
    attention runs once over the whole sequence."""
    return _unshard(gathered_attention(
        _shards(q, n), _shards(k, n), _shards(v, n),
        attn_fn or multi_head_attention, LoopbackComm(n), causal))


def _gather_heads(x, layout):
    """``[B, s, H / T, D]`` -> ``[B, s, H, D]``, the tensor ranks' heads in
    rank order (backward: this rank's heads of the gradient)."""
    from tpudist_torch.parallel.tp import gather_from_tensor

    return gather_from_tensor(x.movedim(2, -1), layout).movedim(-1, 2)


def context_parallel_attention(q, k, v, impl: str, group, *, causal: bool,
                               layout=None):
    """The models' context-parallel attention by ``attn_impl``: ``"ring"``,
    ``"ulysses"`` (dense per head group) or ``"ulysses_flash"`` (the
    kernels, :func:`~tpudist_torch.ops.attention.kernel_attention`), on
    the heads this rank holds. ``layout``: the model's, whose tensor group
    Ulysses gathers the heads over when a rank's do not divide over the
    seq group (module docstring)."""
    if impl == "ring":
        return ring_attention_local(q, k, v, group=group, causal=causal)
    attn_fn = kernel_attention if impl == "ulysses_flash" else None
    n = 1 if group is None else dist.get_world_size(group)
    t = getattr(layout, "tensor", 1) if layout is not None else 1
    if t == 1 or q.shape[2] % n == 0:
        return ulysses_attention_local(q, k, v, group=group, causal=causal,
                                       attn_fn=attn_fn)
    h = q.shape[2]
    out = ulysses_attention_local(
        *(_gather_heads(x, layout) for x in (q, k, v)), group=group,
        causal=causal, attn_fn=attn_fn)
    i = layout.tensor_idx
    return out[:, :, i * h:(i + 1) * h]
