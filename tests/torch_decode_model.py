"""A numerical model of the decode-attention kernels' arithmetic
(tpudist_torch/csrc/decode_attention.cu), for the CPU tests: the same
roundings in the same places, on the CPU in float32.

- Scores are f32 dot products of the inputs, times the scale; masked slots
  get NEG_INF.
- p is rounded to v's dtype exactly where the kernels round it. In the
  contiguous kernel that is against the max over all slots <= pos, the
  parts of a split having exchanged their maxes first. In the paged kernel
  it is against m_j, the running max through pool block j, each part of a
  split seeded with the max of all pool blocks before its own.
- PV runs in column-owning partials: each of ``slices`` slot slices (slot
  t in slice t % slices) is summed on its own and the slices are added in
  order. The paged rescales are folded into the weights:
  ``exp(m_j - m_end) * cast(exp(s - m_j))``, each part holding the scores
  of its whole walk.
- The parts' numerators and denominators are combined in rank order
  (paged: each scaled from its own running max to the largest).

``own_max=True`` models the scheme that computes another function: each
part rounds p against its own max (contiguous) or starts its running max
from NEG_INF (paged), and the parts are rescaled afterwards."""

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)


def _pv(w, v, slices):
    """``sum_t w[..., t] v[t]`` as column-owning partials: slot t in slice
    t % slices, each slice summed alone, the slices added in order."""
    out = None
    for sl in range(slices):
        part = torch.einsum("...t,td->...d", w[..., sl::slices], v[sl::slices])
        out = part if out is None else out + part
    return out


def _split(n_units, parts):
    """``(lo, hi)`` unit ranges of the parts that get at least one unit."""
    ns = min(parts, n_units)
    return [(i * n_units // ns, (i + 1) * n_units // ns) for i in range(ns)]


def contiguous_model(q, k, v, pos, *, parts=1, tile=16, slices=4,
                     own_max=False):
    """q ``[B, 1, H, dh]``, k/v ``[B, H_kv, S, dh]``, scalar ``pos`` ->
    ``[B, 1, H, dh]``: the contiguous kernel with the slots <= pos in
    tiles of ``tile`` shared by ``parts`` parts."""
    b, _, h, dh = q.shape
    h_kv = k.shape[1]
    ratio = h // h_kv
    scale = 1.0 / float(np.sqrt(dh))
    n = pos + 1
    qh = q.reshape(b, h_kv, ratio, dh).float()
    s = torch.einsum("bgrd,bgtd->bgrt", qh, k[:, :, :n].float()) * scale
    n_tiles = (n + tile - 1) // tile
    ranges = [(lo * tile, min(n, hi * tile)) for lo, hi in _split(n_tiles, parts)]
    m_all = s.amax(-1, keepdim=True)
    nums, dens, maxes = [], [], []
    for lo, hi in ranges:
        sp = s[..., lo:hi]
        m = sp.amax(-1, keepdim=True) if own_max else m_all
        p = torch.exp(sp - m)
        dens.append(p.sum(-1, keepdim=True))
        w = p.to(v.dtype).float()
        nums.append(torch.stack([torch.stack([
            _pv(w[i, g], v[i, g, lo:hi].float(), slices)
            for g in range(h_kv)]) for i in range(b)]))
        maxes.append(m)
    top = torch.stack(maxes).amax(0)
    num = sum(torch.exp(m - top) * x for m, x in zip(maxes, nums))
    den = sum(torch.exp(m - top) * x for m, x in zip(maxes, dens))
    return (num / den).to(q.dtype).reshape(b, 1, h, dh)


def paged_model(q, k_pool, v_pool, tables, positions, *, parts=1, gb=1,
                slices=4, own_max=False):
    """q ``[B, s_q, H, dh]``, pools ``[N, H_kv, bs, dh]``, tables ``[B,
    mb]``, positions ``[B]`` -> ``[B, s_q, H, dh]``: the paged kernel with
    each row's walk in units of ``gb`` pool blocks shared by ``parts``
    parts."""
    b, s_q, h, dh = q.shape
    h_kv, bs = k_pool.shape[1], k_pool.shape[2]
    mb = tables.shape[1]
    ratio = h // h_kv
    scale = 1.0 / float(np.sqrt(dh))
    out = torch.empty(b, s_q, h, dh, dtype=q.dtype)
    for i in range(b):
        pos = int(positions[i])
        nblk = min((pos + s_q - 1) // bs, mb - 1) + 1
        qh = q[i].permute(1, 0, 2).reshape(h_kv, ratio * s_q, dh).float()
        lim = pos + torch.arange(s_q).repeat(ratio)  # per query row
        blocks = [int(t) for t in tables[i, :nblk]]
        kw = torch.cat([k_pool[j] for j in blocks], 1).float()  # [H_kv, n, dh]
        vw = torch.cat([v_pool[j] for j in blocks], 1).float()
        s = torch.einsum("grd,gtd->grt", qh, kw) * scale
        slot = torch.arange(nblk * bs)
        s = torch.where(slot[None, None, :] <= lim[None, :, None], s, NEG_INF)
        n_units = (nblk + gb - 1) // gb
        ranges = [(lo * gb, min(nblk, hi * gb)) for lo, hi in _split(n_units, parts)]
        block_max = s.reshape(h_kv, ratio * s_q, nblk, bs).amax(-1)
        nums, dens, ends = [], [], []
        for lo, hi in ranges:
            seed = (block_max[..., :lo].amax(-1) if lo and not own_max
                    else torch.full(block_max.shape[:2], NEG_INF))
            # the running max m_j through each block, from the part's seed
            run = torch.cummax(torch.cat(
                [seed[..., None], block_max[..., lo:hi]], -1), -1).values[..., 1:]
            m_end = run[..., -1]
            m_j = run.repeat_interleave(bs, -1)  # per slot
            e = torch.exp(s[..., lo * bs:hi * bs] - m_j)
            f = torch.exp(m_j - m_end[..., None])
            w = f * e.to(v_pool.dtype).float()
            dens.append((f * e).reshape(*e.shape[:2], hi - lo, bs)
                        .sum(-1).sum(-1))
            nums.append(torch.stack([_pv(w[g], vw[g, lo * bs:hi * bs], slices)
                                     for g in range(h_kv)]))
            ends.append(m_end)
        top = torch.stack(ends).amax(0)
        num = sum(torch.exp(e - top)[..., None] * x for e, x in zip(ends, nums))
        den = sum(torch.exp(e - top) * x for e, x in zip(ends, dens))
        o = (num / den[..., None]).reshape(h, s_q, dh).permute(1, 0, 2)
        out[i] = o.to(q.dtype)
    return out
