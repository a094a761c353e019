"""KV-cache machinery and decode attention.

Counterpart of :mod:`tpudist.ops.decode`. A layer's decode cache is a
plain dict ``{"k": Tensor, "v": Tensor, "index": int}``; :func:`cached_kv`
writes the step's K/V into it IN PLACE (the reference's functional
update, done as PyTorch does it). Three modes, as in the reference:

- scalar cursor (``cache["index"]``): the contiguous head-major
  ``[B, H, max_len, dh]`` buffers of :func:`tpudist_torch.generate.generate`;
- per-row ``positions``: the contiguous slot pool of the serving engine;
- paged ``block_tables`` (with ``positions``): the shared block pool
  ``[n_blocks, H_kv, block_size, dh]`` of :mod:`tpudist_torch.serve.blocks`.

Two kernels serve the decode path, each with a plain PyTorch version of
the same function beside it and a launch counter
(:data:`launch_counts`):

- :func:`fused_decode_attention` — one query token over the contiguous
  cache, slots ``<= pos`` (scalar cursor). Replaces the Pallas
  ``_decode_kernel`` (``tpudist/ops/decode.py::_fused_decode_attention``).
- :func:`paged_fused_attention` — ``s_q`` query rows over the paged pool,
  walking each row's block table up to its cursor with an online softmax.
  Replaces the Pallas ``_paged_decode_kernel``
  (``tpudist/ops/decode.py::_paged_fused_attention``).

What bounds them on the H100: bytes. Each reads every K/V element up to
the row's cursor once, ``2 * sum_b H_kv * slots_b * dh * itemsize``, and
does two multiply-adds per element, far below the card's 295 operations
per byte. The CUDA design (``tpudist_torch/csrc/decode_attention.cu``)
keeps scores, probabilities and running sums on chip, reads only the
slots the mask admits, and keeps loads in flight: one block per (row, kv
head) serving the whole GQA group, K/V tiles of up to 16 KB brought in by
the TMA's bulk copies through a ring of shared-memory stages,
column-owning f32 PV partials summed once after the walk, and, where the
grid is short, the walk split over a thread-block cluster whose parts
exchange their maxes (contiguous: the global max before any p; paged:
each part seeded with the max of all earlier pool blocks), so p is
rounded where the serial function rounds it. PERF.md has their times
against the bound.

The wrappers take the plain version only for tensors on the CPU. On a
CUDA tensor they launch the kernel or raise, as the kernel's launch does
(``RuntimeError``) for an input whose scores fit in shared memory in no
split: a part holds the scores of its whole walk, so the longest cursor
taken falls with the query rows a block serves (``s_q`` times the heads).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpudist_torch.ops.attention import repeat_kv

NEG_INF = float(np.finfo(np.float32).min)

#: the kernels' limits (checked again in C): head dim, query rows per
#: paged launch (the speculative verify width the reference serves)
MAX_HEAD_DIM = 256
PAGED_MAX_SQ = 16

#: launches of each kernel, counted where the wrapper launches it and
#: nowhere else (the plain versions never count)
launch_counts = {"fused_decode_attention": 0, "paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the cache


def cached_kv(cache: dict, k, v, *, positions=None, block_tables=None):
    """Write this step's K/V (``[B, s, H, dh]``) into a layer's ``cache``
    dict in place.

    Scalar mode (no ``positions``): the chunk lands at
    ``cache["index"] .. + s`` and the cursor advances; returns
    ``(keys, values, mask [1, 1, s, max_len], pos)``, causal within the
    chunk (slot ``t`` attendable by chunk row ``i`` iff ``t <= pos + i``).

    ``positions`` ``[B]`` (int tensor on the cache's device): row ``b``'s
    entries land at ``pos_b .. pos_b + s - 1``; entries at or past
    ``max_len`` write nothing (the reference's self-clamp); the cursor is
    neither read nor advanced. Returns ``(keys, values, mask [B, 1, s,
    max_len], positions)``.

    ``block_tables`` ``[B, max_blocks]`` (with ``positions``): the cache
    holds the shared pool ``[n_blocks, H_kv, bs, dh]``; row ``b``'s entry
    at ``p`` lands at ``(table[b, p // bs], p % bs)`` (block 0, the
    garbage block, where the table maps nothing), and an entry past the
    table's extent writes nothing: a speculative verify window's tail
    past ``max_seq_len`` can hold NaN, and a live row walking an unmapped
    block reads the garbage block as masked slots, whose ``p = 0`` times a
    NaN would poison it. Returns ``(k_pool, v_pool, block_tables,
    positions)``.
    """
    b, s, h, dh = k.shape
    ck, cv = cache["k"], cache["v"]
    kt = k.to(ck.dtype).transpose(1, 2)  # [B, H, s, dh]
    vt = v.to(cv.dtype).transpose(1, 2)
    if block_tables is not None:
        if positions is None:
            raise ValueError("paged decode needs per-row positions")
        bs_blk = ck.shape[2]
        if tuple(positions.shape) != (b,):
            raise ValueError(f"positions must be [{b}], got {tuple(positions.shape)}")
        if block_tables.ndim != 2 or block_tables.shape[0] != b:
            raise ValueError(
                f"block_tables must be [{b}, max_blocks], got "
                f"{tuple(block_tables.shape)}"
            )
        mb = block_tables.shape[1]
        pos = positions.long()
        for i in range(s):
            p = pos + i
            lb = torch.div(p, bs_blk, rounding_mode="floor")
            mapped = block_tables.gather(1, lb.clamp(max=mb - 1)[:, None])[:, 0]
            inside = lb < mb
            blk = torch.where(inside, mapped.long(), 0)
            off = p % bs_blk
            keep = inside[:, None, None]
            ck[blk, :, off] = torch.where(keep, kt[:, :, i], ck[blk, :, off])
            cv[blk, :, off] = torch.where(keep, vt[:, :, i], cv[blk, :, off])
        return ck, cv, block_tables, positions
    max_len = ck.shape[2]
    if positions is not None:
        if tuple(positions.shape) != (b,):
            raise ValueError(f"positions must be [{b}], got {tuple(positions.shape)}")
        pos = positions.long()
        rows = torch.arange(b, device=ck.device)
        for i in range(s):
            p = pos + i
            pc = p.clamp(max=max_len - 1)
            keep = (p < max_len)[:, None, None]
            ck[rows, :, pc] = torch.where(keep, kt[:, :, i], ck[rows, :, pc])
            cv[rows, :, pc] = torch.where(keep, vt[:, :, i], cv[rows, :, pc])
        slots = torch.arange(max_len, device=ck.device)
        row_pos = pos[:, None] + torch.arange(s, device=ck.device)[None, :]
        mask = slots[None, None, :] <= row_pos[:, :, None]  # [B, s, max_len]
        return ck, cv, mask[:, None], positions
    pos = int(cache["index"])
    if pos + s > max_len:
        raise ValueError(
            f"cache write at {pos}..{pos + s} past max_len {max_len}"
        )
    ck[:, :, pos:pos + s] = kt
    cv[:, :, pos:pos + s] = vt
    cache["index"] = pos + s
    slots = torch.arange(max_len, device=ck.device)
    rows = pos + torch.arange(s, device=ck.device)
    mask = slots[None, :] <= rows[:, None]  # [s, max_len]
    return ck, cv, mask[None, None], pos


# ---------------------------------------------------------------------------
# scores


def dot_kernel_order(q, k):
    """``[..., R, T]`` f32 dot products of bf16 ``q [..., R, dh]`` and
    ``k [..., T, dh]``, summed in the CUDA kernels' order: lane ``l`` of a
    group of 8 adds the 8-column chunks ``l, l + 8, ...`` in turn, element
    by element (a product of two bf16 values is exact in f32, so the
    kernels' fma is this add), and the 8 lanes meet by xor shuffles 4, 2,
    1. The f32 sum's order decides where p = exp(s - m) rounds to bf16."""
    dh = q.shape[-1]
    pad = -dh % 64  # zero columns add exact zeros
    qf = torch.nn.functional.pad(q.float(), (0, pad))
    kf = torch.nn.functional.pad(k.float(), (0, pad))
    steps = (dh + pad) // 64
    prod = (qf[..., :, None, :] * kf[..., None, :, :]).unflatten(
        -1, (steps, 8, 8))  # [..., R, T, step, lane, element]
    a = torch.zeros(prod.shape[:-3] + (8,), device=q.device)
    for i in range(steps):
        for e in range(8):
            a = a + prod[..., i, :, e]
    a = a + a[..., [4, 5, 6, 7, 0, 1, 2, 3]]
    a = a + a[..., [2, 3, 0, 1, 6, 7, 4, 5]]
    return a[..., 0] + a[..., 1]


def _dot(q, k):
    """f32 ``q . k`` over the last axis (``[..., R, dh]``, ``[..., T, dh]``
    -> ``[..., R, T]``); bf16 operands on the card sum in the kernels'
    order (:func:`dot_kernel_order`), so a check of the kernels' bf16
    output sees where they round p, not how an einsum orders its sums."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        return dot_kernel_order(q, k)
    return torch.einsum("...rd,...td->...rt", q.float(), k.float())


# ---------------------------------------------------------------------------
# contiguous decode attention


def fused_decode_attention_plain(q, keys, values, pos: int):
    """The kernel's function in plain PyTorch: q ``[B, 1, H, dh]``,
    keys/values ``[B, H_kv, S, dh]``, scalar ``pos`` -> ``[B, 1, H, dh]``.
    f32 scores over slots ``<= pos``, global max, ``p = exp(s - m)``,
    ``o = (sum_t cast(p_t) v_t) / sum_t p_t``, p cast to v's dtype."""
    b, _, h, dh = q.shape
    h_kv = keys.shape[1]
    ratio = h // h_kv
    sm_scale = 1.0 / float(np.sqrt(dh))
    s = _dot(q.reshape(b, h_kv, ratio, dh), keys[:, :, :pos + 1]) * sm_scale
    vw = values[:, :, :pos + 1]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrt,bgtd->bgrd", p.to(vw.dtype).float(), vw.float())
    return (o / l).to(q.dtype).reshape(b, 1, h, dh)


def _cuda_args_ok(name, q, *tensors):
    if not q.is_cuda:
        raise ValueError(f"{name}: q is not a CUDA tensor")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not in (float32, bfloat16)")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensors on {q.device}, current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    for t in (q, *tensors):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every argument must be contiguous")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > {MAX_HEAD_DIM}")


def fused_decode_attention_cuda(q, keys, values, pos: int, *, lib=None):
    """Launch the contiguous decode kernel (see module docstring).
    ``lib``: another build of the same C interface (an A/B)."""
    from tpudist_torch.csrc import build

    _cuda_args_ok("fused_decode_attention", q, keys, values)
    b, s_q, h, dh = q.shape
    if s_q != 1:
        raise ValueError("fused decode attention is single-token")
    if keys.ndim != 4 or keys.shape != values.shape or keys.shape[0] != b \
            or keys.shape[3] != dh:
        raise ValueError(
            f"keys/values must be [{b}, H_kv, S, {dh}], got "
            f"{tuple(keys.shape)} / {tuple(values.shape)}"
        )
    if keys.dtype != q.dtype or values.dtype != q.dtype:
        raise ValueError("q, keys and values must share one dtype")
    h_kv, s_len = keys.shape[1], keys.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    pos = int(pos)
    if not 0 <= pos < s_len:
        raise ValueError(f"pos {pos} outside [0, {s_len})")
    lib = lib or build.load()
    out = torch.empty_like(q)
    rc = lib.tpudist_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), keys.data_ptr(),
        values.data_ptr(), out.data_ptr(), b, h, h_kv, s_len, dh, pos,
        ctypes.c_float(1.0 / float(np.sqrt(dh))),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, rc, f"fused_decode_attention (B {b}, H {h}, H_kv {h_kv}, "
                         f"dh {dh}, pos {pos})")
    launch_counts["fused_decode_attention"] += 1
    return out


def fused_decode_attention(q, keys, values, pos: int):
    """The contiguous kernel's wrapper: the plain version on CPU tensors,
    the CUDA kernel on CUDA tensors."""
    if q.is_cuda:
        return fused_decode_attention_cuda(q, keys, values, pos)
    return fused_decode_attention_plain(q, keys, values, pos)


def decode_attention(q, keys, values, mask, pos, *, impl: str = "fused",
                     bias=None, scale=None):
    """Attention of ``q [B, s, H, dh]`` over the head-major cache buffers
    from :func:`cached_kv`. ``impl="fused"`` runs the kernel when its
    semantic gates hold (no bias, default scale, one token, whole head
    groups, a scalar cursor); otherwise, and for ``impl="xla"``, the dense
    oracle runs. The reference's batch cap and VMEM panel bound are v5e
    tuning and are not carried over."""
    fused_ok = (
        bias is None
        and scale is None
        and q.shape[1] == 1
        and q.shape[2] % keys.shape[1] == 0
        and isinstance(pos, int)
    )
    if impl == "fused" and fused_ok:
        return fused_decode_attention(q, keys, values, pos)
    if keys.shape[1] != q.shape[2]:
        keys, values = repeat_kv(q, keys, values, head_axis=1)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), keys.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bqhd", probs, values)


# ---------------------------------------------------------------------------
# paged decode attention


def paged_fused_attention_plain(q, k_pool, v_pool, block_tables, positions):
    """The paged kernel's function in plain PyTorch: q ``[B, s_q, H, dh]``,
    pools ``[N, H_kv, bs, dh]``, tables ``[B, mb]``, positions ``[B]`` ->
    ``[B, s_q, H, dh]``. Walks logical blocks ``j <= min((pos + s_q - 1)
    // bs, mb - 1)`` with a per-query-row online softmax (running max,
    denominator and numerator in f32, p cast to v's dtype before PV), as
    the kernel does."""
    b, s_q, h, dh = q.shape
    h_kv, bs = k_pool.shape[1], k_pool.shape[2]
    mb = block_tables.shape[1]
    ratio = h // h_kv
    sm_scale = 1.0 / float(np.sqrt(dh))
    dev = q.device
    qh = q.permute(0, 2, 1, 3).reshape(b, h_kv, ratio * s_q, dh)
    pos = positions.long()
    last = torch.div(pos + s_q - 1, bs, rounding_mode="floor").clamp(max=mb - 1)
    row_lim = pos[:, None] + torch.arange(s_q, device=dev)[None, :]  # [B, s_q]
    m = torch.full((b, h_kv, ratio, s_q), NEG_INF, device=dev)
    l = torch.zeros((b, h_kv, ratio, s_q), device=dev)
    acc = torch.zeros((b, h_kv, ratio, s_q, dh), device=dev)
    for j in range(mb):
        blk = block_tables[:, j].long()
        vb = v_pool[blk]
        s = _dot(qh, k_pool[blk]).reshape(b, h_kv, ratio, s_q, bs) * sm_scale
        slot = j * bs + torch.arange(bs, device=dev)
        allowed = slot[None, None, :] <= row_lim[:, :, None]  # [B, s_q, bs]
        s = torch.where(allowed[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = alpha * l + p.sum(-1)
        pv = torch.einsum("bgrqt,bgtd->bgrqd", p.to(vb.dtype).float(), vb.float())
        acc_new = alpha[..., None] * acc + pv
        step = (j <= last)[:, None, None, None]  # rows still walking
        m = torch.where(step, m_new, m)
        l = torch.where(step, l_new, l)
        acc = torch.where(step[..., None], acc_new, acc)
    o = (acc / l[..., None]).reshape(b, h, s_q, dh)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def paged_fused_attention_cuda(q, k_pool, v_pool, block_tables, positions,
                               *, lib=None):
    """Launch the paged decode kernel (see module docstring).
    ``lib``: another build of the same C interface (an A/B)."""
    from tpudist_torch.csrc import build

    _cuda_args_ok("paged_decode_attention", q, k_pool, v_pool,
                  block_tables, positions)
    b, s_q, h, dh = q.shape
    if not 1 <= s_q <= PAGED_MAX_SQ:
        raise ValueError(f"paged decode takes 1..{PAGED_MAX_SQ} query rows, got {s_q}")
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != dh:
        raise ValueError(
            f"pools must be [N, H_kv, bs, {dh}], got {tuple(k_pool.shape)} "
            f"/ {tuple(v_pool.shape)}"
        )
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("q and the pools must share one dtype")
    h_kv, bs = k_pool.shape[1], k_pool.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be int32 [{b}, max_blocks]")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (b,):
        raise ValueError(f"positions must be int32 [{b}]")
    mb = block_tables.shape[1]
    lib = lib or build.load()
    out = torch.empty_like(q)
    rc = lib.tpudist_paged_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), positions.data_ptr(),
        out.data_ptr(), b, h, h_kv, s_q, dh, bs, mb,
        ctypes.c_float(1.0 / float(np.sqrt(dh))),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, rc, f"paged_decode_attention (B {b}, s_q {s_q}, H {h}, "
                         f"H_kv {h_kv}, dh {dh}, bs {bs}, max_blocks {mb})")
    launch_counts["paged_decode_attention"] += 1
    return out


def paged_fused_attention(q, k_pool, v_pool, block_tables, positions):
    """The paged kernel's wrapper: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors."""
    if q.is_cuda:
        return paged_fused_attention_cuda(q, k_pool, v_pool, block_tables,
                                          positions)
    return paged_fused_attention_plain(q, k_pool, v_pool, block_tables,
                                       positions)


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions, *,
                           impl: str = "paged"):
    """Attention over the paged pool from :func:`cached_kv`'s block-table
    mode. ``impl="paged"`` runs the kernel (no batch bound: it reads only
    blocks up to each row's cursor); ``impl="xla"`` gathers every row's
    ``max_blocks * block_size`` window and runs the dense oracle."""
    if impl == "paged" and q.shape[2] % k_pool.shape[1] == 0:
        return paged_fused_attention(q, k_pool, v_pool, block_tables,
                                     positions)
    b, s_q = q.shape[0], q.shape[1]
    h_kv, bs = k_pool.shape[1], k_pool.shape[2]
    mb = block_tables.shape[1]
    bt = block_tables.long()
    keys = k_pool[bt].transpose(1, 2).reshape(b, h_kv, mb * bs, -1)
    values = v_pool[bt].transpose(1, 2).reshape(b, h_kv, mb * bs, -1)
    slots = torch.arange(mb * bs, device=q.device)
    rows = positions.long()[:, None] + torch.arange(s_q, device=q.device)[None, :]
    mask = (slots[None, None, :] <= rows[:, :, None])[:, None]  # [B, 1, s_q, mb*bs]
    return decode_attention(q, keys, values, mask, 0, impl="xla")
