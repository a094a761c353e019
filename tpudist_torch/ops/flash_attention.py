"""Blockwise (FlashAttention-2) attention for long sequences.

Counterpart of :mod:`tpudist.ops.flash_attention`. The kernels
(``tpudist_torch/csrc/flash_attention.cu``) replace the Pallas
``_fwd_kernel`` reached through ``_flash_fwd`` and the ``_bwd_dkv_kernel``
and ``_bwd_dq_kernel`` reached through ``_bwd_pallas``. The forward keeps
an online softmax over 128-key tiles from key 0: f32 scores ``q.k * scale``
masked with the finite ``finfo(f32).min``, the running max updated once
per tile, ``p = exp(s - m)`` cast to v's dtype before the value product,
and the row log-sum-exp saved for the backward. The backward recomputes
``p`` from it and runs every product on f32 values, with no rounding of
``p`` or ``ds``. In bf16 the kernels run every product on the tensor
cores (``csrc/attention_mma.cuh``), the backward's ``p`` and ``ds``
carried as hi + lo bf16 pairs; in f32 they are SIMT kernels.

:func:`flash_attention` keeps the reference wrapper's contract on the
models' ``[B, S, H, D]`` layout: keys past ``kv_len`` and past S are
masked and query rows past S are dropped (the kernels mask the ragged
tails themselves, so nothing is padded), ``causal`` needs ``s_q == s_k``,
and block sizes that do not tile S rounded up to 128 raise
``NotImplementedError``, as the reference does: callers
(``multi_head_attention``) route those refusals to the dense path. K/V
carry as many heads as q (the reference has no native GQA; the router
repeats grouped heads first). It is a ``torch.autograd.Function`` with
residuals ``(q, k, v, o, lse)``.

``pallas_bwd`` is accepted and has no effect. The reference runs its
Pallas backward only when asked and otherwise the blockwise ``lax.scan``
backward ``_bwd_blockwise``; the two compute the same function, and the
choice is a v5e speed measurement. On the card the backward always runs
the CUDA kernels; :func:`flash_bwd_plain` is the port of
``_bwd_blockwise``.

Each wrapper takes the kernel for CUDA tensors and its plain PyTorch
version (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`) only for CPU
tensors. On the card a head dim past :data:`MAX_HEAD_DIM` or a
``block_k`` other than :data:`KERNEL_BLOCK_K` raises ``ValueError``,
which no router catches. :data:`launch_counts` counts kernel launches:
one per forward call, and one per backward call, which launches its
three kernels (the ``delta`` pre-pass, dk/dv, dq) together.
"""

from __future__ import annotations

import torch

from tpudist_torch.ops.vmem_attention import (
    MAX_HEAD_DIM, NEG_INF, _dot, _scale, launch_bwd, launch_fwd,
)

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
#: the key tile of the CUDA forward: the running max is updated once per
#: tile, so another ``block_k`` is another bf16 function
KERNEL_BLOCK_K = 128

#: launches of the kernels, counted where the wrappers launch them and
#: nowhere else (the plain versions never count)
launch_counts = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _heads_first(t):
    """``[B, S, H, D]`` -> f32 ``[B, H, S, D]``."""
    return t.float().transpose(1, 2)


def _mask(s, q_pos, k0, *, causal: bool, k_end: int):
    """``s [B, H, Sq, bk]`` with the keys from ``k0`` masked as the kernels
    mask them: at or past ``k_end``, and above the diagonal under
    ``causal``."""
    k_pos = k0 + torch.arange(s.shape[-1], device=s.device)
    keep = (k_pos < k_end)[None, :]
    if causal:
        keep = keep & (q_pos[:, None] >= k_pos[None, :])
    return torch.where(keep, s, NEG_INF)


def flash_fwd_plain(q, k, v, *, causal: bool, kv_len: int, scale: float,
                    block_k: int = DEFAULT_BLOCK_K, dot=_dot):
    """The forward kernel's function in plain PyTorch: ``(o [B, Sq, H, D]
    in q's dtype, lse [B, H, Sq] f32)``. An online softmax over key tiles
    of ``block_k`` from key 0, ``p`` rounded to v's dtype against the
    running max, as the Pallas kernel does; tiles past ``kv_len`` (and
    above the diagonal under ``causal``) add nothing and are skipped.
    ``s = q k^T`` is summed by ``dot`` as the kernel sums it
    (:func:`tpudist_torch.ops.vmem_attention._dot`: on the tensor cores
    for bf16 on the card), since the rounding of p makes ``o`` jump with
    the order of those sums (``lm_kernels_bench --order``)."""
    b, s_q, h, d = q.shape
    k_end = min(kv_len, k.shape[1])
    vt = v.transpose(1, 2)
    m = torch.full((b, h, s_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_q, 1), device=q.device)
    acc = torch.zeros((b, h, s_q, d), device=q.device)
    q_pos = torch.arange(s_q, device=q.device)
    stop = min(k_end, s_q) if causal else k_end
    for k0 in range(0, stop, block_k):
        s = dot(q, k[:, k0:k0 + block_k])
        s = _mask(s * scale, q_pos, k0, causal=causal, k_end=k_end)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                          vt[:, :, k0:k0 + block_k].float())
        acc = acc * alpha + pv
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = (acc / safe_l).to(q.dtype).transpose(1, 2)
    return o, (m + torch.log(safe_l))[..., 0]


def flash_bwd_plain(q, k, v, o, do, lse, *, causal: bool, kv_len: int,
                    scale: float):
    """The backward kernels' function in plain PyTorch, the reference's
    ``_bwd_blockwise``: ``(dq, dk, dv)`` in the input dtypes from the
    residuals, every product on f32 values; the key tiles of
    ``DEFAULT_BLOCK_K`` only set the order of the sums."""
    block_k = DEFAULT_BLOCK_K
    k_end = min(kv_len, k.shape[1])
    qf, kf, vf, dof = (_heads_first(t) for t in (q, k, v, do))
    delta = (dof * _heads_first(o)).sum(-1, keepdim=True)  # [B, H, Sq, 1]
    lse_e = lse[..., None]
    q_pos = torch.arange(q.shape[1], device=q.device)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    stop = min(k_end, q.shape[1]) if causal else k_end
    for k0 in range(0, stop, block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        p = torch.exp(_mask(s, q_pos, k0, causal=causal, k_end=k_end) - lse_e)
        dv[:, :, k0:k0 + block_k] = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = p * (dp - delta) * scale
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk[:, :, k0:k0 + block_k] = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_fwd_cuda(q, k, v, *, block_k: int = DEFAULT_BLOCK_K, **kw):
    """The forward kernel on the current stream
    (:func:`tpudist_torch.ops.vmem_attention.launch_fwd`, ``lib`` among
    ``kw`` for an A/B); it takes only ``block_k`` :data:`KERNEL_BLOCK_K`."""
    if block_k != KERNEL_BLOCK_K:
        raise ValueError(f"flash_attention_fwd: the kernel takes block_k "
                         f"{KERNEL_BLOCK_K}, got {block_k}")
    return launch_fwd("flash", launch_counts, q, k, v, **kw)


def flash_bwd_cuda(q, k, v, o, do, lse, **kw):
    """The backward's three kernels on the current stream
    (:func:`tpudist_torch.ops.vmem_attention.launch_bwd`)."""
    return launch_bwd("flash", launch_counts, q, k, v, o, do, lse, **kw)


def flash_fwd(q, k, v, **kw):
    """The forward kernel for CUDA tensors, its plain version for CPU
    tensors."""
    return (flash_fwd_cuda if q.is_cuda else flash_fwd_plain)(q, k, v, **kw)


def flash_bwd(q, k, v, o, do, lse, **kw):
    """The backward kernels for CUDA tensors, their plain version for CPU
    tensors."""
    fn = flash_bwd_cuda if q.is_cuda else flash_bwd_plain
    return fn(q, k, v, o, do, lse, **kw)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len, block_k):
        scale = _scale(q.shape[-1])
        o, lse = flash_fwd(q, k, v, causal=causal, kv_len=kv_len,
                           scale=scale, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kv_len, ctx.scale = causal, kv_len, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                               kv_len=ctx.kv_len, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K, pallas_bwd: bool = False,
                    kv_len: int | None = None):
    """Flash attention on ``[B, S, H, D]`` inputs (the reference's
    :func:`tpudist.ops.flash_attention.flash_attention`).

    ``kv_len`` (default: all of ``k``) masks the keys at and past it, for
    right-padded batches that share one true length. Raises
    ``NotImplementedError`` for ``causal`` with ``s_q != s_k``, for
    inputs that are not 4-D, and for block sizes that are not multiples
    of 128 dividing S rounded up to 128, as the reference does. ``block_q``
    changes nothing the kernels compute; ``pallas_bwd`` is ignored (module
    docstring)."""
    del pallas_bwd
    if q.ndim != 4:
        raise NotImplementedError(f"expected [B,S,H,D], got {tuple(q.shape)}")
    s_q, h = q.shape[1], q.shape[2]
    s_k = k.shape[1]
    if kv_len is None:
        kv_len = s_k
    if causal and s_q != s_k:
        raise NotImplementedError("causal path assumes s_q == s_k")
    pad_q, pad_k = s_q + (-s_q % 128), s_k + (-s_k % 128)
    bq, bk = min(block_q, pad_q), min(block_k, pad_k)
    if pad_q % bq or pad_k % bk or bq % 128 or bk % 128:
        raise NotImplementedError(
            f"flash attention needs 128-aligned blocks: seq_q={pad_q}, "
            f"seq_k={pad_k}, block_q={bq}, block_k={bk}")
    if k.shape[2] != h or v.shape[2] != h:
        raise ValueError(f"flash attention takes as many K/V heads as query "
                         f"heads ({h}), got {k.shape[2]}; repeat them first")
    if not 1 <= kv_len:
        raise ValueError(f"kv_len must be at least 1, got {kv_len}")
    return _FlashAttention.apply(q, k, v, causal, int(kv_len), bk)
