"""Whole-row softmax attention for short and medium sequences (S <= 1024).

Counterpart of :mod:`tpudist.ops.vmem_attention`. The kernels
(``tpudist_torch/csrc/vmem_attention.cu``) replace the Pallas
``_fwd_kernel`` reached through ``_vmem_fwd_raw`` and the ``_bwd_kernel``
reached through ``_vmem_vjp_bwd``: f32 scores ``q.k * scale`` with the
causal and ``kv_len`` masks, the exact row max, ``p = exp(s - m)`` cast to
v's dtype before the value product, one division by ``l``, and the row
log-sum-exp saved for the backward, which recomputes ``p`` from it. The
TPU kernel holds a head's whole ``[S, S]`` score matrix in VMEM; the CUDA
kernels tile it (the source's note says how), but compute the same
function with the same roundings.

:func:`vmem_attention` keeps the reference's contract on the models'
``[B, S, H, D]`` layout: padded keys past ``kv_len`` are masked (the
kernels mask the ragged tail themselves, so nothing is padded), ``causal``
needs ``s_q == s_k``, GQA reads each grouped K/V head in place, and a
sequence whose length rounded up to 128 exceeds :data:`MAX_SEQ` raises
``NotImplementedError``: ``multi_head_attention(impl="auto")`` routes on
that refusal. It is a ``torch.autograd.Function`` with residuals
``(q, k, v, o, lse)``.

Each wrapper takes the kernel for CUDA tensors and its plain PyTorch
version (:func:`vmem_fwd_plain`, :func:`vmem_bwd_plain`) only for CPU
tensors. :data:`launch_counts` counts kernel launches: one per forward
call, and one per backward call, which launches its three kernels (the
``delta`` pre-pass, dk/dv, dq) together.
"""

from __future__ import annotations

import numpy as np
import torch

#: the longest sequence (rounded up to 128) the reference's kernel takes;
#: ``auto`` routing depends on this refusal
MAX_SEQ = 1024
#: the largest head dim the CUDA kernels take (``kMaxHeadDim`` in the
#: source); a larger one is an error on the card, never a reason to route
#: elsewhere
MAX_HEAD_DIM = 128
NEG_INF = float(np.finfo(np.float32).min)

#: launches of the kernels, counted where the wrappers launch them and
#: nowhere else (the plain versions never count)
launch_counts = {"vmem_attention_fwd": 0, "vmem_attention_bwd": 0}

_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _scale(d: int) -> float:
    """``1 / sqrt(D)`` as the float32 the reference multiplies by."""
    return float(np.float32(1.0 / float(np.sqrt(d))))


def _scores(q, k, *, causal: bool, kv_len: int, scale: float):
    """f32 scores ``[B, H, Sq, Sk]`` of ``q [B, Sq, H, D]`` against the
    head-broadcast ``k [B, Sk, H, D]``, masked with ``finfo(f32).min``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s_q, s_k = s.shape[-2:]
    kp = torch.arange(s_k, device=q.device)
    keep = (kp < kv_len)[None, :].expand(s_q, s_k)
    if causal:
        keep = keep & (torch.arange(s_q, device=q.device)[:, None] >= kp)
    return torch.where(keep, s, NEG_INF)


def _broadcast_kv(q, k, v):
    rep = q.shape[2] // k.shape[2]
    if rep == 1:
        return k, v
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def vmem_fwd_plain(q, k, v, *, causal: bool, kv_len: int, scale: float):
    """The forward kernel's function in plain PyTorch: ``(o [B, Sq, H, D]
    in q's dtype, lse [B, H, Sq] f32)``."""
    kk, vv = _broadcast_kv(q, k, v)
    s = _scores(q, kk, causal=causal, kv_len=kv_len, scale=scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vv.float())
    o = (o / l).to(q.dtype).transpose(1, 2)
    return o, (m + torch.log(l))[..., 0]


def vmem_bwd_plain(q, k, v, o, do, lse, *, causal: bool, kv_len: int,
                   scale: float):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``
    in the input dtypes; grouped K/V heads sum their dk/dv in f32 before
    the cast."""
    kk, vv = _broadcast_kv(q, k, v)
    s = _scores(q, kk, causal=causal, kv_len=kv_len, scale=scale)
    p = torch.exp(s - lse[..., None])
    dob = do.to(v.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dob)
    dp = torch.einsum("bqhd,bkhd->bhqk", dob, vv.float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).to(v.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    b, s_k, h_kv, d = k.shape
    rep = q.shape[2] // h_kv
    if rep > 1:
        dk = dk.reshape(b, s_k, h_kv, rep, d).sum(3)
        dv = dv.reshape(b, s_k, h_kv, rep, d).sum(3)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _check(what, q, k, v, extra=()):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v must be on one CUDA device")
    if q.dtype not in _CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share a dtype in (float32, "
                         f"bfloat16), got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: want q [B, Sq, H, D] and k, v [B, Sk, "
                         f"H_kv, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d}; the kernels take 1 to "
                         f"{MAX_HEAD_DIM}")
    for t in (q, k, v, *extra):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: the last dim must be contiguous, got "
                             f"strides {t.stride()}")


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def vmem_fwd_cuda(q, k, v, *, causal: bool, kv_len: int, scale: float):
    """Launch the forward kernel on the current stream. ``q [B, Sq, H,
    D]``, ``k``/``v`` ``[B, Sk, H_kv, D]`` in one dtype, any strides but a
    contiguous last dim. Returns ``(o, lse)``."""
    from tpudist_torch.csrc import build

    _check("vmem_attention_fwd", q, k, v)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lib = build.load("vmem_attention.cu")
    rc = lib.tpudist_vmem_fwd(
        _CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, s_q, s_k, h, h_kv, d, *_strides(q),
        *_strides(k), *_strides(v), kv_len, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "vmem_attention_fwd")
    launch_counts["vmem_attention_fwd"] += 1
    return o, lse


def vmem_bwd_cuda(q, k, v, o, do, lse, *, causal: bool, kv_len: int,
                  scale: float):
    """Launch the backward's three kernels on the current stream (the
    ``delta`` pre-pass, dk/dv, dq). ``o``/``do`` ``[B, Sq, H, D]`` with a
    contiguous last dim; ``lse`` contiguous f32 ``[B, H, Sq]``. Returns
    ``(dq, dk, dv)``."""
    from tpudist_torch.csrc import build

    _check("vmem_attention_bwd", q, k, v, (o, do))
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    for t, shape in ((o, q.shape), (do, q.shape), (lse, (b, h, s_q))):
        if t.shape != shape or t.device != q.device:
            raise ValueError(f"vmem_attention_bwd: got {tuple(t.shape)}, "
                             f"want {tuple(shape)} on {q.device}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("vmem_attention_bwd: o and do must be in q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("vmem_attention_bwd: lse must be contiguous float32")
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s_k, h_kv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = build.load("vmem_attention.cu")
    rc = lib.tpudist_vmem_bwd(
        _CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s_q, s_k, h, h_kv, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        *_strides(do), kv_len, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "vmem_attention_bwd")
    launch_counts["vmem_attention_bwd"] += 1
    return dq, dk, dv


def vmem_fwd(q, k, v, **kw):
    """The forward kernel for CUDA tensors, its plain version for CPU
    tensors."""
    return (vmem_fwd_cuda if q.is_cuda else vmem_fwd_plain)(q, k, v, **kw)


def vmem_bwd(q, k, v, o, do, lse, **kw):
    """The backward kernels for CUDA tensors, their plain version for CPU
    tensors."""
    fn = vmem_bwd_cuda if q.is_cuda else vmem_bwd_plain
    return fn(q, k, v, o, do, lse, **kw)


class _VmemAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len):
        scale = _scale(q.shape[-1])
        o, lse = vmem_fwd(q, k, v, causal=causal, kv_len=kv_len, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kv_len, ctx.scale = causal, kv_len, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = vmem_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                              kv_len=ctx.kv_len, scale=ctx.scale)
        return dq, dk, dv, None, None


def vmem_attention(q, k, v, *, causal: bool = False,
                   kv_len: int | None = None):
    """Attention on ``[B, S, H, D]`` inputs (the reference's
    :func:`tpudist.ops.vmem_attention.vmem_attention`).

    ``kv_len`` (default: all of ``k``) masks the keys at and past it, for
    right-padded batches that share one true length. ``k``/``v`` may carry
    fewer heads than ``q`` (GQA; heads divisible). Raises
    ``NotImplementedError`` for a sequence longer than :data:`MAX_SEQ`
    after rounding up to 128, for ``causal`` with ``s_q != s_k`` and for
    indivisible heads, as the reference does: callers
    (``multi_head_attention``) route those elsewhere. On the card a head
    dim past :data:`MAX_HEAD_DIM` raises ``ValueError``, which no caller
    routes around."""
    if q.ndim != 4:
        raise NotImplementedError(f"expected [B,S,H,D], got {tuple(q.shape)}")
    s_q, h = q.shape[1], q.shape[2]
    s_k, h_kv = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = s_k
    s_pad = max(s_q + (-s_q % 128), s_k + (-s_k % 128))
    if s_pad > MAX_SEQ:
        raise NotImplementedError(
            f"vmem attention takes whole rows of at most {MAX_SEQ} keys; "
            f"S_pad={s_pad} > {MAX_SEQ} needs the blockwise flash kernel")
    if causal and s_q != s_k:
        raise NotImplementedError("causal path assumes s_q == s_k")
    if h % h_kv:
        raise NotImplementedError(f"q heads {h} not a multiple of kv heads "
                                  f"{h_kv}")
    if not 1 <= kv_len:
        raise ValueError(f"kv_len must be at least 1, got {kv_len}")
    return _VmemAttention.apply(q, k, v, causal, int(kv_len))
