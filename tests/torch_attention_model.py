"""A numerical model of the port's bf16 attention kernels on the tensor
cores (``tpudist_torch/csrc/attention_mma.cuh``), for the CPU tests of
their rounding contract: the same functions the CUDA kernels compute, up
to the order of the f32 sums.

The forward (:func:`mma_fwd_model`): ``s = q k^T`` is a product of the
bf16 inputs summed in f32; ``p = exp(s - m)`` in f32, rounded to one bf16
before ``p v``, against the exact row max (vmem) or the running max of
each key tile from key 0 (flash, 128 keys a tile); ``l`` sums the
unrounded f32 ``p``.

The backward (:func:`mma_bwd_model`): q, k, v and do are bf16; ``s = q
k^T`` and ``dp = do v^T`` are products of those bf16 values summed in
f32. Before ``dv = p^T do``, ``dk = ds^T q`` and ``dq = ds k``, the f32
``p`` and ``ds`` pass through ``parts``: a list of bf16 values whose sum
stands for each one, every part multiplied into one f32 sum. The flash
kernels carry ``hi + lo`` (:func:`split_bf16`); the vmem kernels round to
one bf16 (:func:`one_bf16`), as the Pallas vmem backward does."""

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)


def split_bf16(x):
    """``(hi, lo)`` as float32: ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def one_bf16(x):
    """``(bf16(x),)`` as float32."""
    return (x.to(torch.bfloat16).float(),)


def f32_dot(q, k):
    """``[B, H, Sq, Sk]`` f32 sums of the products of ``q [B, H, Sq, D]``
    and ``k [B, H, Sk, D]`` (bf16 values: every product exact in f32)."""
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())


def xla_dot(pad_d: int = 0):
    """A ``dot`` for :func:`mma_fwd_model` that sums the score products in
    the reference's own order: ``dot_general(bf16, bf16,
    preferred_element_type=f32)`` as XLA runs it on the CPU, after ``pad_d``
    zero columns (the flash wrapper pads D to 128). The model then differs
    from the Pallas kernel only in what it pins, the rounding of p: with
    p rounded to bf16, another order of the f32 sums flips single
    roundings and moves single outputs by several ulps."""
    import jax
    import jax.numpy as jnp

    def dot(a, b):
        pa, pb = (jnp.pad(jnp.asarray(t.float().numpy(), jnp.bfloat16),
                          ((0, 0), (0, 0), (0, 0), (0, pad_d)))
                  for t in (a, b))
        out = jax.lax.dot_general(pa, pb, (((3,), (3,)), ((0, 1), (0, 1))),
                                  preferred_element_type=jnp.float32)
        return torch.tensor(np.asarray(out))

    return dot


def _masked_scores(q, k, *, causal: bool, kv_len: int, scale: float,
                   dot=f32_dot):
    """f32 scores ``[B, H, Sq, Sk]`` of bf16 ``q [B, Sq, H, D]`` and the
    head-repeated ``k`` (products summed by ``dot``), masked with the
    finite ``NEG_INF``."""
    rep = q.shape[2] // k.shape[2]
    s = dot(q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2))
    s = s * scale
    kp = torch.arange(k.shape[1])
    keep = (kp < kv_len)[None, :]
    if causal:
        keep = keep & (torch.arange(q.shape[1])[:, None] >= kp[None, :])
    return torch.where(keep, s, NEG_INF)


def mma_fwd_model(q, k, v, *, causal: bool, kv_len: int, scale: float,
                  block_k: int | None = None, dot=f32_dot):
    """``(o bf16 [B, Sq, H, D], lse f32 [B, H, Sq])`` for bf16 ``q [B, Sq,
    H, D]`` and ``k``/``v`` ``[B, Sk, H_kv, D]``. ``block_k`` None: p
    against the exact row max (vmem); else the online softmax over tiles
    of ``block_k`` keys from key 0 (flash), ``l == 0`` read as 1. ``dot``
    sums the score products (:func:`f32_dot`; a test may pass the
    reference's own order of the sums)."""
    rep = q.shape[2] // k.shape[2]
    vf = v.float().repeat_interleave(rep, 2).transpose(1, 2)
    s = _masked_scores(q, k, causal=causal, kv_len=kv_len, scale=scale,
                       dot=dot)
    bf = torch.bfloat16
    if block_k is None:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(bf).float(), vf)
    else:
        m = torch.full_like(s[..., :1], NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros(*s.shape[:-1], vf.shape[-1])
        for k0 in range(0, s.shape[-1], block_k):
            st = s[..., k0:k0 + block_k]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            o = alpha * o + torch.einsum("bhqk,bhkd->bhqd", p.to(bf).float(),
                                         vf[:, :, k0:k0 + block_k])
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
    return (o / l).to(bf).transpose(1, 2), (m + torch.log(l))[..., 0]


def mma_bwd_model(q, k, v, o, do, lse, *, causal: bool, kv_len: int,
                  scale: float, parts):
    """``(dq, dk, dv)`` in bf16 for ``q``/``do`` ``[B, Sq, H, D]``,
    ``k``/``v`` ``[B, Sk, H_kv, D]`` (grouped heads sum their dk/dv in
    f32), ``o`` and the f32 ``lse [B, H, Sq]`` of the forward."""
    b, s_k, h_kv, d = k.shape
    rep = q.shape[2] // h_kv
    qf, dof, of = (t.float().transpose(1, 2) for t in (q, do, o))
    kf, vf = (t.float().repeat_interleave(rep, 2).transpose(1, 2)
              for t in (k, v))
    s = _masked_scores(q, k, causal=causal, kv_len=kv_len, scale=scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dv = sum(torch.einsum("bhqk,bhqd->bhkd", x, dof) for x in parts(p))
    dk = sum(torch.einsum("bhqk,bhqd->bhkd", x, qf) for x in parts(ds))
    dq = sum(torch.einsum("bhqk,bhkd->bhqd", x, kf) for x in parts(ds))
    dk, dv = (t.transpose(1, 2).reshape(b, s_k, h_kv, rep, d).sum(3)
              for t in (dk, dv))
    return (dq.transpose(1, 2).to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))
