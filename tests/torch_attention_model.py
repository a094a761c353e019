"""A numerical model of the port's bf16 attention backward on the tensor
cores (``tpudist_torch/csrc/attention_mma.cuh``), for the CPU tests of
its rounding contract: the same function the CUDA kernels compute, up to
the order of the f32 sums.

q, k, v and do are bf16; ``s = q k^T`` and ``dp = do v^T`` are products of
those bf16 values summed in f32. Before ``dv = p^T do``, ``dk = ds^T q``
and ``dq = ds k``, the f32 ``p`` and ``ds`` pass through ``parts``: a list
of bf16 values whose sum stands for each one, every part multiplied into
one f32 sum. The flash kernels carry ``hi + lo`` (:func:`split_bf16`);
the vmem kernels round to one bf16 (:func:`one_bf16`), as the Pallas
vmem backward does."""

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
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    kp = torch.arange(s_k)
    keep = (kp < kv_len)[None, :]
    if causal:
        keep = keep & (torch.arange(q.shape[1])[:, None] >= kp[None, :])
    p = torch.exp(torch.where(keep, s, NEG_INF) - lse[..., None])
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
