"""Attention ops for the port's transformer models.

Counterpart of :mod:`tpudist.ops.attention`: the GQA rule
(:func:`repeat_kv`), the dense attention (:func:`dot_product_attention`),
:func:`kernel_attention` and the ``impl`` dispatch of :func:`multi_head_attention` on the
non-decode path. ``"xla"`` and ``"fused"`` are the dense path; ``"vmem"``
and ``"auto"`` reach the whole-row kernel
(:mod:`tpudist_torch.ops.vmem_attention`) and ``"flash"`` the blockwise
kernel (:mod:`tpudist_torch.ops.flash_attention`), with the reference's
routing: the whole-row kernel's ``NotImplementedError`` (S_pad > 1024,
or the refusals the reference shares) sends ``auto`` dense between S 1025
and 2047 and to the flash kernel from 2048; grouped K/V heads are
repeated before the flash and dense paths; flash's own
``NotImplementedError`` (causal with ``s_q != s_k``, unaligned blocks)
and a general ``mask`` send it dense with a warning. Any other error of
a kernel's wrapper (a head dim it does not take, a build or launch
failure) propagates: nothing falls back to the dense path on the card.
These crossovers are the reference's v5e tuning, kept as they are until
they are measured on the H100.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tpudist_torch.ops import flash_attention as _flash
from tpudist_torch.ops import vmem_attention as _vmem

NEG_INF = torch.finfo(torch.float32).min


def repeat_kv(q, k, v, *, head_axis: int = 2):
    """Broadcast grouped K/V heads over their query groups
    (``[.., H_kv, D] -> [.., H, D]``). ``head_axis`` is 2 for the
    ``[B, S, H, D]`` activation layout and 1 for the decode cache's
    head-major ``[B, H, S, D]``; ``q`` stays ``[B, s, H, D]`` either way."""
    h, h_kv = q.shape[2], k.shape[head_axis]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    rep = h // h_kv
    if rep == 1:
        return k, v
    return (
        torch.repeat_interleave(k, rep, dim=head_axis),
        torch.repeat_interleave(v, rep, dim=head_axis),
    )


def kernel_attention(q, k, v, *, causal: bool = False):
    """The best kernel for the shape (``multi_head_attention(impl="auto")``:
    the vmem kernel up to S 1024, the dense path to 2047, the flash kernel
    from 2048), the ``attn_fn`` of Ulysses' ``ulysses_flash``, which sees
    the whole sequence over a local head group."""
    return multi_head_attention(q, k, v, causal=causal, impl="auto")


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          bias=None, scale=None):
    """q, k, v: ``[B, S, H, D]`` -> ``[B, S, H, D]``. Scores in f32, masked
    with ``finfo(float32).min``, softmax in f32, probabilities cast to
    q's dtype for the value product."""
    dtype = q.dtype
    if scale is None:
        # the reference's f32 division: 1.0 / f32(sqrt(D))
        scale = float(np.float32(1.0) / np.float32(np.sqrt(q.shape[-1])))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal_mask = torch.ones(s_q, s_k, dtype=torch.bool,
                                 device=q.device).tril()
        logits = logits.masked_fill(~causal_mask, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def multi_head_attention(q, k, v, *, causal: bool = False, mask=None,
                         impl: str = "xla", kv_len: int | None = None):
    """Attention over ``[B, S, H, D]`` by ``impl`` (module docstring).
    ``kv_len`` masks the keys at and past it (a right-padded batch); a
    general ``mask`` forces the dense path, with a warning when the caller
    asked for ``"vmem"`` or ``"flash"``."""
    if impl in ("vmem", "auto"):
        if mask is None:
            try:
                return _vmem.vmem_attention(q, k, v, causal=causal,
                                            kv_len=kv_len)
            except NotImplementedError as e:
                if impl == "vmem":
                    warnings.warn(
                        f"vmem attention unavailable ({e}); trying flash/XLA")
            # the reference's v5e crossover: dense up to 2047, flash beyond
            impl = "flash" if max(q.shape[1], k.shape[1]) >= 2048 else "xla"
        elif impl == "vmem":
            warnings.warn(
                "vmem attention takes no general mask (pass kv_len for "
                "contiguous key padding); using XLA attention")
            impl = "xla"
        else:
            impl = "xla"
    if impl not in ("xla", "fused", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if k.shape[2] != q.shape[2]:
        # GQA reaching the flash and dense paths (vmem reads grouped heads
        # in place)
        k, v = repeat_kv(q, k, v)
    if impl == "flash":
        if mask is not None:
            warnings.warn(
                "flash attention takes no general mask; falling back to XLA "
                "attention (S x S scores in device memory) - for contiguous "
                "key padding use kv_len instead")
        else:
            try:
                return _flash.flash_attention(q, k, v, causal=causal,
                                              kv_len=kv_len)
            except NotImplementedError as e:
                warnings.warn(
                    f"flash attention unavailable ({e}); using XLA attention")
    if kv_len is not None and kv_len < k.shape[1]:
        mask = (torch.arange(k.shape[1], device=q.device) < kv_len)[
            None, None, None, :]
    return dot_product_attention(q, k, v, causal=causal, mask=mask)
