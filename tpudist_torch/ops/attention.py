"""Attention ops for the port's transformer models.

Counterpart of :mod:`tpudist.ops.attention`. This slice carries the GQA
rule (:func:`repeat_kv`) and the dense attention
(:func:`dot_product_attention`) that the non-decode forward uses. The
whole-sequence and blockwise kernels of the reference (vmem / flash) are
not ported yet, so :func:`multi_head_attention` takes ``impl="xla"`` and
``"fused"`` (dense either way, as the reference's dispatch makes them on
the non-decode path) and raises for ``"vmem"``, ``"flash"`` and
``"auto"``.
"""

from __future__ import annotations

import numpy as np
import torch

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
                         impl: str = "xla"):
    """The dense path for ``impl`` in ``("xla", "fused")``; the kernels
    behind ``"vmem"``, ``"flash"`` and ``"auto"`` are still to be ported."""
    if impl not in ("xla", "fused"):
        raise NotImplementedError(
            f"attention impl {impl!r} needs the vmem / flash kernels, which "
            "the port does not have yet; use 'xla' or 'fused'"
        )
    if k.shape[2] != q.shape[2]:
        k, v = repeat_kv(q, k, v)
    return dot_product_attention(q, k, v, causal=causal, mask=mask)
