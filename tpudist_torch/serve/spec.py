"""Speculative decoding: counterpart of :mod:`tpudist.serve.spec`.

The engine's speculative tick (:mod:`tpudist_torch.serve.engine`) runs
``K`` draft steps per live slot, proposing ``d_1..d_K``, then ONE target
pass over the window ``[t_last, d_1..d_K]`` (on the paged pool, one
launch of the paged decode kernel per layer at ``s_q = K + 1``). This
module decides what to emit from the two sets of logits.

The acceptance identity (Leviathan et al.; Chen et al.): draft ``d_i``,
sampled from the draft's warped distribution ``q_i``, is accepted with
probability ``min(1, p_i(d_i) / q_i(d_i))``, ``p_i`` the target's warped
distribution there; at the first rejection the emitted token is drawn
from the residual ``norm(max(p_i - q_i, 0))``; when all ``K`` are
accepted a bonus token is drawn from ``p_{K+1}``, the verify pass's last
row. Every emitted token is distributed as ``p``. Both ``p`` and ``q``
are the warped per-row distributions of
:func:`tpudist_torch.generate.per_row_log_probs`, which share their
filter with the sampler. A greedy row's warped distribution is a point
mass at the argmax, so it accepts iff the draft equals the target's
argmax and the correction is the argmax: greedy speculative output is
the plain engine's, token for token.

Random draws: the engine derives one key per (request, cursor),
``row_keys(seed, request_id, cursor)``, and folds purpose salts into it
(:func:`tpudist_torch.generate.fold_keys`): draft step ``i`` salt ``i``,
the acceptance uniforms :data:`SALT_ACCEPT`, the residual draw
:data:`SALT_RESIDUAL`. Cursors are strictly increasing and replay-stable
(a preempted request draws the same stream again), and a cursor is at
least 1 (prompts are not empty), so the keys never meet the first
token's, which take token index 0.
"""

from __future__ import annotations

import copy

import torch

from tpudist_torch.generate import (
    fold_keys, gumbel_field, per_row_log_probs, uniform_field,
)

# the engine folds 0..K-1 for the K draft steps; these live far above any
# sane K
SALT_ACCEPT = 1 << 20
SALT_RESIDUAL = (1 << 20) + 1


def _rep(a, n: int):
    """Per-row params ``[B]`` -> per-window-row ``[B * n]`` (row-major, as
    ``logits.reshape(b * n, v)``)."""
    return torch.repeat_interleave(a, n, dim=0)


def _warped(logits, n, temperature, top_k, top_p):
    b, _, v = logits.shape
    return per_row_log_probs(
        logits.reshape(b * n, v), temperature=_rep(temperature, n),
        top_k=_rep(top_k, n), top_p=_rep(top_p, n)).reshape(b, n, v)


def speculative_accept(t_logits, d_logits, d_toks, n_spec, keys, *,
                       temperature, top_k, top_p):
    """Accept or reject a draft window against the target's verify logits.

    ``t_logits [B, K+1, V]``: row ``i`` scores the position draft
    ``d_{i+1}`` was proposed for (row ``K`` the bonus position);
    ``d_logits [B, K, V]`` the raw draft logits the proposals were sampled
    from; ``d_toks [B, K]`` the proposals; ``n_spec [B]`` how many drafts
    are eligible (the engine's sequence-end and budget clamp); ``keys
    [B]`` the per-(request, cursor) keys; ``temperature`` / ``top_k`` /
    ``top_p`` ``[B]``. Returns ``(emit [B, K+1] int32, n_emit [B]
    int32)``: the accepted prefix and one correction or bonus token,
    zero past ``n_emit``, with ``1 <= n_emit <= K + 1``."""
    b, k1, v = t_logits.shape
    kk = k1 - 1
    dev = t_logits.device
    n_spec = n_spec.to(torch.int32)
    logp = _warped(t_logits, k1, temperature, top_k, top_p)
    if kk:
        logq = _warped(d_logits, kk, temperature, top_k, top_p)
    us = uniform_field(fold_keys(keys, SALT_ACCEPT), max(kk, 1))

    # the sequential accept, unrolled (K is small): a draft is kept iff
    # every earlier one was and its own ratio test passes
    acc = torch.ones(b, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(kk):
        d_i = d_toks[:, i].long()[:, None]
        lp = logp[:, i].gather(-1, d_i)[:, 0]
        lq = logq[:, i].gather(-1, d_i)[:, 0]
        # min(1, p/q) as exp(min(0, lp - lq)): lp = -inf rejects; a NaN
        # (lq = -inf, which a q-sampled token cannot have) rejects too
        ratio = torch.exp(torch.clamp(lp - lq, max=0.0))
        ok = (us[:, i] < ratio) & (i < n_spec) & acc
        n_acc = n_acc + ok.to(torch.int32)
        acc = acc & ok

    # the correction at m = n_acc from the residual norm(max(p_m - q_m,
    # 0)); where no proposal was eligible (the bonus row, a clamped row, K
    # == 0) q is zero and the residual is p_m itself
    m = n_acc.long()
    p_m = torch.exp(logp.gather(1, m[:, None, None].expand(b, 1, v))[:, 0])
    if kk:
        mi = m.clamp(max=kk - 1)[:, None, None].expand(b, 1, v)
        q_m = torch.exp(logq.gather(1, mi)[:, 0])
        q_m = torch.where((m < n_spec)[:, None], q_m, 0.0)
    else:
        q_m = torch.zeros_like(p_m)
    residual = torch.clamp(p_m - q_m, min=0.0)
    rsum = residual.sum(-1, keepdim=True)
    # an all-zero residual (p <= q everywhere: rounding only) draws from p
    res = torch.where(rsum > 0.0, residual / torch.where(rsum > 0.0, rsum, 1.0),
                      p_m)
    g = gumbel_field(fold_keys(keys, SALT_RESIDUAL), v)
    corr = torch.argmax(torch.where(res > 0.0, torch.log(res) + g,
                                    float("-inf")), dim=-1)

    cols = torch.arange(k1, device=dev)[None, :]
    d_pad = torch.zeros((b, k1), dtype=torch.int64, device=dev)
    if kk:
        d_pad[:, :kk] = d_toks.long()
    emit = torch.where(cols < m[:, None], d_pad, 0)
    emit = torch.where(cols == m[:, None], corr[:, None], emit)
    return emit.to(torch.int32), (m + 1).to(torch.int32)


def _family(model):
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.llama import Llama

    if isinstance(model, GPT2):
        return "gpt2"
    if isinstance(model, Llama):
        return "llama"
    raise ValueError(f"early_exit_draft knows the GPT-2 and Llama families, "
                     f"not {type(model).__name__}")


def early_exit_draft(model, depth: int):
    """A draft that is the target's own shallow prefix: a module holding
    the target's first ``depth`` blocks, its embedding, final norm and
    head, the same tensors (no copy; the draft's only device memory is
    its KV cache). Early-exit logits correlate with the full model's; the
    engine's telemetry measures how well (the acceptance rate)."""
    family = _family(model)
    if not 1 <= depth < model.depth:
        raise ValueError(
            f"draft depth {depth} outside [1, {model.depth}) of the target")
    if model.scan_layers:
        raise ValueError("early_exit_draft needs the unrolled blocks "
                         "(scan_layers has no decode path)")
    # a shallow copy shares every tensor; its module table is its own
    draft = copy.copy(model)
    draft._parameters = dict(model._parameters)
    draft._buffers = dict(model._buffers)
    draft._modules = dict(model._modules)
    if family == "gpt2":
        draft._modules["h"] = torch.nn.ModuleList(list(model.h)[:depth])
    else:
        for i in range(depth, model.depth):
            del draft._modules[f"layer_{i}"]
    draft.depth = depth
    # the engine rebuilds the draft on its compute copy of the target
    draft.early_exit_of = (model,)
    return draft


def cache_bytes(model, rows: int) -> int:
    """The bytes of the K/V buffers ``model.init_cache(rows)`` allocates
    (nothing is allocated): what a speculative engine pays for its draft
    pool on top of the target's."""
    itemsize = torch.empty((), dtype=model.dtype).element_size()
    return (2 * model.depth * rows * model.cache_heads * model.max_seq_len
            * model.head_dim * itemsize)
