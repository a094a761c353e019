"""Autoregressive generation with a KV cache: counterpart of
:mod:`tpudist.generate`.

:func:`generate` runs the reference's schedule eagerly: ONE bulk prefill
pass over the bucket-padded prompt (causal within the chunk), the
cursors rewound to the true prompt length, then single-token decode
steps against the static head-major ``[B, H_kv, max_seq_len, dh]`` cache —
with ``attn_impl="fused"`` each step runs the contiguous decode kernel
once per layer. The serving engine (:mod:`tpudist_torch.serve`) builds on
:func:`zero_cache`, :func:`sample_logits_per_row` and :func:`eos_retire`.

Random draws: JAX's bits cannot be reproduced, so the port keeps the
reference's CONTRACTS instead. The scalar sampler draws from a seeded
``torch.Generator``; the per-row sampler's gumbel field is a
counter-based hash of ``(seed, request_id, token_index, vocab id)``
(:func:`row_keys`, :func:`gumbel_field`), so a slot's draw depends on
nothing but its own request and token index — the same bits on any
device and in any batch composition.

:func:`generate_seq2seq` is the encoder-decoder counterpart (T5): one
encoder pass, then single-token decoder steps against the decoder's
cache.
"""

from __future__ import annotations

import numpy as np
import torch

# the per-row sampler resolves its filters inside a static top-K
# candidate subset (see the reference's note): per-row top_k clamps to the
# cap, and a nucleus reaching past it truncates there
PER_ROW_TOPK_CAP = 128

_M32 = 0xFFFFFFFF


def bucket_length(n: int, cap: int | None = None, *, minimum: int = 8) -> int:
    """Smallest power of two >= ``n`` (floored at ``minimum``), capped at
    ``cap`` — the shared prompt-padding rule of :func:`generate` and the
    serving prefiller. Chunk boundaries decide bit-identity between the
    two, so the rule is the reference's exactly."""
    if n > (cap if cap is not None else n):
        raise ValueError(f"length {n} exceeds the bucket cap {cap}")
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def _nucleus_threshold_from_probs(sorted_desc, probs, top_p):
    """Nucleus threshold over DESCENDING-sorted logits: keep tokens whose
    EXCLUSIVE cumulative probability is < p; the top token always
    survives (HF's ``min_tokens_to_keep=1``)."""
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep[..., 0] = True
    return torch.where(keep, sorted_desc, float("inf")).amin(-1, keepdim=True)


def _nucleus_threshold(sorted_desc, top_p):
    return _nucleus_threshold_from_probs(
        sorted_desc, torch.softmax(sorted_desc, dim=-1), top_p
    )


def _categorical(logits, generator):
    """Gumbel-max draw over the last axis from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + g, dim=-1)


def sample_logits(logits, generator=None, *, temperature: float = 1.0,
                  top_k: int | None = None, top_p: float | None = None):
    """One sampling step over ``[B, V]`` logits -> ``[B]`` int32.
    ``temperature=0`` is greedy (the first maximal index, as the
    reference's ``lax.top_k(., 1)``); filters compose in HF order:
    temperature -> top_k (exactly k candidates) -> top_p."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None:
        k = min(top_k, logits.shape[-1])
        vals, idx = torch.topk(logits, k, dim=-1)
        if top_p is not None and top_p < 1.0:
            vals = torch.where(vals < _nucleus_threshold(vals, top_p),
                               float("-inf"), vals)
        choice = _categorical(vals, generator)
        return idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)
    if top_p is not None and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        logits = torch.where(logits < _nucleus_threshold(sorted_desc, top_p),
                             float("-inf"), logits)
    return _categorical(logits, generator).to(torch.int32)


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``0 <= x < 2**32`` in int64 without
    overflow: split x into 16-bit halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """lowbias32 integer hash on int64 tensors holding 32-bit values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_keys(keys, data):
    """``keys`` ``[B]`` with ``data`` (an int or ``[B]``) folded in: the
    port's ``fold_in(key, data)``, one link of :func:`row_keys`' chain."""
    data = torch.as_tensor(data, device=keys.device).long()
    return _hash32(keys ^ (data & _M32))


def row_keys(seed: int, request_ids, token_index):
    """Per-row stream keys ``[B]`` (int64, 32-bit values): a hash chain of
    ``(seed, request_id, token_index)`` — the port's
    ``fold_in(fold_in(key(seed), rid), index)``."""
    rid = torch.as_tensor(request_ids).long()
    base = _hash32(torch.full_like(rid, int(seed) & _M32))
    return fold_keys(fold_keys(base, rid), token_index)


def uniform_field(keys, n: int):
    """``[B, n]`` uniforms in (0, 1); row ``b`` depends only on
    ``keys[b]``. 23 bits a draw, centred: ``(j + 0.5) / 2**23`` is exact in
    float32 and at most ``1 - 2**-24`` (with 24 bits the top value rounds
    to 1.0, whose gumbel is ``+inf``)."""
    i = torch.arange(n, device=keys.device, dtype=torch.int64)
    bits = _hash32(_hash32(i)[None, :] ^ keys[:, None])
    bits = _hash32(bits + keys[:, None])
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def gumbel_field(keys, vocab: int):
    """``[B, V]`` standard gumbel noise; row ``b`` depends only on
    ``keys[b]``."""
    return -torch.log(-torch.log(uniform_field(keys, vocab)))


def _per_row_warp(logits, temperature, top_k, top_p):
    """Per-row filter resolution (temperature, the static top-cap
    candidate subset, the composed top-k / nucleus cut as ONE per-row
    threshold) — the reference's ``_per_row_warp``."""
    b, v = logits.shape
    cap = min(PER_ROW_TOPK_CAP, v)
    k = top_k.long().clamp(0, cap)
    p = top_p.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.where(temperature > 0.0, temperature, 1.0)[:, None]
    k_active = k > 0
    p_active = p < 1.0
    top_vals, top_idx = torch.topk(scaled, cap, dim=-1)  # sorted desc
    rank = torch.arange(cap, device=logits.device)[None, :]
    kth = top_vals.gather(-1, (k - 1).clamp(min=0)[:, None])
    k_thresh = torch.where(k_active[:, None], kth, float("-inf"))
    in_k = torch.where(k_active[:, None], rank < k[:, None], True)
    masked_vals = torch.where(in_k, top_vals, float("-inf"))
    logz = torch.where(
        k_active[:, None],
        torch.logsumexp(masked_vals, dim=-1, keepdim=True),
        torch.logsumexp(scaled, dim=-1, keepdim=True),
    )
    probs = torch.exp(masked_vals - logz)
    p_thresh = _nucleus_threshold_from_probs(
        masked_vals, probs, p.clamp(max=1.0)[:, None]
    )
    p_thresh = torch.where(p_active[:, None], p_thresh, float("-inf"))
    thresh = torch.maximum(k_thresh, p_thresh)
    return (greedy, scaled, top_vals, top_idx, masked_vals, thresh,
            k_active, p_active)


def per_row_log_probs(logits, *, temperature, top_k, top_p):
    """Log-probabilities ``[B, V]`` of the warped per-row distribution
    :func:`sample_logits_per_row` draws from (the reference's
    ``per_row_log_probs``): the same filter (:func:`_per_row_warp`), the
    kept set renormalized, filtered tokens ``-inf``; a greedy row
    (``temperature == 0``) is a point mass, ``0.0`` at the first argmax.
    The kept set is the full-vocab test ``scaled >= thresh``, which the
    sampler's candidate subset equals except on exact ties at the cut."""
    (greedy, scaled, _, _, _, thresh, k_active,
     p_active) = _per_row_warp(logits, temperature, top_k, top_p)
    filtered = (k_active | p_active)[:, None]
    keep = torch.where(filtered, scaled >= thresh, True)
    masked = torch.where(keep, scaled, float("-inf"))
    logp = masked - torch.logsumexp(masked, dim=-1, keepdim=True)
    v = logits.shape[-1]
    point = torch.where(
        torch.arange(v, device=logits.device)[None, :] == greedy[:, None],
        0.0, float("-inf"))
    return torch.where((temperature == 0.0)[:, None], point, logp)


def sample_logits_per_row(logits, keys, *, temperature, top_k, top_p):
    """Per-ROW sampling over ``[B, V]`` logits with ``[B]`` tensors of
    temperature / top_k / top_p and ``[B]`` stream keys
    (:func:`row_keys`). ``temperature == 0`` is greedy (bit-identical to
    :func:`sample_logits`' greedy), ``top_k <= 0`` and ``top_p >= 1``
    disable their filters; sampling is gumbel-max over one ``[V]`` field
    per row (:func:`gumbel_field`), over the full vocab for an unfiltered
    row and over its candidate subset for a filtered one."""
    b, v = logits.shape
    (greedy, scaled, _, top_idx, masked_vals, thresh, k_active,
     p_active) = _per_row_warp(logits, temperature, top_k, top_p)
    gumbel = gumbel_field(keys, v)
    free_choice = torch.argmax(scaled + gumbel, dim=-1)
    sub_scores = torch.where(
        masked_vals >= thresh, masked_vals + gumbel.gather(-1, top_idx),
        float("-inf"),
    )
    sub_choice = top_idx.gather(-1, torch.argmax(sub_scores, dim=-1)[:, None])[:, 0]
    sampled = torch.where(k_active | p_active, sub_choice, free_choice)
    return torch.where(temperature == 0.0, greedy, sampled.to(torch.int32))


def eos_retire(tok, done, eos_id, pad_id=0):
    """The ONE stop rule shared by :func:`generate` and the engine: rows
    already done emit ``pad_id``; a row is done after it emits ``eos_id``
    (the EOS itself is delivered). ``eos_id`` may be a per-row tensor with
    ``-1`` meaning no stop token."""
    tok = torch.where(done, pad_id, tok)
    return tok, done | (tok == eos_id)


def zero_cache(model, batch_size: int) -> dict:
    """Zeroed decode cache for ``batch_size`` rows: per layer the
    head-major ``[B, H_kv, max_seq_len, dh]`` K/V buffers (``H_kv`` the
    model's ``cache_heads``: GQA heads are cached once, a tensor rank's
    share of them under a tensor axis, and the decode
    kernels read them in place) and a scalar cursor, plus the wpe cursor
    of a model with a position table (GPT-2; Llama's RoPE reads each
    layer's cursor)."""
    shape = (batch_size, model.cache_heads, model.max_seq_len,
             model.head_dim)
    mk = lambda: torch.zeros(shape, dtype=model.dtype, device=model.device)
    cache = {"layers": [{"k": mk(), "v": mk(), "index": 0}
                        for _ in range(model.depth)]}
    if hasattr(model, "wpe"):
        cache["position"] = 0
    return cache


def reset_cursors(cache: dict, true_len: int) -> None:
    """Rewind every scalar cursor (each layer's, and the wpe cursor where
    the cache has one) to the TRUE prompt length after a bucket-padded
    prefill (the pad tail's K/V sits above the cursor, is overwritten step
    by step and never attended)."""
    if "position" in cache:
        cache["position"] = int(true_len)
    for layer in cache["layers"]:
        layer["index"] = int(true_len)


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *, temperature: float = 1.0,
             top_k: int | None = None, top_p: float | None = None,
             seed: int = 0, eos_id: int | None = None, pad_id: int = 0,
             return_lengths: bool = False):
    """Continue ``prompt`` (``[B, P]`` int tokens) by ``max_new_tokens`` on
    the model's device. Returns ``[B, max_new_tokens]`` int32 numpy (and
    ``[B]`` real lengths with ``return_lengths``). Greedy at
    ``temperature=0``, else temperature / top-k / top-p sampling from a
    ``torch.Generator`` seeded with ``seed``. With ``eos_id`` a row emits
    ``pad_id`` after its first EOS (:func:`eos_retire`)."""
    prompt = np.asarray(prompt, np.int32)
    b, p = prompt.shape
    if p + max_new_tokens > model.max_seq_len:
        raise ValueError(
            f"prompt {p} + {max_new_tokens} new tokens exceeds the model's "
            f"max_seq_len {model.max_seq_len} (the KV cache size)"
        )
    dev = model.device
    bucket = bucket_length(p, cap=model.max_seq_len)
    padded = np.zeros((b, bucket), np.int64)
    padded[:, :p] = prompt
    cache = zero_cache(model, b)
    # bulk prefill: the whole padded prompt in one decode pass, causal
    # within the chunk; the first sample reads the TRUE last position
    logits = model(torch.from_numpy(padded).to(dev), cache=cache)[:, p - 1]
    reset_cursors(cache, p)
    gen = None
    if temperature != 0.0:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    toks, alive = [], []
    for _ in range(max_new_tokens):
        tok = sample_logits(logits, gen, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        alive.append(~done)
        if eos_id is not None:
            tok, done = eos_retire(tok, done, eos_id, pad_id)
        toks.append(tok)
        # the last step primes a position that is never sampled, as in
        # the reference's scan
        logits = model(tok[:, None].long(), cache=cache)[:, -1]
    out = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
    if return_lengths:
        lengths = torch.stack(alive, dim=1).sum(1).to(torch.int32)
        return out, lengths.cpu().numpy()
    return out


@torch.no_grad()
def generate_seq2seq(model, enc_tokens, max_new_tokens: int, *,
                     temperature: float = 1.0, top_k: int | None = None,
                     top_p: float | None = None, seed: int = 0,
                     start_id: int = 0, eos_id: int | None = None,
                     pad_id: int = 0, return_lengths: bool = False):
    """Seq2seq generation for an encoder-decoder model
    (:class:`tpudist_torch.models.t5.T5`): encode ``enc_tokens [B, Se]``
    once, then decode ``max_new_tokens`` tokens from ``start_id`` step by
    step against the decoder's cache (``model.max_decode_len`` slots; the
    start token takes one). Returns ``[B, max_new_tokens]`` int32 numpy
    (and ``[B]`` real lengths with ``return_lengths``), with
    :func:`generate`'s sampling controls and ``eos_id`` / ``pad_id``
    retirement. A model on a tensor layout runs on every tensor rank: the
    encoder once and each decoder step on the rank's heads (its cache
    holds them, the cross-attention recomputed on them), the logits
    gathered whole before sampling, so every rank picks the same token."""
    if max_new_tokens + 1 > model.max_decode_len:
        raise ValueError(
            f"start token + {max_new_tokens} new tokens exceeds the model's "
            f"max_decode_len {model.max_decode_len} (the decoder KV cache "
            "size)")
    dev = model.device
    enc_tokens = torch.as_tensor(np.asarray(enc_tokens, np.int64), device=dev)
    b = enc_tokens.shape[0]
    enc = model(enc_tokens, encode_only=True)
    cache = model.init_cache(b)
    start = torch.full((b, 1), start_id, dtype=torch.long, device=dev)
    logits = model(start, decode=True, enc=enc, cache=cache)[:, -1]
    gen = None
    if temperature != 0.0:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    toks, alive = [], []
    for i in range(max_new_tokens):
        tok = sample_logits(logits, gen, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        alive.append(~done)
        if eos_id is not None:
            tok, done = eos_retire(tok, done, eos_id, pad_id)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits = model(tok[:, None].long(), decode=True, enc=enc,
                           cache=cache)[:, -1]
    out = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
    if return_lengths:
        lengths = torch.stack(alive, dim=1).sum(1).to(torch.int32)
        return out, lengths.cpu().numpy()
    return out
