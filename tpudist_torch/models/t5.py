"""T5 in PyTorch: counterpart of :mod:`tpudist.models.t5`.

An encoder-decoder with the T5 v1.1 conventions: pre-RMSNorm blocks
(eps 1e-6), no biases, a learned bucketed relative-position bias shared
by every layer of a stack (bidirectional buckets in the encoder, causal
in the decoder, none on cross-attention), a gated-GELU MLP (tanh GELU),
an untied LM head and un-scaled attention scores. The parameters keep
the reference's names: ``wte``, ``enc_rel_bias``, ``dec_rel_bias``,
``enc.{i}.{ln_attn, attn.{q, k, v, out}, ln_mlp, mlp.{wi_0, wi_1, wo}}``,
``ln_enc``, ``dec.{i}.{ln_self, self_attn, ln_cross, cross_attn, ln_mlp,
mlp}``, ``ln_dec``, ``lm_head`` (``[V, d]``);
:func:`tpudist_torch.interop.t5_params_from_flax` carries a flax tree
across. The head width is ``d // heads`` (t5_small: 6 heads of 85 over
512, an inner width of 510), as in the reference.

The biased attention takes the dense path everywhere, training and decode
alike: the scores plus the relative bias go to
:func:`~tpudist_torch.ops.attention.dot_product_attention` with ``scale
1``, and the cached decode to :func:`~tpudist_torch.ops.decode.
decode_attention` with the bias, whose semantic gate keeps a biased call
off the decode kernel (the reference's routing).

Entry points (:func:`tpudist_torch.generate.generate_seq2seq` drives the
last two): ``model(enc_tokens, dec_tokens)`` -> f32 logits ``[B, Sd, V]``
(``return_hidden`` for the decoder's final hidden state);
``encode_only=True`` -> the encoder output ``[B, Se, d]``;
``decode=True`` with ``enc`` and a ``cache`` (:meth:`T5.init_cache`,
``max_decode_len`` slots a layer) -> the logits of a decoder chunk whose
self-attention appends to the cache; a chunk past ``max_decode_len``
raises.

:func:`span_corrupt_transform` is the reference's span corruption with
its ``(seed, epoch, start)`` keying, bit for bit.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.device import resolve_device
from tpudist_torch.rng import generator
from tpudist_torch.models.bert import lecun_
from tpudist_torch.models.llama import Linear, RMSNorm
from tpudist_torch.ops.attention import dot_product_attention
from tpudist_torch.ops.decode import cached_kv, decode_attention

EPS = 1e-6


def relative_position_buckets(q_len: int, k_len: int, *, bidirectional: bool,
                              num_buckets: int = 32, max_distance: int = 128,
                              device=None):
    """``[q_len, k_len]`` int64 bucket ids of the learned relative bias:
    half the buckets are exact small offsets, the rest log-spaced out to
    ``max_distance``; a bidirectional stack splits them between past and
    future. The reference's float32 arithmetic."""
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    rel = mem - ctx  # > 0: a future key
    buckets = torch.zeros((), dtype=torch.long, device=device)
    n = num_buckets
    if bidirectional:
        n = n // 2
        buckets = torch.where(rel > 0, n, 0)
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    ratio = torch.clamp(rel, min=1).float() / max_exact
    log_pos = max_exact + (
        torch.log(ratio) / float(np.float32(np.log(max_distance / max_exact)))
        * (n - max_exact)).to(torch.int32).long()
    log_pos = torch.clamp(log_pos, max=n - 1)
    return buckets + torch.where(is_small, rel, log_pos)


class _Attention(nn.Module):
    """Bias-free q/k/v/out projections over ``heads x dh``; ``kv`` is the
    query stream (self-attention) or the encoder output (cross)."""

    def __init__(self, d: int, heads: int, *, device):
        super().__init__()
        self.heads = heads
        self.dh = d // heads
        inner = heads * self.dh
        self.q = Linear(d, inner, device=device)
        self.k = Linear(d, inner, device=device)
        self.v = Linear(d, inner, device=device)
        self.out = Linear(inner, d, device=device)

    def forward(self, x, kv=None, *, bias=None, causal=False, cache=None):
        b, s, _ = x.shape
        kv = x if kv is None else kv
        split = lambda t: t.view(t.shape[0], t.shape[1], self.heads, self.dh)
        q, k, v = split(self.q(x)), split(self.k(kv)), split(self.v(kv))
        bias = None if bias is None else bias[None]
        if cache is not None:
            keys, values, mask, pos = cached_kv(cache, k, v)
            # un-scaled scores plus the relative bias: the bias keeps the
            # call off the decode kernel
            attn = decode_attention(q, keys, values, mask, pos, bias=bias,
                                    scale=1.0)
        else:
            attn = dot_product_attention(q, k, v, causal=causal, bias=bias,
                                         scale=1.0)
        return self.out(attn.reshape(b, s, -1))


class _GatedMlp(nn.Module):
    """T5 v1.1's MLP: ``wo(gelu_tanh(wi_0 x) * wi_1 x)``, no biases."""

    def __init__(self, d: int, ffn: int, *, device):
        super().__init__()
        self.wi_0 = Linear(d, ffn, device=device)
        self.wi_1 = Linear(d, ffn, device=device)
        self.wo = Linear(ffn, d, device=device)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _EncoderBlock(nn.Module):
    def __init__(self, d, heads, ffn, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.ln_attn = RMSNorm(d, eps=EPS, device=device)
        self.attn = _Attention(d, heads, device=device)
        self.ln_mlp = RMSNorm(d, eps=EPS, device=device)
        self.mlp = _GatedMlp(d, ffn, device=device)

    def forward(self, x, bias):
        x = x + self.attn(self.ln_attn(x, self.dtype), bias=bias)
        return x + self.mlp(self.ln_mlp(x, self.dtype))


class _DecoderBlock(nn.Module):
    def __init__(self, d, heads, ffn, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.ln_self = RMSNorm(d, eps=EPS, device=device)
        self.self_attn = _Attention(d, heads, device=device)
        self.ln_cross = RMSNorm(d, eps=EPS, device=device)
        self.cross_attn = _Attention(d, heads, device=device)
        self.ln_mlp = RMSNorm(d, eps=EPS, device=device)
        self.mlp = _GatedMlp(d, ffn, device=device)

    def forward(self, x, enc, bias, cache=None):
        x = x + self.self_attn(self.ln_self(x, self.dtype), bias=bias,
                               causal=cache is None, cache=cache)
        # cross-attention carries no relative bias; in decode its K/V are
        # recomputed from the fixed encoder output each step
        x = x + self.cross_attn(self.ln_cross(x, self.dtype), kv=enc)
        return x + self.mlp(self.ln_mlp(x, self.dtype))


class T5(nn.Module):
    """The reference's ``T5`` (defaults vocab 512, d 256, ffn 512, 4 + 4
    layers, 4 heads, 32 buckets to distance 128, a decode cache of 128
    slots). ``device`` defaults to ``"cuda"`` and raises without a card
    unless ``"cpu"`` is given; ``seed`` draws flax's init (N(0, 1)
    ``wte``, N(0, 0.4) relative-bias tables, N(0, 0.05) ``lm_head``,
    lecun-normal projections, unit norm scales)."""

    def __init__(self, vocab_size: int = 512, hidden_dim: int = 256,
                 ffn_dim: int = 512, enc_depth: int = 4, dec_depth: int = 4,
                 num_heads: int = 4, rel_buckets: int = 32,
                 rel_max_distance: int = 128, max_decode_len: int = 128,
                 dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.ffn_dim = ffn_dim
        self.enc_depth = enc_depth
        self.dec_depth = dec_depth
        self.num_heads = num_heads
        self.rel_buckets = rel_buckets
        self.rel_max_distance = rel_max_distance
        self.max_decode_len = max_decode_len
        self.dtype = dtype
        dev = self.device
        self.wte = nn.Parameter(torch.empty(vocab_size, hidden_dim, device=dev))
        self.enc_rel_bias = nn.Parameter(torch.empty(rel_buckets, num_heads,
                                                     device=dev))
        self.dec_rel_bias = nn.Parameter(torch.empty(rel_buckets, num_heads,
                                                     device=dev))
        blk = dict(dtype=dtype, device=dev)
        self.enc = nn.ModuleList(
            _EncoderBlock(hidden_dim, num_heads, ffn_dim, **blk)
            for _ in range(enc_depth))
        self.ln_enc = RMSNorm(hidden_dim, eps=EPS, device=dev)
        self.dec = nn.ModuleList(
            _DecoderBlock(hidden_dim, num_heads, ffn_dim, **blk)
            for _ in range(dec_depth))
        self.ln_dec = RMSNorm(hidden_dim, eps=EPS, device=dev)
        self.lm_head = Linear(hidden_dim, vocab_size, device=dev)
        self.init_weights(seed)
        self.eval()

    @property
    def geometry(self) -> dict:
        """What a checkpoint of this model is bound to (the run meta)."""
        return {"arch": "t5", "vocab_size": self.vocab_size,
                "hidden_dim": self.hidden_dim, "ffn_dim": self.ffn_dim,
                "enc_depth": self.enc_depth, "dec_depth": self.dec_depth,
                "num_heads": self.num_heads}

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = generator(int(seed), self.device)
        normal = lambda p, std: p.copy_(
            torch.randn(p.shape, device=p.device, generator=g) * std)
        normal(self.wte, 1.0)
        normal(self.enc_rel_bias, 0.4)
        normal(self.dec_rel_bias, 0.4)
        normal(self.lm_head.weight, 0.05)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.startswith(("enc.", "dec.")):
                lecun_(p, p.shape[1], g)

    def _rel_bias(self, table, q_len: int, k_len: int, bidirectional: bool):
        buckets = relative_position_buckets(
            q_len, k_len, bidirectional=bidirectional,
            num_buckets=self.rel_buckets, max_distance=self.rel_max_distance,
            device=table.device)
        return table[buckets].permute(2, 0, 1)  # [H, Sq, Sk]

    def _head(self, y):
        return self.lm_head(self.ln_dec(y, self.dtype)).float()

    def init_cache(self, batch_size: int) -> dict:
        """Zeroed decoder cache: per decoder layer head-major ``[B, H,
        max_decode_len, dh]`` K/V buffers and a cursor, and the stack's
        position cursor (the bias rows)."""
        shape = (batch_size, self.num_heads, self.max_decode_len,
                 self.hidden_dim // self.num_heads)
        mk = lambda: torch.zeros(shape, dtype=self.dtype, device=self.device)
        return {"position": 0,
                "layers": [{"k": mk(), "v": mk(), "index": 0}
                           for _ in range(self.dec_depth)]}

    def encode(self, enc_tokens):
        x = self.wte[enc_tokens.long()].to(self.dtype)
        se = x.shape[1]
        bias = self._rel_bias(self.enc_rel_bias, se, se, True)
        for blk in self.enc:
            x = blk(x, bias)
        return self.ln_enc(x, self.dtype)

    def forward(self, enc_tokens, dec_tokens=None, *,
                return_hidden: bool = False, encode_only: bool = False,
                decode: bool = False, enc=None, cache=None):
        """Teacher-forced ``(enc_tokens [B, Se], dec_tokens [B, Sd])`` ->
        f32 logits ``[B, Sd, V]``; the other entry points are in the
        module docstring (under ``decode`` the first argument is the
        decoder chunk)."""
        if decode:
            if cache is None or enc is None:
                raise ValueError("decode=True needs the encoder output enc= "
                                 "and a cache= (T5.init_cache)")
            with torch.no_grad():
                return self._decode(enc_tokens, enc, cache)
        if encode_only:
            return self.encode(enc_tokens)
        if dec_tokens is None:
            # the reference's single-input convention: an (enc, dec) pair
            enc_tokens, dec_tokens = enc_tokens
        enc = self.encode(enc_tokens)
        y = self.wte[dec_tokens.long()].to(self.dtype)
        sd = y.shape[1]
        bias = self._rel_bias(self.dec_rel_bias, sd, sd, False)
        for blk in self.dec:
            y = blk(y, enc, bias)
        if return_hidden:
            return self.ln_dec(y, self.dtype)
        return self._head(y)

    def _decode(self, tok, enc, cache):
        dmax = self.max_decode_len
        s = tok.shape[1]
        if s > dmax:
            raise ValueError(f"decode chunk of {s} tokens exceeds "
                             f"max_decode_len {dmax} (the decoder KV-cache "
                             "buffer)")
        pos = int(cache["position"])
        if pos + s > dmax:
            raise ValueError(
                f"incremental decode past max_decode_len {dmax} (cursor "
                f"{pos} + chunk {s}); grow max_decode_len or stop the decode "
                "loop")
        cache["position"] = pos + s
        # rows pos..pos+s of the full causal table: each chunk row sees its
        # own relative distances to every slot
        bias = self._rel_bias(self.dec_rel_bias, dmax, dmax, False)[
            :, pos:pos + s]
        y = self.wte[tok.long()].to(self.dtype)
        for blk, layer in zip(self.dec, cache["layers"]):
            y = blk(y, enc, bias, cache=layer)
        return self._head(y)


def t5_small(**kw) -> T5:
    """t5-v1.1-small geometry: 512 hidden, 8 + 8 layers, 6 heads, ffn
    1024."""
    kw.setdefault("hidden_dim", 512)
    kw.setdefault("ffn_dim", 1024)
    kw.setdefault("enc_depth", 8)
    kw.setdefault("dec_depth", 8)
    kw.setdefault("num_heads", 6)
    return T5(**kw)


def span_corruption_plan(length: int, *, density: float = 0.15,
                         mean_span: float = 3.0):
    """``(noise_tokens, n_spans, enc_len, dec_len)`` for a window of
    ``length`` tokens: fixed counts, so every example shares one shape."""
    noise = max(1, int(round(length * density)))
    spans = max(1, int(round(noise / mean_span)))
    spans = min(spans, noise)
    enc_len = length - noise + spans
    dec_len = noise + spans + 1  # sentinels + spans + EOS
    return noise, spans, enc_len, dec_len


def span_corrupt_transform(vocab_size: int, *, density: float = 0.15,
                           mean_span: float = 3.0, seed: int = 0,
                           key: str = "tokens", start_id: int = 0):
    """The reference's T5 span corruption, bit for bit: exactly ``noise``
    tokens in exactly ``spans`` spans leave each window, each span replaced
    by a sentinel (ids ``vocab_size - 1`` downward); the target is
    ``sentinel_0, span_0, ..., EOS`` (EOS ``vocab_size - spans - 1``), the
    decoder input the target shifted right behind ``start_id``. Produces
    ``{"enc_tokens", "dec_tokens", "targets"}``. ``wants_position``: a
    position-aware loader passes ``(epoch, start)`` and the draws are a
    function of ``(seed, epoch, start)`` (fresh each epoch, replayed
    exactly on a resume); called without them it keys on the crc32 of the
    batch's tokens."""

    def run(batch, epoch=None, start=None):
        tokens = np.asarray(batch[key])
        if epoch is not None:
            entropy = [seed, int(epoch), int(start)]
        else:
            entropy = [seed,
                       zlib.crc32(np.ascontiguousarray(tokens).tobytes())]
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence(entropy)))
        b, length = tokens.shape
        noise, spans, enc_len, dec_len = span_corruption_plan(
            length, density=density, mean_span=mean_span)
        sentinels = vocab_size - 1 - np.arange(spans)
        eos = vocab_size - spans - 1
        enc = np.empty((b, enc_len), tokens.dtype)
        dec = np.empty((b, dec_len), tokens.dtype)
        tgt = np.empty((b, dec_len), tokens.dtype)
        for i in range(b):
            # `noise` into `spans` positive parts, `length - noise` into
            # `spans + 1` non-negative gaps
            span_cuts = np.sort(
                rng.choice(noise - 1, size=spans - 1, replace=False)
            ) + 1 if spans > 1 else np.empty(0, np.int64)
            span_lens = np.diff(np.r_[0, span_cuts, noise])
            free = length - noise
            gap_cuts = np.sort(rng.integers(0, free + 1, size=spans))
            gaps = np.diff(np.r_[0, gap_cuts, free])
            e, t, pos = [], [], 0
            for s in range(spans):
                e.append(tokens[i, pos:pos + gaps[s]])
                pos += gaps[s]
                e.append(sentinels[s:s + 1].astype(tokens.dtype))
                t.append(sentinels[s:s + 1].astype(tokens.dtype))
                t.append(tokens[i, pos:pos + span_lens[s]])
                pos += span_lens[s]
            e.append(tokens[i, pos:])
            t.append(np.asarray([eos], tokens.dtype))
            enc[i] = np.concatenate(e)
            tgt[i] = np.concatenate(t)
            dec[i, 0] = start_id
            dec[i, 1:] = tgt[i, :-1]
        out = dict(batch)
        out.pop(key, None)
        out["enc_tokens"] = enc
        out["dec_tokens"] = dec
        out["targets"] = tgt
        return out

    run.wants_position = True
    return run


def seq2seq_forward(model: T5):
    """``forward_loss(module, batch)`` for :func:`tpudist_torch.train.
    make_train_step`: the mean CE of the decoder's logits against the span
    targets (every position is real: the fixed-count corruption pads
    nothing). Ranks hold equal batches, so DDP's average of the ranks'
    means is the global mean."""

    def forward_loss(module, batch):
        logits = module(batch["enc_tokens"], batch["dec_tokens"])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["targets"].long().reshape(-1))

    forward_loss.layout = None
    return forward_loss
