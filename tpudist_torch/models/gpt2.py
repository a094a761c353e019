"""GPT-2 decoder in PyTorch: counterpart of :mod:`tpudist.models.gpt2`.

Dense blocks only (no MoE, tensor/pipeline parallelism, scan or remat in
this slice). The decode path runs over a KV cache
(:mod:`tpudist_torch.ops.decode`) in the reference's three modes: scalar
cursor (``generate``), per-row positions (the contiguous serving pool)
and paged block tables (the paged pool). Any ``attn_impl`` other than
``"xla"`` sends decode through the kernels, as in the reference. The
non-decode forward is dense for ``"xla"`` and ``"fused"`` and goes
through :func:`tpudist_torch.ops.attention.multi_head_attention` for
``"vmem"`` and ``"auto"`` (the whole-row kernel); ``"flash"`` raises
until its kernel is ported (ROADMAP Queue 2 #4).

``fused_ln`` (an attribute, which ``make_train_step(fused="ln")`` sets)
swaps in the fused residual-add + LayerNorm kernel
(:mod:`tpudist_torch.ops.layernorm`) where the reference's knob does:
``ln_1`` plain, ``ln_2`` pre-norm with the residual stream, ``ln_f``
plain, never on decode. The parameters are the same either way: each
:class:`LayerNorm` holds ``scale`` and ``bias`` and runs either path.

Numerics follow the flax model at ``dtype``: every parameter is a
float32 master cast to ``dtype`` at each use, as flax does (under the
fused optimizer's compute copy the parameters already are ``dtype`` and
the casts are no-ops); :func:`compute_copy` gives the serving engine a
copy held in ``dtype``. LayerNorm keeps f32 statistics with flax's fast
variance ``E[x^2] - E[x]^2``, GELU is the tanh approximation (flax
``nn.gelu``), and the tied LM head returns f32 logits.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.device import resolve_device
from tpudist_torch.ops.attention import multi_head_attention
from tpudist_torch.ops.decode import (
    cached_kv, decode_attention, paged_decode_attention,
)
from tpudist_torch.ops.layernorm import fused_layernorm

ATTN_IMPLS = ("xla", "fused", "vmem", "auto")
_UNPORTED_IMPLS = ("flash",)
# flax's lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: f32 statistics with the fast
    variance, ``(x - mu) * (rsqrt(var + eps) * scale) + bias`` in f32,
    cast to the compute dtype."""

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, dtype):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mu) * mul + self.bias).to(dtype)

    def fused(self, x, dtype, residual=None):
        """The reference's ``FusedLayerNorm`` over these parameters: the
        kernel's direct variance, ``n`` in ``dtype``; with ``residual``,
        the pre-norm composition returning ``(n, x + residual)``."""
        return fused_layernorm(x, self.scale, self.bias, residual=residual,
                               eps=self.eps, out_dtype=dtype)


class Dense(nn.Module):
    """A linear layer with a float32 master ``weight [out, in]`` and
    ``bias``, cast to the input's dtype at each use (flax's
    ``Dense(dtype=...)``). ``bias_shape`` keeps the reference's bias shape
    (``qkv``'s ``[3, heads, dh]``), which the weight-decay mask reads:
    only 1-D leaves escape decay."""

    def __init__(self, n_in: int, n_out: int, *, bias_shape=None,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, device=device))
        self.bias = nn.Parameter(torch.zeros(bias_shape or (n_out,),
                                             device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        self.bias.reshape(-1).to(x.dtype))


class Block(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, *, dtype, attn_impl,
                 device):
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        lin = lambda i, o: Dense(i, o, device=device)
        self.ln_1 = LayerNorm(d, device=device)
        # out features ordered (3, heads, dh)
        self.qkv = Dense(d, 3 * d, bias_shape=(3, num_heads, d // num_heads),
                         device=device)
        self.out = lin(d, d)           # in features ordered (heads, dh)
        self.ln_2 = LayerNorm(d, device=device)
        self.mlp_fc = lin(d, 4 * d)
        self.mlp_proj = lin(4 * d, d)

    def forward(self, x, cache=None, positions=None, block_tables=None,
                fused_ln: bool = False):
        b, s, d = x.shape
        h = self.num_heads
        fused = fused_ln and cache is None
        y = self.ln_1.fused(x, self.dtype) if fused else self.ln_1(x, self.dtype)
        qkv = self.qkv(y).view(b, s, 3, h, d // h)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            keys, values, mask, pos = cached_kv(
                cache, k, v, positions=positions, block_tables=block_tables,
            )
            kernel = self.attn_impl != "xla"
            if block_tables is not None:
                # paged decode: keys/values are the shared block pool and
                # `mask` carries the per-row block tables
                attn = paged_decode_attention(
                    q.contiguous(), keys, values, mask, pos,
                    impl="paged" if kernel else "xla",
                )
            else:
                attn = decode_attention(
                    q.contiguous(), keys, values, mask, pos,
                    impl="fused" if kernel else "xla",
                )
        else:
            attn = multi_head_attention(q, k, v, causal=True,
                                        impl=self.attn_impl)
        y = self.out(attn.reshape(b, s, d))
        if fused:
            # one kernel sweep: the residual add and the norm, both the
            # normed value and the updated residual stream come back
            y, x = self.ln_2.fused(y, self.dtype, residual=x)
        else:
            x = x + y
            y = self.ln_2(x, self.dtype)
        y = F.gelu(self.mlp_fc(y), approximate="tanh")
        return x + self.mlp_proj(y)


class GPT2(nn.Module):
    """GPT-2 with the reference's defaults (124M: vocab 50257, S 1024,
    d 768, 12 layers, 12 heads). ``device`` defaults to ``"cuda"`` and
    raises without a card unless ``"cpu"`` is given; ``seed`` draws the
    random init from a ``torch.Generator`` on that device (flax's
    distributions: lecun-normal kernels, N(0, 0.02) ``wte``, N(0, 0.01)
    ``wpe``, zero biases, unit LayerNorm scales)."""

    def __init__(self, vocab_size: int = 50257, max_seq_len: int = 1024,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 dtype=torch.float32, attn_impl: str = "xla", *,
                 fused_ln: bool = False, device=None, seed: int = 0):
        super().__init__()
        if attn_impl in _UNPORTED_IMPLS:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} needs the blockwise flash kernel, "
                "which the port does not have yet (ROADMAP Queue 2 #4)"
            )
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide into num_heads")
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.fused_ln = bool(fused_ln)
        dev = self.device
        self.wte = nn.Parameter(torch.empty(vocab_size, hidden_dim, device=dev))
        self.wpe = nn.Parameter(torch.empty(max_seq_len, hidden_dim, device=dev))
        self.h = nn.ModuleList(
            Block(hidden_dim, num_heads, dtype=dtype, attn_impl=attn_impl,
                  device=dev)
            for _ in range(depth)
        )
        self.ln_f = LayerNorm(hidden_dim, device=dev)
        self.init_weights(seed)
        self.eval()

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))

        def lecun(p, fan_in):
            t = torch.empty(p.shape, device=self.device)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            p.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

        def normal(p, std):
            p.copy_(torch.randn(p.shape, device=self.device, generator=g) * std)

        d = self.hidden_dim
        normal(self.wte, 0.02)
        normal(self.wpe, 0.01)
        for blk in self.h:
            for lin, fan_in in ((blk.qkv, d), (blk.out, d), (blk.mlp_fc, d),
                                (blk.mlp_proj, 4 * d)):
                lecun(lin.weight, fan_in)
                lin.bias.zero_()
            for ln in (blk.ln_1, blk.ln_2):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.scale.fill_(1.0)
        self.ln_f.bias.zero_()

    def init_cache(self, batch_size: int) -> dict:
        """Zeroed decode cache for ``batch_size`` rows — the serving
        engine's slot-pool allocation hook."""
        from tpudist_torch.generate import zero_cache

        return zero_cache(self, batch_size)

    def forward(self, tokens, *, cache=None, positions=None,
                block_tables=None, return_hidden: bool = False):
        """``tokens [B, s]`` -> f32 logits ``[B, s, V]`` (or the final
        hidden state with ``return_hidden``). With ``cache`` the decode
        path runs: scalar cursor, per-row ``positions`` or paged
        ``block_tables``, and the cache is updated in place — without
        autograd, as the reference's KV-cache step has no backward. The
        ``fused_ln`` attribute takes the fused LN kernel on the non-decode
        path."""
        if cache is not None:
            with torch.no_grad():
                return self._forward(tokens, cache, positions, block_tables,
                                     return_hidden, False)
        return self._forward(tokens, None, None, None, return_hidden,
                             self.fused_ln)

    def _forward(self, tokens, cache, positions, block_tables, return_hidden,
                 fused):
        b, s = tokens.shape
        if tokens.dtype != torch.int64:
            tokens = tokens.long()
        if cache is not None and positions is not None:
            # per-ENTRY overrun: row b's entry i sits at pos_b + i. Entries
            # past max_seq_len NaN-poison individually (a speculative verify
            # tail); a fully-overrun row fails loudly when the check costs
            # no device sync (positions on the host)
            row_pos = positions.long()[:, None] + torch.arange(
                s, device=positions.device)[None, :]
            overrun = row_pos + 1 > self.max_seq_len
            if positions.device.type == "cpu" and bool(overrun[:, 0].any()):
                raise ValueError(
                    f"per-slot decode past max_seq_len {self.max_seq_len} "
                    f"(positions {positions.tolist()}); the KV cache and wpe "
                    "table end there"
                )
            pos = self.wpe[row_pos.clamp(max=self.max_seq_len - 1)]
            pos = torch.where(overrun[:, :, None], float("nan"), pos)
        elif cache is not None:
            cursor = int(cache["position"])
            if cursor + s > self.max_seq_len:
                raise ValueError(
                    f"incremental decode past max_seq_len {self.max_seq_len} "
                    f"(cursor {cursor} + chunk {s}); the KV cache and wpe "
                    "table end there"
                )
            pos = self.wpe[cursor:cursor + s][None]
            cache["position"] = cursor + s
        else:
            pos = self.wpe[:s][None]
        x = self.wte[tokens].to(self.dtype) + pos.to(self.dtype)
        layers = cache["layers"] if cache is not None else [None] * self.depth
        for blk, layer in zip(self.h, layers):
            x = blk(x, layer, positions=positions, block_tables=block_tables,
                    fused_ln=fused)
        x = self.ln_f.fused(x, self.dtype) if fused else self.ln_f(x, self.dtype)
        if return_hidden:
            return x
        return tied_head(x, self.wte.to(self.dtype))


class _TiedHeadF32(torch.autograd.Function):
    """``x @ wte^T`` of two half-precision operands with float32 output
    (cuBLAS accumulates in f32); the backward rounds the f32 cotangent to
    the operands' dtype for its two products."""

    @staticmethod
    def forward(ctx, x2, wte):
        ctx.save_for_backward(x2, wte)
        return torch.mm(x2, wte.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, wte = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ wte, g.t() @ x2


def tied_head(x, wte):
    """The weight-tied LM head with f32 logits (the reference's
    ``preferred_element_type=f32``): a bf16 product would round the logits
    to bf16 and change greedy choices. ``wte`` is in x's dtype."""
    if x.dtype == torch.float32:
        return x @ wte.t()
    if x.is_cuda:
        flat = _TiedHeadF32.apply(x.reshape(-1, x.shape[-1]), wte)
        return flat.reshape(*x.shape[:-1], wte.shape[0])
    return x.float() @ wte.float().t()


def compute_copy(model: GPT2) -> GPT2:
    """``model`` with its matmul weights, biases and embeddings held in
    its compute dtype, the values every forward casts them to, so an
    inference step pays no per-use cast (the serving engine's copy: on
    the H100 a GPT-2 124M bf16 decode step took 9.1-10.8 ms on it and
    11.9-15.7 ms on the masters, ``lm_kernels_bench --decode_ab``);
    LayerNorm parameters stay float32. The copy is a snapshot: later
    updates of ``model``'s weights do not reach it. Returns ``model``
    itself when it computes in float32 or already holds its weights in
    its dtype."""
    if model.dtype == torch.float32 or model.wte.dtype == model.dtype:
        return model
    held = copy.deepcopy(model)
    with torch.no_grad():
        for p in (held.wte, held.wpe):
            p.data = p.data.to(held.dtype)
        for m in held.modules():
            if isinstance(m, Dense):
                m.weight.data = m.weight.data.to(held.dtype)
                m.bias.data = m.bias.data.to(held.dtype)
    return held


def gpt2_124m(**kw) -> GPT2:
    return GPT2(**kw)
