"""Llama-family decoder in PyTorch: counterpart of :mod:`tpudist.models.llama`.

Pre-norm RMSNorm, rotary position embeddings (:func:`apply_rope`, the
rotate-half convention, angles in float32, no position table),
grouped-query attention (``num_kv_heads`` K/V heads under ``num_heads``
query heads), a SwiGLU MLP, no biases and an untied LM head (tying
optional). Dense blocks only: ``num_experts > 0`` (Mixtral) is not
ported yet. The context-parallel impls (``"ring"``, ``"ulysses"``,
``"ulysses_flash"``) take GPT-2's ``layout`` (:mod:`.gpt2`): RoPE rotates
this rank's chunk at its global positions, and grouped K/V heads are
repeated before the attention, as the reference repeats them. Under a seq
axis the other impls attend over the gathered sequence, as GPT-2's do,
with grouped K/V heads gathered before any repeat.

The parameter names are the reference's, so the optimizer's routing
(``optim._ADAM_TOP``, ``muon_view``, the 1-D decay mask), the checkpoint
and the HF bridge read them as they read the flax tree: top-level
``embed``, ``norm`` and ``lm_head``, and ``layer_{i}`` with ``attn_norm``,
``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``, ``mlp_norm``,
``gate_proj``, ``up_proj`` and ``down_proj`` (each linear a float32
master ``weight [out, in]``, flax's ``[in, out...]`` kernel transposed
with its grouped axes flattened).

Numerics follow the flax model at ``dtype``, as :mod:`.gpt2` does: every
parameter is cast to ``dtype`` at its use, RMSNorm is flax's ``nn.RMSNorm``
(the mean of squares in float32, ``x * (rsqrt(var + eps) * scale)``, cast
to ``dtype``), and the head is ``einsum("bsd,vd->bsv", x, head.astype(
dtype), preferred_element_type=f32)``: the product of the half-precision
operands with float32 logits that :func:`.gpt2.tied_head` computes for any
``[V, D]`` weight (and its float32-cotangent backward).

``fused_ln`` (which ``make_train_step(fused="ln")`` sets) runs the three
RMSNorms through the fused kernel (:func:`~tpudist_torch.ops.layernorm.
fused_layernorm`, ``rms=True``) as the reference does: ``attn_norm``
plain, ``mlp_norm`` pre-norm with the residual stream riding back, the
final ``norm`` plain; never on decode.

The decode path (``cache=``) is the reference's: keys are rotated at
their absolute positions before they are cached and q at the same offset
(the layer's scalar cursor, or ``positions`` per row); the cache holds
``num_kv_heads`` heads, which the decode kernels read in place. Any
``attn_impl`` other than ``"xla"`` sends decode through the kernels.
``scan_layers``/``remat_layers``/``remat_policy`` are GPT-2's (see
:mod:`.gpt2`): eager PyTorch keeps the unrolled blocks, and
:func:`stack_llama_layers` / :func:`unstack_llama_layers` move a state
dict between that layout and the reference's stacked one.
"""

from __future__ import annotations

import copy
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch import remat as remat_lib
from tpudist_torch.device import resolve_device
from tpudist_torch.rng import generator
from tpudist_torch.models.gpt2 import (
    _TRUNC_STD, check_attn_impl, gathers_sequence, refuse_cp_decode,
    seq_offset, tied_head,
)
from tpudist_torch.ops.attention import multi_head_attention, repeat_kv
from tpudist_torch.ops.decode import (
    cached_kv, decode_attention, paged_decode_attention,
)
from tpudist_torch.ops.layernorm import fused_layernorm
from tpudist_torch.parallel.cp import (
    CP_IMPLS, context_parallel_attention, gathered_attention_local,
)

#: the ROADMAP item that ports the Mixtral-style experts
_MOE_ITEM = "Queue 1 #7"


def apply_rope(x, *, theta: float = 10000.0, positions=None):
    """Rotary position embedding over ``x [B, S, H, D]`` (rotate-half).
    Angles in float32, the output cast once to x's dtype. ``positions`` is
    ``[S]`` (shared by the batch) or ``[B, S]`` (per-row absolute
    positions); ``None`` means ``0 .. S-1``. The frequencies are
    ``theta ** (-i / (D/2))`` with the exponent in float32, as the
    reference computes it, and the power rounded once to float32."""
    b, s, h, d = x.shape
    half = d // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(float(theta), dtype=torch.float64,
                                   device=x.device), expo.double()).float()
    if positions is None:
        positions = torch.arange(s, dtype=torch.float32, device=x.device)
    angles = positions.float()[..., :, None] * freqs  # [S, half] / [B, S, half]
    if angles.ndim == 3:
        cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    else:
        cos, sin = torch.cos(angles)[None, :, None], torch.sin(angles)[None, :, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_positions(start, s: int, device):
    """The positions of a decode chunk of ``s`` rows: ``start .. start + s
    - 1`` for a scalar cursor (``[s]``), row ``b``'s ``start_b ..`` for
    per-row cursors ``[B]`` (``[B, s]``), as float32."""
    steps = torch.arange(s, device=device)
    if isinstance(start, int):
        return (start + steps).float()
    return (start.long()[:, None] + steps[None, :]).float()


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=eps, dtype=dtype)``: float32 mean of
    squares, ``x * (rsqrt(var + eps) * scale)`` in float32, cast to the
    compute dtype. ``fused`` runs the fused kernel over the same
    ``scale``."""

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x, dtype):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps) * self.scale)).to(dtype)

    def fused(self, x, dtype, residual=None):
        """The reference's ``FusedLayerNorm(rms=True)``: ``n`` in
        ``dtype``; with ``residual``, the pre-norm composition returning
        ``(n, x + residual)``."""
        return fused_layernorm(x, self.scale, residual=residual, eps=self.eps,
                               rms=True, out_dtype=dtype)


class Linear(nn.Module):
    """A bias-free linear layer (flax ``Dense(use_bias=False)``): a float32
    master ``weight [out, in]`` cast to the input's dtype at each use."""

    def __init__(self, n_in: int, n_out: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


class LlamaBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, num_kv_heads: int,
                 ffn_dim: int, *, dtype, attn_impl, rope_theta: float,
                 norm_eps: float, device, layout=None):
        super().__init__()
        d = hidden_dim
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.dtype, self.attn_impl = dtype, attn_impl
        self.layout = layout
        self.rope_theta = rope_theta
        dh = d // num_heads
        self.attn_norm = RMSNorm(d, eps=norm_eps, device=device)
        # q/k/v out features ordered (heads, dh); o_proj's in features too
        self.q_proj = Linear(d, num_heads * dh, device=device)
        self.k_proj = Linear(d, num_kv_heads * dh, device=device)
        self.v_proj = Linear(d, num_kv_heads * dh, device=device)
        self.o_proj = Linear(num_heads * dh, d, device=device)
        self.mlp_norm = RMSNorm(d, eps=norm_eps, device=device)
        self.gate_proj = Linear(d, ffn_dim, device=device)
        self.up_proj = Linear(d, ffn_dim, device=device)
        self.down_proj = Linear(ffn_dim, d, device=device)

    def forward(self, x, cache=None, positions=None, block_tables=None,
                fused_ln: bool = False, offset: int = 0):
        """``offset``: the global position of ``x``'s first row (a
        context-parallel chunk's)."""
        b, s, d = x.shape
        h, kv = self.num_heads, self.num_kv_heads
        dh = d // h
        fused = fused_ln and cache is None
        y = (self.attn_norm.fused(x, self.dtype) if fused
             else self.attn_norm(x, self.dtype))
        q = self.q_proj(y).view(b, s, h, dh)
        k = self.k_proj(y).view(b, s, kv, dh)
        v = self.v_proj(y).view(b, s, kv, dh)
        theta = self.rope_theta
        if cache is not None:
            if cache["k"].shape[1] != kv:
                raise ValueError(
                    f"the decode cache holds {cache['k'].shape[1]} heads, the "
                    f"block {kv} K/V heads (num_kv_heads)")
            # keys rotated at their absolute positions before they are
            # cached; q at the same offset
            start = positions if positions is not None else int(cache["index"])
            pos = rope_positions(start, s, x.device)
            k = apply_rope(k, theta=theta, positions=pos)
            q = apply_rope(q, theta=theta, positions=pos).contiguous()
            keys, values, mask, cur = cached_kv(
                cache, k, v, positions=positions, block_tables=block_tables)
            kernel = self.attn_impl != "xla"
            if block_tables is not None:
                attn = paged_decode_attention(
                    q, keys, values, mask, cur,
                    impl="paged" if kernel else "xla")
            else:
                attn = decode_attention(q, keys, values, mask, cur,
                                        impl="fused" if kernel else "xla")
        elif self.attn_impl in CP_IMPLS:
            pos = torch.arange(offset, offset + s, dtype=torch.float32,
                               device=x.device)
            q = apply_rope(q, theta=theta, positions=pos)
            k = apply_rope(k, theta=theta, positions=pos)
            # the CP bodies shard and rotate whole head sets
            k, v = repeat_kv(q, k, v)
            attn = context_parallel_attention(
                q, k, v, self.attn_impl, self.layout.seq_group, causal=True)
        elif gathers_sequence(self):
            pos = torch.arange(offset, offset + s, dtype=torch.float32,
                               device=x.device)
            q = apply_rope(q, theta=theta, positions=pos)
            k = apply_rope(k, theta=theta, positions=pos)
            # grouped K/V gathered as they are, repeated (if at all) by the
            # attention over the whole sequence
            attn = gathered_attention_local(
                q, k, v, group=self.layout.seq_group, causal=True,
                attn_fn=functools.partial(multi_head_attention,
                                          impl=self.attn_impl))
        else:
            q = apply_rope(q, theta=theta)
            k = apply_rope(k, theta=theta)
            # grouped K/V as they are: vmem reads them in place, flash and
            # the dense path repeat them
            attn = multi_head_attention(q, k, v, causal=True,
                                        impl=self.attn_impl)
        o = self.o_proj(attn.reshape(b, s, h * dh))
        if fused:
            # the residual add and the norm in one sweep; the updated
            # residual stream rides back
            y, x = self.mlp_norm.fused(o, self.dtype, residual=x)
        else:
            x = x + o
            y = self.mlp_norm(x, self.dtype)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))


def default_ffn_dim(hidden_dim: int) -> int:
    """The SwiGLU width ``ffn_dim=None`` resolves to: 8/3 d rounded up to a
    multiple of 256 (the Llama convention, the reference's formula)."""
    return -(-8 * hidden_dim // 3 // 256) * 256


class Llama(nn.Module):
    """The reference's ``Llama`` fields and defaults (vocab 32000, S 2048,
    d 768, 12 layers, 12 heads, MHA unless ``num_kv_heads``, SwiGLU width
    :func:`default_ffn_dim` unless ``ffn_dim``, theta 1e4, eps 1e-5, an
    untied head; ``layout`` for the context-parallel impls, as GPT-2's).
    ``device`` defaults to ``"cuda"`` and raises without a card unless
    ``"cpu"`` is given; ``seed`` draws the random init from a
    ``torch.Generator`` on that device (flax's distributions: lecun-normal
    kernels, N(0, 0.02) ``embed`` and ``lm_head``, unit RMSNorm scales)."""

    def __init__(self, vocab_size: int = 32000, max_seq_len: int = 2048,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_kv_heads: int | None = None, ffn_dim: int | None = None,
                 rope_theta: float = 10000.0, dtype=torch.float32,
                 attn_impl: str = "xla", *, tie_embeddings: bool = False,
                 norm_eps: float = 1e-5, scan_layers: bool = False,
                 remat_layers: bool = False, remat_policy=None,
                 fused_ln: bool = False, num_experts: int = 0, layout=None,
                 device=None, seed: int = 0):
        super().__init__()
        if num_experts:
            raise NotImplementedError(
                f"Llama num_experts={num_experts} (Mixtral-style MoE) is not "
                f"ported yet (ROADMAP {_MOE_ITEM})")
        check_attn_impl(attn_impl, layout)
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide into num_heads")
        if remat_layers and not scan_layers:
            raise ValueError("remat_layers requires scan_layers=True "
                             "(set remat_policy to checkpoint the unrolled "
                             "blocks, or make_train_step(remat=...) for a "
                             "whole-forward checkpoint)")
        self.block_policy = remat_policy or ("full" if remat_layers else None)
        remat_lib.resolve(self.block_policy)  # an unknown name raises here
        self.device = resolve_device(device)
        self.vocab_size, self.max_seq_len = vocab_size, max_seq_len
        self.hidden_dim, self.depth, self.num_heads = hidden_dim, depth, num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.ffn_dim = ffn_dim or default_ffn_dim(hidden_dim)
        self.rope_theta = float(rope_theta)
        self.norm_eps = norm_eps
        self.dtype, self.attn_impl = dtype, attn_impl
        self.layout = layout
        self.tie_embeddings = bool(tie_embeddings)
        self.scan_layers = bool(scan_layers)
        self.fused_ln = bool(fused_ln)
        dev = self.device
        self.embed = nn.Parameter(torch.empty(vocab_size, hidden_dim, device=dev))
        for i in range(depth):
            self.add_module(f"layer_{i}", LlamaBlock(
                hidden_dim, num_heads, self.num_kv_heads, self.ffn_dim,
                dtype=dtype, attn_impl=attn_impl, rope_theta=self.rope_theta,
                norm_eps=norm_eps, device=dev, layout=layout))
        self.norm = RMSNorm(hidden_dim, eps=norm_eps, device=dev)
        if not self.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(vocab_size, hidden_dim, device=dev))
        self.init_weights(seed)
        self.eval()

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def blocks(self) -> list[LlamaBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.depth)]

    @property
    def head_weight(self) -> torch.Tensor:
        """The ``[V, D]`` output projection: ``lm_head``, or ``embed`` when
        tied."""
        return self.embed if self.tie_embeddings else self.lm_head

    @property
    def geometry(self) -> dict:
        """What a checkpoint of this model is bound to (the run meta)."""
        return {"arch": "llama", "vocab_size": self.vocab_size,
                "hidden_dim": self.hidden_dim, "depth": self.depth,
                "num_heads": self.num_heads, "num_kv_heads": self.num_kv_heads,
                "ffn_dim": self.ffn_dim, "rope_theta": self.rope_theta,
                "tie_embeddings": self.tie_embeddings}

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = generator(int(seed), self.device)

        def lecun(p, fan_in):
            t = torch.empty(p.shape, device=self.device)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            p.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

        def normal(p, std):
            p.copy_(torch.randn(p.shape, device=self.device, generator=g) * std)

        normal(self.embed, 0.02)
        for blk in self.blocks:
            for lin in (blk.q_proj, blk.k_proj, blk.v_proj, blk.o_proj,
                        blk.gate_proj, blk.up_proj, blk.down_proj):
                lecun(lin.weight, lin.weight.shape[1])
            blk.attn_norm.scale.fill_(1.0)
            blk.mlp_norm.scale.fill_(1.0)
        self.norm.scale.fill_(1.0)
        if not self.tie_embeddings:
            normal(self.lm_head, 0.02)

    def init_cache(self, batch_size: int) -> dict:
        """Zeroed decode cache for ``batch_size`` rows (``num_kv_heads``
        heads a layer) — the serving engine's slot-pool allocation hook."""
        from tpudist_torch.generate import zero_cache

        return zero_cache(self, batch_size)

    def compute_copy(self) -> "Llama":
        """The serving engine's copy (:func:`compute_copy`)."""
        return compute_copy(self)

    def forward(self, tokens, *, cache=None, positions=None,
                block_tables=None, return_hidden: bool = False):
        """``tokens [B, s]`` -> f32 logits ``[B, s, V]`` (or the final
        hidden state with ``return_hidden``). With ``cache`` the decode
        path runs (scalar cursor, per-row ``positions`` or paged
        ``block_tables``) without autograd, updating the cache in place;
        otherwise the ``fused_ln`` attribute picks the fused RMSNorm."""
        if cache is not None:
            refuse_cp_decode(self)
            if self.scan_layers:
                raise ValueError(
                    "scan_layers has no decode path (the KV cache needs "
                    "per-layer variables); generate with scan_layers=False")
            with torch.no_grad():
                return self._forward(tokens, cache, positions, block_tables,
                                     return_hidden, False)
        return self._forward(tokens, None, None, None, return_hidden,
                             self.fused_ln)

    def _forward(self, tokens, cache, positions, block_tables, return_hidden,
                 fused):
        b, s = tokens.shape
        if s > self.max_seq_len:
            raise ValueError(f"sequence {s} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        if tokens.dtype != torch.int64:
            tokens = tokens.long()
        x = self.embed[tokens].to(self.dtype)  # RoPE: no position table
        layers = cache["layers"] if cache is not None else [None] * self.depth
        policy = self.block_policy if cache is None else None
        offset = seq_offset(self, s) if cache is None else 0
        for blk, layer in zip(self.blocks, layers):
            run = remat_lib.checkpoint(blk, policy)
            x = run(x, layer, positions=positions, block_tables=block_tables,
                    fused_ln=fused, offset=offset)
        x = self.norm.fused(x, self.dtype) if fused else self.norm(x, self.dtype)
        if return_hidden:
            return x
        return tied_head(x, self.head_weight.to(self.dtype))


def compute_copy(model: Llama) -> Llama:
    """``model`` with ``embed``, ``lm_head`` and every linear weight held
    in its compute dtype, the values every forward casts them to, and the
    RMSNorm scales in float32 (:func:`.gpt2.compute_copy`'s rule). A
    snapshot; ``model`` itself when it computes in float32 or already
    holds its weights in its dtype."""
    if model.dtype == torch.float32 or model.embed.dtype == model.dtype:
        return model
    held = copy.deepcopy(model)
    with torch.no_grad():
        held.embed.data = held.embed.data.to(held.dtype)
        if not held.tie_embeddings:
            held.lm_head.data = held.lm_head.data.to(held.dtype)
        for m in held.modules():
            if isinstance(m, Linear):
                m.weight.data = m.weight.data.to(held.dtype)
    return held


def stack_llama_layers(state: dict, depth: int) -> dict:
    """The port's unrolled ``layer_{i}.*`` state dict -> the reference's
    ``scan_layers`` layout (``layers.block.*`` with a leading depth axis),
    refusing a depth that is not the state's."""
    found = {k.split(".", 1)[0] for k in state if k.startswith("layer_")}
    if len(found) != depth:
        raise ValueError(
            f"state holds {len(found)} layer_* layers but depth={depth} was "
            "requested — refusing to silently truncate/misstack")
    out = {k: v for k, v in state.items() if not k.startswith("layer_")}
    names = sorted({k.split(".", 1)[1] for k in state if k.startswith("layer_0.")})
    for n in names:
        out[f"layers.block.{n}"] = torch.stack(
            [state[f"layer_{i}.{n}"] for i in range(depth)])
    return out


def unstack_llama_layers(state: dict) -> dict:
    """Inverse of :func:`stack_llama_layers`: back to the unrolled
    ``layer_{i}.*`` layout the port's model, decode and the HF bridge
    use."""
    prefix = "layers.block."
    out = {k: v for k, v in state.items() if not k.startswith(prefix)}
    for k, v in state.items():
        if k.startswith(prefix):
            for i in range(v.shape[0]):
                out[f"layer_{i}.{k[len(prefix):]}"] = v[i]
    return out


def llama_125m(**kw) -> Llama:
    """GPT-2-124M-comparable Llama: 12 layers, 768 hidden, GQA 12/4."""
    kw.setdefault("num_kv_heads", 4)
    return Llama(**kw)


def llama2_7b(**kw) -> Llama:
    """Llama-2 7B geometry: 32 layers, 4096 hidden, MHA, ffn 11008."""
    kw.setdefault("hidden_dim", 4096)
    kw.setdefault("depth", 32)
    kw.setdefault("num_heads", 32)
    kw.setdefault("ffn_dim", 11008)
    kw.setdefault("max_seq_len", 4096)
    return Llama(**kw)


def llama3_8b(**kw) -> Llama:
    """Llama-3 8B geometry: GQA 32/8, ffn 14336, 128k vocab, theta 5e5."""
    kw.setdefault("hidden_dim", 4096)
    kw.setdefault("depth", 32)
    kw.setdefault("num_heads", 32)
    kw.setdefault("num_kv_heads", 8)
    kw.setdefault("ffn_dim", 14336)
    kw.setdefault("vocab_size", 128256)
    kw.setdefault("rope_theta", 500000.0)
    kw.setdefault("max_seq_len", 8192)
    return Llama(**kw)


def mixtral_8x7b(**kw) -> Llama:
    """Mixtral-8x7B geometry (every block an 8-expert top-2 MoE): not
    ported yet."""
    raise NotImplementedError(
        f"mixtral_8x7b (Mixtral-style MoE) is not ported yet (ROADMAP "
        f"{_MOE_ITEM})")

